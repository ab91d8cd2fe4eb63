"""laion_clap checkpoints -> the port's ``ClapModel`` state dict (port of
``syncfusion_tpu/models/clap/convert.py``).

The public ``630k-audioset-best.pt`` holds HTSAT under ``audio_branch.``
(timm-style Swin names, the mel BatchNorm as ``bn0``), HF RoBERTa under
``text_branch.`` and the two heads as ``{audio,text}_projection.{0,2}``,
each key possibly behind ``module.`` or ``model.``.  torch's layouts are the
port's, so loading is a rename: no tensor is transposed.  Keys the port does
not use (HTSAT's own mel front end and head, RoBERTa's pooler, the logit
scales, buffers such as ``relative_position_index``) are left out; the
caller's ``load_state_dict(strict=True)`` catches any key that is missing.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_BN0 = {"weight": "mel_bn_scale", "bias": "mel_bn_bias",
        "running_mean": "mel_bn_mean", "running_var": "mel_bn_var"}
_ROBERTA = {"attention.self.query": "attention_q", "attention.self.key": "attention_k",
            "attention.self.value": "attention_v",
            "attention.output.dense": "attention_out",
            "attention.output.LayerNorm": "attention_norm",
            "intermediate.dense": "intermediate", "output.dense": "output",
            "output.LayerNorm": "output_norm"}
_RULES = [
    (r"audio_branch\.patch_embed\.proj\.(weight|bias)", r"audio_branch.patch_embed.\1"),
    (r"audio_branch\.patch_embed\.norm\.(weight|bias)", r"audio_branch.patch_norm.\1"),
    (r"audio_branch\.layers\.(\d+)\.blocks\.(\d+)\."
     r"(norm1|norm2|attn\.qkv|attn\.proj)\.(weight|bias)",
     r"audio_branch.layers_\1.blocks_\2.\3.\4"),
    (r"audio_branch\.layers\.(\d+)\.blocks\.(\d+)\.mlp\.fc(1|2)\.(weight|bias)",
     r"audio_branch.layers_\1.blocks_\2.mlp_fc\3.\4"),
    (r"audio_branch\.layers\.(\d+)\.blocks\.(\d+)\.attn\.relative_position_bias_table",
     r"audio_branch.layers_\1.blocks_\2.attn.relative_position_bias_table"),
    (r"audio_branch\.layers\.(\d+)\.downsample\.(norm\.weight|norm\.bias|reduction\.weight)",
     r"audio_branch.layers_\1.downsample.\2"),
    (r"audio_branch\.norm\.(weight|bias)", r"audio_branch.norm.\1"),
    (r"(audio|text)_projection\.0\.(weight|bias)", r"\1_projection.linear1.\2"),
    (r"(audio|text)_projection\.2\.(weight|bias)", r"\1_projection.linear2.\2"),
    (r"text_branch\.embeddings\.(word_embeddings|position_embeddings|"
     r"token_type_embeddings|LayerNorm)\.(weight|bias)", r"text_branch.embeddings.\1.\2"),
]


def _strip(key: str, prefixes=("module.", "model.")) -> str:
    for p in prefixes:
        if key.startswith(p):
            key = key[len(p):]
    return key


def _port_key(key: str) -> str | None:
    """A laion_clap key (prefixes stripped) -> the port's key, or None for a
    key the port does not use."""
    m = re.fullmatch(r"audio_branch\.bn0\.(weight|bias|running_mean|running_var)", key)
    if m:
        return _BN0[m.group(1)]
    m = re.fullmatch(r"text_branch\.encoder\.layer\.(\d+)\.(.+)\.(weight|bias)", key)
    if m:
        sub = _ROBERTA.get(m.group(2))
        return None if sub is None else f"text_branch.layer_{m.group(1)}.{sub}.{m.group(3)}"
    for pattern, repl in _RULES:
        if re.fullmatch(pattern, key):
            return re.sub(pattern, repl, key)
    return None


def load_laion_clap(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A laion_clap state dict (tensors or numpy arrays) -> a state dict for
    ``ClapModel.load_state_dict(strict=True)``, in f32."""
    out = {}
    for key, val in state_dict.items():
        port = _port_key(_strip(key))
        if port is not None:
            out[port] = torch.as_tensor(np.asarray(val), dtype=torch.float32)
    return out


def hf_clap_audio_to_laion(state_dict: Mapping) -> dict[str, np.ndarray]:
    """Rename ``transformers``' CLAP audio-tower keys to laion_clap's
    (``ClapAudioModel(WithProjection)``: ``audio_model.audio_encoder.*`` and
    ``audio_projection.linear{1,2}``).  HF splits the fused qkv into query,
    key and value and renames the Swin block's parts; laion fuses qkv and
    keeps timm's names."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    out: dict = {}
    qkv: dict = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked") or "relative_position_index" in k:
            continue
        k = k.replace("audio_model.audio_encoder.", "audio_branch.")
        k = k.replace("audio_projection.linear1.", "audio_projection.0.")
        k = k.replace("audio_projection.linear2.", "audio_projection.2.")
        k = k.replace(".layernorm_before.", ".norm1.")
        k = k.replace(".layernorm_after.", ".norm2.")
        k = k.replace(".attention.output.dense.", ".attn.proj.")
        k = k.replace(".attention.self.relative_position_bias_table",
                      ".attn.relative_position_bias_table")
        k = k.replace(".intermediate.dense.", ".mlp.fc1.")
        k = k.replace(".output.dense.", ".mlp.fc2.")
        k = k.replace("audio_branch.batch_norm.", "audio_branch.bn0.")
        if ".attention.self." in k:  # query/key/value -> fused qkv
            base, leaf = k.rsplit(".attention.self.", 1)
            which, kind = leaf.split(".")
            qkv.setdefault((base, kind), {})[which] = v
            continue
        out[k] = v
    for (base, kind), parts in qkv.items():
        out[f"{base}.attn.qkv.{kind}"] = np.concatenate(
            [parts["query"], parts["key"], parts["value"]], axis=0)
    return out


def convert_hf_clap_audio(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """``transformers``' ``ClapAudioModelWithProjection`` state dict -> the
    audio tower's part of a ``ClapModel`` state dict (``audio_branch``,
    ``mel_bn_*``, ``audio_projection``): the rename to laion_clap's keys,
    then laion_clap's loader, as the JAX ``convert_hf_clap_audio`` composes
    its two."""
    return load_laion_clap(hf_clap_audio_to_laion(state_dict))
