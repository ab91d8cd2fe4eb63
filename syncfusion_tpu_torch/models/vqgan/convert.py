"""The reference's SpecVQGAN and minGPT checkpoints -> the Flax-named
parameter trees (port of ``syncfusion_tpu/models/vqgan/convert.py``).

The reference's SpecVQGAN state dicts (``specvqgan/models/vqgan.py``
VQModel) use taming-transformers names: ``encoder.down.{i}.block.{j}.*``,
``encoder.mid.block_1.*``, ``quantize.embedding.weight``, ``quant_conv.*``
and so on; its GPT (``GPTFeats``) minGPT's ``blocks.{i}.attn.{query,key,
value,proj}``, ``blocks.{i}.mlp.{0,2}`` and a Conv1d(512 -> n_embd, k1)
feature embedder.  Both functions return the same numpy tree as the JAX
converters, leaf for leaf; the port loads it with ``convert.
vqgan_state_dict`` into ``models.vqgan.model.VQModel`` and with
``convert.gpt_state_dict`` into ``models.mingpt.GPTFeats``.
"""

from __future__ import annotations

import numpy as np


def _t_conv2d(w: np.ndarray) -> np.ndarray:  # (O, I, Kh, Kw) -> (Kh, Kw, I, O)
    return np.transpose(w, (2, 3, 1, 0))


def _t_linear(w: np.ndarray) -> np.ndarray:  # (O, I) -> (I, O)
    return w.T


def _gn(sd, key):
    return {"scale": np.asarray(sd[f"{key}.weight"]), "bias": np.asarray(sd[f"{key}.bias"])}


def _conv(sd, key):
    return {"kernel": _t_conv2d(np.asarray(sd[f"{key}.weight"])),
            "bias": np.asarray(sd[f"{key}.bias"])}


def _resblock(sd, src):
    out = {"GroupNorm_0": _gn(sd, f"{src}.norm1"), "conv1": _conv(sd, f"{src}.conv1"),
           "GroupNorm_1": _gn(sd, f"{src}.norm2"), "conv2": _conv(sd, f"{src}.conv2")}
    if f"{src}.nin_shortcut.weight" in sd:
        out["nin_shortcut"] = _conv(sd, f"{src}.nin_shortcut")
    return out


def _attnblock(sd, src):
    return {"GroupNorm_0": _gn(sd, f"{src}.norm"), "q": _conv(sd, f"{src}.q"),
            "k": _conv(sd, f"{src}.k"), "v": _conv(sd, f"{src}.v"),
            "proj_out": _conv(sd, f"{src}.proj_out")}


def _numpy(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def convert_torch_vqgan(state_dict: dict, ch_mult=(1, 1, 2, 2, 4),
                        num_res_blocks: int = 2) -> dict:
    """A SpecVQGAN state dict -> ``{"params": ...}`` of the VQModel."""
    sd = {k: _numpy(v) for k, v in state_dict.items()
          if not k.startswith(("loss.", "wav_transforms", "first_stage"))}
    enc: dict = {"conv_in": _conv(sd, "encoder.conv_in")}
    n_levels = len(ch_mult)
    for i in range(n_levels):
        for j in range(num_res_blocks):
            enc[f"down_{i}_block_{j}"] = _resblock(sd, f"encoder.down.{i}.block.{j}")
            if f"encoder.down.{i}.attn.{j}.norm.weight" in sd:
                enc[f"down_{i}_attn_{j}"] = _attnblock(sd, f"encoder.down.{i}.attn.{j}")
        if f"encoder.down.{i}.downsample.conv.weight" in sd:
            enc[f"down_{i}_downsample"] = {
                "Conv_0": _conv(sd, f"encoder.down.{i}.downsample.conv")}
    enc["mid_block_1"] = _resblock(sd, "encoder.mid.block_1")
    enc["mid_attn_1"] = _attnblock(sd, "encoder.mid.attn_1")
    enc["mid_block_2"] = _resblock(sd, "encoder.mid.block_2")
    enc["norm_out"] = _gn(sd, "encoder.norm_out")
    enc["conv_out"] = _conv(sd, "encoder.conv_out")

    dec: dict = {"conv_in": _conv(sd, "decoder.conv_in")}
    dec["mid_block_1"] = _resblock(sd, "decoder.mid.block_1")
    dec["mid_attn_1"] = _attnblock(sd, "decoder.mid.attn_1")
    dec["mid_block_2"] = _resblock(sd, "decoder.mid.block_2")
    for i in range(n_levels):
        for j in range(num_res_blocks + 1):
            dec[f"up_{i}_block_{j}"] = _resblock(sd, f"decoder.up.{i}.block.{j}")
            if f"decoder.up.{i}.attn.{j}.norm.weight" in sd:
                dec[f"up_{i}_attn_{j}"] = _attnblock(sd, f"decoder.up.{i}.attn.{j}")
        if f"decoder.up.{i}.upsample.conv.weight" in sd:
            dec[f"up_{i}_upsample"] = {"Conv_0": _conv(sd, f"decoder.up.{i}.upsample.conv")}
    dec["norm_out"] = _gn(sd, "decoder.norm_out")
    dec["conv_out"] = _conv(sd, "decoder.conv_out")
    return {"params": {
        "encoder": enc,
        "decoder": dec,
        "quantize": {"embedding": np.asarray(sd["quantize.embedding.weight"])},
        "quant_conv": _conv(sd, "quant_conv"),
        "post_quant_conv": _conv(sd, "post_quant_conv"),
    }}


def convert_torch_mingpt(state_dict: dict, prefix: str = "transformer.") -> dict:
    """A reference minGPT (``GPTFeats``) state dict, its keys under
    ``prefix`` or bare -> ``{"params": ...}`` of ``GPTFeats``."""
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): _numpy(v)
          for k, v in state_dict.items()}

    def dense(key):
        return {"kernel": _t_linear(sd[f"{key}.weight"]), "bias": sd[f"{key}.bias"]}

    def ln(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    params: dict = {
        "tok_emb": {"embedding": sd["tok_emb.weight"]},
        "pos_emb": sd["pos_emb"].reshape(sd["pos_emb"].shape[-2], -1),
        "ln_f": ln("ln_f"),
        "head": {"kernel": _t_linear(sd["head.weight"])},
    }
    for cand in ("embedder.weight", "cond_emb.weight", "feat_emb.weight"):
        if cand in sd:  # the feature embedder, Conv1d(512, n_embd, 1) -> Dense
            w = sd[cand]
            params["feat_proj"] = {"kernel": w[:, :, 0].T,
                                   "bias": sd[cand.replace("weight", "bias")]}
            break
    i = 0
    while f"blocks.{i}.ln1.weight" in sd:
        src = f"blocks.{i}"
        qkv = [_t_linear(sd[f"{src}.attn.{nm}.weight"]) for nm in ("query", "key", "value")]
        params[f"h_{i}"] = {
            "ln1": ln(f"{src}.ln1"),
            "ln2": ln(f"{src}.ln2"),
            "attn": {
                "qkv": {"kernel": np.concatenate(qkv, axis=1),
                        "bias": np.concatenate([sd[f"{src}.attn.{nm}.bias"]
                                                for nm in ("query", "key", "value")])},
                "proj": dense(f"{src}.attn.proj"),
            },
            "mlp_fc": dense(f"{src}.mlp.0"),
            "mlp_proj": dense(f"{src}.mlp.2"),
        }
        i += 1
    return {"params": params}
