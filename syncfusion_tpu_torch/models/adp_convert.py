"""Reference PyTorch diffusion checkpoints -> the compat twins' parameter
tree (port of ``syncfusion_tpu/models/adp_convert.py``).

Takes in the reference's Lightning checkpoint (``torch.load(...)
["state_dict"]`` of ``main/module_diffusion.Model``, e.g. the published
``epoch=784-valid_loss=0.008.ckpt``) and returns the same Flax-named numpy
tree as the JAX converter, leaf for leaf; ``convert.to_state_dict`` then
loads it into ``SyncFusionDiffusion.from_config(..., compat=True)``
(``load_diffusion_state`` does both).

Keys are matched by name when they follow the manifests of
``models/adp_torch_recon.py``, else by registration order and shape
(upstream a-unet checkpoints name their modules ``blocks.N``); a shape
that disagrees raises at the first diverging entry.

Layouts (torch -> Flax): Linear (O, I) -> Dense kernel (I, O); Conv1d
(O, I, K) -> Conv kernel (K, I, O); ConvTranspose1d (I, O, K) -> kernel
(K, I, O); GroupNorm and LayerNorm weight -> scale; Embedding weight as
it is.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np

from syncfusion_tpu_torch.models.adp_torch_recon import (
    Encoder1dConfig,
    UNetV0Config,
    encoder_manifest,
    unet_manifest,
)

log = logging.getLogger("syncfusion_tpu_torch.adp_convert")


def _np(sd: dict) -> Dict[str, np.ndarray]:
    return {k: v if isinstance(v, np.ndarray) else np.asarray(
        v.detach().cpu().float() if hasattr(v, "detach") else v) for k, v in sd.items()}


def strip_prefix(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def align_to_manifest(sd: Dict[str, np.ndarray], manifest: List[Tuple[str, tuple]],
                      label: str) -> Dict[str, np.ndarray]:
    """``sd`` keyed by the manifest's names: by name when every manifest key
    is there, else by position and shape."""
    want = {k for k, _ in manifest}
    if want <= set(sd):
        extra = set(sd) - want
        if extra:
            raise ValueError(f"{label}: {len(extra)} unexpected keys alongside exact-name "
                             f"match, e.g. {sorted(extra)[:5]}")
        return sd
    if len(sd) != len(manifest):
        raise ValueError(f"{label}: checkpoint has {len(sd)} tensors, manifest expects "
                         f"{len(manifest)}: structural mismatch (see the decision log of "
                         "syncfusion_tpu/models/adp_torch_recon.py)")
    renamed, rebound = {}, []
    for (fk, fv), (mk, mshape) in zip(sd.items(), manifest):
        if tuple(fv.shape) != tuple(mshape):
            raise ValueError(f"{label}: shape mismatch at manifest entry '{mk}' "
                             f"{tuple(mshape)} vs checkpoint '{fk}' {tuple(fv.shape)}: "
                             "the first structural divergence")
        renamed[mk] = fv
        if fk != mk:
            rebound.append((fk, mk))
    if rebound:
        log.info("%s: positionally rebound %d/%d keys (e.g. %s -> %s)", label,
                 len(rebound), len(manifest), *rebound[0])
    return renamed


def _lin(sd, key, bias=True):
    p = {"kernel": np.transpose(sd[f"{key}.weight"], (1, 0))}
    if bias:
        p["bias"] = sd[f"{key}.bias"]
    return p


def _conv(sd, key):
    return {"kernel": np.transpose(sd[f"{key}.weight"], (2, 1, 0)),
            "bias": sd[f"{key}.bias"]}


def _norm(sd, key):
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _item_params(sd, prefix: str, kind: str) -> dict:
    if kind == "res":
        return {"gn1": _norm(sd, f"{prefix}.gn1"), "conv1": _conv(sd, f"{prefix}.conv1"),
                "gn2": _norm(sd, f"{prefix}.gn2"), "conv2": _conv(sd, f"{prefix}.conv2")}
    if kind == "mod":
        return {"to_scale_shift": _lin(sd, f"{prefix}.to_scale_shift"),
                "norm": _norm(sd, f"{prefix}.norm")}
    if kind == "inj":
        return {"conv": _conv(sd, f"{prefix}.conv")}
    return {"norm": _norm(sd, f"{prefix}.norm"),
            "norm_context": _norm(sd, f"{prefix}.norm_context"),
            "to_q": _lin(sd, f"{prefix}.to_q", bias=False),
            "to_kv": _lin(sd, f"{prefix}.to_kv", bias=False),
            "to_out": _lin(sd, f"{prefix}.to_out")}


def _block_params(sd, prefix: str, cfg: UNetV0Config, level: int) -> dict:
    p: dict = {"downsample": _conv(sd, f"{prefix}.downsample")}
    kinds = cfg.item_kinds(level)
    for j, k in enumerate(kinds):
        p[f"items_down_{j}"] = _item_params(sd, f"{prefix}.items_down.{j}", k)
    if level + 1 < len(cfg.channels):
        p["inner"] = _block_params(sd, f"{prefix}.inner", cfg, level + 1)
        for j in range(len(kinds)):
            p[f"skip_adapters_{j}"] = {"conv": _conv(sd, f"{prefix}.skip_adapters.{j}.conv")}
    for j, k in enumerate(kinds):
        p[f"items_up_{j}"] = _item_params(sd, f"{prefix}.items_up.{j}", k)
    p["upsample_kernel"] = np.transpose(sd[f"{prefix}.upsample.weight"], (2, 0, 1))
    p["upsample_bias"] = sd[f"{prefix}.upsample.bias"]
    return p


def convert_unet_state(state_dict: dict, cfg: UNetV0Config) -> dict:
    """UNetV0 state dict -> ``{"params": ...}`` of the UNetV0 twin."""
    sd = align_to_manifest(_np(state_dict), unet_manifest(cfg), "UNetV0")
    params: dict = {
        "embedder_weights": sd["embedder.weights"],
        "embedder_to_out": _lin(sd, "embedder.to_out"),
        "mlp_0": _lin(sd, "mlp.0.0"),
        "mlp_1": _lin(sd, "mlp.1.0"),
        "net": _block_params(sd, "net", cfg, 0),
    }
    if cfg.use_embedding_cfg:
        params["fixed_embedding"] = sd["fixed_embedding.weight"]
    return {"params": params}


def convert_encoder_state(state_dict: dict, cfg: Encoder1dConfig) -> dict:
    """aep Encoder1d state dict -> ``{"params": ...}`` of the encoder twin."""
    sd = align_to_manifest(_np(state_dict), encoder_manifest(cfg), "Encoder1d")
    params: dict = {"to_in_gn": _norm(sd, "to_in.groupnorm"),
                    "to_in_conv": _conv(sd, "to_in.project")}
    for i in range(len(cfg.factors)):
        params[f"ds{i}_down"] = _conv(sd, f"downsamples.{i}.downsample")
        for j in range(cfg.num_blocks[i]):
            base = f"downsamples.{i}.blocks.{j}"
            params[f"ds{i}_b{j}_gn1"] = _norm(sd, f"{base}.block1.groupnorm")
            params[f"ds{i}_b{j}_conv1"] = _conv(sd, f"{base}.block1.project")
            params[f"ds{i}_b{j}_gn2"] = _norm(sd, f"{base}.block2.groupnorm")
            params[f"ds{i}_b{j}_conv2"] = _conv(sd, f"{base}.block2.project")
    return {"params": params}


def convert_diffusion_ckpt(state_dict: dict, unet_cfg: UNetV0Config | None = None,
                           enc_cfg: Encoder1dConfig | None = None) -> dict:
    """The reference module's state dict -> ``{"unet", "encoder"}``.

    Takes ``model.net.*`` (UNetV0; ``model.diffusion.net.*`` and
    ``model.sampler.net.*`` are the same shared module and are dropped) and
    ``onsets_encoder.*``; ``embedder.*`` (the frozen CLAP) is left to the
    CLAP loader (``models/clap``)."""
    unet_cfg = unet_cfg or UNetV0Config()
    enc_cfg = enc_cfg or Encoder1dConfig()
    unet_sd = strip_prefix(state_dict, "model.net.")
    enc_sd = strip_prefix(state_dict, "onsets_encoder.")
    if not unet_sd:
        raise ValueError("no 'model.net.*' keys: not a diffusion checkpoint")
    if not enc_sd:
        raise ValueError("no 'onsets_encoder.*' keys in checkpoint")
    return {"unet": convert_unet_state(unet_sd, unet_cfg),
            "encoder": convert_encoder_state(enc_sd, enc_cfg)}


def load_diffusion_ckpt(path, unet_cfg: UNetV0Config | None = None,
                        enc_cfg: Encoder1dConfig | None = None) -> dict:
    """``torch.load`` a Lightning ``.ckpt``/``.pt``/``.pth`` on the CPU and
    convert it.  A Lightning checkpoint pickles more than tensors
    (hyper-parameters, loop state), so it loads with ``weights_only=False``:
    load only checkpoints from a trusted source."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return convert_diffusion_ckpt(sd, unet_cfg, enc_cfg)


def load_diffusion_state(model, path) -> None:
    """The checkpoint at ``path`` into ``model`` (a ``SyncFusionDiffusion``
    built with the twins, at the checkpoint's configuration), strictly."""
    from syncfusion_tpu_torch.convert import to_state_dict

    tree = load_diffusion_ckpt(path, model.unet.cfg, model.onsets_encoder.cfg)
    model.load_state_dict(to_state_dict(tree), strict=True)
