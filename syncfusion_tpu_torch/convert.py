"""Flax parameter tree -> the port's ``state_dict``.

The JAX package's ``SyncFusionDiffusion.init`` returns ``{"unet": {"params":
...}, "encoder": {"params": ...}}``.  The port's modules carry the Flax
names, so each leaf's key is its Flax path joined with dots; what changes
is the leaf's layout:

  * ``Dense`` kernel (in, out) -> ``Linear`` weight (out, in);
  * ``DenseGeneral`` kernel (in, *out) (qkv: (C, 3, H, D)) -> (prod(out), in),
    its bias (*out) -> (prod(out),);
  * ``Conv`` kernel (k, in, out) -> (out, in, k), a 2-D one (kh, kw, in,
    out) -> (out, in, kh, kw) and a 3-D one (kt, kh, kw, in, out) -> (out,
    in, kt, kh, kw);
  * ``ConvTranspose`` kernel (k, in, out) -> (in, out, k) flipped along k:
    Flax does not flip the kernel (``transpose_kernel=False``), torch's
    transposed convolution does;
  * ``GroupNorm``, ``BatchNorm`` and ``LayerNorm`` scale -> weight;
    BatchNorm's ``batch_stats`` mean and var -> the buffers running_mean and
    running_var (``onset_state_dict``);
  * ``Embed`` embedding -> ``nn.Embedding`` weight (``clap_state_dict``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_DENSE_GENERAL = {"qkv", "q", "k", "v"}
_TOPS = (("unet", "unet"), ("encoder", "onsets_encoder"))


def flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """``{"unet/params/down_0/Conv_0/kernel": array, ...}`` (an ``.npz``'s
    contents) -> the nested tree."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(val)
    return tree


def convert_leaf(path: tuple, a: np.ndarray) -> tuple[str, np.ndarray]:
    """One Flax leaf -> (state_dict key below its top module, array)."""
    *mods, name = path
    parent = mods[-1] if mods else ""
    if name == "kernel":
        name = "weight"
        if parent.startswith("ConvTranspose"):
            a = a[::-1].transpose(1, 2, 0)
        elif parent in _DENSE_GENERAL:
            a = a.reshape(a.shape[0], -1).T
        elif a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 5:
            a = a.transpose(4, 3, 0, 1, 2)
        else:
            a = a.T
    elif name == "bias" and parent in _DENSE_GENERAL:
        a = a.reshape(-1)
    elif name in ("scale", "embedding"):
        name = "weight"
    return ".".join([*mods, name]), np.array(a, dtype=np.float32, order="C")


def to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``{"unet", "encoder"}`` tree (numpy or JAX arrays) -> a
    ``state_dict`` for ``SyncFusionDiffusion.load_state_dict(strict=True)``."""
    sd = {}
    for top, prefix in _TOPS:
        tree = params[top]
        tree = tree.get("params", tree)
        for path, leaf in flatten(tree).items():
            key, a = convert_leaf(path, leaf)
            sd[f"{prefix}.{key}"] = torch.from_numpy(a)
    return sd


_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def onset_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX onset net's ``{"params", "batch_stats"}`` tree (numpy or JAX
    arrays) -> a ``state_dict`` for ``VideoOnsetNet.load_state_dict(
    strict=True)``."""
    sd = {}
    for path, leaf in flatten(variables["params"]).items():
        key, a = convert_leaf(path, leaf)
        sd[key] = torch.from_numpy(a)
    for path, leaf in flatten(variables.get("batch_stats", {})).items():
        *mods, name = path
        sd[".".join([*mods, _BN_STATS[name]])] = torch.from_numpy(
            np.array(leaf, dtype=np.float32, order="C"))
    return sd


def clap_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ClapModel``'s ``{"params"}`` tree (numpy or JAX arrays) ->
    a ``state_dict`` for the port's ``ClapModel.load_state_dict(strict=True)``;
    the mel BatchNorm's ``mel_bn_*`` parameters become its buffers as they
    are."""
    sd = {}
    for path, leaf in flatten(variables.get("params", variables)).items():
        key, a = convert_leaf(path, leaf)
        sd[key] = torch.from_numpy(a)
    return sd


def vggish_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``VGGish``'s ``{"params"}`` tree (numpy or JAX arrays;
    ``syncfusion_tpu/eval/fad.py``, the inverse of its
    ``convert_torchvggish``) -> a ``state_dict`` for the port's
    ``eval.fad.VGGish.load_state_dict(strict=True)``.  ``fc1_1`` keeps its
    rows' order: both flatten the 6 x 4 x 512 map as (H, W, C)."""
    return clap_state_dict(variables)
