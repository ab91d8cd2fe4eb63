"""Shared set-up of the port's parity tests: the tiny JAX SyncFusion of
tests/test_diffusion_stack.py and its PyTorch port with the same
parameters, carried over by ``syncfusion_tpu_torch.convert``; a webdataset
shard written by the JAX package's shard writer; a model of the tensor
cores' TF32 products, for the CPU models of the kernels' arithmetic."""

from pathlib import Path

import jax
import numpy as np
import torch

from syncfusion_tpu.data.shard_writer import write_shards
from syncfusion_tpu.ops.wav import write_wav
from syncfusion_tpu.models.encoder1d import Encoder1d
from syncfusion_tpu.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu.models.unet1d import UNet1d
from syncfusion_tpu_torch.convert import to_state_dict
from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion as TorchSyncFusion
from test_diffusion_stack import ENC, L, UNET  # noqa: F401  (re-exported)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_pair(seed: int = 0, fold_cap: int = 0, **unet_kw):
    """(JAX model, JAX params, port model on the CPU with those params);
    ``unet_kw`` (e.g. ``fused_stats=True``) goes to both UNets, ``fold_cap``
    to the JAX model and the port's UNet config."""
    jm = SyncFusionDiffusion(unet=UNet1d(**UNET, **unet_kw),
                             onsets_encoder=Encoder1d(**ENC), fold_cap=fold_cap)
    params = jm.init(jax.random.key(seed), L, batch=2)
    tm = TorchSyncFusion(UNetConfig(**UNET, **unet_kw, fold_cap=fold_cap),
                         EncoderConfig(**ENC))
    tm.load_state_dict(to_state_dict(to_numpy(params)), strict=True)
    return jm, params, tm.eval()


def t(a):
    """numpy -> torch (CPU)."""
    return torch.from_numpy(np.array(a))


def n(x):
    """torch or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_shard(root: Path, n_tracks: int = 3, seconds: float = 0.1,
               sr: int = 48000, onset_every: float = 0.004, seed: int = 0) -> str:
    """One ``.tar`` shard of ``n_tracks`` noise tracks with an onset every
    ``onset_every`` seconds (labels alternate with 'None'), written by
    ``syncfusion_tpu.data.shard_writer``; returns its path."""
    rng = np.random.default_rng(seed)
    names = [f"track{i}" for i in range(n_tracks)]
    for name in names:
        audio = root / "raw" / name / "audio"
        audio.mkdir(parents=True)
        wav = 0.3 * rng.standard_normal((1, int(seconds * sr)))
        write_wav(audio / f"{name}.resampled.wav", wav.astype(np.float32), sr)
        times = np.arange(0.001, seconds, onset_every)
        labels = ["hit" if i % 2 else "None" for i in range(len(times))]
        (root / "raw" / name / f"{name}.times.csv").write_text(
            "".join(f"{x:.6f},{lab}\n" for x, lab in zip(times, labels)))
    split = root / "split.txt"
    split.write_text("\n".join(names) + "\n")
    return write_shards(root / "raw", split, str(root / "shard_%d.tar"))[0]


# The tensor cores' tf32 products, in plain PyTorch on the CPU, as the
# kernels of csrc/tf32_mma.cuh take them (mma.sync m16n8k8): an f32 operand
# x as big = x rounded to tf32 (to nearest, ties away from zero, as
# cvt.rna.tf32.f32 rounds) and small = x - big, which the tensor cores read
# truncated to tf32; the product as small·big + big·small + big·big
# (3xTF32), in k-steps of 8 added to one f32 accumulator.
THREE_TF32 = ("small_big", "big_small", "big_big")


def tf32(x):
    """x rounded to tf32 (10 mantissa bits) as cvt.rna.tf32.f32 does it:
    add half of the dropped 13 bits' range to the int32 view and clear
    them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x):
    """x as the tensor cores read a tf32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_tf32(a, b, passes=THREE_TF32):
    """a @ b, f32, as the kernels take it: per k-step of 8, the products of
    the tf32 parts named in ``passes`` (small terms first), each added to
    one f32 accumulator."""
    a_big, b_big = tf32(a), tf32(b)
    terms = {"small_big": (tf32_read(a - a_big), b_big),
             "big_small": (a_big, tf32_read(b - b_big)),
             "big_big": (a_big, b_big)}
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                      + a.shape[-2:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        for name in passes:
            x, y = terms[name]
            acc = acc + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    return acc
