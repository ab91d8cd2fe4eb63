"""Shared set-up of the port's parity tests: the tiny JAX SyncFusion of
tests/test_diffusion_stack.py and its PyTorch port with the same
parameters, carried over by ``syncfusion_tpu_torch.convert``; a webdataset
shard written by the JAX package's shard writer."""

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


def tiny_pair(seed: int = 0, fold_cap: int = 0):
    """(JAX model, JAX params, port model on the CPU with those params)."""
    jm = SyncFusionDiffusion(unet=UNet1d(**UNET), onsets_encoder=Encoder1d(**ENC),
                             fold_cap=fold_cap)
    params = jm.init(jax.random.key(seed), L, batch=2)
    tm = TorchSyncFusion(UNetConfig(**UNET), EncoderConfig(**ENC))
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
