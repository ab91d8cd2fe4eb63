"""Fréchet Audio Distance with VGGish (port of ``syncfusion_tpu/eval/fad.py``).

Mirrors the reference's evaluation (main/evaluation.py:7-28, the
``frechet_audio_distance`` package with ``model_name="vggish",
use_pca=False, use_activation=False``): embed every wav in two directories
with VGGish (128-d, final ReLU removed) and compute the Fréchet distance
between the two Gaussian fits.

Two embedding backends:
  * ``VGGishEmbedder``: the Google VGGish CNN as an ``nn.Module`` on the
    card, on the ``vggish_input`` features (16 kHz, 25 ms window / 10 ms hop
    STFT, 64 HTK mel bins 125-7500 Hz, log(mel + 0.01), 0.96 s patches,
    numpy on the host); torchvggish's state dict loads as it is, else the
    weights are seeded random (the public checkpoint is not in the
    repository).
  * ``MelStatsEmbedder``: log-mel frame statistics, no weights.  NOT the
    paper metric; a relative fidelity signal where VGGish has no weights.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import scipy.linalg
import torch
from torch import nn
import torch.nn.functional as F

from syncfusion_tpu_torch.device import default_device, exact_f32
from syncfusion_tpu_torch.models.init import flax_init
from syncfusion_tpu_torch.ops.mel import mel_filterbank
from syncfusion_tpu_torch.ops.resample import resample
from syncfusion_tpu_torch.ops.wav import read_wav

# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """FID formula: |mu1-mu2|² + Tr(S1 + S2 − 2·sqrt(S1·S2))."""
    diff = mu1 - mu2
    try:
        covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    except (ValueError, np.linalg.LinAlgError):
        covmean = None
    if covmean is None or not np.isfinite(covmean).all():
        # rank-deficient covariances (few samples): standard eps·I offset
        eps = 1e-6 * np.eye(sigma1.shape[0])
        covmean = scipy.linalg.sqrtm((sigma1 + eps) @ (sigma2 + eps))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def gaussian_stats(embeddings: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if embeddings.shape[0] == 0:
        raise ValueError("no embeddings — audio too short or directory empty")
    mu = embeddings.mean(axis=0)
    sigma = np.cov(embeddings, rowvar=False)
    return mu, np.atleast_2d(sigma)


# ---------------------------------------------------------------------------
# VGGish input features (vggish_input semantics)
# ---------------------------------------------------------------------------

VGGISH_SR = 16000
_WIN = 400       # 25 ms
_HOP = 160       # 10 ms
_N_MELS = 64
_PATCH = 96      # 0.96 s of 10 ms frames


def vggish_log_mel(y: np.ndarray, sr: int) -> np.ndarray:
    """(T,) audio → (num_patches, 96, 64) log-mel examples."""
    if sr != VGGISH_SR:
        y = resample(y, sr, VGGISH_SR)
    min_len = _WIN + (_PATCH - 1) * _HOP  # one full 0.96 s patch
    if len(y) < min_len:  # repeat-pad short clips so every file contributes
        reps = int(np.ceil(min_len / max(len(y), 1)))
        y = np.tile(y, reps)[:min_len]
    n_frames = 1 + (len(y) - _WIN) // _HOP
    idx = np.arange(n_frames)[:, None] * _HOP + np.arange(_WIN)[None, :]
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(_WIN) / _WIN)
    spec = np.abs(np.fft.rfft(y[idx] * window, n=512, axis=-1))
    fb = mel_filterbank(VGGISH_SR, 512, _N_MELS, 125.0, 7500.0, scale="htk", norm=None)
    mel = spec @ fb.T
    log_mel = np.log(mel + 0.01)
    n_patches = log_mel.shape[0] // _PATCH
    return (log_mel[: n_patches * _PATCH]
            .reshape(n_patches, _PATCH, _N_MELS)
            .astype(np.float32))


# ---------------------------------------------------------------------------
# VGGish network
# ---------------------------------------------------------------------------

# (Flax name, torchvggish name, output channels) of the convolutions, block
# by block (each block ends in a 2x2 max pool), and the Dense layers' names
_CONVS = [[("conv1_1", "features.0", 64)], [("conv2_1", "features.3", 128)],
          [("conv3_1", "features.6", 256), ("conv3_2", "features.8", 256)],
          [("conv4_1", "features.11", 512), ("conv4_2", "features.13", 512)]]
_FCS = [("fc1_1", "embeddings.0"), ("fc1_2", "embeddings.2"), ("fc2", "embeddings.4")]


class VGGish(nn.Module):
    """Google VGGish: (B, 96, 64) log-mel patches -> (B, 128) embeddings,
    without the final ReLU (``use_activation=False``).  Modules carry the
    Flax names.  The 6 x 4 x 512 map flattens in (H, W, C) order, as the
    Flax module (NHWC) and torchvggish (which transposes to NHWC before its
    ``view``) flatten it: ``fc1_1``'s columns are in that order."""

    def __init__(self):
        super().__init__()
        cin = 1
        for block in _CONVS:
            for name, _, cout in block:
                self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1))
                cin = cout
        self.fc1_1 = nn.Linear(6 * 4 * 512, 4096)
        self.fc1_2 = nn.Linear(4096, 4096)
        self.fc2 = nn.Linear(4096, 128)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None]  # (B, 1, 96, 64)
        for block in _CONVS:
            for name, _, _ in block:
                x = F.relu(getattr(self, name)(x))
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc1_1(x))
        x = F.relu(self.fc1_2(x))
        return self.fc2(x)


def torchvggish_to_state_dict(state_dict) -> dict[str, torch.Tensor]:
    """torchvggish's keys (features.{0,3,6,8,11,13} convs, embeddings.{0,2,4}
    linears; other keys, e.g. the PCA's, are dropped) -> ``VGGish``'s.  The
    layouts are the same: torch's own, and the (H, W, C) flatten."""
    out = {}
    names = [(ours, theirs) for block in _CONVS for ours, theirs, _ in block]
    for ours, theirs in names + _FCS:
        for leaf in ("weight", "bias"):
            out[f"{ours}.{leaf}"] = torch.as_tensor(state_dict[f"{theirs}.{leaf}"]).float()
    return out


class VGGishEmbedder:
    """VGGish on ``device`` (default: the card): torchvggish's state dict
    from ``checkpoint_path`` (a ``.pth`` of its keys), else ``flax_init`` at
    seed 0.
    ``embed`` returns numpy (num_patches, 128)."""

    def __init__(self, checkpoint_path: Optional[str] = None, device=None):
        self.device = default_device(device)
        with torch.device(self.device):
            net = VGGish()
        if checkpoint_path:
            from syncfusion_tpu_torch.core.checkpoint import load_torch_state_dict

            net.load_state_dict(torchvggish_to_state_dict(
                load_torch_state_dict(checkpoint_path)), strict=True)
        else:
            flax_init(net, 0)
        self.net = net.eval().requires_grad_(False)

    @torch.no_grad()
    def embed_patches(self, patches: np.ndarray) -> np.ndarray:
        """(N, 96, 64) log-mel patches -> (N, 128), f32 without TF32."""
        with exact_f32():
            x = torch.from_numpy(np.ascontiguousarray(patches)).to(self.device)
            return self.net(x).cpu().numpy()

    def embed(self, y: np.ndarray, sr: int) -> np.ndarray:
        patches = vggish_log_mel(y, sr)
        if patches.shape[0] == 0:
            return np.zeros((0, 128), np.float32)
        return self.embed_patches(patches)


class MelStatsEmbedder:
    """Per-patch [mean, std] of the VGGish log-mel features (128-d).
    Weight-free stand-in; clearly not the paper's FAD."""

    def embed(self, y: np.ndarray, sr: int) -> np.ndarray:
        patches = vggish_log_mel(y, sr)
        if patches.shape[0] == 0:
            return np.zeros((0, 2 * _N_MELS), np.float32)
        return np.concatenate(
            [patches.mean(axis=1), patches.std(axis=1)], axis=-1
        ).astype(np.float32)


# ---------------------------------------------------------------------------
# Directory-level FAD (the reference's evaluate_fad)
# ---------------------------------------------------------------------------

def _embed_dir(embedder, d: str | Path) -> np.ndarray:
    embs = []
    for p in sorted(Path(d).glob("*.wav")):
        wav, sr = read_wav(p)
        embs.append(embedder.embed(wav.mean(axis=0), sr))
    if not embs:
        raise ValueError(f"no wavs in {d}")
    return np.concatenate(embs, axis=0)


def evaluate_fad(gen_dir: str | Path, gt_dir: str | Path,
                 vggish_checkpoint: Optional[str] = None, device=None) -> dict[str, float]:
    """FAD between generated and GT wav directories
    (reference main/evaluation.py:7-28).  VGGish on ``device`` (default:
    the card) when ``vggish_checkpoint`` exists, else the weight-free
    mel-stats backend on the host."""
    if vggish_checkpoint and Path(vggish_checkpoint).exists():
        embedder = VGGishEmbedder(vggish_checkpoint, device=device)
        name = "fad_vggish"
    else:
        embedder = MelStatsEmbedder()
        name = "fad_melstats"
    mu1, s1 = gaussian_stats(_embed_dir(embedder, gen_dir))
    mu2, s2 = gaussian_stats(_embed_dir(embedder, gt_dir))
    return {name: frechet_distance(mu1, s1, mu2, s2)}
