"""HTSAT-tiny audio encoder (port of ``syncfusion_tpu/models/clap/htsat.py``).

The LAION-CLAP audio tower (amodel 'HTSAT-tiny'): 48 kHz audio -> 64-bin
slaney mel (n_fft 1024, hop 480, 50-14000 Hz, power -> dB) -> a 256x256
one-channel image (time in 4 quarters stacked along frequency) -> 4x4
patch embed to 96 channels -> 4 Swin stages (depths 2, 2, 6, 2; heads 4, 8,
16, 32; window 8) -> LayerNorm -> mean over tokens -> 768.

Input contract, as the reference's: 10 s at 48 kHz; shorter audio is
repeat-padded, longer truncated (``prepare_audio``).  The 1001 -> 1024
frame resampling is the same numpy bicubic matrix as the JAX package's,
not ``F.interpolate``, so the two agree by construction.  The patch embed
is an NCHW ``Conv2d``; ``convert.clap_state_dict`` transposes the Flax
kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from syncfusion_tpu_torch.models.clap.swin import LN_EPS, SwinStage
from syncfusion_tpu_torch.ops.mel import mel_filterbank
from syncfusion_tpu_torch.ops.stft import spectrogram

CLAP_SR = 48000
CLAP_SAMPLES = 10 * CLAP_SR  # 480000
N_FFT = 1024
HOP = 480
N_MELS = 64
FMIN, FMAX = 50.0, 14000.0
SPEC_SIZE = 256
FREQ_RATIO = SPEC_SIZE // N_MELS  # 4
TARGET_T = SPEC_SIZE * FREQ_RATIO  # 1024 frames
DB_FLOOR = 1e-10  # the power below which clap_mel's dB value is clamped


@functools.lru_cache(maxsize=None)
def _device_constant(name: str, device: torch.device, *args) -> torch.Tensor:
    """The f32 mel bank (``"mel_bank"``) or bicubic matrix (``"bicubic"``,
    ``args`` its lengths) on ``device``, copied there once: a copy from
    pageable host memory per call would wait for the device's queue, and
    the training feeder embeds while the step's kernels are queued."""
    if name == "mel_bank":
        a = mel_filterbank(CLAP_SR, N_FFT, N_MELS, FMIN, FMAX, scale="slaney",
                           norm="slaney")
    else:
        a = _torch_bicubic_matrix(*args)
    return torch.tensor(a, dtype=torch.float32, device=device)


def clap_mel(wav: torch.Tensor) -> torch.Tensor:
    """(B, 480000) audio -> (B, frames, 64) power-dB mel: the slaney-scale,
    slaney-normed bank (laion_clap's non-fusion path), then
    10·log10(max(x, 1e-10))."""
    spec = spectrogram(wav, n_fft=N_FFT, hop_length=HOP, power=2.0)
    mel = torch.einsum("mf,bft->bmt", _device_constant("mel_bank", spec.device), spec)
    db = 10.0 * torch.log10(torch.clamp(mel, min=DB_FLOOR))
    return db.transpose(1, 2)  # (B, T, mels)


@functools.lru_cache(maxsize=4)
def _torch_bicubic_matrix(in_len: int, out_len: int, a: float = -0.75) -> np.ndarray:
    """1-D cubic-convolution resampling matrix with torch's
    ``interpolate(mode="bicubic", align_corners=True)`` semantics (source
    positions o·(in-1)/(out-1), kernel a = -0.75, clamped borders).  The
    cached array is shared: callers copy it before writing to it."""
    W = np.zeros((out_len, in_len), np.float64)
    for o in range(out_len):
        x = o * (in_len - 1) / (out_len - 1) if out_len > 1 else 0.0
        x0 = int(np.floor(x))
        t = x - x0
        for k in range(-1, 3):
            d = abs(t - k)
            if d <= 1.0:
                w = (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0
            elif d < 2.0:
                w = a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a
            else:
                continue
            W[o, min(max(x0 + k, 0), in_len - 1)] += w
    return W


def reshape_mel_to_image(mel: torch.Tensor) -> torch.Tensor:
    """(B, T, 64) -> (B, 256, 256, 1): resample T to 1024 frames (bicubic,
    align_corners; a 10-s clip gives 1001 frames), then stack the 4 time
    quarters along frequency."""
    b, t, f = mel.shape
    if t != TARGET_T:
        W = _device_constant("bicubic", mel.device, t, TARGET_T).to(mel.dtype)
        mel = torch.einsum("ot,btf->bof", W, mel)
    x = mel.transpose(1, 2)  # (B, F, T)
    x = x.reshape(b, f, FREQ_RATIO, TARGET_T // FREQ_RATIO).transpose(1, 2)
    return x.reshape(b, FREQ_RATIO * f, TARGET_T // FREQ_RATIO)[..., None]


class HTSAT(nn.Module):
    """(B, 256, 256, 1) mel image -> (B, 8·embed_dim) latent."""

    def __init__(self, embed_dim: int = 96, depths: tuple = (2, 2, 6, 2),
                 num_heads: tuple = (4, 8, 16, 32), window_size: int = 8,
                 patch_size: int = 4):
        super().__init__()
        self.n_stages = len(depths)
        self.patch_embed = nn.Conv2d(1, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        res, dim = SPEC_SIZE // patch_size, embed_dim
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            last = i == len(depths) - 1
            self.add_module(f"layers_{i}", SwinStage(
                dim, res, depth, heads, window_size, downsample=not last))
            if not last:
                res, dim = res // 2, dim * 2
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(image.permute(0, 3, 1, 2))  # (B, C, 64, 64)
        x = self.patch_norm(x.flatten(2).transpose(1, 2))  # (B, 64·64, C)
        for i in range(self.n_stages):
            x = getattr(self, f"layers_{i}")(x)
        return self.norm(x).mean(dim=1)


def prepare_audio(wav: np.ndarray, length: int = CLAP_SAMPLES) -> np.ndarray:
    """laion_clap's 'repeatpad': tile ⌊length/t⌋ times, then zero-pad the
    rest; longer audio is truncated (the deterministic rand_trunc)."""
    t = wav.shape[-1]
    if t < length:
        wav = np.tile(wav, (1,) * (wav.ndim - 1) + (length // t,))
        wav = np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, length - wav.shape[-1])])
    return wav[..., :length]
