"""Polyphase windowed-sinc resampling (port of
``syncfusion_tpu/ops/resample.py``).

torchaudio ``functional.resample`` semantics: hann-windowed sinc lowpass,
``lowpass_filter_width=6``, ``rolloff=0.99``; one FIR kernel per output
phase, applied as a strided convolution.  Two implementations share the
kernel bank:
  * ``resample``: numpy, on the host.  The data pipeline calls it for a
    shard whose sample rate differs from the training rate, evaluation for
    48 -> 22.05 kHz after generation.
  * ``resample_torch``: batched, on the tensor's device, a strided
    ``F.conv1d`` in f32 (the JAX package's ``resample_jax``, which runs
    outside Pallas).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from syncfusion_tpu_torch.device import exact_f32


@functools.lru_cache(maxsize=64)
def _kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> tuple[np.ndarray, int, int, int]:
    """The polyphase kernel bank: ``(kernels (new, K), width, orig, new)``
    with the frequencies reduced by their gcd."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = orig_freq // g, new_freq // g
    if lowpass_filter_width <= 0:
        raise ValueError("lowpass_filter_width must be positive")
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)

    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    kernels = np.sinc(t) * window * (base_freq / orig)
    return kernels.astype(np.float32), width, orig, new


def resample(
    wav: np.ndarray,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> np.ndarray:
    """Resample ``(..., T)`` float32 audio from ``orig_freq`` to ``new_freq``."""
    if orig_freq == new_freq:
        return np.asarray(wav, dtype=np.float32)
    kernels, width, orig, new = _kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    x = np.asarray(wav, dtype=np.float32)
    shape, length = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, length)
    target_len = int(math.ceil(new * length / orig))

    num_frames = length // orig + 1
    padded = np.pad(x, ((0, 0), (width, width + orig)))
    k_size = kernels.shape[1]
    # frames at stride ``orig``: (B, num_frames, K)
    frames = np.lib.stride_tricks.sliding_window_view(padded, k_size, axis=-1)[
        :, : num_frames * orig : orig, :
    ]
    # (B, num_frames, K) @ (K, new) -> (B, num_frames, new) -> interleave
    y = frames @ kernels.T
    y = y.reshape(x.shape[0], -1)[:, :target_len]
    return y.reshape(*shape, target_len)


def resample_torch(wav: torch.Tensor, orig_freq: int, new_freq: int,
                   lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample ``(..., T)`` audio on its device, in f32 (cuDNN's TF32 off,
    as ``resample_jax`` convolves at ``Precision.HIGHEST``)."""
    if orig_freq == new_freq:
        return wav
    kernels, width, orig, new = _kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    shape, length = wav.shape[:-1], wav.shape[-1]
    target_len = int(math.ceil(new * length / orig))
    x = F.pad(wav.reshape(-1, 1, length).float(), (width, width + orig))
    k = torch.from_numpy(kernels).to(x.device)[:, None, :]  # (new, 1, K)
    with exact_f32():
        y = F.conv1d(x, k, stride=orig)  # (B, new, num_frames)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)[:, :target_len]
    return y.reshape(*shape, target_len)
