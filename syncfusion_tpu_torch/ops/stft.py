"""STFT and spectrogram (port of ``stft``, ``spectrogram`` and
``hann_window`` of ``syncfusion_tpu/ops/stft.py``).

torch.stft's conventions, which the reference's audio features rely on: the
signal centred by reflect padding of ``n_fft // 2`` on each side, a periodic
Hann window of ``n_fft``, a one-sided FFT, no normalisation.  Framing is the
JAX package's gather (frame ``i`` starts at sample ``i·hop``), here
``Tensor.unfold``, then ``torch.fft.rfft`` over each frame.  The JAX
functions' other settings (a shorter window, no centring, other padding)
have no caller and are not ported.
"""

from __future__ import annotations

import math

import torch


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann (``torch.hann_window``'s default), as the JAX package
    computes it: 0.5 - 0.5·cos(2πn / N)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of a length-``n`` signal padded by ``pad`` on both sides in
    numpy's 'reflect' mode, which, unlike ``F.pad``, takes pads longer than
    the signal (reflecting again at each end), as ``jnp.pad`` does."""
    period = max(2 * (n - 1), 1)
    idx = torch.arange(-pad, n + pad, device=device).remainder(period)
    return torch.where(idx >= n, period - idx, idx)


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256) -> torch.Tensor:
    """Complex STFT of ``(..., T)`` -> ``(..., n_fft//2+1, frames)``."""
    shape = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    x = x[:, _reflect_index(x.shape[-1], n_fft // 2, x.device)]
    frames = x.unfold(-1, n_fft, hop_length) * hann_window(n_fft, x.dtype, x.device)
    spec = torch.fft.rfft(frames, dim=-1).transpose(-1, -2)
    return spec.reshape(*shape, n_fft // 2 + 1, frames.shape[1])


def spectrogram(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                power: float = 1.0) -> torch.Tensor:
    """Magnitude (``power=1``) or power (``power=2``) spectrogram: |STFT|
    raised to ``power``."""
    s = stft(x, n_fft, hop_length).abs()
    if power != 1.0:
        s = s ** power
    return s
