"""STFT, spectrogram, inverse STFT and Griffin-Lim (port of ``stft``,
``spectrogram``, ``hann_window``, ``istft`` and ``griffin_lim`` of
``syncfusion_tpu/ops/stft.py``).

torch.stft's conventions, which the reference's audio features rely on: the
signal centred by reflect padding of ``n_fft // 2`` on each side, a periodic
Hann window of ``n_fft``, a one-sided FFT, no normalisation.  Framing is the
JAX package's gather (frame ``i`` starts at sample ``i·hop``), here
``Tensor.unfold``, then ``torch.fft.rfft`` over each frame.  The JAX
functions' other settings (a shorter window, no centring, other padding)
have no caller and are not ported.

The JAX package's Griffin-Lim runs on real (re, im) pairs with Fourier-basis
matmuls (``stft_real``, ``istft_real``) because its TPU lacked complex
support; that is layout, not function, and here it runs on ``torch.fft``.
The overlap-add is ``F.fold``, which sums each output sample's frames in a
fixed order (a scatter-add on the card would add them in any order).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, n_frames, n_fft) -> (B, n_fft + hop·(n_frames - 1)): frame ``i``
    added at sample ``i·hop``."""
    b, n_frames, n_fft = frames.shape
    total = n_fft + hop_length * (n_frames - 1)
    return F.fold(frames.transpose(1, 2), (1, total), (1, n_fft),
                  stride=(1, hop_length)).reshape(b, total)


def istft(spec: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT of ``(..., n_fft//2+1, frames)`` complex -> ``(...,
    samples)``: each frame's inverse rFFT times the Hann window,
    overlap-added, divided by the overlap-added squared window (floored at
    1e-11), the centring pad cut off, then cut to ``length``."""
    shape = spec.shape[:-2]
    spec = spec.reshape(-1, spec.shape[-2], spec.shape[-1])
    window = hann_window(n_fft, spec.real.dtype, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    y = _overlap_add(frames, hop_length)
    win_sq = _overlap_add((window * window).expand(1, frames.shape[1], n_fft),
                          hop_length)
    y = (y / win_sq.clamp_min(1e-11))[:, n_fft // 2:]
    if length is not None:
        y = y[:, :length]
    return y.reshape(*shape, y.shape[-1])


def griffin_lim(magnitude: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                n_iter: int = 32, length: int | None = None, momentum: float = 0.99,
                generator: torch.Generator | None = None,
                theta: torch.Tensor | None = None) -> torch.Tensor:
    """Fast Griffin-Lim (momentum ``momentum``) from a magnitude
    ``(..., n_fft//2+1, frames)`` -> ``(..., samples)``.

    The initial phase is ``theta`` (radians, the magnitude's shape) where
    given, else 2π·U[0, 1) drawn from ``generator``.  Each iteration
    rebuilds the spectrum of the current signal and steps the phase to
    that of ``rebuilt - momentum/(1 + momentum) · previous rebuilt``."""
    if theta is None:
        theta = 2.0 * math.pi * torch.rand(magnitude.shape, generator=generator,
                                           device=magnitude.device,
                                           dtype=magnitude.dtype)
    angles = torch.polar(torch.ones_like(theta), theta)
    c = momentum / (1.0 + momentum)
    n_frames = magnitude.shape[-1]
    prev = torch.zeros_like(angles)
    for _ in range(n_iter):
        rebuilt = stft(istft(magnitude * angles, n_fft, hop_length), n_fft,
                       hop_length)[..., :n_frames]
        acc = rebuilt - c * prev
        angles = acc / acc.abs().clamp_min(1e-16)
        prev = rebuilt
    return istft(magnitude * angles, n_fft, hop_length, length=length)
