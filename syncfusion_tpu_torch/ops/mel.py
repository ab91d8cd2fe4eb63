"""Mel filterbanks, mel spectrograms, dB scaling and the SpecVQGAN
scaling chain (port of ``_hz_to_mel``, ``_mel_to_hz``, ``mel_filterbank``,
``mel_spectrogram``, ``power_to_db``, ``specvqgan_scale``,
``specvqgan_unscale`` and ``mel01_to_waveform_gl`` of
``syncfusion_tpu/ops/mel.py``).

Consumers: CLAP's HTSAT front end (48 kHz, slaney scale and norm), the
training sample logger's panels, and the CondFoleyGen baseline (22.05 kHz,
htk scale with slaney norm, 125-7600 Hz; its [0, 1] scaling chain and the
Griffin-Lim decode without a vocoder).  The filterbank is numpy (float64,
then float32), as the JAX package builds it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from syncfusion_tpu_torch.ops.stft import griffin_lim, spectrogram


def _hz_to_mel(f, scale: str):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def _mel_to_hz(m, scale: str):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=32)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, scale: str = "htk",
                   norm: str | None = None) -> np.ndarray:
    """Triangular mel filterbank ``(n_mels, n_fft//2+1)`` float32.

    ``scale``: "htk" or "slaney"; ``norm``: None or "slaney" (area norm).
    The cached array is shared: callers copy it before writing to it.
    """
    fmax = fmax if fmax is not None else sample_rate / 2
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)

    mel_pts = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, scale)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sample_rate: int = 22050, n_fft: int = 1024,
                    hop_length: int = 256, n_mels: int = 80, fmin: float = 0.0,
                    fmax: float | None = None, power: float = 1.0,
                    scale: str = "htk", norm: str | None = None) -> torch.Tensor:
    """Mel spectrogram of ``(..., T)`` -> ``(..., n_mels, frames)``."""
    spec = spectrogram(x, n_fft=n_fft, hop_length=hop_length, power=power)
    fb = torch.from_numpy(
        mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax, scale, norm).copy()
    ).to(spec.device)
    return torch.einsum("mf,...ft->...mt", fb, spec)


def power_to_db(s: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = 80.0) -> torch.Tensor:
    """librosa's dB conversion (the sample logger's panels): 10·log10 of
    ``max(amin, s)`` over ``ref``, floored ``top_db`` below the largest
    value of the whole tensor."""
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def specvqgan_scale(mel: torch.Tensor) -> torch.Tensor:
    """The CondFoleyGen [0, 1] chain: floor at 1e-5, log10, ×20, −20,
    +100, ÷100, clip to [0, 1]."""
    x = torch.log10(torch.clamp(mel, min=1e-5))
    x = (x * 20.0 - 20.0 + 100.0) / 100.0
    return torch.clamp(x, 0.0, 1.0)


def specvqgan_unscale(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`specvqgan_scale` (up to its clip)."""
    return torch.pow(10.0, (x * 100.0 + 20.0 - 100.0) / 20.0)


@functools.lru_cache(maxsize=8)
def _mel_pinv_t(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """The pseudo-inverse of the baseline's filterbank, transposed: (n_mels,
    n_fft//2+1) float32, as numpy computes it for the JAX package."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels, 125, 7600, scale="htk",
                        norm="slaney")
    return np.linalg.pinv(fb).T.copy()


def mel01_to_waveform_gl(spec01: torch.Tensor, sample_rate: int = 22050,
                         n_fft: int = 1024, hop_length: int = 256, n_iter: int = 32,
                         theta: torch.Tensor | None = None) -> torch.Tensor:
    """[0, 1]-scaled mel ``(..., n_mels, T)`` -> waveform: the inverse
    scaling chain, the filterbank's pseudo-inverse (negative bins floored at
    0), then ``n_iter`` Griffin-Lim iterations.  The initial phase is
    ``theta`` where given, else drawn from a generator seeded 0 on the
    input's device: every call without one starts from the same phase, as
    the JAX function does with its fixed key."""
    mel = specvqgan_unscale(spec01)
    pinv_t = torch.from_numpy(_mel_pinv_t(sample_rate, n_fft, mel.shape[-2])).to(mel.device)
    lin = torch.einsum("mf,...mt->...ft", pinv_t, mel).clamp_min(0.0)
    generator = None if theta is not None else torch.Generator(
        device=mel.device).manual_seed(0)
    return griffin_lim(lin, n_fft, hop_length, n_iter=n_iter, generator=generator,
                       theta=theta)
