"""Stationary spectral-gate denoiser (port of ``syncfusion_tpu/ops/denoise.py``).

The repository's replacement for the reference's ``noisereduce.reduce_noise(x,
sr, n_fft=1024, hop_length=256)`` in video preprocessing
(``gh_preprocess_videos``, which writes ``.resampled_denoised.wav``):

1. STFT the signal (the 1024/256 Hann framing of ``ops/stft.py``).
2. A per-frequency noise floor from the signal's own statistics:
   ``thresh_dB[f] = mean_dB[f] + n_std_thresh · std_dB[f]`` over time.
3. A binary mask of the cells whose magnitude exceeds it.
4. The mask smoothed by a separable linear-taper kernel over (frequency,
   time), a ``conv2d`` with "same" padding, so the gate opens and closes
   gradually.
5. Masked-out cells attenuated by ``prop_decrease``, then the inverse STFT.

It runs on the device of its input (cuFFT and cuDNN on the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from syncfusion_tpu_torch.device import exact_f32
from syncfusion_tpu_torch.ops.stft import istft, stft


def _taper_kernel(n_grad_freq: int, n_grad_time: int) -> np.ndarray:
    """Separable linear-taper smoothing kernel, normalized to sum 1
    (the smoothing filter noisereduce builds from outer(linspace ramps))."""
    ramp_f = np.concatenate([
        np.linspace(0.0, 1.0, n_grad_freq + 1, endpoint=False)[1:],
        np.linspace(1.0, 0.0, n_grad_freq + 2)[:-1],
    ])
    ramp_t = np.concatenate([
        np.linspace(0.0, 1.0, n_grad_time + 1, endpoint=False)[1:],
        np.linspace(1.0, 0.0, n_grad_time + 2)[:-1],
    ])
    k = np.outer(ramp_f, ramp_t)
    return (k / k.sum()).astype(np.float32)


def _db(spec: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(spec.abs().clamp_min(1e-12))


def gate_mask(wav: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
              n_std_thresh: float = 1.5,
              noise_clip: Optional[torch.Tensor] = None) -> tuple:
    """``(spec, mask)``: the STFT of ``wav`` (C, T) and the binary gate
    (C, F, frames) f32, 1 where a cell is kept (``sig_dB > thresh_dB``)."""
    spec = stft(wav, n_fft, hop_length)
    sig_db = _db(spec)
    ref = sig_db if noise_clip is None else _db(stft(noise_clip, n_fft, hop_length))
    thresh_db = (ref.mean(-1, keepdim=True)
                 + n_std_thresh * ref.std(-1, correction=0, keepdim=True))
    return spec, (sig_db > thresh_db).to(torch.float32)


def apply_gate(spec: torch.Tensor, mask: torch.Tensor, length: int,
               n_fft: int = 1024, hop_length: int = 256, prop_decrease: float = 1.0,
               n_grad_freq: int = 4, n_grad_time: int = 4) -> torch.Tensor:
    """Steps 4-5: smooth the binary ``mask`` (C, F, frames), attenuate the
    masked-out cells of ``spec`` by ``prop_decrease`` and invert to (C,
    ``length``)."""
    kernel = torch.from_numpy(_taper_kernel(n_grad_freq, n_grad_time)).to(mask.device)
    with exact_f32():  # cuDNN's TF32 would round the taper's weights
        mask = F.conv2d(mask[:, None], kernel[None, None],
                        padding=(n_grad_freq, n_grad_time))[:, 0].clamp(0.0, 1.0)
    gain = mask + (1.0 - mask) * (1.0 - prop_decrease)
    return istft(spec * gain.to(spec.dtype), n_fft, hop_length, length=length)


def spectral_gate(wav: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                  n_std_thresh: float = 1.5, prop_decrease: float = 1.0,
                  n_grad_freq: int = 4, n_grad_time: int = 4,
                  noise_clip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Denoise a ``(C, T)`` float waveform; returns the same shape and
    length.  ``noise_clip`` (C, T'), when given, supplies the floor's
    statistics in place of the signal's own (the reference call passes
    none)."""
    spec, mask = gate_mask(wav, n_fft, hop_length, n_std_thresh, noise_clip)
    return apply_gate(spec, mask, wav.shape[-1], n_fft, hop_length, prop_decrease,
                      n_grad_freq, n_grad_time)
