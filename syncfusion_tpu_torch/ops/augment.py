"""Augments of the port's trainers (port of ``syncfusion_tpu/ops/augment.py``).

The audio augments of the CondFoleyGen transformer's training, on the host
in numpy as the JAX module computes them: ``normalize_audio`` (scale to an
RMS of 0.1), ``pitch_shift`` (a phase-vocoder ``time_stretch`` then linear
resampling back to the length) and ``random_audio_augment`` (with
probability ``p`` both, by a uniform ±12 semitones), all from an explicit
``np.random.Generator``: the same generator gives the JAX functions' draws.

ColorJitter of frame batches on the device, the onset trainer's.
torchvision semantics, one draw per chunk: uniform brightness, contrast and
saturation factors, a uniform hue shift and a random order of the four ops,
each per sample.  ``draw_jitter`` draws them from an explicit
``torch.Generator``; ``apply_color_jitter`` applies given factors and
orders, so that a test can hold it against the JAX adjusters on the same
ones.  The JAX package draws from its own key: the same seed gives other
factors there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_LUMA = (0.299, 0.587, 0.114)


def _luma(x):
    return x @ torch.tensor(_LUMA, dtype=x.dtype, device=x.device)


def _per_sample(f, x, trailing: int):
    """A factor per sample (B,) -> broadcastable over ``trailing`` dims."""
    f = torch.as_tensor(f, dtype=x.dtype, device=x.device)
    return f.reshape(f.shape + (1,) * trailing) if f.ndim else f


def adjust_brightness(x, f):
    return (x * _per_sample(f, x, x.ndim - 1)).clamp(0.0, 1.0)


def adjust_contrast(x, f):
    """Blend with the mean luma of each frame (the last two dims before the
    channels)."""
    gray = _luma(x).mean(dim=(-2, -1), keepdim=True)[..., None]
    f = _per_sample(f, x, x.ndim - 1)
    return (f * x + (1.0 - f) * gray).clamp(0.0, 1.0)


def adjust_saturation(x, f):
    gray = _luma(x)[..., None]
    f = _per_sample(f, x, x.ndim - 1)
    return (f * x + (1.0 - f) * gray).clamp(0.0, 1.0)


def adjust_hue(x, f):
    """Hue rotation by ``f`` in [-0.5, 0.5] of the circle (RGB -> HSV ->
    rotate -> RGB)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc, minc = x.amax(-1), x.amin(-1)
    v = maxc
    deltac = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, deltac / maxc.clamp_min(1e-8), zero)
    dc = deltac.clamp_min(1e-8)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(deltac == 0, zero, h)
    h = torch.remainder(h + _per_sample(f, x, x.ndim - 2), 1.0)
    i = torch.floor(h * 6.0)
    frac = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * frac), v * (1 - s * (1 - frac))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(choices):
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    r2 = select([v, q, p, p, t, v])
    g2 = select([t, v, v, q, p, p])
    b2 = select([p, p, t, v, v, q])
    return torch.stack([r2, g2, b2], dim=-1).to(x.dtype)


def draw_jitter(n: int, generator: Optional[torch.Generator],
                brightness: float = 0.4, contrast: float = 0.2,
                saturation: float = 0.4, hue: float = 0.1,
                device=None) -> tuple:
    """Per-sample factors ``(fb, fc, fs, fh)``, each (n,), and op orders
    (n, 4) (a permutation of 0-3: brightness, contrast, saturation, hue).
    A strength of 0 gives the identity factor."""
    def uniform(lo, hi):
        u = torch.rand((n,), generator=generator, device=device)
        return lo + (hi - lo) * u

    ones = torch.ones((n,), device=device)
    fb = uniform(max(0.0, 1 - brightness), 1 + brightness) if brightness > 0 else ones
    fc = uniform(max(0.0, 1 - contrast), 1 + contrast) if contrast > 0 else ones
    fs = uniform(max(0.0, 1 - saturation), 1 + saturation) if saturation > 0 else ones
    fh = uniform(-hue, hue) if hue > 0 else torch.zeros((n,), device=device)
    perms = torch.argsort(torch.rand((n, 4), generator=generator, device=device), dim=1)
    return fb, fc, fs, fh, perms


def apply_color_jitter(frames, fb, fc, fs, fh, perms):
    """``frames`` (B, ..., H, W, 3) float in [0, 1]; each sample gets its
    factors in its order.  Each of the four steps computes all four ops and
    selects per sample: 16 elementwise passes over the batch, no host
    sync."""
    ops = (lambda x: adjust_brightness(x, fb), lambda x: adjust_contrast(x, fc),
           lambda x: adjust_saturation(x, fs), lambda x: adjust_hue(x, fh))
    trailing = (1,) * (frames.ndim - 1)
    x = frames
    for step in range(4):
        which = perms[:, step].reshape(perms.shape[:1] + trailing)
        outs = [op(x) for op in ops]
        x = torch.where(which == 0, outs[0],
                        torch.where(which == 1, outs[1],
                                    torch.where(which == 2, outs[2], outs[3])))
    return x


def color_jitter_device(frames, generator: Optional[torch.Generator],
                        brightness: float = 0.4, contrast: float = 0.2,
                        saturation: float = 0.4, hue: float = 0.1):
    """Batched ColorJitter on ``frames``' device: ``draw_jitter`` then
    ``apply_color_jitter``."""
    drawn = draw_jitter(frames.shape[0], generator, brightness, contrast,
                        saturation, hue, device=frames.device)
    return apply_color_jitter(frames, *drawn)


# --------------------------------------------------------------------------
# Audio augments (host, numpy)
# --------------------------------------------------------------------------

def normalize_audio(y: np.ndarray, desired_rms: float = 0.1,
                    eps: float = 1e-4) -> np.ndarray:
    rms = max(float(np.sqrt(np.mean(np.square(y)))), eps)
    return (y * (desired_rms / rms)).astype(np.float32)


def _hann(n_fft: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)


def _stft_np(y, n_fft=1024, hop=256):
    """Centred (reflect-padded) periodic-Hann STFT -> (freq, frames)."""
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(y[idx] * _hann(n_fft), axis=-1).T


def _istft_np(spec, hop=256, length=None):
    """Windowed overlap-add inverse of ``_stft_np``, cut or padded to
    ``length``."""
    n_fft = 2 * (spec.shape[0] - 1)
    window = _hann(n_fft)
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1) * window
    total = n_fft + hop * (frames.shape[0] - 1)
    y = np.zeros(total)
    wsum = np.zeros(total)
    for i, fr in enumerate(frames):
        y[i * hop:i * hop + n_fft] += fr
        wsum[i * hop:i * hop + n_fft] += window ** 2
    y = (y / np.maximum(wsum, 1e-10))[n_fft // 2:]
    if length is not None:
        y = y[:length] if len(y) >= length else np.pad(y, (0, length - len(y)))
    return y.astype(np.float32)


def time_stretch(y: np.ndarray, rate: float, n_fft: int = 1024,
                 hop: int = 256) -> np.ndarray:
    """Phase-vocoder time stretch by ``rate`` (> 1: faster, shorter)."""
    spec = _stft_np(y, n_fft, hop)
    n_freq, n_frames = spec.shape
    steps = np.arange(0, n_frames, rate)
    phi_advance = np.linspace(0, np.pi * hop, n_freq)
    out = np.zeros((n_freq, len(steps)), complex)
    phase_acc = np.angle(spec[:, 0])
    for t, step in enumerate(steps):
        i = int(step)
        frac = step - i
        cols = spec[:, i:i + 2]
        if cols.shape[1] < 2:
            cols = np.pad(cols, ((0, 0), (0, 2 - cols.shape[1])))
        mag = (1 - frac) * np.abs(cols[:, 0]) + frac * np.abs(cols[:, 1])
        out[:, t] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(cols[:, 1]) - np.angle(cols[:, 0]) - phi_advance
        dphase = dphase - 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc = phase_acc + phi_advance + dphase
    return _istft_np(out, hop, length=int(round(len(y) / rate)))


def pitch_shift(y: np.ndarray, sr: int, n_steps: float) -> np.ndarray:
    """Shift the pitch by ``n_steps`` semitones, keeping the length: time
    stretch by 2^(−n/12), then linear interpolation back to ``len(y)``."""
    if n_steps == 0:
        return np.asarray(y, np.float32)
    rate = 2.0 ** (-n_steps / 12.0)
    stretched = time_stretch(y, rate)
    src = np.arange(len(stretched)) * rate
    tgt = np.arange(len(y), dtype=np.float64)
    return np.interp(tgt, src, stretched).astype(np.float32)


def random_audio_augment(y: np.ndarray, sr: int, rng: np.random.Generator,
                         p: float = 0.5, max_semitones: float = 12.0) -> np.ndarray:
    """The transformer's train-time augment: with probability ``p``, RMS
    normalisation and a uniform ±``max_semitones`` pitch shift."""
    if rng.random() >= p:
        return y
    y = normalize_audio(y)
    return pitch_shift(y, sr, float(rng.uniform(-max_semitones, max_semitones)))
