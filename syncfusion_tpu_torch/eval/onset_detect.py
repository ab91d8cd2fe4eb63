"""Audio onset detection (librosa ``onset_detect`` equivalent, numpy; a
copy of ``syncfusion_tpu/eval/onset_detect.py``).

The reference scores generated audio with librosa's default onset pipeline
at 22.05 kHz with ``delta=0.3`` (script/evaluate_onset.py:30).  That
pipeline is: mel-power spectrogram (n_fft 2048, hop 512, 128 mels) → dB →
positive first-order spectral flux averaged over mel bins → [0,1]
normalization → local-max/mean peak picking.  This module implements the
same algorithm on the port's mel filterbank, so evaluation needs no
librosa.
"""

from __future__ import annotations

import numpy as np

from syncfusion_tpu_torch.ops.mel import mel_filterbank

SR = 22050
N_FFT = 2048
HOP = 512
N_MELS = 128


def _stft_mag(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Centered magnitude STFT (numpy, reflect padding)."""
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    frames = y[idx] * window
    return np.abs(np.fft.rfft(frames, axis=-1)).T  # (freq, frames)


def onset_strength(y: np.ndarray, sr: int = SR) -> np.ndarray:
    """Positive spectral-flux novelty curve (librosa onset_strength
    semantics: power mel → dB → lag-1 diff → clamp → mean over mels →
    left-pad by 1 + n_fft//(2·hop) frames for centering)."""
    S = _stft_mag(y, N_FFT, HOP) ** 2
    fb = mel_filterbank(sr, N_FFT, N_MELS, 0.0, sr / 2, scale="slaney", norm="slaney")
    mel = fb @ S
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db, db.max() - 80.0)
    flux = np.maximum(0.0, db[:, 1:] - db[:, :-1])
    env = flux.mean(axis=0)
    pad = 1 + N_FFT // (2 * HOP)
    return np.pad(env, (pad, 0))


def peak_pick(
    env: np.ndarray,
    pre_max: int,
    post_max: int,
    pre_avg: int,
    post_avg: int,
    delta: float,
    wait: int,
) -> np.ndarray:
    """librosa.util.peak_pick semantics."""
    peaks = []
    last = -1 - wait
    n = len(env)
    for i in range(n):
        lo_m, hi_m = max(0, i - pre_max), min(n, i + post_max + 1)
        if env[i] < env[lo_m:hi_m].max():
            continue
        lo_a, hi_a = max(0, i - pre_avg), min(n, i + post_avg + 1)
        if env[i] < env[lo_a:hi_a].mean() + delta:
            continue
        if i - last <= wait:
            continue
        peaks.append(i)
        last = i
    return np.asarray(peaks, int)


def onset_detect(
    y: np.ndarray,
    sr: int = SR,
    delta: float = 0.3,
    units: str = "samples",
) -> np.ndarray:
    """Detected onset positions (librosa defaults: pre/post windows derived
    from sr/hop, normalize=True)."""
    env = onset_strength(y, sr)
    rng = env.max() - env.min()
    if rng > 0:
        env = (env - env.min()) / rng
    peaks = peak_pick(
        env,
        pre_max=int(0.03 * sr // HOP),
        post_max=int(0.0 * sr // HOP) + 1,
        pre_avg=int(0.10 * sr // HOP),
        post_avg=int(0.10 * sr // HOP) + 1,
        delta=delta,
        wait=int(0.03 * sr // HOP),
    )
    if units == "frames":
        return peaks
    # Centered-STFT frame indices can map one frame past the signal end
    # (frame ceil(len/HOP) · HOP ≥ len).  The matching protocol indexes the
    # wav directly at onset positions (evaluate_onset.py:69,76 in the
    # reference does the same), so clamp into the signal.
    return np.minimum(peaks * HOP, max(len(y) - 1, 0))
