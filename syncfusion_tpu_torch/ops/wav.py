"""RIFF/WAVE writing in pure numpy (a copy of ``syncfusion_tpu/ops/wav.py``'s
writer, so that the port needs nothing of the JAX package)."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003


def write_wav(path, wav: np.ndarray, sample_rate: int, fmt: str = "f32") -> None:
    """Write ``(C, T)`` or ``(T,)`` float array as float32 or PCM16 wav."""
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim == 1:
        wav = wav[None, :]
    channels, _ = wav.shape
    interleaved = wav.T.reshape(-1)

    if fmt == "f32":
        body = interleaved.astype("<f4").tobytes()
        audio_format, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    elif fmt == "pcm16":
        clipped = np.clip(interleaved, -1.0, 1.0 - 1.0 / 32768.0)
        body = (clipped * 32768.0).astype("<i2").tobytes()
        audio_format, bits = _WAVE_FORMAT_PCM, 16
    else:
        raise ValueError(f"unknown fmt {fmt!r}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, audio_format, channels, sample_rate, byte_rate, block_align, bits
    )
    header += b"data" + struct.pack("<I", len(body))
    Path(path).write_bytes(header + body)
