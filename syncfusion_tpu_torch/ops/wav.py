"""RIFF/WAVE reading and writing in pure numpy (a copy of
``syncfusion_tpu/ops/wav.py``, so that the port needs nothing of the JAX
package).

Reads PCM 16/24/32-bit and IEEE float32 with any channel count; arrays are
``(channels, samples)`` float32 in [-1, 1].
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path_or_bytes) -> tuple[np.ndarray, int]:
    """Return ``(waveform (C, T) float32 in [-1,1], sample_rate)``."""
    if isinstance(path_or_bytes, (str, Path)):
        data = Path(path_or_bytes).read_bytes()
    else:
        data = bytes(path_or_bytes)

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        # SubFormat GUID's first two bytes carry the real format tag.
        audio_format = _WAVE_FORMAT_PCM if bits != 32 else _WAVE_FORMAT_IEEE_FLOAT

    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif audio_format == _WAVE_FORMAT_PCM and bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == _WAVE_FORMAT_PCM and bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == _WAVE_FORMAT_PCM and bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported wav format tag={audio_format} bits={bits}")

    n = (len(x) // channels) * channels
    wav = x[:n].reshape(-1, channels).T.copy()
    return wav, sample_rate


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
