"""Native ISO-BMFF (QuickTime/MP4) muxer + audio demuxer (a copy of
``syncfusion_tpu/eval/mp4.py``).

The reference writes its baseline artifacts as ``.mp4`` videos via moviepy
and scores them by re-extracting the audio track
(CondFoleyGen/audio_generation_utils.py:61-92,
script/evaluate_onset_baseline.py:17-27).  ffmpeg and moviepy are not
promised, so the artifact protocol gets a native container implementation
instead of an env-gate:

* :func:`write_mp4` — muxes the processed layout's per-video JPEG frames
  (stored byte-for-byte as Motion-JPEG samples: zero transcode) plus a mono
  PCM track into one QuickTime-compatible file.  Readable by ffmpeg/ffprobe,
  QuickTime, VLC and moviepy (all speak 'jpeg' video + 'sowt' audio in BMFF).
* :func:`read_mp4_audio` — walks the box tree, finds the sound track and
  decodes its PCM samples; the eval protocol therefore round-trips through a
  real container exactly like the reference, with no external binaries.

Box layout written: ftyp ('qt  '), mdat (video samples then audio samples),
moov { mvhd, trak(video){tkhd mdia{mdhd hdlr minf{vmhd dinf stbl}}},
trak(audio){...smhd...} } — offsets are absolute, mdat precedes moov so
sample offsets don't depend on moov's size.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full(fourcc: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return _box(fourcc, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from a JPEG's SOF marker."""
    assert data[:2] == b"\xff\xd8", "not a JPEG"
    i = 2
    while i < len(data) - 9:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xC0, 0xC1, 0xC2, 0xC3):  # SOF0-3
            h, w = struct.unpack(">HH", data[i + 5 : i + 9])
            return w, h
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        (seglen,) = struct.unpack(">H", data[i + 2 : i + 4])
        i += 2 + seglen
    raise ValueError("no SOF marker found")


def _stbl(entry: bytes, stts: Sequence[tuple[int, int]], n_samples: int,
          sample_sizes, chunk_offset: int, samples_per_chunk: int) -> bytes:
    stsd = _full(b"stsd", struct.pack(">I", 1) + entry)
    stts_b = _full(b"stts", struct.pack(">I", len(stts)) +
                   b"".join(struct.pack(">II", c, d) for c, d in stts))
    stsc = _full(b"stsc", struct.pack(">IIII", 1, 1, samples_per_chunk, 1))
    if isinstance(sample_sizes, int):  # constant size
        stsz = _full(b"stsz", struct.pack(">II", sample_sizes, n_samples))
    else:
        stsz = _full(b"stsz", struct.pack(">II", 0, n_samples) +
                     struct.pack(f">{n_samples}I", *sample_sizes))
    stco = _full(b"stco", struct.pack(">II", 1, chunk_offset))
    return _box(b"stbl", stsd + stts_b + stsc + stsz + stco)


def _trak(track_id: int, duration_mv: int, timescale: int, duration_md: int,
          handler: bytes, handler_name: bytes, mhd: bytes, stbl: bytes,
          width: int = 0, height: int = 0, volume: int = 0) -> bytes:
    tkhd = _full(b"tkhd", struct.pack(
        ">III4xI8xhhh2x", 0, 0, track_id, duration_mv, 0, 0, volume
    ) + _MATRIX + struct.pack(">II", width << 16, height << 16), flags=3)
    mdhd = _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, duration_md,
                                      0x55C4, 0))
    hdlr = _full(b"hdlr", struct.pack(">4s4s12x", b"\0\0\0\0", handler) +
                 handler_name + b"\0")
    dinf = _box(b"dinf", _full(b"dref", struct.pack(">I", 1) +
                               _full(b"url ", b"", flags=1)))
    minf = _box(b"minf", mhd + dinf + stbl)
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    return _box(b"trak", tkhd + mdia)


def write_mp4(dest: str | Path, jpeg_frames: Iterable[bytes], fps: float,
              audio: np.ndarray, sample_rate: int) -> Path:
    """Mux JPEG frame bytes (stored as-is) + mono float32 audio into ``dest``."""
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    frames = list(jpeg_frames)
    assert frames, "need at least one frame"
    w, h = jpeg_size(frames[0])
    pcm = (np.clip(np.asarray(audio, np.float32), -1.0, 1.0 - 1 / 32768.0)
           * 32768.0).astype("<i2").tobytes()
    n_audio = len(pcm) // 2

    ftyp = _box(b"ftyp", b"qt  " + struct.pack(">I", 0x200) + b"qt  ")
    video_bytes = b"".join(frames)
    mdat = _box(b"mdat", video_bytes + pcm)
    video_off = len(ftyp) + 8
    audio_off = video_off + len(video_bytes)

    vts = int(round(fps * 1000))  # video timescale; 1000 ticks per frame
    dur_md_v = len(frames) * 1000
    dur_mv = int(round(len(frames) / fps * 1000))  # movie timescale 1000

    # 'jpeg' VideoSampleEntry (86 bytes)
    ventry = _box(b"jpeg", struct.pack(
        ">6xH16xHHIIIH32pHh",
        1, w, h, 0x480000, 0x480000, 0, 1, b"Motion-JPEG", 24, -1))
    vstbl = _stbl(ventry, [(len(frames), 1000)], len(frames),
                  [len(f) for f in frames], video_off, len(frames))
    vtrak = _trak(1, dur_mv, vts, dur_md_v, b"vide", b"VideoHandler",
                  _full(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1),
                  vstbl, width=w, height=h)

    # 'sowt' (little-endian PCM) AudioSampleEntry, version 0
    aentry = _box(b"sowt", struct.pack(
        ">6xHHHIHHHHI", 1, 0, 0, 0, 1, 16, 0, 0, sample_rate << 16))
    astbl = _stbl(aentry, [(n_audio, 1)], n_audio, 2, audio_off, n_audio)
    atrak = _trak(2, int(round(n_audio / sample_rate * 1000)), sample_rate,
                  n_audio, b"soun", b"SoundHandler",
                  _full(b"smhd", struct.pack(">Hxx", 0)), astbl,
                  volume=0x0100)

    mvhd = _full(b"mvhd", struct.pack(
        ">IIIII2s2x8x", 0, 0, 1000, dur_mv, 0x10000, b"\x01\x00"
    ) + _MATRIX + b"\0" * 24 + struct.pack(">I", 3))
    moov = _box(b"moov", mvhd + vtrak + atrak)
    dest.write_bytes(ftyp + mdat + moov)
    return dest


# ----------------------------------------------------------------- demuxer
def _children(data: bytes, start: int, end: int):
    """Yield (fourcc, body_start, body_end) for boxes in data[start:end]."""
    i = start
    while i + 8 <= end:
        size, fourcc = struct.unpack(">I4s", data[i : i + 8])
        body = i + 8
        if size == 1:  # 64-bit size
            (size,) = struct.unpack(">Q", data[i + 8 : i + 16])
            body = i + 16
        elif size == 0:
            size = end - i
        yield fourcc, body, i + size
        i += max(size, 8)


def _find(data: bytes, start: int, end: int, path: Sequence[bytes]):
    """All (body_start, body_end) of boxes at the given path."""
    spans = [(start, end)]
    for name in path:
        nxt = []
        for s, e in spans:
            for fourcc, bs, be in _children(data, s, e):
                if fourcc == name:
                    nxt.append((bs, be))
        spans = nxt
    return spans


def read_mp4_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode the sound track of a BMFF file written by :func:`write_mp4`
    (or any mov/mp4 with uncompressed 'sowt'/'twos'/'lpcm' audio).

    Returns (mono float32 waveform, sample_rate).  Raises ``ValueError`` for
    compressed audio codecs — callers fall back to ffmpeg for those.
    """
    data = Path(path).read_bytes()
    for trak_s, trak_e in _find(data, 0, len(data), [b"moov", b"trak"]):
        hdlrs = _find(data, trak_s, trak_e, [b"mdia", b"hdlr"])
        if not hdlrs or data[hdlrs[0][0] + 8 : hdlrs[0][0] + 12] != b"soun":
            continue
        stbl_s, stbl_e = _find(data, trak_s, trak_e,
                               [b"mdia", b"minf", b"stbl"])[0]
        boxes = {f: (s, e) for f, s, e in _children(data, stbl_s, stbl_e)}

        s, e = boxes[b"stsd"]
        fourcc, es, ee = next(_children(data, s + 8, e))
        if fourcc not in (b"sowt", b"twos", b"lpcm", b"in16"):
            raise ValueError(f"unsupported audio codec {fourcc!r}")
        channels, bits = struct.unpack(">HH", data[es + 16 : es + 20])
        (sr_fixed,) = struct.unpack(">I", data[es + 24 : es + 28])
        sample_rate = sr_fixed >> 16
        if bits != 16:  # ValueError → callers fall back to ffmpeg
            raise ValueError(f"only 16-bit PCM supported, got {bits}")

        s, e = boxes[b"stsz"]
        const_size, n_samples = struct.unpack(">II", data[s + 4 : s + 12])
        sizes = (np.full(n_samples, const_size, np.int64) if const_size
                 else np.frombuffer(data[s + 12 : s + 12 + 4 * n_samples],
                                    ">u4").astype(np.int64))

        key = b"stco" if b"stco" in boxes else b"co64"
        s, e = boxes[key]
        (n_chunks,) = struct.unpack(">I", data[s + 4 : s + 8])
        offs = np.frombuffer(
            data[s + 8 : s + 8 + (4 if key == b"stco" else 8) * n_chunks],
            ">u4" if key == b"stco" else ">u8").astype(np.int64)

        s, e = boxes[b"stsc"]
        (n_stsc,) = struct.unpack(">I", data[s + 4 : s + 8])
        stsc = [struct.unpack(">III", data[s + 8 + 12 * i : s + 20 + 12 * i])
                for i in range(n_stsc)]

        # samples per chunk, expanded over chunk runs
        per_chunk = np.empty(n_chunks, np.int64)
        for i, (first, spc, _) in enumerate(stsc):
            last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else n_chunks
            per_chunk[first - 1 : last] = spc

        chunks = []
        si = 0
        for ci in range(n_chunks):
            take = int(per_chunk[ci])
            nbytes = int(sizes[si : si + take].sum())
            chunks.append(data[offs[ci] : offs[ci] + nbytes])
            si += take
        raw = b"".join(chunks)

        dt = "<i2" if fourcc == b"sowt" else ">i2"
        wav = np.frombuffer(raw[: len(raw) // 2 * 2], dt).astype(np.float32)
        wav /= 32768.0
        if channels > 1:
            wav = wav[: len(wav) // channels * channels]
            wav = wav.reshape(-1, channels).mean(axis=1)
        return wav, sample_rate
    raise ValueError(f"no sound track found in {path}")
