"""Demo video utilities, ffmpeg-backed, without cv2 or moviepy (a copy of
``syncfusion_tpu/eval/video_utils.py``).

Equivalents of the reference's demo helpers
(CondFoleyGen/feature_extraction/demo_utils.py): duration probing,
``trim_video`` (:98), ``reencode_video_with_diff_fps`` (:131), and
``load_frames`` (:675-694: cv2.VideoCapture there; a raw RGB ffmpeg pipe
here).  Like the preprocessing and :mod:`eval.mux`, these shell out to the
ffmpeg/ffprobe binaries.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np


def which_ffmpeg() -> str:
    return shutil.which("ffmpeg") or ""


def which_ffprobe() -> str:
    return shutil.which("ffprobe") or ""


def _run(cmd: list[str]) -> bytes:
    try:
        return subprocess.run(cmd, check=True, capture_output=True).stdout
    except subprocess.CalledProcessError as e:
        stderr = (e.stderr or b"").decode(errors="replace").strip()
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed (rc={e.returncode}): {stderr}"
        ) from e


def get_duration(video_path: str | Path) -> float:
    """Container duration in seconds (reference demo_utils.get_duration)."""
    out = _run([
        which_ffprobe() or "ffprobe", "-hide_banner", "-loglevel", "panic",
        "-select_streams", "v:0", "-show_entries", "format=duration",
        "-of", "default=noprint_wrappers=1:nokey=1", str(video_path),
    ])
    return float(out.decode().strip())


def trim_video(
    video_path: str | Path,
    start: float,
    trim_duration: float = 10,
    tmp_path: str | Path = "./tmp",
    cond: bool = False,
) -> str:
    """Cut ``trim_duration`` seconds starting at ``start`` into a tmp mp4;
    returns the output path (reference demo_utils.trim_video:98, including
    its file-naming scheme so downstream name parsing matches)."""
    assert which_ffmpeg(), "ffmpeg not found on PATH"
    video_path = Path(video_path)
    duration = get_duration(video_path)
    assert duration > start, f"Video Duration < Trim Start: {duration} < {start}"

    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    tag = "_cond_trim_to_" if cond else "_trim_to_"
    dest = tmp / f"{video_path.stem}{tag}{int(trim_duration)}s_from_{start:.4f}.mp4"
    _run([
        which_ffmpeg(), "-hide_banner", "-loglevel", "panic",
        "-i", str(video_path), "-ss", str(start), "-t", str(trim_duration),
        "-y", str(dest),
    ])
    return str(dest)


def reencode_video_with_diff_fps(
    video_path: str | Path, tmp_path: str | Path, extraction_fps: int
) -> str:
    """Re-encode to ``extraction_fps`` (reference
    demo_utils.reencode_video_with_diff_fps:131: no audio, mp4 container)."""
    assert which_ffmpeg(), "ffmpeg not found on PATH"
    video_path = Path(video_path)
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    dest = tmp / f"{video_path.stem}_new_fps.mp4"
    _run([
        which_ffmpeg(), "-hide_banner", "-loglevel", "panic",
        "-y", "-i", str(video_path), "-an",
        "-filter:v", f"fps=fps={extraction_fps}", str(dest),
    ])
    return str(dest)


def load_frames(
    video_path: str | Path, width: int | None = None, height: int | None = None
) -> list[np.ndarray]:
    """Decode every frame to an RGB uint8 array (reference
    demo_utils.load_frames:675-694).  Streams rawvideo over a pipe instead
    of cv2.VideoCapture; frame dims come from ffprobe when not given."""
    if width is None or height is None:
        out = _run([
            which_ffprobe() or "ffprobe", "-v", "error",
            "-select_streams", "v:0", "-show_entries", "stream=width,height",
            "-of", "csv=p=0", str(video_path),
        ])
        width, height = (int(v) for v in out.decode().strip().split(","))
    raw = _run([
        which_ffmpeg() or "ffmpeg", "-i", str(video_path), "-loglevel", "error",
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-",
    ])
    frame_bytes = width * height * 3
    n = len(raw) // frame_bytes
    arr = np.frombuffer(raw[: n * frame_bytes], np.uint8)
    return list(arr.reshape(n, height, width, 3))
