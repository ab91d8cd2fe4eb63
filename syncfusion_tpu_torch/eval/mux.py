"""Mux generated audio back onto source video (demo/paper-style outputs;
a copy of ``syncfusion_tpu/eval/mux.py``).

The equivalent of the reference's moviepy muxer
(CondFoleyGen/audio_generation_utils.py:61-92 ``attach_audio_to_video``):
trim the source video to the generation window, force the model fps, attach
the generated wav, and optionally burn an "Original/Generated Audio" label.
moviepy is not promised; the preprocessing layer already shells out to
ffmpeg (script/gh_preprocess_videos.py), so this does too.
``attach_audio_to_frames`` and ``extract_video_audio``'s native demuxer
need no ffmpeg.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from syncfusion_tpu_torch.eval.mp4 import read_mp4_audio, write_mp4
from syncfusion_tpu_torch.ops.resample import resample
from syncfusion_tpu_torch.ops.wav import read_wav


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def attach_audio_to_video(
    video_path: str | Path,
    audio_path: str | Path,
    dest: str | Path,
    fps: int = 15,
    video_start_in_seconds: float = 0.0,
    video_duration_in_seconds: float = 2.0,
    put_text: bool = False,
    text_start_frame: int = 0,
    recon_only: bool = False,
) -> Path:
    """Write ``dest`` = trimmed ``video_path`` with ``audio_path`` as its
    audio track.  Mirrors the reference muxer's arguments; text burning uses
    ffmpeg drawtext (frame-gated like the reference's per-frame cv2.putText).
    """
    if not have_ffmpeg():
        raise RuntimeError("ffmpeg not found on PATH — cannot mux video")
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)

    filters = [f"fps={fps}"]
    if put_text:
        if recon_only:
            filters.append(_drawtext("Reconstructed Sound"))
        else:
            # frames < text_start_frame carry the original-audio label
            t_switch = text_start_frame / fps
            filters.append(_drawtext("Original Audio", f"lt(t,{t_switch:.4f})"))
            filters.append(_drawtext("Generated Audio", f"gte(t,{t_switch:.4f})"))

    cmd = [
        "ffmpeg", "-y", "-loglevel", "error",
        "-ss", f"{video_start_in_seconds:.3f}",
        "-t", f"{video_duration_in_seconds:.3f}",
        "-i", str(video_path),
        "-i", str(audio_path),
        "-map", "0:v:0", "-map", "1:a:0",
        "-vf", ",".join(filters),
        "-c:v", "libx264", "-pix_fmt", "yuv420p",
        "-c:a", "aac", "-shortest",
        str(dest),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        # Surface ffmpeg's diagnostics (e.g. drawtext failing when no
        # fontconfig font is available) instead of an opaque exit code.
        stderr = (e.stderr or b"").decode(errors="replace").strip()
        raise RuntimeError(f"ffmpeg mux failed (rc={e.returncode}): {stderr}") from e
    return dest


def attach_audio_to_frames(
    frames_dir: str | Path,
    frame_pattern: str,
    audio_path: str | Path,
    dest: str | Path,
    fps: float = 15,
    start_frame: int = 0,
    n_frames: int = 30,
) -> Path:
    """Like :func:`attach_audio_to_video` but assembles the video track from
    the processed per-video JPEG frames (``frames/{name}.frame_%06d.jpg``).

    The reference muxes from the ORIGINAL ``_mic.mp4`` files
    (audio_generation.py:31-32 ``--orig_videos_dir/--orig_videos_suffix``);
    the processed GH layout this framework trains from only keeps the
    extracted frames, so when no original-video dir is supplied the muxed
    artifact is rebuilt from those frames — stored byte-for-byte as
    Motion-JPEG samples by the native BMFF muxer (eval/mp4.py): zero
    transcode, no ffmpeg dependency.
    """
    frames_dir = Path(frames_dir)
    jpegs = []
    for i in range(start_frame, start_frame + n_frames):
        # frame files are 1-based on disk (gh_preprocess_videos frame_%06d)
        p = frames_dir / (frame_pattern % (i + 1))
        if not p.exists():  # clamp at end of video like the datasets do
            break
        jpegs.append(p.read_bytes())
    wav, sr = read_wav(audio_path)
    return write_mp4(dest, jpegs, fps, wav.mean(axis=0), sr)


def extract_video_audio(
    video_path: str | Path, sample_rate: int = 22050
) -> np.ndarray:
    """Decode a video's audio track to mono float32 at ``sample_rate``.

    Equivalent of the reference's moviepy extraction
    (script/evaluate_onset_baseline.py:17-27 ``VideoFileClip(...)
    .audio.to_soundarray(fps=22050)`` + channel mean).  Tries the native
    BMFF demuxer first (covers every artifact this framework writes);
    falls back to an ffmpeg pipe for foreign codecs.
    """
    try:
        wav, sr = read_mp4_audio(video_path)
        if sr != sample_rate:
            wav = np.asarray(resample(wav, sr, sample_rate))
        return wav
    except (ValueError, KeyError, struct.error) as e:
        if not have_ffmpeg():
            raise RuntimeError(
                f"native demux failed ({e}) and no ffmpeg on PATH"
            ) from e
    cmd = [
        "ffmpeg", "-loglevel", "error", "-i", str(video_path),
        "-f", "f32le", "-acodec", "pcm_f32le",
        "-ac", "1", "-ar", str(sample_rate), "-",
    ]
    out = subprocess.run(cmd, check=True, capture_output=True).stdout
    return np.frombuffer(out, dtype=np.float32)


def _drawtext(text: str, enable: Optional[str] = None) -> str:
    d = (
        f"drawtext=text='{text}':x=w/50:y=h/6:fontsize=h/12:fontcolor=red"
    )
    if enable:
        d += f":enable='{enable}'"
    return d
