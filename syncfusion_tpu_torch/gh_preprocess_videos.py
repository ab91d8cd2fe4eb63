"""Greatest Hits video preprocessing (the counterpart of
``script/gh_preprocess_videos.py``, the reference's
script/gh_preprocess_videos.py).

    python -m syncfusion_tpu_torch.gh_preprocess_videos \
        --input_dir data/gh/mic-mp4 --output_dir data/gh/mic-mp4-processed \
        [-adn | --audio_denoise] [--audio_onsets] [--num_workers 8] \
        [--device cpu]

Per video, in a pool of ``--num_workers`` processes: ffprobe metadata ->
``{name}.metadata.json`` (original and processed sections), ffmpeg audio
extraction -> a mono resampled wav (f32, s24 or s16), an onset-track wav
from ``hit_record.csv`` (``--audio_onsets``), and frames at 15 fps as
WxH jpgs.  With ``--audio_denoise`` the spectral gate (``ops/denoise.py``,
the reference's noisereduce call) then runs in this process, one video
after another, on ``--device`` (the card unless told; raises without one):
the workers never open the card, so N of them make no N contexts on it.

Needs the ffmpeg and ffprobe binaries on PATH, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import shutil
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout


def probe(video_path: str) -> dict:
    out = _run([
        "ffprobe", "-v", "error", "-print_format", "json",
        "-show_streams", str(video_path),
    ])
    return json.loads(out)


def video_name(video_path: str, video_suffix: str = ".mp4") -> str:
    return Path(video_path).name.replace(video_suffix, "")


def pipeline(
    video_path: str,
    video_suffix: str = ".mp4",
    audio_sample_rate: int = 48000,
    audio_bitdepth: int = 32,
    audio_onsets: bool = False,
    video_frames_per_second: int = 15,
    video_width: int = 320,
    video_height: int = 240,
    output_dir: str = "processed",
) -> None:
    """One video's metadata, audio, onset track and frames (host only)."""
    from syncfusion_tpu_torch.ops.wav import read_wav, write_wav

    name = video_name(video_path, video_suffix)
    out = Path(output_dir) / name
    out.mkdir(parents=True, exist_ok=True)

    meta = probe(video_path)
    streams = {s["codec_type"]: s for s in meta["streams"]}
    v, a = streams["video"], streams["audio"]
    num, den = v["avg_frame_rate"].split("/")
    metadata = {
        "original": {
            "width": int(v["width"]),
            "height": int(v["height"]),
            "video_frame_rate": float(num) / float(den),
            "video_duration": float(v["duration"]),
            "video_num_frames": int(v.get("nb_frames", 0)),
            "audio_sample_rate": int(a["sample_rate"]),
            "audio_channels": int(a["channels"]),
            "audio_duration": float(a["duration"]),
        },
        "processed": {
            "width": video_width,
            "height": video_height,
            "video_frame_rate": video_frames_per_second,
            "video_duration": float(v["duration"]),
            "video_num_frames": int(float(v["duration"]) * video_frames_per_second),
            "audio_sample_rate": audio_sample_rate,
            "audio_channels": 1,
            "audio_bitdepth": audio_bitdepth,
        },
    }
    (out / f"{name}.metadata.json").write_text(json.dumps(metadata, indent=4))

    fmt = {32: "pcm_f32le", 24: "pcm_s24le", 16: "pcm_s16le"}[audio_bitdepth]
    audio_dir = out / "audio"
    audio_dir.mkdir(exist_ok=True)
    audio_path = audio_dir / f"{name}.resampled.wav"
    _run([
        "ffmpeg", "-i", str(video_path), "-loglevel", "error",
        "-ar", str(audio_sample_rate), "-ac", "1", "-c:a", fmt,
        "-y", str(audio_path),
    ])

    if audio_onsets:
        wav, sr = read_wav(audio_path)
        hits = np.loadtxt(out / "hit_record.csv", delimiter=",", usecols=0, ndmin=1)
        track = np.zeros_like(wav)
        track[:, (hits * sr).astype(int)] = 1.0
        write_wav(audio_dir / f"{name}.resampled_onset.wav", track, sr)

    frames_dir = out / "frames"
    frames_dir.mkdir(exist_ok=True)
    _run([
        "ffmpeg", "-i", str(video_path), "-loglevel", "error",
        "-filter:v",
        f"fps=fps={video_frames_per_second},scale={video_width}:{video_height}",
        "-y", str(frames_dir / f"{name}.frame_%06d.jpg"),
    ])


def denoise(audio_dir: Path, name: str, audio_bitdepth: int, device) -> None:
    """``{name}.resampled.wav`` -> ``{name}.resampled_denoised.wav`` through
    the spectral gate on ``device`` (the reference's
    ``noisereduce.reduce_noise(x, sr, n_fft=1024, hop_length=256)``)."""
    import torch

    from syncfusion_tpu_torch.ops.denoise import spectral_gate
    from syncfusion_tpu_torch.ops.wav import read_wav, write_wav

    wav, sr = read_wav(audio_dir / f"{name}.resampled.wav")
    with torch.no_grad():
        out = spectral_gate(torch.from_numpy(wav).to(device), n_fft=1024,
                            hop_length=256).cpu().numpy()
    write_wav(audio_dir / f"{name}.resampled_denoised.wav", out, sr,
              fmt="pcm16" if audio_bitdepth == 16 else "f32")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--video_suffix", default=".mp4")
    ap.add_argument("--audio_sample_rate", type=int, default=48000)
    ap.add_argument("--audio_bitdepth", type=int, default=32)
    ap.add_argument("-adn", "--audio_denoise", action="store_true")
    ap.add_argument("--audio_onsets", action="store_true")
    ap.add_argument("--video_frames_per_second", type=int, default=15)
    ap.add_argument("--video_width", type=int, default=320)
    ap.add_argument("--video_height", type=int, default=240)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--test", action="store_true", help="process first 5 videos only")
    ap.add_argument("--device", default=None,
                    help="torch device of the denoiser (default: the card; "
                         "raises without one)")
    args = ap.parse_args(argv)

    if shutil.which("ffmpeg") is None or shutil.which("ffprobe") is None:
        sys.exit("ffmpeg/ffprobe not found on PATH: required for preprocessing")
    device = None
    if args.audio_denoise:
        from syncfusion_tpu_torch.device import default_device

        device = default_device(args.device)

    videos = sorted(Path(args.input_dir).glob(f"*{args.video_suffix}"))
    if args.test:
        videos = videos[:5]
    # spawn, not fork: a forked child of a threaded process (torch's pools)
    # can inherit locked mutexes
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=args.num_workers, mp_context=ctx) as pool:
        futures = [
            pool.submit(
                pipeline, str(v), args.video_suffix, args.audio_sample_rate,
                args.audio_bitdepth, args.audio_onsets,
                args.video_frames_per_second, args.video_width,
                args.video_height, args.output_dir,
            )
            for v in videos
        ]
        for f in futures:
            f.result()
    if args.audio_denoise:
        for v in videos:
            name = video_name(str(v), args.video_suffix)
            denoise(Path(args.output_dir) / name / "audio", name, args.audio_bitdepth,
                    device)
    print(f"processed {len(videos)} videos -> {args.output_dir}")


if __name__ == "__main__":
    main()
