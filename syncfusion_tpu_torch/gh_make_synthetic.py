"""Generate a synthetic Greatest-Hits-shaped PROCESSED dataset at scale (the
counterpart of ``script/gh_make_synthetic.py``; the same files for the same
seed).

Produces exactly the per-video layout the real preprocessing emits
(``gh_preprocess_videos`` -> ``{name}/{name}.metadata.json``,
``{name}.times.csv``, ``audio/{name}.resampled.wav``, ``frames/*.jpg``) plus
``train/val/test.txt`` splits, so every downstream surface (shard packing,
onset training on frames, diffusion training, the baseline stages and the
evaluation entry points) runs the reference recipe on it.

Content is designed so the models can genuinely learn from it:
- audio: per-onset decaying band-noise+ping "hits" whose timbre depends on
  a material label (the times.csv text), over a low noise floor;
- frames: a moving colored disc that flashes white for 2 frames at each
  onset, a real audiovisual correspondence for the R(2+1)D onset net.

    python -m syncfusion_tpu_torch.gh_make_synthetic \
        --output_dir data/rehearsal/processed --n_videos 320 \
        [--min_dur 8 --max_dur 14] [--num_workers 8]

The frames need PIL.  Host work only: no device is used.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

SR = 48000
FPS = 15
W, H = 320, 240

MATERIALS = {
    # material → (center freq Hz, decay tau s, noise/ping mix)
    "metal": (2400.0, 0.25, 0.35),
    "wood": (600.0, 0.06, 0.75),
    "plastic": (1100.0, 0.04, 0.85),
    "glass": (3200.0, 0.18, 0.30),
    "ceramic": (1800.0, 0.10, 0.50),
    "carpet": (300.0, 0.03, 0.95),
}


def _synth_hit(rng: np.random.Generator, material: str) -> np.ndarray:
    f0, tau, noise_mix = MATERIALS[material]
    n = int(SR * min(6 * tau, 0.6))
    t = np.arange(n, dtype=np.float32) / SR
    env = np.exp(-t / (tau * (0.8 + 0.4 * rng.random()))).astype(np.float32)
    f = f0 * (0.9 + 0.2 * rng.random())
    ping = np.sin(2 * np.pi * f * t) + 0.5 * np.sin(2 * np.pi * 2.01 * f * t)
    noise = rng.normal(size=n).astype(np.float32)
    # crude band-pass: difference (HP) then 3-tap smooth (LP)
    noise = np.diff(noise, prepend=0.0)
    noise = np.convolve(noise, np.ones(3, np.float32) / 3, mode="same")
    noise /= max(1e-6, np.abs(noise).max())
    hit = env * (noise_mix * noise + (1.0 - noise_mix) * ping.astype(np.float32))
    return (0.4 + 0.3 * rng.random()) * hit


def make_video(args) -> None:
    name, out_root, seed, min_dur, max_dur, quality = args
    from PIL import Image

    from syncfusion_tpu_torch.ops.wav import write_wav

    rng = np.random.default_rng(seed)
    dur = float(min_dur + (max_dur - min_dur) * rng.random())
    n_samples = int(SR * dur)

    # onset schedule + materials
    onsets, t = [], 0.5 + 0.3 * rng.random()
    while t < dur - 1.0:
        onsets.append(t)
        t += 0.45 + 1.15 * rng.random()
    mats = [list(MATERIALS)[rng.integers(len(MATERIALS))] for _ in onsets]

    wav = rng.normal(size=n_samples).astype(np.float32) * 1e-3
    for t0, m in zip(onsets, mats):
        hit = _synth_hit(rng, m)
        i = int(t0 * SR)
        wav[i : i + len(hit)] += hit[: n_samples - i]
    peak = np.abs(wav).max()
    if peak > 0.98:
        wav *= 0.98 / peak

    out = Path(out_root) / name
    (out / "audio").mkdir(parents=True, exist_ok=True)
    (out / "frames").mkdir(exist_ok=True)
    write_wav(out / "audio" / f"{name}.resampled.wav", wav[None], SR)

    (out / f"{name}.times.csv").write_text(
        "".join(f"{t0:.4f},{m} hit\n" for t0, m in zip(onsets, mats))
    )

    n_frames = int(dur * FPS)
    meta = {
        "original": {
            "width": W, "height": H, "video_frame_rate": 29.97,
            "video_duration": dur, "video_num_frames": int(dur * 29.97),
            "audio_sample_rate": 96000, "audio_channels": 2,
            "audio_duration": dur,
        },
        "processed": {
            "width": W, "height": H, "video_frame_rate": FPS,
            "video_duration": dur, "video_num_frames": n_frames,
            "audio_sample_rate": SR, "audio_channels": 1, "audio_bitdepth": 32,
        },
    }
    (out / f"{name}.metadata.json").write_text(json.dumps(meta, indent=4))

    # frames: moving disc on gradient background, white flash at onsets
    onset_frames = {int(round(t0 * FPS)) for t0 in onsets}
    flash_frames = onset_frames | {f + 1 for f in onset_frames}
    gx = np.linspace(0, 80, W, dtype=np.float32)[None, :]
    gy = np.linspace(0, 80, H, dtype=np.float32)[:, None]
    base = np.zeros((H, W, 3), np.float32)
    base[..., 0] = 40 + gx
    base[..., 1] = 40 + gy
    base[..., 2] = 60.0
    color = rng.integers(100, 255, 3)
    cx0, cy0 = rng.uniform(60, W - 60), rng.uniform(60, H - 60)
    vx, vy = rng.uniform(-40, 40), rng.uniform(-30, 30)
    yy, xx = np.mgrid[:H, :W]
    for f in range(1, n_frames + 1):
        tt = f / FPS
        cx = 60 + (cx0 + vx * tt - 60) % (W - 120)
        cy = 60 + (cy0 + vy * tt - 60) % (H - 120)
        img = base.copy()
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < 30**2
        img[mask] = color
        if f - 1 in flash_frames:  # frame index is 1-based on disk
            img = np.minimum(255.0, img + 140.0)
            img[mask] = 255
        Image.fromarray(img.astype(np.uint8)).save(
            out / "frames" / f"{name}.frame_{f:06d}.jpg", quality=quality
        )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--n_videos", type=int, default=320)
    ap.add_argument("--min_dur", type=float, default=8.0)
    ap.add_argument("--max_dur", type=float, default=14.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--jpeg_quality", type=int, default=70)
    args = ap.parse_args(argv)

    names = [f"synth_{i:04d}" for i in range(args.n_videos)]
    jobs = [
        (n, args.output_dir, args.seed * 100003 + i, args.min_dur,
         args.max_dur, args.jpeg_quality)
        for i, n in enumerate(names)
    ]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=args.num_workers, mp_context=ctx) as pool:
        for _ in pool.map(make_video, jobs, chunksize=4):
            pass

    # seeded 0.7/0.1/0.2 split (reference gh_preprocess_split.py semantics)
    rng = np.random.default_rng(42)
    shuffled = list(names)
    rng.shuffle(shuffled)
    n = len(shuffled)
    n_tr, n_val = int(0.7 * n), int(0.1 * n)
    root = Path(args.output_dir)
    (root / "train.txt").write_text("\n".join(sorted(shuffled[:n_tr])) + "\n")
    (root / "val.txt").write_text(
        "\n".join(sorted(shuffled[n_tr : n_tr + n_val])) + "\n")
    (root / "test.txt").write_text("\n".join(sorted(shuffled[n_tr + n_val :])) + "\n")
    print(f"wrote {n} synthetic videos -> {root} "
          f"({n_tr} train / {n_val} val / {n - n_tr - n_val} test)")


if __name__ == "__main__":
    main()
