"""Onset metrics for CondFoleyGen baseline outputs (the counterpart of
``script/evaluate_onset_baseline.py``).

Two protocols:

* **mp4 protocol (reference parity)** — ``--tar_dir``: both dirs hold
  videos; the audio track is extracted straight from each ``.mp4``
  (ffmpeg-pipe equivalent of the reference's moviepy extraction,
  evaluate_onset_baseline.py:17-27), generated ``{A}_to_{B}.mp4`` names are
  split on ``_to_`` and ``A`` is matched against ``{A}.mp4`` in the target
  dir (:177-183).
* **wav protocol** — ``--gt_root``: generated wavs are scored against the
  target video's ground-truth audio chunk from the processed GH root (a
  redesign kept for wav-only runs).

    python -m syncfusion_tpu_torch.evaluate_onset_baseline --gen_dir DIR \\
        (--tar_dir VIDEO_DIR | --gt_root PROCESSED_ROOT) \\
        [--multi_delta] [--remove_head S]

Host code (numpy); needs no card, and ffmpeg only for an mp4 whose audio
the native demuxer cannot read.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from syncfusion_tpu_torch.eval.mux import extract_video_audio
from syncfusion_tpu_torch.eval.onset_detect import SR, onset_detect
from syncfusion_tpu_torch.eval.onset_metrics import score_onset_pairs
from syncfusion_tpu_torch.ops.resample import resample
from syncfusion_tpu_torch.ops.wav import read_wav


def _split_pair(stem: str):
    """``{A}_to_{B}`` → (A, B) or None (reference :180-182 requires exactly
    one ``_to_``)."""
    parts = stem.split("_to_")
    return (parts[0], parts[1]) if len(parts) == 2 else None


def _load_wav(path, duration):
    wav, sr = read_wav(path)
    y = wav.mean(axis=0)
    if sr != SR:
        y = resample(y, sr, SR)
    return y[: int(duration * SR)]


def _gen_items(gen_dir: Path, duration: float):
    """Yield (stem, 22.05 kHz mono audio) for every generated item.

    Accepts a dir of ``.mp4``s, a dir of ``.wav``s, or the generation
    generation script's output root (falls back to its ``generated_video`` /
    ``generated_audio`` subdirs)."""
    mp4s = sorted(gen_dir.glob("*.mp4"))
    if not mp4s and (gen_dir / "generated_video").is_dir():
        mp4s = sorted((gen_dir / "generated_video").glob("*.mp4"))
    if mp4s:
        for p in mp4s:
            yield p.stem, extract_video_audio(p, SR)[: int(duration * SR)]
        return
    wavs = sorted(gen_dir.glob("*.wav"))
    if not wavs and (gen_dir / "generated_audio").is_dir():
        wavs = sorted((gen_dir / "generated_audio").glob("*.wav"))
    for p in wavs:
        yield p.stem, _load_wav(p, duration)


def main(argv=None) -> dict:
    """Prints the metrics' JSON line and returns it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gen_dir", required=True)
    ap.add_argument("--tar_dir", default=None,
                    help="dir of target {A}.mp4 videos — audio extracted "
                    "from the mp4s (reference protocol)")
    ap.add_argument("--gt_root", default=None,
                    help="processed GH root with {video}/audio/*.resampled.wav")
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--multi_delta", action="store_true",
                    help="average over delta ∈ arange(0.1, delta+0.05, 0.05) "
                    "(reference :194-203)")
    ap.add_argument("--remove_head", type=float, default=None,
                    help="drop onsets earlier than this many seconds "
                    "(reference :190-192)")
    args = ap.parse_args(argv)
    if not (args.tar_dir or args.gt_root):
        ap.error("pass --tar_dir (mp4) or --gt_root (wav)")

    # target audio lookup: {video_name: wav}
    tar_cache: dict[str, np.ndarray] = {}

    def target_audio(name: str):
        if name in tar_cache:
            return tar_cache[name]
        if args.tar_dir:
            p = Path(args.tar_dir) / f"{name}.mp4"
            wav = (extract_video_audio(p, SR)[: int(args.duration * SR)]
                   if p.exists() else None)
        else:
            p = Path(args.gt_root) / name / "audio" / f"{name}.resampled.wav"
            wav = _load_wav(p, args.duration) if p.exists() else None
        tar_cache[name] = wav
        return wav

    deltas = (list(np.arange(0.1, args.delta + 0.05, 0.05))
              if args.multi_delta else [args.delta])

    # detect onsets ONCE per file (only the matching depends on delta)
    pairs = []
    for stem, gen in _gen_items(Path(args.gen_dir), args.duration):
        split = _split_pair(stem)
        if split is None:
            continue
        gt = target_audio(split[0])
        if gt is None:
            continue
        gen_onsets = onset_detect(gen, SR, delta=0.3)
        gt_onsets = onset_detect(gt, SR, delta=0.3)
        if args.remove_head is not None:
            head = args.remove_head * SR
            gen_onsets = gen_onsets[gen_onsets >= head]
            gt_onsets = gt_onsets[gt_onsets >= head]
        pairs.append((gen, gen_onsets, gt_onsets))

    # baseline-protocol policy: count-match on raw lengths even for
    # zero-onset pairs (reference counts cnt_match before any skip, :193)
    metrics = score_onset_pairs(pairs, deltas, empty_count_match_when_equal=True)
    line = {
        "detection_acc": round(metrics["detection_acc"], 4),
        "detection_ap": round(metrics["detection_ap"], 4),
        "onset_count_match": round(metrics["onset_count_match"], 4),
        "num_files": len(pairs),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
