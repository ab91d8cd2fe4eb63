"""Test-time onset annotation CSV writer (port of
``syncfusion_tpu/eval/onset_annotations.py``).

Reproduces the reference's test flow (main/module_onset.py:142-229): for
each chunk write per-chunk ``{video}.{start}-{end}.times.csv`` files for
target and (raw logit > 0.5, consecutive-deduped) predictions, then merge all
chunks of each video into one ``{video}.times.csv`` and delete the chunk
files.  These merged prediction files are what becomes
``test_onset_preds.tar`` for the pred-onset diffusion eval (SURVEY §3.4).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from syncfusion_tpu_torch.data.onset_dataset import natsorted


def dedup_consecutive(idx: list) -> list:
    """The reference's consecutive-onset dedup over a sorted index list
    (module_onset.py:169-172): of a run of consecutive frames, every other
    one is dropped against its kept predecessor, so [3, 4, 5] -> [3, 5]."""
    idx = list(idx)
    j = 0
    while j < len(idx) - 1:
        if idx[j + 1] == idx[j] + 1:
            del idx[j + 1]
        else:
            j += 1
    return idx


def write_chunk_annotations(
    out_dir: str | Path,
    batch: dict,
    logits: np.ndarray,
) -> None:
    """Write per-chunk target/pred onset-time CSVs for one batch."""
    out_dir = Path(out_dir)
    target_dir = out_dir / "target"
    pred_dir = out_dir / "pred"
    target_dir.mkdir(parents=True, exist_ok=True)
    pred_dir.mkdir(parents=True, exist_ok=True)

    # NB: the reference thresholds RAW logits at 0.5 (module_onset.py:162),
    # i.e. sigmoid prob ≈ 0.62 — reproduced for parity.
    pred_labels = (np.asarray(logits) > 0.5).astype(np.float32)
    target_labels = np.asarray(batch["label"])

    for i, video in enumerate(batch["video_name"]):
        t_idx = np.nonzero(target_labels[i])[0]
        p_idx = np.nonzero(pred_labels[i])[0]

        p_idx = np.asarray(dedup_consecutive(p_idx.tolist()))

        fps = float(np.asarray(batch["frame_rate"][i]))
        start = int(np.asarray(batch["start_frame"][i]))
        end = int(np.asarray(batch["end_frame"][i]))
        t_times = (t_idx + start) / fps
        p_times = (p_idx + start) / fps
        np.savetxt(target_dir / f"{video}.{start}-{end}.times.csv",
                   t_times, fmt="%.4f", delimiter=",")
        np.savetxt(pred_dir / f"{video}.{start}-{end}.times.csv",
                   p_times, fmt="%.4f", delimiter=",")


def concat_annotations(out_dir: str | Path) -> None:
    """Merge per-chunk CSVs per video; delete chunk files."""
    out_dir = Path(out_dir)
    for sub in ("target", "pred"):
        d = out_dir / sub
        if not d.exists():
            continue
        chunk_files = natsorted(str(p) for p in d.glob("*.*.times.csv"))
        videos: dict[str, list[float]] = {}
        for f in chunk_files:
            video = Path(f).name.split(".")[0]
            text = Path(f).read_text().strip()
            # a chunk with zero onsets writes an empty CSV — legal, not a
            # warning (np.loadtxt warns "input contained no data" on it)
            times = [float(line) for line in text.splitlines() if line.strip()]
            videos.setdefault(video, []).extend(times)
        for video, times in videos.items():
            np.savetxt(d / f"{video}.times.csv", times, fmt="%.4f", delimiter="\n")
        for f in chunk_files:
            Path(f).unlink()
