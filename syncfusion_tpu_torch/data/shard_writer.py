"""Webdataset shard writer: processed GH dirs -> ``.tar`` shards (a copy of
``syncfusion_tpu/data/shard_writer.py``; its tars are byte-identical).

The reference downloads ready-made shards (Zenodo 12634671); this utility
closes the loop so the whole pipeline runs from raw data: for each video in
a split it packs ``{name}.resampled.wav`` + ``{name}.times.csv`` (+ optional
``times.pred.csv`` from onset-model predictions) into numbered tar shards.
"""

from __future__ import annotations

import io
import tarfile
from pathlib import Path
from typing import Optional


def write_shards(
    root_dir: str | Path,
    split_file_path: str | Path,
    output_pattern: str,
    shard_size: int = 256,
    pred_csv_dir: Optional[str | Path] = None,
    audio_file_suffix: str = ".resampled.wav",
    annotations_file_suffix: str = ".times.csv",
) -> list[str]:
    """Write ``output_pattern % shard_idx`` tars (1-based); returns paths.

    ``pred_csv_dir``: a directory of merged ``{video}.times.csv`` prediction
    files (the onset test output) to embed as ``times.pred.csv`` members —
    this is how test_onset_preds.tar-style shards are produced.
    """
    root = Path(root_dir)
    names = Path(split_file_path).read_text().splitlines()
    written: list[str] = []
    tf: Optional[tarfile.TarFile] = None
    shard_idx = 0

    def add(tf, member_name: str, data: bytes):
        info = tarfile.TarInfo(member_name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    for i, name in enumerate(names):
        if i % shard_size == 0:
            if tf is not None:
                tf.close()
            shard_idx += 1
            path = output_pattern % shard_idx
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            tf = tarfile.open(path, "w")
            written.append(path)
        wav_path = root / name / "audio" / f"{name}{audio_file_suffix}"
        csv_path = root / name / f"{name}{annotations_file_suffix}"
        add(tf, f"{name}.resampled.wav", wav_path.read_bytes())
        add(tf, f"{name}.times.csv", csv_path.read_bytes())
        if pred_csv_dir is not None:
            pred = Path(pred_csv_dir) / f"{name}.times.csv"
            if pred.exists():
                # prediction files are bare times; append labels column absent
                add(tf, f"{name}.times.pred.csv",
                    "".join(f"{t}\n" for t in pred.read_text().splitlines()
                            if t.strip()).encode())
    if tf is not None:
        tf.close()
    return written
