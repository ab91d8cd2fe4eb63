"""Webdataset-style tar shard streaming (the Python reader of
``syncfusion_tpu/data/shards.py``).

Shards are ``.tar`` files whose members are grouped by key:
``{key}.resampled.wav``, ``{key}.times.csv``, optional
``{key}.times.pred.csv``.  A generator yields samples ``{suffix: bytes}``;
helpers decode the wav and csv members.  Members come from the native C++
reader (``data/native.py``, ``csrc/sfx_io.cpp``) where it builds, else
from Python's ``tarfile``; ``native=True`` insists on the native one
(raising when it cannot build), ``native=False`` takes ``tarfile``.
``shard_for_process`` splits a shard list over processes, so that each
reads disjoint data.
"""

from __future__ import annotations

import random
import re
import tarfile
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from syncfusion_tpu_torch.ops.wav import read_wav


def expand_shards(path: str | Sequence[str]) -> list[str]:
    """Accept a path, list, glob, or brace pattern ``shard_{1..3}.tar``."""
    if isinstance(path, (list, tuple)):
        out: list[str] = []
        for p in path:
            out.extend(expand_shards(p))
        return out
    path = str(path)
    m = re.search(r"\{(\d+)\.\.(\d+)\}", path)
    if m:
        lo, hi = int(m.group(1)), int(m.group(2))
        return [path[: m.start()] + str(i) + path[m.end():] for i in range(lo, hi + 1)]
    if any(ch in path for ch in "*?["):
        parent = Path(path).parent
        return sorted(str(p) for p in parent.glob(Path(path).name))
    return [path]


def shard_for_process(shards: Sequence[str], process_index: int,
                      process_count: int) -> list[str]:
    """Disjoint round-robin shard assignment per process."""
    return [s for i, s in enumerate(shards) if i % process_count == process_index]


def _iter_members_python(shard: str) -> Iterator[tuple[str, bytes]]:
    with tarfile.open(shard, mode="r|*") as tf:
        for member in tf:
            if not member.isfile():
                continue
            fileobj = tf.extractfile(member)
            if fileobj is not None:
                yield member.name, fileobj.read()


def _iter_members(shard: str, native: Optional[bool]) -> Iterator[tuple[str, bytes]]:
    """The shard's members from the native reader (``native`` True, or
    None where it builds) or from ``tarfile`` (False, or None where it does
    not)."""
    if native is not False:
        from syncfusion_tpu_torch.data import native as native_io

        if native or native_io.available():
            yield from native_io.iter_tar_members(shard)
            return
    yield from _iter_members_python(shard)


def iter_tar_samples(
    shards: str | Sequence[str],
    shardshuffle: bool = False,
    seed: int = 0,
    native: Optional[bool] = None,
) -> Iterator[dict]:
    """Yield ``{"__key__": key, suffix: bytes, ...}`` grouped by sample key.

    Keys follow webdataset rules: the member name up to the first dot is the
    key; everything after is the suffix (so ``a/b.times.csv`` → key ``a/b``,
    suffix ``times.csv``).  ``native``: the member reader, as
    ``_iter_members`` takes it.
    """
    shard_list = expand_shards(shards)
    if shardshuffle:
        shard_list = list(shard_list)
        random.Random(seed).shuffle(shard_list)

    for shard in shard_list:
        current_key: Optional[str] = None
        sample: dict = {}
        for name, data in _iter_members(shard, native):
            base = Path(name).name
            stem = base.split(".", 1)[0]
            key = str(Path(name).parent / stem) if "/" in name else stem
            suffix = base.split(".", 1)[1] if "." in base else ""
            if key != current_key:
                if sample:
                    yield sample
                current_key, sample = key, {"__key__": key}
            sample[suffix] = data
        if sample:
            yield sample


def decode_wav_member(data: bytes) -> tuple[np.ndarray, int]:
    return read_wav(data)


def decode_times_csv(data: bytes) -> dict[float, Optional[str]]:
    """``time,label`` lines → {time: label} (reference
    main/dataset_diffusion.py:19-25 — trailing newline dropped, label may be
    absent)."""
    rows = data.decode("utf-8").split("\n")[:-1]
    out: dict[float, Optional[str]] = {}
    for row in rows:
        parts = row.split(",")
        out[float(parts[0])] = parts[1] if len(parts) > 1 else None
    return out
