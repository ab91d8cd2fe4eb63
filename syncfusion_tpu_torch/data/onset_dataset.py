"""Greatest Hits onset-detection dataset (frames + per-frame labels; port
of ``syncfusion_tpu/data/onset_dataset.py``).

Reproduces main/dataset_onset.py semantics on the preprocessed layout
``{root}/{video}/{video}.metadata.json, {video}.times.csv, frames/*.jpg``:

  * each video is split into ``int(duration / 2.0)`` 2-second chunks
  * labels: zeros(chunk_frames) with 1 at ``int((t − chunk_start)·fps)`` for
    each annotated onset inside the chunk (dataset_onset.py:88-105)
  * frames ``[start_frame:end_frame]`` decoded from JPEG, transformed
    (Resize/Normalize, or the augment pipeline), returned channels-last
    ``(T, H, W, 3)`` float32.

JPEG decode is the CPU hot loop (30 frames/item); a thread pool overlaps it
across items in ``loader`` (the torch num_workers equivalent).  PIL is
imported by the decoder only: the rest runs without it.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import re
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from syncfusion_tpu_torch.data.transforms import FrameTransform


def natsorted(items):
    """Natural sort (the reference depends on the natsort package)."""

    def key(s):
        return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def decode_frames(files) -> np.ndarray:
    """JPEG files -> (T, H, W, 3) float32 RGB in [0, 1]."""
    from PIL import Image

    return np.stack([np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
                     for f in files])


class GreatestHitsDataset:
    def __init__(
        self,
        root_dir: str,
        split_file_path: str,
        chunk_length_in_seconds: float = 2.0,
        frames_transforms: Optional[FrameTransform] = None,
        data_to_use: float = 1.0,
        annotations_file_suffix: str = ".times.csv",
        metadata_file_suffix: str = ".metadata.json",
        frame_file_suffix: str = ".jpg",
        seed: int = 0,
        cache_decoded: bool = False,
        cache_max_bytes: Optional[int] = 8 << 30,
    ):
        self.root = Path(root_dir)
        self.transform = frames_transforms or FrameTransform(augment=False)
        self.frame_file_suffix = frame_file_suffix
        self.rng = np.random.default_rng(seed)
        # cache_decoded: keep each chunk's decoded+Resized frames in RAM as
        # uint8 (~2 MB/chunk at the augment size) so epochs ≥2 skip the JPEG
        # hot loop entirely (30 decodes and resizes per item).  The uint8 quantization of the cached (pre-crop/jitter) frames is one
        # part in 255 — the same precision as the JPEG source pixels.
        # cache_max_bytes bounds host RAM: once full, later chunks simply
        # stay on the decode path (a partial cache still removes that share
        # of the JPEG hot loop; no eviction churn).  None = unbounded.
        self._decoded: Optional[dict[int, np.ndarray]] = {} if cache_decoded else None
        self._cache_max_bytes = cache_max_bytes
        self._cache_bytes = 0

        samples = Path(split_file_path).read_text().splitlines()
        if data_to_use < 1.0:
            self.rng.shuffle(samples)
            samples = natsorted(samples[: int(len(samples) * data_to_use)])
        self.list_samples = samples

        self.list_chunks: list[dict] = []
        self.total_time_in_minutes = 0.0
        for sample in samples:
            meta = json.loads(
                (self.root / sample / f"{sample}{metadata_file_suffix}").read_text()
            )
            fps = meta["processed"]["video_frame_rate"]
            duration = meta["processed"]["video_duration"]
            num_chunks = int(duration / chunk_length_in_seconds)
            end_time = num_chunks * chunk_length_in_seconds
            self.total_time_in_minutes += end_time

            ann_path = self.root / sample / f"{sample}{annotations_file_suffix}"
            times = []
            for line in ann_path.read_text().splitlines():
                if line.strip():
                    times.append(float(line.split(",")[0]))
            times = np.asarray(times)

            chunk_frames = int(chunk_length_in_seconds * fps)
            for i in range(num_chunks):
                t0 = i * chunk_length_in_seconds
                t1 = t0 + chunk_length_in_seconds
                in_chunk = times[(times >= t0) & (times < t1)] - t0
                labels = np.zeros(chunk_frames, np.float32)
                labels[(in_chunk * fps).astype(int)] = 1.0
                self.list_chunks.append(
                    {
                        "video_name": sample,
                        "frames_path": self.root / sample / "frames",
                        "start_time": t0,
                        "end_time": t1,
                        "start_frame": int(t0 * fps),
                        "end_frame": int(t1 * fps),
                        "labels": labels,
                        "frame_rate": fps,
                    }
                )
        self.total_time_in_minutes /= 60.0
        self._frames_cache: dict[Path, list[str]] = {}

    def __len__(self) -> int:
        return len(self.list_chunks)

    def _frame_files(self, frames_path: Path) -> list[str]:
        if frames_path not in self._frames_cache:
            self._frames_cache[frames_path] = natsorted(
                str(p) for p in frames_path.glob(f"*{self.frame_file_suffix}")
            )
        return self._frames_cache[frames_path]

    def _resized_frames(self, index: int) -> np.ndarray:
        """Decoded + Resize-staged frames, (T, H, W, 3) float32 in [0, 1]."""
        if self._decoded is not None and index in self._decoded:
            return self._decoded[index].astype(np.float32) / 255.0
        chunk = self.list_chunks[index]
        files = self._frame_files(chunk["frames_path"])
        files = files[chunk["start_frame"] : chunk["end_frame"]]
        frames = self.transform.resize_stage(decode_frames(files))
        if self._decoded is not None:
            q = (frames * 255.0 + 0.5).astype(np.uint8)
            if (self._cache_max_bytes is None
                    or self._cache_bytes + q.nbytes <= self._cache_max_bytes):
                self._decoded[index] = q
                self._cache_bytes += q.nbytes
        return frames

    def __getitem__(self, index: int) -> dict:
        chunk = self.list_chunks[index]
        frames = self.transform.finish(self._resized_frames(index), self.rng)
        return {
            "video_name": chunk["video_name"],
            "start_time": chunk["start_time"],
            "end_time": chunk["end_time"],
            "start_frame": chunk["start_frame"],
            "end_frame": chunk["end_frame"],
            # dtype preserved: uint8 under wire_uint8 (do NOT cast to f32 —
            # that silently re-quadruples the H2D bytes)
            "frames": frames,
            "label": chunk["labels"],
            "frame_rate": chunk["frame_rate"],
        }

    def print(self) -> None:
        print(f"\nGreatesthit dataset: {len(self.list_samples)} samples, "
              f"{len(self.list_chunks)} chunks, "
              f"{self.total_time_in_minutes:.1f} min")


def loader(
    dataset: GreatestHitsDataset,
    batch_size: int,
    shuffle: bool = False,
    drop_last: bool = False,
    num_workers: int = 8,
    seed: int = 0,
) -> Iterator[dict]:
    """Threaded batch loader (JPEG decode overlapped across items)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    def collate(items: list[dict]) -> dict:
        out: dict = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            if isinstance(vals[0], np.ndarray):
                out[k] = np.stack(vals)
            elif isinstance(vals[0], (int, float)):
                out[k] = np.asarray(vals)
            else:
                out[k] = vals
        return out

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            yield collate(list(pool.map(dataset.__getitem__, idx)))
