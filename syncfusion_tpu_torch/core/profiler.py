"""Profiling and step timing (port of ``syncfusion_tpu/core/profiler.py``).

``trace(log_dir)`` records the host and the card with ``torch.profiler``
for the block it wraps and writes a Chrome trace (``trace.json``, for
chrome://tracing or Perfetto) into ``log_dir``.  ``StepTimer`` keeps the
wall time of each step; ``tick`` synchronises the card first, so a step's
time includes the device work it queued.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[profile]:
    """Profile the block (CPU, and CUDA when a card is present); its trace
    is written to ``log_dir/trace.json`` when the block ends."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class StepTimer:
    """Tracks per-step wall time; call ``tick`` at the end of each step
    (after ``start``), which waits for the card's queued work.  The first
    ``warmup`` steps are not kept."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._last: float | None = None
        self._steps = 0

    def start(self) -> None:
        self._sync()
        self._last = time.perf_counter()

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def tick(self, result=None) -> float:
        """Close a step: synchronise the card, keep its time past the
        warm-up steps and return it.  ``result`` (the JAX signature's array
        to wait for) is accepted and not needed: the sync waits for all."""
        self._sync()
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self._steps += 1
        if self._steps > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")
