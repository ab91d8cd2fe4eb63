"""Checkpoints of a training run with ``torch.save`` (port of
``syncfusion_tpu/core/checkpoint.py``'s ``Checkpointer``).

Retention is Lightning's, as the JAX package keeps it: the best ``save_top_k``
checkpoints by the monitored metric **and** always the latest
(``save_last``).  Each checkpoint is one file, ``step_{step}.pt``, written to
a temporary name and renamed, so a file that exists is whole; the metrics of
every kept step are in ``metrics.json`` beside them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping, Optional

import torch


@dataclasses.dataclass
class CheckpointConfig:
    directory: str | Path
    monitor: str = "valid_loss"
    mode: str = "min"  # "min" or "max"
    save_top_k: int = 1
    save_last: bool = True


class Checkpointer:
    """Save and restore state dicts; keeps best-k by a metric and the latest.

    Saves are synchronous: ``save`` returns when the file is written and
    renamed.  (The JAX package drains a device snapshot on a worker thread
    because its device link was slow; here a save is one ``torch.save`` of
    tensors the card copies to the host at its own rate.)
    """

    def __init__(self, config: CheckpointConfig):
        if config.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {config.mode!r}")
        self.config = config
        self.directory = Path(config.directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._index = self.directory / "metrics.json"
        self._metrics: dict[int, dict[str, float]] = (
            {int(k): v for k, v in json.loads(self._index.read_text()).items()}
            if self._index.exists() else {})

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem[len("step_"):])
                      for p in self.directory.glob("step_*.pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[0] if ranked else None

    def _ranked(self) -> list[int]:
        """Kept steps that carry the monitored metric, best first."""
        mon, on_disk = self.config.monitor, set(self.all_steps())
        steps = [s for s, m in self._metrics.items() if mon in m and s in on_disk]
        return sorted(steps, key=lambda s: self._metrics[s][mon],
                      reverse=self.config.mode == "max")

    def save(self, step: int, state: Mapping[str, Any],
             metrics: Optional[Mapping[str, float]] = None) -> Path:
        """Write ``state`` (a mapping of tensors, numbers and nested state
        dicts) as the checkpoint of ``step``, then prune."""
        path = self.path(step)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(dict(state), tmp)
        tmp.replace(path)
        self._metrics[step] = {k: float(v) for k, v in (metrics or {}).items()}
        self._prune()
        return path

    def _prune(self) -> None:
        cfg = self.config
        steps = self.all_steps()
        if cfg.save_top_k or cfg.save_last:
            keep = set(self._ranked()[:cfg.save_top_k])
            if cfg.save_last and steps:
                keep.add(steps[-1])
            for s in steps:
                if s not in keep:
                    self.path(s).unlink()
                    self._metrics.pop(s, None)
        tmp = self._index.with_suffix(".tmp")
        tmp.write_text(json.dumps({str(k): v for k, v in self._metrics.items()}))
        tmp.replace(self._index)

    def restore(self, step: Optional[int] = None) -> dict:
        """The saved state of ``step`` (the latest when None), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None or not self.path(step).exists():
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)
