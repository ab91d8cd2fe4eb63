"""Checkpoints of a training run with ``torch.save`` (port of
``syncfusion_tpu/core/checkpoint.py``'s ``Checkpointer``).

Retention is Lightning's, as the JAX package keeps it: the best ``save_top_k``
checkpoints by the monitored metric **and** always the latest
(``save_last``).  Each checkpoint is one file, ``step_{step}.pt``, written to
a temporary name and renamed, so a file that exists is whole; the metrics of
every kept step are in ``metrics.json`` beside them.  Under
``torch.distributed`` rank 0 alone writes and reads the files; the state it
writes is the full one, gathered by ``TrainState.state_dict`` at every world
size, so a checkpoint restores at any other.

``load_torch_state_dict`` reads a state dict saved by another program
(laion_clap's checkpoint), plain or nested under ``"state_dict"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping, Optional

import torch

from syncfusion_tpu_torch.core.mesh import Mesh, rank_zero


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

    def __init__(self, config: CheckpointConfig, mesh: Optional[Mesh] = None):
        if config.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {config.mode!r}")
        self.config = config
        self.mesh = mesh or Mesh.single()
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
        dicts) as the checkpoint of ``step``, then prune.  Under
        ``torch.distributed`` rank 0 writes and every rank of the mesh waits
        for it at a barrier."""
        path = self.path(step)
        if rank_zero():
            self._metrics[step] = {k: float(v) for k, v in (metrics or {}).items()}
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(dict(state), tmp)
            tmp.replace(path)
            self._prune()
        self.mesh.barrier()
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
        """The saved state of ``step`` (the latest when None), on the CPU;
        an empty dict on ranks other than 0, which ``TrainState.load_state_dict``
        fills from rank 0."""
        step = self.latest_step() if step is None else step
        if step is None or not self.path(step).exists():
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        if not rank_zero():
            return {}
        return torch.load(self.path(step), map_location="cpu", weights_only=True)


def restore_best(directory: str | Path, monitor: str, mode: str = "min") -> dict:
    """The saved state of a checkpoint directory's best step by ``monitor``
    (from its ``metrics.json``), else of its latest."""
    if not Path(directory).is_dir():
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    ckpt = Checkpointer(CheckpointConfig(directory, monitor=monitor, mode=mode))
    step = ckpt.best_step()
    return ckpt.restore(ckpt.latest_step() if step is None else step)


def load_torch_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``.pt``/``.ckpt`` file -> ``{name: tensor}`` on the CPU: a plain
    state dict, or a Lightning or laion_clap checkpoint that nests it under
    ``"state_dict"``.  Entries that are not tensors are dropped.  Read with
    ``weights_only=True``: a file that pickles other objects is refused."""
    blob = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(blob, Mapping) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k: v for k, v in blob.items() if isinstance(v, torch.Tensor)}
