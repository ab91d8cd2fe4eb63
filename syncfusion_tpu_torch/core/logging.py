"""Metrics and media of a training run (port of
``syncfusion_tpu/core/logging.py`` without wandb): ``metrics.jsonl`` and
``media/*.wav`` in the run directory."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np

from syncfusion_tpu_torch.ops.wav import write_wav


class MetricLogger:
    """One JSON object per ``log`` call, appended to ``metrics.jsonl`` and
    flushed; ``close`` closes the file."""

    def __init__(self, run_dir: str | Path):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.run_dir / "metrics.jsonl", "a")

    def log(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        record: dict[str, Any] = {"_time": time.time()}
        if step is not None:
            record["step"] = int(step)
        for key, val in metrics.items():
            record[key] = val.item() if hasattr(val, "item") else val
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def log_audio(self, name: str, wav: np.ndarray, sample_rate: int,
                  step: int = 0) -> Path:
        """Write ``media/{name}_step{step}.wav``; returns its path."""
        media = self.run_dir / "media"
        media.mkdir(exist_ok=True)
        path = media / f"{name}_step{step}.wav"
        write_wav(path, np.asarray(wav), sample_rate)
        return path

    def close(self) -> None:
        self._fh.close()
