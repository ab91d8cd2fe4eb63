"""Run utilities (port of ``syncfusion_tpu/utils/misc.py``).

Reference main/utils.py equivalents: flaky-service retry
(``retry_if_error``, utils.py:190-197), hyperparameter snapshot logging
(utils.py:123-165), parameter counting, global seeding.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import random
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

log = logging.getLogger(__name__)


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a
    ``torch.Generator`` seeded alike (the JAX function's root key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def retry_if_error(fn: Callable | None = None, *, retries: int = 10,
                   delay: float = 1.0):
    """Retry a flaky callable (the reference retries wandb init 10x)."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            last: Exception | None = None
            for attempt in range(retries):
                try:
                    return f(*args, **kwargs)
                except Exception as e:  # noqa: BLE001 (retrying is the point)
                    last = e
                    log.warning("attempt %d/%d failed: %s", attempt + 1, retries, e)
                    time.sleep(delay)
            raise last  # type: ignore[misc]

        return wrapper

    return deco(fn) if fn is not None else deco


def _leaves(tree: Any):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def count_params(tree: Any) -> int:
    """Elements of every array or tensor in ``tree`` (a module's
    parameters, or nested dicts, lists and tuples of arrays)."""
    return sum(int(np.prod(x.shape)) for x in _leaves(tree))


def log_hyperparameters(run_dir: str | Path, config: Any, params: Any = None) -> None:
    """Snapshot config + param counts + installed packages to the run dir
    (reference utils.py:123-165); ``devices`` names torch's devices."""
    import importlib.metadata as md

    devices = ["cpu"] + [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                         for i in range(torch.cuda.device_count())]
    out = {
        "config": config,
        "param_count": count_params(params) if params is not None else None,
        "packages": sorted(
            f"{d.metadata['Name']}=={d.version}" for d in md.distributions()
        ),
        "devices": devices,
    }
    path = Path(run_dir) / "hparams.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2, default=str))


def load_dotenv(path: str | Path = ".env", override: bool = True) -> dict:
    """Minimal ``.env`` loader (reference script/train_diffusion_model.py:15
    ``dotenv.load_dotenv(override=True)``).

    Supports comments, blank lines, ``export KEY=VALUE`` and single/double
    quoted values.  Returns the parsed mapping; does nothing when the file
    does not exist (as python-dotenv).
    """
    path = Path(path)
    parsed: dict[str, str] = {}
    if not path.exists():
        return parsed
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        if line.startswith("export "):
            line = line[len("export "):]
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
            value = value[1:-1]
        parsed[key] = value
        if override or key not in os.environ:
            os.environ[key] = value
    return parsed
