"""Background host-to-device prefetch of training batches (port of
``syncfusion_tpu/data/prefetch.py``).

A thread runs the numpy pipeline, turns each array of a batch into a tensor,
pins it when the target is a card and starts its copy with
``non_blocking=True``, so that reading shards and the copies overlap the
training step.  The copies are issued on the device's current stream, so the
step that consumes a batch is ordered after its copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Mapping

import numpy as np
import torch


def to_device(batch: Mapping, device: torch.device) -> dict:
    """numpy arrays of ``batch`` -> tensors on ``device``; other entries
    (texts, file names) pass through."""
    pin = device.type == "cuda"
    out = {}
    for key, val in batch.items():
        if isinstance(val, np.ndarray):
            val = torch.from_numpy(np.ascontiguousarray(val))
            if pin:
                val = val.pin_memory()
            val = val.to(device, non_blocking=pin)
        out[key] = val
    return out


def device_prefetch(batches: Iterator[Mapping], device: torch.device,
                    buffer_size: int = 2) -> Iterator[dict]:
    """Yield ``to_device`` batches, keeping ``buffer_size`` in flight.

    An error of the pipeline is raised on the consumer's side.  Closing the
    generator (or leaving a loop over it) stops and joins the thread.
    """
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    end = object()
    stop = threading.Event()
    error: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batches:
                if not put(to_device(batch, device)):
                    return
        except BaseException as e:  # raised again on the consumer side
            error.append(e)
        put(end)

    thread = threading.Thread(target=worker, name="device-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        thread.join()
