"""Where the port runs: the card, unless the caller names another device."""

from __future__ import annotations

import torch


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` when given, else the first CUDA device.

    Raises when no card is present and no device was asked for: an entry
    point never carries on silently on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: syncfusion_tpu_torch runs on the card; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")
