"""Where the port runs: the card, unless the caller names another device;
and how it computes in f32 there: exact, without TF32, as the JAX package
does."""

from __future__ import annotations

import contextlib

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


def set_exact_f32() -> None:
    """From here on cuBLAS and cuDNN compute f32 products in f32, not TF32
    (the JAX package's f32).  Entry points call it for precision 32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def exact_f32():
    """``set_exact_f32`` within the block, the settings before it after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    set_exact_f32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
