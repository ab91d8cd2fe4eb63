"""Attention for the UNet's self-attention levels.

``flash_attention(q, k, v)`` in the JAX package's (B, L, H, D) layout: on a
CUDA tensor it launches the hand-written kernel of ``csrc/flash_fwd.cu``
(the port of the TPU kernel ``_flash_kernel``, forward only: sampling needs
no gradient); on a CPU tensor it takes the plain version,
``attention_reference``.  It never falls back from the kernel to the plain
version on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from syncfusion_tpu_torch.ops import _build

HEAD_DIM = 64  # the one head width the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q, k, v, causal: bool = False,
                        return_lse: bool = False):
    """Plain attention, (B, L, H, D) layout, math in f32.

    Returns O in ``q``'s dtype and, with ``return_lse``, the row logsumexp
    of the scaled logits as a (B, H, Lq) f32 tensor.  ``causal`` masks keys
    after the query's own index (top-left aligned, as the TPU kernel does).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("blhd,bmhd->bhlm", q.float() * scale, k.float())
    if causal:
        lq, lk = s.shape[-2:]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhlm,bmhd->blhd", p, v.float()).to(q.dtype)
    return (o, lse) if return_lse else o


@functools.cache
def _kernel():
    lib = _build.library("flash_fwd")
    fn = lib.flash_fwd
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i, p, p, p, p, p, i, i, i, i, *([ll] * 12), i,
                   ctypes.c_float, p]
    fn.restype = i
    return fn


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, L, H, D)")
    (b, _, h, d), (bk, lk, hk, dk) = q.shape, k.shape
    if d != HEAD_DIM or dk != HEAD_DIM or v.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}; got {d}")
    if (bk, hk) != (b, h) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def flash_attention(q, k, v, causal: bool = False, return_lse: bool = False):
    """Attention in (B, L, H, D) layout: the CUDA kernel on the card, the
    plain version on the CPU.  Same returns as ``attention_reference``.

    Counts each kernel launch in ``flash_attention.kernel_launches`` and
    each plain call in ``flash_attention.plain_calls``.
    """
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        return attention_reference(q, k, v, causal, return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on cuda or cpu, "
                           f"not {q.device.type}")
    _check(q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)]
    err = _kernel()(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, lq, lk, *strides, int(causal),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_attention.kernel_launches += 1
    return (o, lse) if return_lse else o


flash_attention.kernel_launches = 0
flash_attention.plain_calls = 0
