"""Attention for the UNet's self-attention levels, differentiable.

``flash_attention(q, k, v)`` in the JAX package's (B, L, H, D) layout is one
``torch.autograd.Function`` on every device, the counterpart of the JAX
package's custom VJP.  On a CUDA tensor its forward is the hand-written
kernel of ``csrc/flash_fwd.cu`` (the port of the TPU kernel
``_flash_kernel``, K1, on the tensor cores, f32 as 3xTF32) and its backward
the two kernels of ``csrc/flash_bwd.cu`` (``_flash_bwd_dq_kernel``, K2a,
then ``_flash_bwd_dkv_kernel``, K2b; on the tensor cores likewise).  All
three copy with ``cp.async`` and so take 16-byte aligned operands with B, L
and H strides in multiples of 16 bytes, see ``cp_async_misalignment``.
The kernels are built for heads of 64 and of 128 features
(``KERNEL_WIDTHS``); on the card the Function zero-pads a narrower head to
the next of the two and passes the kernels the true width's scale: the zero
columns change no logit, LSE or delta, and the padded columns of O, dq, dk
and dv come out exactly 0 and are sliced off.  A head wider than 128
raises ``ValueError`` (``kernel_width``).  On a CPU tensor the same
Function runs their plain versions, so the CPU tests reach the wiring the
card runs.  It never falls back from a kernel to a plain version on the
card.

Each wrapper (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) launches
its kernel on a CUDA tensor and takes its plain version on a CPU tensor, and
counts which, on ``flash_attention``: ``kernel_launches`` (K1),
``dq_launches`` (K2a), ``dkv_launches`` (K2b); ``plain_calls`` (K1's plain
version) and ``plain_bwd_calls`` (K2a's and K2b's).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from syncfusion_tpu_torch.ops import _build

KERNEL_WIDTHS = (64, 128)  # the head widths the kernels are built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _up(x):
    """``x`` in at least f32: the plain versions' arithmetic type (f64 for
    f64 inputs, which only the CPU takes)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def kernel_width(d: int) -> int:
    """The width of the kernel instantiation that takes a head of ``d``
    features: the least of ``KERNEL_WIDTHS`` not below it.  Raises
    ``ValueError`` above the widest."""
    for width in KERNEL_WIDTHS:
        if d <= width:
            return width
    raise ValueError(f"the attention kernels take heads of up to "
                     f"{KERNEL_WIDTHS[-1]} features; got {d}")


def _scale(q, scale):
    """The softmax scale: ``scale``, or 1/sqrt(D) of q's head width."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def attention_reference(q, k, v, causal: bool = False,
                        return_lse: bool = False, scale: float | None = None):
    """Plain attention, (B, L, H, D) layout, math in f32 (f64 for f64
    inputs).

    Returns O in ``q``'s dtype and, with ``return_lse``, the row logsumexp
    of the scaled logits as a (B, H, Lq) f32 tensor.  ``causal`` masks keys
    after the query's own index (top-left aligned, as the TPU kernel does).
    ``scale`` multiplies the logits (default 1/sqrt(D)).
    """
    s = torch.einsum("blhd,bmhd->bhlm", _up(q) * _scale(q, scale), _up(k))
    if causal:
        s = s.masked_fill(~_causal_keep(s), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhlm,bmhd->blhd", p, _up(v)).to(q.dtype)
    return (o, lse) if return_lse else o


def _causal_keep(s):
    lq, lk = s.shape[-2:]
    return torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril()


def _softmax_grad(q, k, v, lse, do, delta, causal, scale):
    """(q·scale, P, dS) in f32 by recompute: P = exp(q kᵀ·scale - lse),
    dS = P∘(dO vᵀ - delta), masked pairs 0."""
    qs = _up(q) * _scale(q, scale)
    s = torch.einsum("blhd,bmhd->bhlm", qs, _up(k))
    if causal:
        s = s.masked_fill(~_causal_keep(s), float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("blhd,bmhd->bhlm", _up(do), _up(v))
    return qs, p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, o, lse, do, causal: bool = False,
                           scale: float | None = None):
    """Plain version of K2a: ``(dq, delta)``, delta = rowsum(dO∘O) as a
    (B, H, Lq) f32 tensor, dq in ``q``'s dtype; ``scale`` as the
    forward's."""
    delta = (_up(do) * _up(o)).sum(-1).transpose(1, 2)
    _, _, ds = _softmax_grad(q, k, v, lse, do, delta, causal, scale)
    dq = torch.einsum("bhlm,bmhd->blhd", ds, _up(k))
    dq = dq / math.sqrt(q.shape[-1]) if scale is None else dq * scale
    return dq.to(q.dtype), delta


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = False,
                            scale: float | None = None):
    """Plain version of K2b: ``(dk, dv)`` in ``k``'s dtype; ``scale`` as
    the forward's."""
    qs, p, ds = _softmax_grad(q, k, v, lse, do, delta, causal, scale)
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qs)
    dv = torch.einsum("bhlm,blhd->bmhd", p, _up(do))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                        scale: float | None = None):
    """The attention backward by recompute in plain PyTorch: ``(dq, dk,
    dv)`` from q, k, v, the forward's O and row LSE (B, H, Lq), and dO."""
    dq, delta = flash_bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


@functools.cache
def _kernels():
    fwd = _build.library("flash_fwd").flash_fwd
    bwd = _build.library("flash_bwd")
    i, ll, p, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
    fwd.argtypes = [i, p, p, p, p, p, i, i, i, i, i, *([ll] * 12), i, f, p]
    bwd_args = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p, i, f, p]
    bwd.flash_bwd_dq.argtypes = bwd_args
    bwd.flash_bwd_dkv.argtypes = bwd_args
    for fn in (fwd, bwd.flash_bwd_dq, bwd.flash_bwd_dkv):
        fn.restype = i
    return fwd, bwd.flash_bwd_dq, bwd.flash_bwd_dkv


def cp_async_misalignment(name: str, ptr: int, shape, strides,
                          esize: int = 2) -> str | None:
    """Why the kernels' 16-byte ``cp.async`` copies cannot take a (B, L, H,
    D) operand of ``esize``-byte elements (bf16 by default) at address
    ``ptr`` with these element ``strides`` of B, L and H, or None if they
    can: the address must be a multiple of 16 bytes and each stride (of a
    dim longer than 1) a multiple of 16 bytes, i.e. of ``16 // esize``
    elements."""
    if ptr % 16:
        return f"{name}: data_ptr {ptr:#x} is not 16-byte aligned"
    per = 16 // esize
    for dim, size, stride in zip("BLH", shape, strides):
        if size > 1 and stride % per:
            return (f"{name}: its {dim} stride {stride} is not a multiple "
                    f"of {per} elements")
    return None


def _check(q, k, v):
    if q.device.type != "cuda":
        raise RuntimeError(f"the kernels run on cuda, not {q.device.type}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, L, H, D)")
    (b, _, h, d), (bk, lk, hk, dk) = q.shape, k.shape
    if d not in KERNEL_WIDTHS or dk != d or v.shape[-1] != d:
        width = kernel_width(d)  # raises above the widest
        raise ValueError(f"the kernels are built for head dims {KERNEL_WIDTHS}; "
                         f"got q {d}, k {dk}, v {v.shape[-1]} (flash_attention "
                         f"pads a head of {d} to {width})")
    if (bk, hk) != (b, h) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def _check_aligned(**tensors):
    for name, x in tensors.items():
        why = cp_async_misalignment(name, x.data_ptr(), x.shape[:3],
                                    x.stride()[:3], x.element_size())
        if why is not None:
            raise ValueError(f"the attention kernels copy with cp.async: {why}")


def _for_cp_async(x):
    """``x`` if the kernels' ``cp.async`` copies can take it, else a
    contiguous copy of it (freshly allocated, so 16-byte aligned)."""
    why = cp_async_misalignment("x", x.data_ptr(), x.shape[:3], x.stride()[:3],
                                x.element_size())
    return x if why is None else x.clone(memory_format=torch.contiguous_format)


def _check_rows(q, **tensors):
    """o and dO: q's shape, dtype and device with a contiguous head dim;
    lse and delta: contiguous (B, H, Lq) f32 on q's device."""
    b, lq, h, _ = q.shape
    for name, x in tensors.items():
        if name in ("lse", "delta"):
            ok = (x.dtype == torch.float32 and x.shape == (b, h, lq)
                  and x.is_contiguous())
        else:
            ok = x.dtype == q.dtype and x.shape == q.shape and x.stride(-1) == 1
        if not ok or x.device != q.device:
            raise ValueError(f"{name} does not fit q {tuple(q.shape)} "
                             f"{q.dtype}: {tuple(x.shape)} {x.dtype} {x.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q, k, v, causal: bool = False, scale: float | None = None):
    """K1: ``(o, lse)``, O in q's dtype, LSE (B, H, Lq) f32; ``scale``
    multiplies the logits (default 1/sqrt(D)).  The kernel on a CUDA tensor
    of head dim 64 or 128 (raises ``ValueError`` for another width or a q,
    k or v ``cp.async`` cannot take), ``attention_reference`` on a CPU
    tensor."""
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        return attention_reference(q, k, v, causal, return_lse=True, scale=scale)
    _check(q, k, v)
    _check_aligned(q=q, k=k, v=v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)]
    _raise_on(_kernels()[0](
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d, *strides, int(causal),
        _scale(q, scale), _stream(q)), "flash_fwd")
    flash_attention.kernel_launches += 1
    return o, lse


def _stride_array(*tensors):
    return (ctypes.c_longlong * 18)(
        *[t.stride(i) for t in tensors for i in (0, 1, 2)])


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = False,
                 scale: float | None = None):
    """K2a: ``(dq, delta)`` as ``flash_bwd_dq_reference``.  The kernel on a
    CUDA tensor (raises ``ValueError`` as ``flash_fwd``), that plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        flash_attention.plain_bwd_calls += 1
        return flash_bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    _check(q, k, v)
    _check_rows(q, o=o, do=do, lse=lse)
    _check_aligned(q=q, k=k, v=v, o=o, do=do)
    b, lq, h, d = q.shape
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _raise_on(_kernels()[1](
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, h, lq, k.shape[1], d, _stride_array(q, k, v, o, do, dq),
        int(causal), _scale(q, scale), _stream(q)), "flash_bwd_dq")
    flash_attention.dq_launches += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  scale: float | None = None):
    """K2b: ``(dk, dv)`` as ``flash_bwd_dkv_reference``.  The kernel on a
    CUDA tensor (raises ``ValueError`` as K2a), that plain version on a CPU
    tensor."""
    if q.device.type == "cpu":
        flash_attention.plain_bwd_calls += 1
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v)
    _check_rows(q, do=do, lse=lse, delta=delta)
    _check_aligned(q=q, k=k, v=v, do=do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    b, lq, h, d = q.shape
    _raise_on(_kernels()[2](
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, lq, k.shape[1], d, _stride_array(q, k, v, do, dk, dv),
        int(causal), _scale(q, scale), _stream(q)), "flash_bwd_dkv")
    flash_attention.dkv_launches += 1
    return dk, dv


def _pads(q) -> bool:
    """Whether the Function zero-pads q's head to a kernel width: on the
    card, where the kernels run (the plain versions take any width)."""
    return q.device.type == "cuda"


def _pad_head(x, width):
    """x (B, L, H, D) zero-padded to ``width`` features (a new contiguous
    tensor), or x itself at that width."""
    d = x.shape[-1]
    return x if d == width else torch.nn.functional.pad(x, (0, width - d))


def _cut_head(x, d):
    """The first ``d`` features of x (a view), or x itself at that width."""
    return x if x.shape[-1] == d else x[..., :d]


class _FlashAttention(torch.autograd.Function):
    """Forward K1, backward K2a then K2b (each wrapper takes its plain
    version on a CPU tensor).  On the card a head of D features is
    zero-padded to ``kernel_width(D)`` (a head wider than 128 raises), the
    kernels take 1/sqrt(D), and O, dq, dk and dv are sliced back to D.
    Saves q, k, v, O (padded) and the LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        d = q.shape[-1]
        scale = 1.0 / math.sqrt(d)
        if _pads(q):
            width = kernel_width(d)
            if width != d:
                q, k, v = (_pad_head(x, width) for x in (q, k, v))
            elif q.device.type == "cuda" and q.dtype == torch.float32:
                # training's f32 path takes any strides (autograd may hand
                # over a view cp.async cannot take): K1 gets copies of
                # those, and K2a and K2b the same tensors; bf16 views that
                # do not fit raise
                q, k, v = map(_for_cp_async, (q, k, v))
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.causal, ctx.scale, ctx.d = causal, scale, d
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return _cut_head(o, d), lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        d = ctx.d
        if do.stride(-1) != 1:
            do = do.contiguous()
        do = _pad_head(do, q.shape[-1])
        if q.device.type == "cuda":
            # autograd may hand over a dO that cp.async cannot take (a slice
            # of a cat's gradient, an odd stride): K2a and K2b get a copy
            q, k, v, o, do = map(_for_cp_async, (q, k, v, o, do))
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return _cut_head(dq, d), _cut_head(dk, d), _cut_head(dv, d), None


def flash_attention(q, k, v, causal: bool = False, return_lse: bool = False):
    """Attention in (B, L, H, D) layout, differentiable in q, k and v: the
    CUDA kernels on the card, the plain versions on the CPU.  Same returns
    as ``attention_reference`` (the LSE carries no gradient)."""
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_attention runs on cuda or cpu, "
                           f"not {q.device.type}")
    o, lse = _FlashAttention.apply(q, k, v, causal)
    return (o, lse) if return_lse else o


def reset_counts() -> None:
    """Set every launch and plain-call count of ``flash_attention`` to 0."""
    for name in COUNTS:
        setattr(flash_attention, name, 0)


COUNTS = ("kernel_launches", "dq_launches", "dkv_launches", "plain_calls",
          "plain_bwd_calls")
reset_counts()
