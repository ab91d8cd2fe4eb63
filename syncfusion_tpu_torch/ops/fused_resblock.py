"""Fused GroupNorm/FiLM/SiLU -> conv1d(k3) of the UNet's resnet chain (port
of ``syncfusion_tpu/ops/fused_resblock.py``).

``y = conv1d_k3(silu(x·scale + shift)) + bias``: the per-(batch, channel)
``scale`` and ``shift`` fold the GroupNorm statistics, its gamma/beta and
the FiLM modulation (``fold_groupnorm_film``, or ``stats_affine`` from sums
a producer already made), so x is read once and the activated input never
reaches device memory.  Public functions keep the JAX package's signatures
and layout: x (B, L, C), weight (3, C, Cout), scale and shift (B, C) f32,
bias (Cout,) f32; any strides, so the port's blocks pass (B, L, C) views of
their (B, C, L) tensors and no copy is made.  The weight arrives rounded to
the compute dtype; sums are f32; y is in x's dtype.  On the card both
kernels run on the tensor cores: bf16 with a bf16 weight and the activation
as hi + lo bf16, f32 as 3xTF32 (every operand as a rounded tf32 part and
its remainder).

* ``fused_affine_silu_conv`` and ``fused_affine_silu_conv_blocked`` (the
  entries of the TPU kernels K3a and K3b, one function) run
  ``affine_silu_conv``: on a CUDA tensor the kernel of
  ``csrc/fused_resblock.cu``, on a CPU tensor its plain version
  ``_reference``.
* ``fused_affine_silu_conv_stats`` (K4's entry) runs
  ``affine_silu_conv_stats``: the same op with an optional residual, and
  the per-(batch, group) sum and sum of squares of the f32 output, for the
  next GroupNorm; plain version ``_stats_reference``.

Each entry is a ``torch.autograd.Function`` whose backward recomputes
through the plain version, as the JAX custom VJPs do; K4's backward takes
the cotangents of the sums too, since the next GroupNorm's affine is
computed from them.  ``affine_silu_conv`` and ``affine_silu_conv_stats``
count kernel launches (``kernel_launches``) and plain forward calls
(``plain_calls``); ``reset_counts()`` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from syncfusion_tpu_torch.ops import _build

DEFAULT_BLOCK_L = 4096
GN_EPS = 1e-6
TILE_L = 128  # positions per block of the kernel
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _reference(x, scale, shift, weight, bias):
    """Plain version of K3: f32 math, y in x's dtype, (B, L, Cout)."""
    h = F.silu(x.float() * scale[:, None, :] + shift[:, None, :])
    y = F.conv1d(h.transpose(1, 2), weight.float().permute(2, 1, 0),
                 bias.float(), padding=1)
    return y.to(x.dtype).transpose(1, 2)


def _stats_reference(x, scale, shift, weight, bias, residual, num_groups):
    """Plain version of K4: ``(y, s, ss)``, y as ``_reference`` plus the
    residual, s and ss (B, G) f32 sums of the f32 y before its cast."""
    h = F.silu(x.float() * scale[:, None, :] + shift[:, None, :])
    y = F.conv1d(h.transpose(1, 2), weight.float().permute(2, 1, 0),
                 bias.float(), padding=1)
    if residual is not None:
        y = y + residual.float().transpose(1, 2)
    yg = y.reshape(y.shape[0], num_groups, -1)
    return y.to(x.dtype).transpose(1, 2), yg.sum(-1), (yg * yg).sum(-1)


def fold_groupnorm_film(x, gamma, beta, film_scale, film_shift, num_groups,
                        eps: float = GN_EPS):
    """GroupNorm statistics of x (B, L, C) in f32 (population variance)
    folded with gamma/beta and FiLM into ``(scale, shift)``, each (B, C) f32:
    ``x·scale + shift == GN(x)·(1 + film_scale) + film_shift``."""
    b, _, c = x.shape
    xg = x.float().transpose(1, 2).reshape(b, num_groups, -1)
    var, mean = torch.var_mean(xg, dim=-1, correction=0)
    inv = torch.rsqrt(var + eps).repeat_interleave(c // num_groups, dim=1)
    mean = mean.repeat_interleave(c // num_groups, dim=1)
    one_plus = 1.0 + film_scale
    scale = inv * gamma[None] * one_plus
    shift = (beta[None] - mean * inv * gamma[None]) * one_plus + film_shift
    return scale, shift


def group_stats(x, num_groups):
    """Per-(batch, group) ``(sum, sum of squares)`` of x (B, L, C) in f32:
    the one plain reduction at a chain start (``folded_group_stats``)."""
    xg = x.float().transpose(1, 2).reshape(x.shape[0], num_groups, -1)
    return xg.sum(-1), (xg * xg).sum(-1)


def stats_affine(s, ss, count, gamma, beta, num_groups, film_scale=None,
                 film_shift=None, eps: float = GN_EPS):
    """(B, G) sums of ``count`` values per group -> ``(scale, shift)``, each
    (B, C) f32, folding GroupNorm with ``mean = s/count``, ``var =
    ss/count - mean²``, gamma/beta and optional FiLM (``folded_stats_affine``
    of the JAX package at fold 1)."""
    cols = gamma.shape[0] // num_groups
    mean = s / count
    var = ss / count - mean * mean
    inv = torch.rsqrt(var + eps).repeat_interleave(cols, dim=1)
    mean = mean.repeat_interleave(cols, dim=1)
    g32, b32 = gamma.float()[None], beta.float()[None]
    one_plus = 1.0 + film_scale.float() if film_scale is not None else 1.0
    scale = inv * g32 * one_plus
    shift = (b32 - mean * inv * g32) * one_plus
    if film_shift is not None:
        shift = shift + film_shift.float()
    return scale, shift


@functools.cache
def _kernel():
    fn = _build.library("fused_resblock").fused_resblock
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, i, *([p] * 9), i, i, i, i, i, p, i, p]
    fn.restype = i
    return fn


@functools.cache
def _chunk(dtype_code: int, tco: int) -> int:
    """Input channels of one staged chunk of the kernel: the weight's
    channels are zero-padded to a multiple of it."""
    return _build.library("fused_resblock").fused_resblock_chunk(dtype_code, tco)


def _check(x, scale, shift, weight, bias, residual):
    if x.device.type != "cuda":
        raise RuntimeError(f"the kernel runs on cuda, not {x.device.type}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError(f"x must be (B, L, C) and weight (3, C, Cout); got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    b, _, c = x.shape
    cout = weight.shape[-1]
    if (weight.shape[:2] != (3, c) or scale.shape != (b, c)
            or shift.shape != (b, c) or bias.shape != (cout,)):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, scale {tuple(scale.shape)}, "
                         f"shift {tuple(shift.shape)}, bias {tuple(bias.shape)}")
    if residual is not None and (residual.shape != (*x.shape[:2], cout)
                                 or residual.dtype != x.dtype):
        raise ValueError(f"residual must be (B, L, Cout) in x's dtype; got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    tensors = (scale, shift, weight, bias) + ((residual,) if residual is not None else ())
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors must lie on x's device")
    if any(s_ < 0 for t in (x,) + tensors for s_ in t.stride()):
        raise ValueError("negative strides are not taken")
    if x.dtype == torch.bfloat16 and weight.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 kernel's products take a bf16 weight (the "
                        f"blocks pass it rounded to bf16); got {weight.dtype}")


def _out_tensor(x, cout):
    """(B, L, Cout) in x's dtype, laid out as x: a (B, L, C) view of a
    (B, C, L) tensor gives one of a (B, Cout, L) tensor."""
    b, length, _ = x.shape
    if x.stride(1) == 1 and x.stride(2) != 1:
        return x.new_empty((b, cout, length)).transpose(1, 2)
    return x.new_empty((b, length, cout))


def _channel_tile(cout: int) -> int:
    return next((t for t in (8, 16, 32) if cout <= t), 64)


def _launch(x, scale, shift, weight, bias, residual=None, num_groups=0):
    """One launch of the kernel; returns y, or ``(y, s, ss)`` when
    ``num_groups`` > 0 (the statistics)."""
    _check(x, scale, shift, weight, bias, residual)
    b, length, c = x.shape
    cout = weight.shape[-1]
    stats = num_groups > 0
    if stats and cout % num_groups:
        raise ValueError(f"{num_groups} groups do not divide {cout} channels")
    tco = _channel_tile(cout)
    seg = math.gcd(cout // num_groups, tco) if stats else 1
    f32 = dict(dtype=torch.float32)
    scale, shift = scale.to(**f32).contiguous(), shift.to(**f32).contiguous()
    bias = bias.to(**f32).contiguous()
    # (3, Cout, Cp) in x's dtype, input channels zero-padded to whole
    # chunks: the layout the kernel stages for its B fragments
    chunk = _chunk(_DTYPE_CODE[x.dtype], tco)
    cp = -(-c // chunk) * chunk
    weight = F.pad(weight.to(x.dtype).permute(0, 2, 1), (0, cp - c)).contiguous()
    y = _out_tensor(x, cout)
    n_tiles = -(-length // TILE_L)
    # per-(tile, segment) partial sums, tiles last: their sum is one
    # reduction over contiguous rows
    part = (torch.empty((2, b, cout // seg, n_tiles), device=x.device, **f32)
            if stats else None)
    r = residual if residual is not None else y
    strides = (ctypes.c_longlong * 9)(*x.stride(), *y.stride(), *r.stride())
    err = _kernel()(
        _DTYPE_CODE[x.dtype], int(residual is not None), int(stats), tco,
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), r.data_ptr(), y.data_ptr(),
        part[0].data_ptr() if stats else None,
        part[1].data_ptr() if stats else None,
        b, length, c, cout, cp, strides, seg,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_resblock kernel launch failed: error {err}")
    if not stats:
        return y
    s, ss = part.sum(-1).view(2, b, num_groups, -1).sum(-1)
    return y, s, ss


def affine_silu_conv(x, scale, shift, weight, bias):
    """K3: the kernel on a CUDA tensor, ``_reference`` on a CPU tensor."""
    if x.device.type == "cpu":
        affine_silu_conv.plain_calls += 1
        return _reference(x, scale, shift, weight, bias)
    y = _launch(x, scale, shift, weight, bias)
    affine_silu_conv.kernel_launches += 1
    return y


def affine_silu_conv_stats(x, scale, shift, weight, bias, residual, num_groups):
    """K4: ``(y, s, ss)``; the kernel on a CUDA tensor,
    ``_stats_reference`` on a CPU tensor."""
    if x.device.type == "cpu":
        affine_silu_conv_stats.plain_calls += 1
        return _stats_reference(x, scale, shift, weight, bias, residual, num_groups)
    out = _launch(x, scale, shift, weight, bias, residual, num_groups)
    affine_silu_conv_stats.kernel_launches += 1
    return out


def _recompute_grads(fn, inputs, grads, needs):
    """Gradients of ``fn(*inputs)`` (a tensor or a tuple) for the inputs
    that ``needs`` marks, by recomputing it with autograd on."""
    leaves = [t.detach().requires_grad_(need) if t is not None else None
              for t, need in zip(inputs, needs)]
    wrt = [t for t in leaves if t is not None and t.requires_grad]
    if not wrt:
        return (None,) * len(inputs)
    with torch.enable_grad():
        outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in leaves)


class _AffineSiluConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, weight, bias):
        ctx.save_for_backward(x, scale, shift, weight, bias)
        return affine_silu_conv(x, scale, shift, weight, bias)

    @staticmethod
    def backward(ctx, g):
        return _recompute_grads(_reference, ctx.saved_tensors, (g,),
                                ctx.needs_input_grad)


class _AffineSiluConvStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, weight, bias, residual, num_groups):
        ctx.num_groups = num_groups
        ctx.save_for_backward(x, scale, shift, weight, bias, residual)
        return affine_silu_conv_stats(x, scale, shift, weight, bias, residual,
                                      num_groups)

    @staticmethod
    def backward(ctx, gy, gs, gss):
        def ref(*args):
            return _stats_reference(*args, ctx.num_groups)

        grads = _recompute_grads(ref, ctx.saved_tensors, (gy, gs, gss),
                                 ctx.needs_input_grad[:6])
        return (*grads, None)


def fused_affine_silu_conv(x, scale, shift, weight, bias,
                           block_l: int = DEFAULT_BLOCK_L, interpret: bool = False):
    """``y = conv1d_k3(silu(x·scale + shift)) + bias``, x read once;
    differentiable.  ``block_l`` and ``interpret`` are the JAX signature's
    (the TPU tile and Pallas's interpret mode): the CUDA kernel tiles L
    itself, takes any L and loads its own halo, so neither changes y."""
    return _AffineSiluConv.apply(x, scale, shift, weight, bias)


def fused_affine_silu_conv_blocked(x, scale, shift, weight, bias,
                                   block_l: int = DEFAULT_BLOCK_L,
                                   interpret: bool = False):
    """K3b's entry: the same function and kernel as
    ``fused_affine_silu_conv`` (the TPU's block-local scheme and its
    boundary fix are not needed where the kernel loads its halo)."""
    return _AffineSiluConv.apply(x, scale, shift, weight, bias)


def fused_affine_silu_conv_stats(x, scale, shift, weight, bias, residual=None,
                                 num_groups: int = 8,
                                 block_l: int = DEFAULT_BLOCK_L,
                                 interpret: bool = False):
    """``(y, s, ss)``: K3's op plus ``residual`` and the (B, num_groups) f32
    sum and sum of squares of y before its cast; differentiable in every
    tensor, through s and ss too.  ``block_l`` and ``interpret`` as in
    ``fused_affine_silu_conv``."""
    return _AffineSiluConvStats.apply(x, scale, shift, weight, bias, residual,
                                      num_groups)


COUNTS = ("kernel_launches", "plain_calls")


def reset_counts() -> None:
    """Set the launch and plain-call counts of K3 and K4 to 0."""
    for fn in (affine_silu_conv, affine_silu_conv_stats):
        for name in COUNTS:
            setattr(fn, name, 0)


reset_counts()
