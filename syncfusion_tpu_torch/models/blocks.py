"""Building blocks of the 1-D audio models (port of
``syncfusion_tpu/models/blocks.py``).

Layout: the blocks work on ``(batch, channels, length)`` tensors, the
layout torch's convolutions take; the models transpose once at their edges
so that their public functions keep the JAX package's (batch, length,
channels).  Submodules and parameters carry the Flax names, so a converted
Flax tree (``syncfusion_tpu_torch.convert``) loads with ``strict=True``.

Precision follows Flax's ``dtype`` semantics: parameters stay f32; a layer
built with ``dtype=bfloat16`` casts its input, weight and bias to bf16 and
returns bf16; GroupNorm takes its statistics in f32 and returns ``dtype``;
the time embedding and the FiLM projection stay f32 (their Flax Dense has
no ``dtype``).  Where rounding differs from Flax: torch adds a conv's or
linear's bias before rounding the sum to bf16 once, Flax rounds the product
to bf16 and then adds the bias in bf16; and torch's SiLU on bf16 computes
in f32 and rounds once.  Both are within bf16's last bit per op.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.ops.attention import attention_reference, flash_attention
from syncfusion_tpu_torch.ops.fused_resblock import (
    fold_groupnorm_film,
    fused_affine_silu_conv_blocked,
    fused_affine_silu_conv_stats,
    group_stats,
    stats_affine,
)

GN_EPS = 1e-6  # Flax GroupNorm's epsilon (torch's default is 1e-5)
# the JAX block's fused gate: narrower channels lost on the TPU (its
# fused_min_ch default, which no caller changes)
FUSED_MIN_CH = 32


def gn_groups(channels: int, groups: int) -> int:
    """Largest group count <= ``groups`` that divides ``channels``."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def same_padding(length: int, kernel: int, stride: int = 1) -> tuple[int, int]:
    """XLA's SAME padding (left, right): uneven totals put the extra sample
    on the right, which ``Conv1d(padding=...)`` cannot express."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class Linear(nn.Module):
    """Flax ``Dense``: weight (out, in) in torch's layout.  ``dtype=None``
    computes, as a Flax ``Dense`` without ``dtype`` does, in the promoted
    type of the input and the parameters."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv1d(nn.Module):
    """Flax ``Conv`` with SAME padding: weight (out, in, kernel)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.stride = stride
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        k = self.weight.shape[-1]
        x = F.pad(x.to(dt), same_padding(x.shape[-1], k, self.stride))
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv1d(x, self.weight.to(dt), bias, stride=self.stride)


class ConvTranspose1d(nn.Module):
    """Flax ``ConvTranspose`` (SAME padding, ``transpose_kernel=False``).

    Flax correlates the stride-dilated input with the kernel as it stands;
    torch's ``conv_transpose1d`` flips the kernel.  The weight is kept in
    torch's (in, out, kernel) layout already flipped (the converter flips
    the Flax kernel), the full transposed convolution is taken, and the
    window that XLA's SAME padding selects is cut out of it.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.stride = stride
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        k, s = self.weight.shape[-1], self.stride
        # lax.conv_transpose's SAME padding of the dilated input
        pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        y = F.conv_transpose1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                               stride=s)
        start = k - 1 - pad_a
        return y[..., start:start + x.shape[-1] * s]


class GroupNorm(nn.Module):
    """Flax ``GroupNorm``: statistics in the parameters' type (f32; f64 for
    a model cast to f64), eps 1e-6, output in ``dtype``."""

    def __init__(self, groups: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        return F.group_norm(x, self.groups, self.weight, self.bias,
                            GN_EPS).to(self.dtype)


class FourierTimeEmbedding(nn.Module):
    """sigma (B,) -> (B, features) via learned random-Fourier features."""

    def __init__(self, features: int, fourier_dim: int = 128):
        super().__init__()
        self.freqs = nn.Parameter(torch.empty(fourier_dim // 2))
        self.Dense_0 = Linear(fourier_dim + 1, features)
        self.Dense_1 = Linear(features, features)

    def forward(self, sigma):
        angles = 2.0 * math.pi * sigma[:, None] * self.freqs[None, :]
        h = torch.cat([torch.sin(angles), torch.cos(angles), sigma[:, None]], -1)
        return self.Dense_1(F.silu(self.Dense_0(h)))


class ResnetBlock1d(nn.Module):
    """GN -> (FiLM) -> SiLU -> conv(k3), GN -> SiLU -> conv(k3), residual
    (``time_features`` adds the FiLM projection of the time embedding to
    ``(1 + scale, shift)``).

    ``fused=True`` runs both GN -> (FiLM) -> SiLU -> conv chains through
    K3 (``ops/fused_resblock``) where the JAX block's gate admits it:
    ``L % fused_block_l == 0`` and ``FUSED_MIN_CH <= in_channels, channels
    <= 128``; elsewhere the plain path.  ``forward_stats`` is the
    producer-side-statistics path of the JAX package's
    ``unet1d_folded._folded_resnet_stats``: two K4 calls that emit the
    group sums the next GroupNorm needs.  Parameters are the same on every
    path.
    """

    def __init__(self, in_channels: int, channels: int, groups: int = 8,
                 time_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 fused_block_l: int = 4096):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(gn_groups(in_channels, groups), in_channels, dtype)
        self.GroupNorm_1 = GroupNorm(gn_groups(channels, groups), channels, dtype)
        self.conv1 = Conv1d(in_channels, channels, 3, dtype=dtype)
        self.conv2 = Conv1d(channels, channels, 3, dtype=dtype)
        self.film = (Linear(time_features, 2 * in_channels)
                     if time_features else None)
        self.skip_proj = (Conv1d(in_channels, channels, 1, bias=False, dtype=dtype)
                          if in_channels != channels else None)
        self.fused, self.fused_block_l = fused, fused_block_l

    def uses_fused(self, length: int) -> bool:
        """The JAX block's gate for the fused path at sequence ``length``."""
        in_ch, ch = self.conv1.weight.shape[1], self.conv1.weight.shape[0]
        return (self.fused and length % self.fused_block_l == 0
                and FUSED_MIN_CH <= in_ch <= 128 and FUSED_MIN_CH <= ch <= 128)

    def _film(self, time_emb, batch: int, device):
        """FiLM (scale, shift), each (B, in_channels) f32; zeros without."""
        if self.film is None:
            zero = torch.zeros(batch, self.conv1.weight.shape[1], device=device)
            return zero, zero
        return self.film(F.silu(time_emb)).chunk(2, dim=-1)

    def _residual(self, x):
        return x if self.skip_proj is None else self.skip_proj(x)

    def forward(self, x, time_emb=None):
        if self.uses_fused(x.shape[-1]):
            return self._fused(x, time_emb)
        h = self.GroupNorm_0(x)
        if self.film is not None:
            scale, shift = self.film(F.silu(time_emb)).chunk(2, dim=-1)
            h = h.to(scale.dtype) * (1.0 + scale[:, :, None]) + shift[:, :, None]
        h = self.conv1(F.silu(h))
        h = self.conv2(F.silu(self.GroupNorm_1(h)))
        return h + self._residual(x)

    def _kernel_weight(self, conv):
        """conv's weight as the ops take it: (3, C, Cout) in the compute
        dtype (a view; rounded as the plain conv rounds it)."""
        return conv.weight.to(self.conv1.dtype).permute(2, 1, 0)

    def _fused(self, x, time_emb):
        """The JAX block's ``_fused_path``: GN stats folded with gamma/beta
        and FiLM into a per-(batch, channel) affine, then K3, twice."""
        gn0, gn1 = self.GroupNorm_0, self.GroupNorm_1
        fs, ft = self._film(time_emb, x.shape[0], x.device)
        xt = x.transpose(1, 2)
        scale, shift = fold_groupnorm_film(xt, gn0.weight, gn0.bias, fs, ft,
                                           gn0.groups)
        h = fused_affine_silu_conv_blocked(xt, scale, shift,
                                           self._kernel_weight(self.conv1),
                                           self.conv1.bias, self.fused_block_l)
        zero = torch.zeros(h.shape[0], h.shape[-1], device=h.device)
        scale, shift = fold_groupnorm_film(h, gn1.weight, gn1.bias, zero, zero,
                                           gn1.groups)
        h = fused_affine_silu_conv_blocked(h, scale, shift,
                                           self._kernel_weight(self.conv2),
                                           self.conv2.bias, self.fused_block_l)
        return h.transpose(1, 2) + self._residual(x)

    def forward_stats(self, x, time_emb=None, in_stats=None):
        """``(out, (s, ss))``: the block through two K4 calls.  ``in_stats``:
        the (B, G) sum and sum of squares of x from the previous block's
        conv2, or None at a chain start, where one plain reduction makes
        them.  The returned sums are grouped for the next block's GN_0."""
        gn0, gn1 = self.GroupNorm_0, self.GroupNorm_1
        length = x.shape[-1]
        fs, ft = self._film(time_emb, x.shape[0], x.device)
        xt = x.transpose(1, 2)
        s, ss = group_stats(xt, gn0.groups) if in_stats is None else in_stats
        scale, shift = stats_affine(s, ss, length * (x.shape[1] // gn0.groups),
                                    gn0.weight, gn0.bias, gn0.groups, fs, ft)
        h, s, ss = fused_affine_silu_conv_stats(
            xt, scale, shift, self._kernel_weight(self.conv1), self.conv1.bias,
            num_groups=gn1.groups)
        channels = h.shape[-1]
        scale, shift = stats_affine(s, ss, length * (channels // gn1.groups),
                                    gn1.weight, gn1.bias, gn1.groups)
        out, s, ss = fused_affine_silu_conv_stats(
            h, scale, shift, self._kernel_weight(self.conv2), self.conv2.bias,
            residual=self._residual(x).transpose(1, 2), num_groups=gn1.groups)
        return out.transpose(1, 2), (s, ss)


class SelfAttention1d(nn.Module):
    """Pre-norm multi-head self-attention with residual (no FF).

    The attention itself is ``flash_attention``: the CUDA kernel on the
    card, the plain version on the CPU.  ``attend`` is the function used;
    a caller may set it on an instance (e.g. to ``attention_reference``)
    to compare the two on the card.
    """

    attend = staticmethod(flash_attention)

    def __init__(self, channels: int, heads: int = 8, head_features: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.head_features = heads, head_features
        inner = heads * head_features
        self.GroupNorm_0 = GroupNorm(gn_groups(channels, 8), channels, dtype)
        self.qkv = Linear(channels, 3 * inner, dtype)  # rows ordered (3, H, D)
        self.out = Linear(inner, channels, dtype)

    def forward(self, x):
        b, _, length = x.shape
        h = self.GroupNorm_0(x).transpose(1, 2)
        qkv = self.qkv(h).view(b, length, 3, self.heads, self.head_features)
        q, k, v = qkv.unbind(2)
        o = self.attend(q, k, v).reshape(b, length, -1)
        return x + self.out(o).transpose(1, 2)


class CrossAttention1d(nn.Module):
    """Cross-attention from the sequence to embedding tokens, with residual.

    With a single context token (this model's case: one CLAP token) the
    softmax over one key is identically 1, so the output is ``out(v(emb))``
    for every position: it is computed once per row and broadcast, and the
    query and key projections are never needed (nor created, as in Flax).
    """

    def __init__(self, channels: int, context_features: int, heads: int = 8,
                 head_features: int = 64, tokens: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.head_features = heads, head_features
        inner = heads * head_features
        self.GroupNorm_0 = GroupNorm(gn_groups(channels, 8), channels, dtype)
        self.v = Linear(context_features, inner, dtype)
        self.out = Linear(inner, channels, dtype)
        if tokens > 1:
            self.q = Linear(channels, inner, dtype)
            self.k = Linear(context_features, inner, dtype)

    def forward(self, x, context):
        v = self.v(context)
        if context.shape[1] == 1:
            return x + self.out(v).transpose(1, 2)
        b, _, length = x.shape
        shape = (b, -1, self.heads, self.head_features)
        q = self.q(self.GroupNorm_0(x).transpose(1, 2)).view(shape)
        k = self.k(context).view(shape)
        o = attention_reference(q, k, v.view(shape)).reshape(b, length, -1)
        return x + self.out(o).transpose(1, 2)


class Downsample1d(nn.Module):
    """Strided conv downsample by ``factor`` (kernel 2·factor)."""

    def __init__(self, in_channels: int, channels: int, factor: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = (Conv1d(in_channels, channels, 3, dtype=dtype) if factor == 1
                       else Conv1d(in_channels, channels, 2 * factor,
                                   stride=factor, dtype=dtype))

    def forward(self, x):
        return self.Conv_0(x)


class Upsample1d(nn.Module):
    """Transposed-conv upsample by ``factor`` (kernel 2·factor)."""

    def __init__(self, in_channels: int, channels: int, factor: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if factor == 1:
            self.Conv_0 = Conv1d(in_channels, channels, 3, dtype=dtype)
        else:
            self.ConvTranspose_0 = ConvTranspose1d(
                in_channels, channels, 2 * factor, factor, dtype=dtype)

    def forward(self, x):
        conv = self.Conv_0 if hasattr(self, "Conv_0") else self.ConvTranspose_0
        return conv(x)
