"""Swin-Transformer blocks of the HTSAT audio tower (port of
``syncfusion_tpu/models/clap/swin.py``).

Swin v1: windowed multi-head self-attention with a learned relative-position
bias, shifted windows on odd blocks, patch merging between stages, on fixed
square inputs (HTSAT: 64x64 tokens after the patch embed, window 8).  Tokens
are ``(B, H·W, C)`` channels-last, as in the JAX package.

The attention is over 64-token windows with a bias table and a mask: plain
``torch.matmul`` and softmax, as the JAX package computes it outside any
Pallas kernel.  Submodules carry the Flax names, so ``convert.clap_state_dict``
of a JAX tree loads with ``strict=True``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B·nW, ws·ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, ws·ws, C) -> (B, H, W, C)."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2·ws-1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) mask of SW-MSA: -100 where two tokens come from
    different pre-shift windows, else 0."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    win = win.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Fused qkv, q scaled by head_dim^-0.5 before the product, the bias
    table indexed per head, the mask added per window, softmax, proj."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b_, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)  # (B_, nh, n, n)
        bias = self.relative_position_bias_table[self.index].reshape(n, n, nh)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, nh, n, n)
        out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> residual -> LN -> MLP (exact
    GELU) -> residual.  Odd blocks shift by ``window // 2`` (``torch.roll``);
    no shift where the window covers the whole resolution."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int,
                 window_size: int = 8, shift_size: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.res = input_resolution
        self.ws = min(window_size, input_resolution)
        self.shift = 0 if self.ws >= input_resolution else shift_size
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, self.ws, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        if self.shift:
            self.register_buffer("mask", torch.from_numpy(shifted_window_mask(
                self.res, self.res, self.ws, self.shift)), persistent=False)
        else:
            self.mask = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = w = self.res
        b, length, c = x.shape
        s = self.shift
        y = self.norm1(x).reshape(b, h, w, c)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = self.attn(window_partition(y, self.ws), self.mask)
        y = window_reverse(y, self.ws, h, w)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y.reshape(b, length, c)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in the order (0,0), (1,0), (0,1), (1,1)
    of (row, column), LN, bias-free reduction 4C -> 2C."""

    def __init__(self, input_resolution: int, dim: int):
        super().__init__()
        self.res = input_resolution
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = w = self.res
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, (h // 2) * (w // 2), 4 * c)))


class SwinStage(nn.Module):
    """``depth`` blocks (shifted on odd ones), then an optional merge."""

    def __init__(self, dim: int, input_resolution: int, depth: int, num_heads: int,
                 window_size: int = 8, downsample: bool = False):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks_{i}", SwinBlock(
                dim, input_resolution, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2))
        self.downsample = PatchMerging(input_resolution, dim) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
        return x if self.downsample is None else self.downsample(x)
