"""The taming-style conv encoder and decoder of SpecVQGAN (port of
``syncfusion_tpu/models/vqgan/autoencoder.py``).

Geometry of the reference codebook config: an 80 x 160 mel, ch 128, ch_mult
(1, 1, 2, 2, 4), so 4 downsamples to a 5 x 10 latent of z_channels 256,
attention at resolution 10, 2 res blocks a level.  GroupNorm takes
``min(32, C)`` groups with eps 1e-6, then swish; 1 x 1 ``nin_shortcut``
where the width changes; downsampling pads (0, 1) on H and W and runs a
stride-2 VALID 3 x 3 conv (a ``padding=1`` conv is not the same operation);
upsampling is nearest x2 then a 3 x 3 conv.

Layout: (B, C, H, W) with the mel axis as H, which is the JAX package's
channels-last (B, 80, 160, 1) moved across.  Submodules carry the Flax
names, so ``convert.vqgan_state_dict`` of a JAX tree loads with
``strict=True``.  The encoder's and decoder's ``resolution`` counts the W
(time) axis, as the JAX modules count it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=1e-6)


class ResnetBlock2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.GroupNorm_0 = group_norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.GroupNorm_1 = group_norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.GroupNorm_0(x)))
        h = self.conv2(F.silu(self.GroupNorm_1(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock2d(nn.Module):
    """Single-head self-attention over the H·W positions: softmax(q kᵀ /
    √C) v, in plain PyTorch as the JAX block runs it (no kernel of the
    port: its JAX counterpart runs outside Pallas)."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = group_norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.GroupNorm_0(x)
        q = self.q(hn).flatten(2).transpose(1, 2)  # (B, HW, C), h-major
        k = self.k(hn).flatten(2)                  # (B, C, HW)
        v = self.v(hn).flatten(2).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q, k) * (c ** -0.5), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample2d(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.Conv_0(F.pad(x, (0, 1, 0, 1)))


class Upsample2d(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.Conv_0(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder2d(nn.Module):
    """(B, 1, 80, 160) -> (B, z_channels, 5, 10) at the reference config."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (10,),
                 resolution: int = 160, z_channels: int = 256):
        super().__init__()
        self.conv_in = nn.Conv2d(1, ch, 3, padding=1)
        self.names = []
        c, res = ch, resolution
        for i, mult in enumerate(ch_mult):
            for j in range(num_res_blocks):
                self._add(f"down_{i}_block_{j}", ResnetBlock2d(c, ch * mult))
                c = ch * mult
                if res in attn_resolutions:
                    self._add(f"down_{i}_attn_{j}", AttnBlock2d(c))
            if i != len(ch_mult) - 1:
                self._add(f"down_{i}_downsample", Downsample2d(c))
                res //= 2
        self.mid_block_1 = ResnetBlock2d(c, c)
        self.mid_attn_1 = AttnBlock2d(c)
        self.mid_block_2 = ResnetBlock2d(c, c)
        self.norm_out = group_norm(c)
        self.conv_out = nn.Conv2d(c, z_channels, 3, padding=1)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.names.append(name)

    def forward(self, x):
        h = self.conv_in(x)
        for name in self.names:
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder2d(nn.Module):
    """(B, z_channels, h, w) -> (B, 1, 16h, 16w) at the reference
    config."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (10,),
                 resolution: int = 160, z_channels: int = 256):
        super().__init__()
        res = resolution // 2 ** (len(ch_mult) - 1)
        c = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, c, 3, padding=1)
        self.mid_block_1 = ResnetBlock2d(c, c)
        self.mid_attn_1 = AttnBlock2d(c)
        self.mid_block_2 = ResnetBlock2d(c, c)
        self.names = []
        for i in reversed(range(len(ch_mult))):
            for j in range(num_res_blocks + 1):
                self._add(f"up_{i}_block_{j}", ResnetBlock2d(c, ch * ch_mult[i]))
                c = ch * ch_mult[i]
                if res in attn_resolutions:
                    self._add(f"up_{i}_attn_{j}", AttnBlock2d(c))
            if i != 0:
                self._add(f"up_{i}_upsample", Upsample2d(c))
                res *= 2
        self.norm_out = group_norm(c)
        self.conv_out = nn.Conv2d(c, 1, 3, padding=1)

    _add = Encoder2d._add

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for name in self.names:
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h)))
