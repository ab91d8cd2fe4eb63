"""Onset-track 1-D conv encoder (port of ``syncfusion_tpu/models/encoder1d.py``).

Encodes the binary onset track into a pyramid of feature maps, ``xs =
[input, stem_out, block_0_out, ..., block_{n-1}_out]``; ``xs[2:-1]`` is the
UNet's per-level context.
"""

from __future__ import annotations

import torch
from torch import nn

from syncfusion_tpu_torch.core.config import EncoderConfig
from syncfusion_tpu_torch.models.blocks import Conv1d, Downsample1d, ResnetBlock1d


class Encoder1d(nn.Module):
    def __init__(self, cfg: EncoderConfig = EncoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        assert len(cfg.factors) == len(cfg.num_blocks) == len(cfg.multipliers) - 1
        self.cfg = cfg
        ch = cfg.channels * cfg.multipliers[0]
        self.stem = Conv1d(cfg.in_channels * cfg.patch_size, ch, 7, dtype=dtype)
        for i, (factor, n_blocks) in enumerate(zip(cfg.factors, cfg.num_blocks)):
            out = cfg.channels * cfg.multipliers[i + 1]
            self.add_module(f"down_{i}", Downsample1d(ch, out, factor, dtype))
            for j in range(n_blocks):
                self.add_module(f"block_{i}_{j}", ResnetBlock1d(
                    out, out, groups=cfg.resnet_groups, dtype=dtype))
            ch = out

    def forward(self, x):
        """x: (B, L, in_channels) -> ``xs``, each (B, length, channels)."""
        cfg = self.cfg
        xs = [x]
        if cfg.patch_size > 1:
            b, length, c = x.shape
            x = x.reshape(b, length // cfg.patch_size, c * cfg.patch_size)
        h = self.stem(x.transpose(1, 2))
        xs.append(h.transpose(1, 2))
        for i, n_blocks in enumerate(cfg.num_blocks):
            h = getattr(self, f"down_{i}")(h)
            for j in range(n_blocks):
                h = getattr(self, f"block_{i}_{j}")(h)
            xs.append(h.transpose(1, 2))
        return xs
