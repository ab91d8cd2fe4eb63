"""1-D waveform diffusion UNet (port of ``syncfusion_tpu/models/unet1d.py``,
plain layout: no fused or folded paths).

Per-level channel concat of the onset-encoder context, self-attention at
the deep levels, cross-attention to the CLAP token at every level, and
classifier-free guidance through a learned fixed (unconditional) embedding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.core.config import UNetConfig
from syncfusion_tpu_torch.models.blocks import (
    Conv1d,
    CrossAttention1d,
    Downsample1d,
    FourierTimeEmbedding,
    GroupNorm,
    ResnetBlock1d,
    SelfAttention1d,
    Upsample1d,
)


def cfg_dropout_mask(batch: int, proba: float,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """(B, 1, 1) bool: rows that take the fixed embedding, each with
    probability ``proba`` (the JAX package draws the same Bernoulli from
    its ``cfg`` key; the bits differ, the distribution does not)."""
    u = torch.rand((batch, 1, 1), generator=generator, device=device)
    return u < proba


class UNet1d(nn.Module):
    """``context_levels``: how many levels receive a context map (the
    encoder's ``len(factors) - 1``).  Flax infers each level's input width
    from the arrays it is first called with; torch needs it up front."""

    def __init__(self, cfg: UNetConfig = UNetConfig(),
                 context_levels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        n = len(cfg.channels)
        self.context_levels = n if context_levels is None else context_levels
        # levels that concatenate a context map (JAX: map given and width > 0)
        self._with_context = [i < self.context_levels and cfg.context_channels[i] > 0
                              for i in range(n)]
        mod = cfg.modulation_features
        self.time_emb = FourierTimeEmbedding(mod)
        if cfg.use_embedding_cfg:
            self.fixed_embedding = nn.Parameter(
                torch.empty(cfg.embedding_max_length, cfg.embedding_features))

        def items(level, path, in_ch):
            ch = cfg.channels[level]
            for j in range(cfg.items[level]):
                self.add_module(f"{path}_res_{level}_{j}", ResnetBlock1d(
                    in_ch, ch, cfg.resnet_groups, mod, dtype))
                in_ch = ch
            if cfg.attentions[level]:
                self.add_module(f"{path}_attn_{level}", self._attn(in_ch))
            if cfg.cross_attentions[level]:
                self.add_module(f"{path}_xattn_{level}", self._xattn(in_ch))
            return in_ch

        ch = cfg.in_channels
        for i in range(n):
            self.add_module(f"down_{i}", Downsample1d(
                ch, cfg.channels[i], cfg.factors[i], dtype))
            ch = cfg.channels[i]
            if self._with_context[i]:
                ch += cfg.context_channels[i]
            ch = items(i, "down", ch)
        mid = cfg.channels[-1]
        self.mid_res_0 = ResnetBlock1d(mid, mid, cfg.resnet_groups, mod, dtype)
        self.mid_attn = self._attn(mid)
        self.mid_xattn = self._xattn(mid)
        self.mid_res_1 = ResnetBlock1d(mid, mid, cfg.resnet_groups, mod, dtype)
        ch = mid
        for i in reversed(range(n)):
            ch = items(i, "up", ch + cfg.channels[i])
            up_ch = cfg.channels[i - 1] if i > 0 else cfg.channels[0]
            self.add_module(f"up_{i}", Upsample1d(ch, up_ch, cfg.factors[i], dtype))
            ch = up_ch
        self.GroupNorm_0 = GroupNorm(min(cfg.resnet_groups, cfg.channels[0]),
                                     cfg.channels[0], dtype)
        self.head = Conv1d(cfg.channels[0], cfg.out_channels or cfg.in_channels,
                           3, dtype=dtype)

    def _attn(self, ch):
        return SelfAttention1d(ch, self.cfg.attention_heads,
                               self.cfg.attention_features, self.dtype)

    def _xattn(self, ch):
        c = self.cfg
        return CrossAttention1d(ch, c.embedding_features, c.attention_heads,
                                c.attention_features, c.embedding_max_length,
                                self.dtype)

    def _items(self, h, level, path, time_emb, embedding):
        c = self.cfg
        for j in range(c.items[level]):
            h = getattr(self, f"{path}_res_{level}_{j}")(h, time_emb)
        if c.attentions[level]:
            h = getattr(self, f"{path}_attn_{level}")(h)
        if c.cross_attentions[level] and embedding is not None:
            h = getattr(self, f"{path}_xattn_{level}")(h, embedding)
        return h

    def forward(self, x, sigma, *, context: Optional[Sequence] = None,
                embedding=None, embedding_cfg_mask=None,
                embedding_mask_proba: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """x (B, L, in_channels), sigma (B,), context: the encoder's
        ``xs[2:-1]`` (each (B, length, channels)), embedding (B, tokens,
        features) or None.  ``embedding_cfg_mask`` (B, 1, 1): rows where it
        is 1 use the fixed (unconditional) embedding.  Without a mask,
        ``embedding_mask_proba > 0`` is the training-time CFG dropout: each
        row takes the fixed embedding with that probability, drawn from
        ``generator``.  Returns (B, L, out) in f32."""
        c = self.cfg
        n = len(c.channels)
        context = list(context) if context is not None else []
        if len(context) != self.context_levels:
            raise ValueError(f"built for {self.context_levels} context maps, "
                             f"got {len(context)}")
        time_emb = self.time_emb(sigma.float())

        if c.use_embedding_cfg:
            fixed = self.fixed_embedding[None].expand(x.shape[0], -1, -1)
            if embedding is None:
                embedding = fixed
            else:
                if embedding_cfg_mask is None and embedding_mask_proba > 0.0:
                    embedding_cfg_mask = cfg_dropout_mask(
                        x.shape[0], embedding_mask_proba, generator, x.device)
                if embedding_cfg_mask is not None:
                    embedding = torch.where(embedding_cfg_mask.bool(), fixed,
                                            embedding)

        h = x.to(self.dtype).transpose(1, 2)
        skips = []
        for i in range(n):
            h = getattr(self, f"down_{i}")(h)
            if self._with_context[i]:
                h = torch.cat([h, context[i].to(h.dtype).transpose(1, 2)], 1)
            h = self._items(h, i, "down", time_emb, embedding)
            skips.append(h)

        h = self.mid_res_0(h, time_emb)
        h = self.mid_attn(h)
        if embedding is not None:
            h = self.mid_xattn(h, embedding)
        h = self.mid_res_1(h, time_emb)

        for i in reversed(range(n)):
            h = torch.cat([h, skips[i]], 1)
            h = self._items(h, i, "up", time_emb, embedding)
            h = getattr(self, f"up_{i}")(h)

        out = self.head(F.silu(self.GroupNorm_0(h)))
        return out.transpose(1, 2).float()
