"""1-D waveform diffusion UNet (port of ``syncfusion_tpu/models/unet1d.py``).

Per-level channel concat of the onset-encoder context, self-attention at
the deep levels, cross-attention to the CLAP token at every level, and
classifier-free guidance through a learned fixed (unconditional) embedding.

Activations stay in the plain (B, C, L) layout: the JAX package's folded
layout (``unet1d_folded.py``) only avoids the TPU's 128-lane padding and
is numerically the plain UNet.  What the port carries over of the fused
and folded execution:
  * ``fused_resnet``: each resnet block that passes the JAX block's gate
    runs its two GN -> (FiLM) -> SiLU -> conv chains through K3;
  * ``fused_stats`` with ``fold_cap``: the levels that the JAX folded apply
    folds (``compute_folds``) run each resnet block as two K4 calls, the
    group sums threaded from block to block within a level, as
    ``unet1d_folded.folded_apply`` does.  The other levels keep their own
    gate; the bottleneck's blocks are never fused.
  * the DeepCache split of ``unet1d_folded.folded_apply`` (``deep_split``,
    ``deep_cache``, ``return_deep``), its feature in the (B, C, L) layout.

``remat`` (the JAX ``nn.remat(ResnetBlock1d)``): while gradients are on,
each resnet block of the levels runs under ``torch.utils.checkpoint``, so
the backward recomputes it (K3/K4 launch again there) instead of keeping
its activations; attention and the bottleneck's blocks are kept, as in
JAX.  A K4 block's group sums leave it as outputs, so the chain of sums
crosses the checkpointed blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def compute_folds(cfg: UNetConfig, fold_cap: int, length: int) -> list[int]:
    """Per-level fold factors of the JAX package's folded apply (1 =
    unfolded; a copy of ``unet1d_folded.compute_folds``): the deepest
    attention-free level D whose folded widths stay within ``fold_cap``
    lanes and whose lengths stay divisible; f_D = factors[D+1], f_i =
    f_{i+1}·factors[i+1]."""
    n = len(cfg.channels)
    multi_token = cfg.embedding_max_length != 1
    lengths = []
    level_len = length
    for j in range(n):
        if level_len % cfg.factors[j]:
            return [1] * n
        level_len //= cfg.factors[j]
        lengths.append(level_len)

    best = [1] * n
    for d in range(n - 1):
        if cfg.factors[d + 1] == 1:
            continue
        folds = [1] * n
        folds[d] = cfg.factors[d + 1]
        for i in range(d - 1, -1, -1):
            folds[i] = folds[i + 1] * cfg.factors[i + 1]
        ok = True
        for j in range(d + 1):
            width = max(cfg.channels[j] + (cfg.context_channels[j] or 0),
                        2 * cfg.channels[j]) * folds[j]
            if (cfg.attentions[j] or (cfg.cross_attentions[j] and multi_token)
                    or width > fold_cap or lengths[j] % folds[j] != 0):
                ok = False
                break
        if ok:
            best = folds
    return best


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
                    in_ch, ch, cfg.resnet_groups, mod, dtype,
                    fused=cfg.fused_resnet, fused_block_l=cfg.fused_block_l))
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

    def stats_levels(self, length: int) -> list[bool]:
        """Which levels run their resnet blocks through K4 at input
        ``length``: those the JAX folded apply folds, when ``fused_stats``."""
        c = self.cfg
        if not c.fused_stats:
            return [False] * len(c.channels)
        return [f > 1 for f in compute_folds(c, c.fold_cap, length)]

    def _items(self, h, level, path, time_emb, embedding, with_stats=False):
        c = self.cfg
        stats = None  # the group sums, threaded block to block (K4)
        for j in range(c.items[level]):
            block = getattr(self, f"{path}_res_{level}_{j}")
            fn = block.forward_stats if with_stats else block
            args = (h, time_emb, stats) if with_stats else (h, time_emb)
            if c.remat and torch.is_grad_enabled():
                out = checkpoint(fn, *args, use_reentrant=False)
            else:
                out = fn(*args)
            h, stats = out if with_stats else (out, None)
        if c.attentions[level]:
            h = getattr(self, f"{path}_attn_{level}")(h)
        if c.cross_attentions[level] and embedding is not None:
            h = getattr(self, f"{path}_xattn_{level}")(h, embedding)
        return h

    def forward(self, x, sigma, *, context: Optional[Sequence] = None,
                embedding=None, embedding_cfg_mask=None,
                embedding_mask_proba: float = 0.0,
                generator: Optional[torch.Generator] = None,
                deep_split: int = 0, deep_cache: Optional[torch.Tensor] = None,
                return_deep: bool = False):
        """x (B, L, in_channels), sigma (B,), context: the encoder's
        ``xs[2:-1]`` (each (B, length, channels)), embedding (B, tokens,
        features) or None.  ``embedding_cfg_mask`` (B, 1, 1): rows where it
        is 1 use the fixed (unconditional) embedding.  Without a mask,
        ``embedding_mask_proba > 0`` is the training-time CFG dropout: each
        row takes the fixed embedding with that probability, drawn from
        ``generator``.  Returns (B, L, out) in f32 (f64 for an f64 model).

        DeepCache (Ma et al. 2023, arXiv:2312.00858): ``deep_split=S`` in
        [1, n-1] splits the net at level S.  Without ``deep_cache`` the whole
        net runs, and ``return_deep`` also returns the deep feature: the
        output of ``up_S``, which enters level S-1's concat, (B, channels[S-1],
        length at level S-1).  With ``deep_cache`` (that feature from an
        earlier call) levels S..n-1, the bottleneck and their up path are
        skipped: the down path runs levels 0..S-1, the cache takes the place
        of ``up_S``'s output, and the up path runs S-1..0 and the head.
        """
        c = self.cfg
        n = len(c.channels)
        if deep_split and not 1 <= deep_split <= n - 1:
            raise ValueError(f"deep_split must be in [1, {n - 1}], got {deep_split}")
        if (deep_cache is not None or return_deep) and not deep_split:
            raise ValueError("deep_cache and return_deep require deep_split")
        cached = deep_cache is not None
        n_down = deep_split if cached else n
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

        with_stats = self.stats_levels(x.shape[1])
        h = x.to(self.dtype).transpose(1, 2)
        skips = []
        for i in range(n_down):
            h = getattr(self, f"down_{i}")(h)
            if self._with_context[i]:
                h = torch.cat([h, context[i].to(h.dtype).transpose(1, 2)], 1)
            h = self._items(h, i, "down", time_emb, embedding, with_stats[i])
            skips.append(h)

        deep = deep_cache
        if cached:
            h = deep_cache.to(self.dtype)
        else:
            h = self.mid_res_0(h, time_emb)
            h = self.mid_attn(h)
            if embedding is not None:
                h = self.mid_xattn(h, embedding)
            h = self.mid_res_1(h, time_emb)

        for i in reversed(range(n_down)):
            h = torch.cat([h, skips[i]], 1)
            h = self._items(h, i, "up", time_emb, embedding, with_stats[i])
            h = getattr(self, f"up_{i}")(h)
            if deep_split and i == deep_split and deep is None:
                deep = h

        out = self.head(F.silu(self.GroupNorm_0(h)))
        out = out.transpose(1, 2)
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        return (out, deep) if return_deep else out
