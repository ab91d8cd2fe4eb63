"""Weight-compatible twins of the reference's diffusion nets (port of
``syncfusion_tpu/models/adp_compat.py``).

``UNetV0Compat`` and ``Encoder1dCompat`` are the reference's
``audio_diffusion_pytorch.UNetV0`` (0.1.3, an a-unet XUNet with the time
and CFG plugins) and ``audio_encoders_pytorch.Encoder1d`` (0.0.22) as
``exp/model/diffusion.yaml`` configures them, parameter for parameter.
With ``models/adp_convert.py`` they take in the reference's published
Lightning checkpoint (``epoch=784-valid_loss=0.008.ckpt``), which is how
``evaluate_diffusion --ckpt X.ckpt`` evaluates the paper's model.

Submodules and parameters carry the JAX twins' Flax names, so
``convert.to_state_dict`` maps a JAX twin's tree (or ``adp_convert``'s)
onto them with ``strict=True``.  The transposed convolution's kernel is a
raw Flax parameter there, ``upsample_kernel`` (f, channels, out), and is
kept in that layout here: the generic rule of ``convert.convert_leaf``
only reorders leaves named ``kernel``.

Call contract, as the port's ``UNet1d`` and ``Encoder1d`` (so that
``SyncFusionDiffusion`` and the v-diffusion loss and samplers drive either
family unchanged):

  unet(x, sigma, context=..., embedding=..., embedding_cfg_mask=...,
       embedding_mask_proba=..., generator=...)   x (B, L, C), sigma (B,)
  encoder(x, with_info=True) -> (out, {"xs": [...]}); xs[2:-1] is the
  UNet's context pyramid, each (B, length, channels).

Activations run in the (B, C, L) layout inside.  Precision follows the JAX
twin's: parameters stay f32; convolutions and projections compute in
``dtype``; GroupNorm and LayerNorm (torch's eps, 1e-5) compute and return
at least f32; the time MLP stays f32.  The self-attention (levels with
``attentions``) is ``ops.attention.flash_attention``: K1 on the card (K2a
and K2b in its backward), its plain version on the CPU.  A single context
token (the CLAP embedding) makes the cross-attention's softmax identically
1, so its output is ``to_out(v)`` for every position (exact), as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from syncfusion_tpu_torch.models.adp_torch_recon import Encoder1dConfig, UNetV0Config
from syncfusion_tpu_torch.models.unet1d import cfg_dropout_mask
from syncfusion_tpu_torch.ops.attention import attention_reference, flash_attention

EPS = 1e-5  # torch's GroupNorm and LayerNorm epsilon, which the reference trained with


def _at_least_f32(x, weight):
    return x.to(torch.promote_types(x.dtype, weight.dtype))


class _Dense(nn.Module):
    """Flax ``Dense``: weight (out, in).  ``dtype=None`` computes in the
    promoted type of the input and the weight."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class _Conv(nn.Module):
    """Flax ``Conv`` with explicit padding on (B, C, L): weight (out, in, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride, padding=self.padding)


class _GroupNorm(nn.Module):
    """Flax ``GroupNorm`` without ``dtype`` on (B, C, L), eps 1e-5."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(_at_least_f32(x, self.weight), self.groups, self.weight,
                            self.bias, EPS)


class _LayerNorm(nn.Module):
    """Flax ``LayerNorm`` without ``dtype`` over the last axis, eps 1e-5."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(_at_least_f32(x, self.weight), self.weight.shape, self.weight,
                            self.bias, EPS)


def conv_transpose_torch(x, kernel, bias, stride: int):
    """torch's ``ConvTranspose1d`` (padding 0) on (B, C, L) with the JAX
    twin's kernel layout (k, in, out), which ``_conv_transpose_torch``
    flips along k and correlates with the stride-dilated input; torch's
    transposed convolution flips it itself, so the kernel goes in as it
    stands, permuted to (in, out, k)."""
    return F.conv_transpose1d(x, kernel.permute(1, 2, 0), bias, stride=stride)


class _Resnet(nn.Module):
    def __init__(self, channels: int, groups: int, dtype: torch.dtype):
        super().__init__()
        g = min(groups, channels)
        self.gn1 = _GroupNorm(g, channels)
        self.conv1 = _Conv(channels, channels, 3, padding=1, dtype=dtype)
        self.gn2 = _GroupNorm(g, channels)
        self.conv2 = _Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.gn1(x)))
        h = self.conv2(F.silu(self.gn2(h)))
        return h + x


class _Modulation(nn.Module):
    """GroupNorm(1) then FiLM ``gn(x)·(1 + scale) + shift``, [scale, shift]
    = Dense(SiLU(features)) (decision D9)."""

    def __init__(self, channels: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.to_scale_shift = _Dense(features, 2 * channels, dtype=dtype)
        self.norm = _GroupNorm(1, channels)

    def forward(self, x, features):
        scale, shift = self.to_scale_shift(F.silu(features))[:, :, None].chunk(2, dim=1)
        return self.norm(x) * (1.0 + scale) + shift


class _Attention(nn.Module):
    """Pre-LayerNorm attention with the residual inside (decision D8).
    ``context=None``: self-attention, q from ``norm(x)``, k and v from
    ``norm_context(x)``, through ``attend``: ``flash_attention``, which a
    caller may set on an instance (e.g. to ``attention_reference``) to
    compare the two on the card."""

    attend = staticmethod(flash_attention)

    def __init__(self, channels: int, heads: int, head_features: int,
                 context_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.head_features = heads, head_features
        mid = heads * head_features
        ctx_features = context_features or channels
        self.norm = _LayerNorm(channels)
        self.norm_context = _LayerNorm(ctx_features)
        self.to_q = _Dense(channels, mid, bias=False, dtype=dtype)
        self.to_kv = _Dense(ctx_features, 2 * mid, bias=False, dtype=dtype)
        self.to_out = _Dense(mid, channels, dtype=dtype)

    def forward(self, x, context=None):
        """x (B, C, L); context (B, tokens, features) or None."""
        tokens = x.transpose(1, 2)
        ctx = tokens if context is None else context
        k, v = self.to_kv(self.norm_context(ctx)).chunk(2, dim=-1)
        if ctx.shape[1] == 1:
            # softmax over one key is 1: every position gets to_out(v)
            return x + self.to_out(v).transpose(1, 2)
        b, length, _ = tokens.shape
        q = self.to_q(self.norm(tokens))
        shape = (b, -1, self.heads, self.head_features)
        attend = self.attend if context is None else attention_reference
        o = attend(q.view(shape), k.reshape(shape), v.reshape(shape))
        return x + self.to_out(o.reshape(b, length, -1)).transpose(1, 2)


class _Inject(nn.Module):
    """Conv k1 over [x, context] on channels, no residual (decision D6)."""

    def __init__(self, channels: int, ctx_channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = _Conv(channels + ctx_channels, channels, 1, dtype=dtype)

    def forward(self, x, ctx):
        """ctx (B, length, ctx_channels)."""
        return self.conv(torch.cat([x, ctx.transpose(1, 2).to(x.dtype)], 1))


class _MergeCat(nn.Module):
    """Conv k1 over [skip · skip_scale, x] (or [x, skip ·], ``cat_order``
    'x_first'): decision D4."""

    def __init__(self, channels: int, skip_scale: float, cat_order: str,
                 dtype: torch.dtype):
        super().__init__()
        self.skip_scale, self.cat_order = skip_scale, cat_order
        self.conv = _Conv(2 * channels, channels, 1, dtype=dtype)

    def forward(self, skip, x):
        pair = [skip * self.skip_scale, x]
        if self.cat_order == "x_first":
            pair = pair[::-1]
        return self.conv(torch.cat(pair, 1))


class _Block(nn.Module):
    """One XUNet level: downsample, the items down (each output a skip),
    the inner level, [merge, item] up, upsample (decisions D4, D10)."""

    def __init__(self, cfg: UNetV0Config, level: int, dtype: torch.dtype,
                 remat: bool = False):
        super().__init__()
        self.cfg, self.level, self.remat = cfg, level, remat
        n = len(cfg.channels)
        ch, f = cfg.channels[level], cfg.factors[level]
        in_ch = cfg.in_channels if level == 0 else cfg.channels[level - 1]
        out_ch = (cfg.out_channels or cfg.in_channels) if level == 0 else in_ch
        self.kinds = cfg.item_kinds(level)
        self.downsample = _Conv(in_ch, ch, f, stride=f, dtype=dtype)
        for j, kind in enumerate(self.kinds):
            self.add_module(f"items_down_{j}", self._item(kind, dtype))
        self.inner = _Block(cfg, level + 1, dtype, remat) if level + 1 < n else None
        if self.inner is not None:
            for j in range(len(self.kinds)):
                self.add_module(f"skip_adapters_{j}", _MergeCat(
                    ch, cfg.skip_scale, cfg.cat_order, dtype))
        for j, kind in enumerate(self.kinds):
            self.add_module(f"items_up_{j}", self._item(kind, dtype))
        self.upsample_kernel = nn.Parameter(torch.empty(f, ch, out_ch))
        self.upsample_bias = nn.Parameter(torch.zeros(out_ch))
        self.factor, self.dtype = f, dtype

    def _item(self, kind: str, dtype):
        cfg, lvl = self.cfg, self.level
        ch = cfg.channels[lvl]
        if kind == "res":
            return _Resnet(ch, cfg.resnet_groups, dtype)
        if kind == "mod":
            return _Modulation(ch, cfg.modulation_features, dtype)
        if kind == "inj":
            return _Inject(ch, cfg.context_channels[lvl], dtype)
        return _Attention(ch, cfg.attention_heads, cfg.attention_features,
                          cfg.embedding_features if kind == "xattn" else None, dtype)

    def _run_item(self, kind, item, x, features, embedding, context):
        if kind == "mod":
            return item(x, features)
        if kind == "inj":
            ctx = context[self.level] if len(context) > self.level else None
            return x if ctx is None else item(x, ctx)
        if kind == "xattn":
            return item(x, embedding)
        if kind == "res" and self.remat and torch.is_grad_enabled():
            return checkpoint(item, x, use_reentrant=False)
        return item(x)

    def forward(self, x, features, embedding, context):
        x = self.downsample(x)
        skips = []
        for j, kind in enumerate(self.kinds):
            x = self._run_item(kind, getattr(self, f"items_down_{j}"), x, features,
                            embedding, context)
            skips.append(x)
        if self.inner is not None:
            x = self.inner(x, features, embedding, context)
        for j, kind in enumerate(self.kinds):
            if self.inner is not None:
                x = getattr(self, f"skip_adapters_{j}")(skips[len(skips) - 1 - j], x)
            x = self._run_item(kind, getattr(self, f"items_up_{j}"), x, features,
                            embedding, context)
        dt = self.dtype
        return conv_transpose_torch(x.to(dt), self.upsample_kernel.to(dt),
                                    self.upsample_bias.to(dt), self.factor)


class UNetV0Compat(nn.Module):
    """audio-diffusion-pytorch 0.1.3 ``UNetV0``, weight-compatible.

    ``sigma`` is the diffusion time in [0, 1], embedded by the
    NumberEmbedder (decision D3: [t, sin, cos] of learned frequencies, a
    Dense) and a 2-layer exact-GELU MLP.  ``remat`` (the JAX twin's
    ``nn.remat(_Resnet)``): while gradients are on, each resnet item runs
    under ``torch.utils.checkpoint`` and is recomputed in the backward.
    """

    def __init__(self, cfg: UNetV0Config = UNetV0Config(),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        mf = cfg.modulation_features
        self.embedder_weights = nn.Parameter(torch.empty(cfg.fourier_dim // 2))
        self.embedder_to_out = _Dense(cfg.fourier_dim + 1, mf)
        self.mlp_0 = _Dense(mf, mf)
        self.mlp_1 = _Dense(mf, mf)
        if cfg.use_embedding_cfg:
            self.fixed_embedding = nn.Parameter(
                torch.empty(cfg.embedding_max_length, cfg.embedding_features))
        self.net = _Block(cfg, 0, dtype, remat)

    def time_features(self, sigma):
        """sigma (B,) -> the modulation features (B, modulation_features)."""
        t = sigma.to(torch.float32)[:, None]
        angles = t * self.embedder_weights[None, :] * (2.0 * math.pi)
        fourier = torch.cat([t.to(angles.dtype), torch.sin(angles), torch.cos(angles)], -1)
        h = F.gelu(self.embedder_to_out(fourier))
        return F.gelu(self.mlp_1(F.gelu(self.mlp_0(h))))

    def forward(self, x, sigma, *, context: Optional[Sequence] = None, embedding=None,
                embedding_cfg_mask=None, embedding_mask_proba: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """x (B, L, in_channels), sigma (B,); context: the encoder's
        ``xs[2:-1]`` (a level beyond it, or a None entry, is skipped);
        embedding (B, tokens, features) or None (the fixed embedding).
        ``embedding_cfg_mask`` (B, 1, 1): rows where it is 1 take the fixed
        embedding; without it ``embedding_mask_proba > 0`` draws that mask
        from ``generator`` (training's CFG dropout).  Returns (B, L, out)
        in f32 (f64 for an f64 model)."""
        cfg = self.cfg
        features = self.time_features(sigma)
        if cfg.use_embedding_cfg:
            fixed = self.fixed_embedding[None].expand(x.shape[0], -1, -1)
            if embedding is None:
                embedding = fixed
            else:
                if embedding_cfg_mask is None and embedding_mask_proba > 0.0:
                    embedding_cfg_mask = cfg_dropout_mask(
                        x.shape[0], embedding_mask_proba, generator, x.device)
                if embedding_cfg_mask is not None:
                    embedding = torch.where(embedding_cfg_mask.bool(), fixed, embedding)
        context = list(context) if context is not None else []
        h = self.net(x.to(self.dtype).transpose(1, 2), features, embedding, context)
        out = h.transpose(1, 2)
        return out.to(torch.promote_types(out.dtype, torch.float32))


class Encoder1dCompat(nn.Module):
    """audio-encoders-pytorch 0.0.22 ``Encoder1d``, weight-compatible:
    ``xs = [input, to_in(x), block_0(x), ...]`` (decision D11)."""

    def __init__(self, cfg: Encoder1dConfig = Encoder1dConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        chs = [cfg.channels * m for m in cfg.multipliers]
        self.to_in_gn = _GroupNorm(1, cfg.in_channels)
        self.to_in_conv = _Conv(cfg.in_channels, chs[0] // cfg.patch_size, 3, padding=1,
                                dtype=dtype)
        for i, f in enumerate(cfg.factors):
            oc = chs[i + 1]
            self.add_module(f"ds{i}_down", _Conv(chs[i], oc, 2 * f + 1, stride=f,
                                                 padding=f, dtype=dtype))
            g = min(cfg.resnet_groups, oc)
            for j in range(cfg.num_blocks[i]):
                for k in (1, 2):
                    self.add_module(f"ds{i}_b{j}_gn{k}", _GroupNorm(g, oc))
                    self.add_module(f"ds{i}_b{j}_conv{k}",
                                    _Conv(oc, oc, 3, padding=1, dtype=dtype))

    def forward(self, x, with_info: bool = False):
        """x (B, L, in_channels) -> the last map (B, length, channels), and
        with ``with_info`` also ``{"xs": [...]}``, each (B, length,
        channels)."""
        cfg = self.cfg
        xs = [x]
        h = self.to_in_conv(F.silu(self.to_in_gn(x.transpose(1, 2))))
        if cfg.patch_size > 1:
            b, c, length = h.shape
            p = cfg.patch_size
            h = h.transpose(1, 2).reshape(b, length // p, p, c).transpose(2, 3).reshape(
                b, length // p, c * p).transpose(1, 2)
        xs.append(h.transpose(1, 2))
        for i in range(len(cfg.factors)):
            h = getattr(self, f"ds{i}_down")(h)
            for j in range(cfg.num_blocks[i]):
                r = h
                h = getattr(self, f"ds{i}_b{j}_conv1")(F.silu(getattr(self, f"ds{i}_b{j}_gn1")(h)))
                h = getattr(self, f"ds{i}_b{j}_conv2")(F.silu(getattr(self, f"ds{i}_b{j}_gn2")(h)))
                h = h + r
            xs.append(h.transpose(1, 2))
        out = xs[-1]
        return (out, {"xs": xs}) if with_info else out


@torch.no_grad()
def init_compat(module: nn.Module, generator: torch.Generator) -> None:
    """Random parameters for the twins from ``generator``, with the JAX
    twins' distributions: kernels normal with variance 1/fan_in (Flax draws
    them truncated), zero biases, unit norm scales, normal(0, 1) Fourier
    frequencies and fixed embedding."""
    for m in module.modules():
        if isinstance(m, (_Dense, _Conv)):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (_GroupNorm, _LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, _Block):
            f, ch, _ = m.upsample_kernel.shape
            m.upsample_kernel.normal_(0.0, 1.0 / math.sqrt(f * ch), generator=generator)
            m.upsample_bias.zero_()
        elif isinstance(m, UNetV0Compat):
            m.embedder_weights.normal_(generator=generator)
            if m.cfg.use_embedding_cfg:
                m.fixed_embedding.normal_(generator=generator)
