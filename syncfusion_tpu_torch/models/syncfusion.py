"""SyncFusion diffusion system: UNet + onset encoder (port of
``syncfusion_tpu/models/syncfusion.py``).

The encoder's intermediate activations ``xs[2:-1]`` are the UNet's
per-level context; they are computed once per clip, outside the sampler's
step loop.  Parameters are f32; ``dtype`` is the compute type (bf16 for
generation, as the JAX package's ``from_config(dtype=bfloat16)``).
The UNet's fused configuration (``fused_resnet``, ``fused_stats`` at
``fold_cap``) comes from the config, as in the JAX package.

``compat`` (or the config's top-level ``compat: true``) builds the a-unet
weight-compatible twins of ``models/adp_compat.py`` in place of
``UNet1d``/``Encoder1d``, as the JAX ``from_config`` does: the reference's
published checkpoints load into them (``models/adp_convert.py``).  The
loss and both samplers drive either family; DeepCache and the fused
resnet chain exist only for ``UNet1d`` and raise ``ValueError`` with the
twins, as the JAX package refuses them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig, model_configs
from syncfusion_tpu_torch.device import default_device
from syncfusion_tpu_torch.models import blocks
from syncfusion_tpu_torch.models.adp_compat import Encoder1dCompat, UNetV0Compat, init_compat
from syncfusion_tpu_torch.models.adp_torch_recon import Encoder1dConfig, UNetV0Config
from syncfusion_tpu_torch.models.diffusion import dpm_sample, v_diffusion_loss, v_sample
from syncfusion_tpu_torch.models.encoder1d import Encoder1d
from syncfusion_tpu_torch.models.unet1d import UNet1d


class SyncFusionDiffusion(nn.Module):
    """``unet_cfg``/``encoder_cfg``: ``UNetConfig``/``EncoderConfig`` for
    the port's UNet1d family, ``UNetV0Config``/``Encoder1dConfig`` for the
    a-unet twins."""

    def __init__(self, unet_cfg: UNetConfig | UNetV0Config = UNetConfig(),
                 encoder_cfg: EncoderConfig | Encoder1dConfig = EncoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if isinstance(unet_cfg, UNetV0Config):
            self.unet = UNetV0Compat(unet_cfg, dtype=dtype)
            self.onsets_encoder = Encoder1dCompat(encoder_cfg, dtype=dtype)
        else:
            self.unet = UNet1d(unet_cfg, context_levels=len(encoder_cfg.factors) - 1,
                               dtype=dtype)
            self.onsets_encoder = Encoder1d(encoder_cfg, dtype=dtype)

    @property
    def compat(self) -> bool:
        """Whether the model is the a-unet twin pair."""
        return isinstance(self.unet, UNetV0Compat)

    @classmethod
    def from_config(cls, model_cfg: Optional[dict] = None,
                    dtype: torch.dtype = torch.float32, device=None,
                    seed: int = 0, fold_cap: Optional[int] = None,
                    fused_stats: Optional[bool] = None,
                    compat: Optional[bool] = None) -> "SyncFusionDiffusion":
        """Build from an ``exp/model/diffusion.yaml``-style ``model`` node
        (the defaults when None) on ``device`` (the card when None; raises
        without one), with parameters drawn from ``seed``.  ``fold_cap`` and
        ``fused_stats``, when given, override the node's top-level
        ``fold_cap`` and ``model.fused_stats`` (the JAX ``from_config``'s
        keywords).  ``compat`` (default: the node's top-level ``compat``)
        builds the a-unet twins; with them a fused switch raises
        ``ValueError`` (``fold_cap`` alone changes nothing, as it does not
        in JAX)."""
        device = default_device(device)
        if compat is None:
            compat = bool(model_cfg and model_cfg.get("compat", False))
        unet_cfg, encoder_cfg = model_configs(model_cfg)
        if compat:
            if fused_stats or unet_cfg.fused_stats or unet_cfg.fused_resnet:
                raise ValueError("the fused resnet chain (fused_resnet, fused_stats) "
                                 "runs in UNet1d only, not in the a-unet compat twins")
            unet_cfg, encoder_cfg = (
                (UNetV0Config(), Encoder1dConfig()) if model_cfg is None else
                (UNetV0Config.from_node(model_cfg["model"]),
                 Encoder1dConfig.from_node(model_cfg["onsets_encoder"])))
        else:
            overrides = {k: v for k, v in (("fold_cap", fold_cap),
                                           ("fused_stats", fused_stats)) if v is not None}
            unet_cfg = dataclasses.replace(unet_cfg, **overrides)
        with torch.device(device):
            model = cls(unet_cfg, encoder_cfg, dtype=dtype)
        return model.init(seed).eval()

    @torch.no_grad()
    def init(self, seed: int) -> "SyncFusionDiffusion":
        """Random parameters from ``seed``, with the JAX package's
        distributions: kernels normal with variance 1/fan_in (Flax draws
        them from a truncated normal), zero biases, unit GroupNorm scales,
        normal(0, 1) Fourier frequencies and fixed embedding.  The numbers
        differ from JAX's for the same seed; load converted parameters to
        match."""
        gen = torch.Generator(device=next(self.parameters()).device)
        gen.manual_seed(seed)
        if self.compat:
            init_compat(self, gen)
            return self
        for m in self.modules():
            if isinstance(m, (blocks.Linear, blocks.Conv1d, blocks.ConvTranspose1d)):
                w = m.weight  # ConvTranspose1d: (in, out, k); others (out, in, ...)
                fan_in = (w.shape[0] * w.shape[2] if isinstance(m, blocks.ConvTranspose1d)
                          else w[0].numel())
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, blocks.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, blocks.FourierTimeEmbedding):
                m.freqs.normal_(generator=gen)
            elif isinstance(m, UNet1d) and m.cfg.use_embedding_cfg:
                m.fixed_embedding.normal_(generator=gen)
        return self

    def encode_context(self, onsets) -> list:
        """Onset track (B, L, 1) -> the UNet context pyramid ``xs[2:-1]``.
        Differentiable: the encoder is trained with the UNet."""
        if self.compat:
            return self.onsets_encoder(onsets, with_info=True)[1]["xs"][2:-1]
        return self.onsets_encoder(onsets)[2:-1]

    def loss(self, wav, onsets, embedding, embedding_mask_proba: float = 0.0,
             *, sigma=None, noise=None, embedding_cfg_mask=None,
             generator: Optional[torch.Generator] = None):
        """v-diffusion training loss of waveforms (B, L, 1) under the onset
        track (B, L, 1) and the embedding (B, 1, features) or None; the
        gradient reaches the UNet and the onset encoder.  ``sigma``,
        ``noise`` and the CFG mask as in ``v_diffusion_loss``."""
        return v_diffusion_loss(
            self.unet, wav, context=self.encode_context(onsets),
            embedding=embedding, embedding_mask_proba=embedding_mask_proba,
            sigma=sigma, noise=noise, embedding_cfg_mask=embedding_cfg_mask,
            generator=generator)

    def forward(self, wav, onsets, embedding, embedding_mask_proba: float = 0.0,
                **draws):
        """The training loss, ``loss``: DDP and FSDP act through a module's
        forward."""
        return self.loss(wav, onsets, embedding, embedding_mask_proba, **draws)

    @torch.no_grad()
    def sample(self, noise, onsets, embedding, num_steps: int = 150,
               embedding_scale: float = 1.0,
               guidance_interval: Optional[tuple[float, float]] = None,
               sampler: str = "ddim", deep_cache_interval: int = 0,
               deep_split: int = 4, deep_cache_pow: float = 1.0):
        """Waveforms (B, L, 1) f32 from ``noise`` (B, L, 1), conditioned on
        the onset track (B, L, 1) and the embedding (B, 1, features).

        ``sampler``: "ddim" (``v_sample``, the reference's) or "dpm"
        (DPM-Solver++(2M), ``dpm_sample``).  ``deep_cache_interval=K > 1``:
        DeepCache, the UNet's levels >= ``deep_split`` rerun every K-th step
        (``deep_cache_pow != 1``: the same count, spaced by a power curve).
        The JAX package needs its folded apply for the cache; the plain UNet
        here carries it in its own layout.  The a-unet twins have no deep
        split: DeepCache raises ``ValueError`` with them.
        """
        samplers = {"ddim": v_sample, "dpm": dpm_sample}
        if sampler not in samplers:
            raise ValueError(f"unknown sampler {sampler!r}, not one of {sorted(samplers)}")
        if self.compat and deep_cache_interval > 1:
            raise ValueError("deep_cache_interval needs the UNet1d's deep split; the "
                             "a-unet compat twins have none")
        context = self.encode_context(onsets)
        return samplers[sampler](
            self.unet, noise, num_steps, context=context, embedding=embedding,
            embedding_scale=embedding_scale, guidance_interval=guidance_interval,
            deep_cache_interval=deep_cache_interval, deep_split=deep_split,
            deep_cache_pow=deep_cache_pow)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
