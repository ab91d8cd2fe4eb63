"""SyncFusion diffusion system: UNet + onset encoder (port of
``syncfusion_tpu/models/syncfusion.py``).

The encoder's intermediate activations ``xs[2:-1]`` are the UNet's
per-level context; they are computed once per clip, outside the sampler's
step loop.  Parameters are f32; ``dtype`` is the compute type (bf16 for
generation, as the JAX package's ``from_config(dtype=bfloat16)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig, model_configs
from syncfusion_tpu_torch.device import default_device
from syncfusion_tpu_torch.models import blocks
from syncfusion_tpu_torch.models.diffusion import DPM_TODO, v_diffusion_loss, v_sample
from syncfusion_tpu_torch.models.encoder1d import Encoder1d
from syncfusion_tpu_torch.models.unet1d import UNet1d


class SyncFusionDiffusion(nn.Module):
    def __init__(self, unet_cfg: UNetConfig = UNetConfig(),
                 encoder_cfg: EncoderConfig = EncoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.unet = UNet1d(unet_cfg, context_levels=len(encoder_cfg.factors) - 1,
                           dtype=dtype)
        self.onsets_encoder = Encoder1d(encoder_cfg, dtype=dtype)

    @classmethod
    def from_config(cls, model_cfg: Optional[dict] = None,
                    dtype: torch.dtype = torch.float32, device=None,
                    seed: int = 0) -> "SyncFusionDiffusion":
        """Build from an ``exp/model/diffusion.yaml``-style ``model`` node
        (the defaults when None) on ``device`` (the card when None; raises
        without one), with parameters drawn from ``seed``."""
        device = default_device(device)
        with torch.device(device):
            model = cls(*model_configs(model_cfg), dtype=dtype)
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

    @torch.no_grad()
    def sample(self, noise, onsets, embedding, num_steps: int = 150,
               embedding_scale: float = 1.0,
               guidance_interval: Optional[tuple[float, float]] = None,
               sampler: str = "ddim", deep_cache_interval: int = 0):
        """Waveforms (B, L, 1) f32 from ``noise`` (B, L, 1), conditioned on
        the onset track (B, L, 1) and the embedding (B, 1, features)."""
        if sampler == "dpm":
            raise NotImplementedError(DPM_TODO)
        if sampler != "ddim":
            raise ValueError(f"unknown sampler {sampler!r}")
        context = self.encode_context(onsets)
        return v_sample(self.unet, noise, num_steps, context=context,
                        embedding=embedding, embedding_scale=embedding_scale,
                        guidance_interval=guidance_interval,
                        deep_cache_interval=deep_cache_interval)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
