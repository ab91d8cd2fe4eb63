"""Seeded random parameters with Flax's default distributions, for every
model of the port that is built without converted weights.  The numbers
differ from JAX's for the same seed; load converted parameters to match."""

from __future__ import annotations

import torch
from torch import nn

# variance_scaling's truncated normal: the std of the untruncated normal
# divided by the shrink of its truncation at two standard deviations
_TRUNC = 0.87962566103423978


@torch.no_grad()
def flax_init(model: nn.Module, seed: int) -> nn.Module:
    """Draws from one generator seeded with ``seed``, module by module in
    ``model.modules()`` order.  A module's ``weight``: an ``nn.Embedding``'s
    normal of variance 1/width; one of two or more dims (a Dense or Conv
    kernel) lecun-normal, a normal of variance 1/fan_in truncated at two
    standard deviations, with its bias zero; a 1-D one (a norm's scale) 1
    with its bias 0 and any running statistics 0 and 1.  By name: ``pos_emb``
    normal(0.02); ``relative_position_bias_table`` normal(0.02) truncated
    at two standard deviations; a VQ codebook ``embedding`` (n_e, e_dim)
    U(-1/n_e, 1/n_e).  Returns ``model``."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    for m in model.modules():
        w = getattr(m, "weight", None)
        bias = getattr(m, "bias", None)
        if not isinstance(w, nn.Parameter):
            pass
        elif isinstance(m, nn.Embedding):
            w.normal_(0.0, w.shape[1] ** -0.5, generator=gen)
        elif w.dim() >= 2:
            # ConvTranspose1d: (in, out, k); the others (out, in, ...)
            fan_in = (w.shape[0] * w.shape[2] if isinstance(m, nn.ConvTranspose1d)
                      else w[0].numel())
            std = fan_in ** -0.5 / _TRUNC
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            if bias is not None:
                bias.zero_()
        else:
            w.fill_(1.0)
            bias.zero_()
            if getattr(m, "running_mean", None) is not None:
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        params = dict(m.named_parameters(recurse=False))
        if "pos_emb" in params:
            params["pos_emb"].normal_(0.0, 0.02, generator=gen)
        if "relative_position_bias_table" in params:
            nn.init.trunc_normal_(params["relative_position_bias_table"], 0.0, 0.02,
                                  -0.04, 0.04, generator=gen)
        if "embedding" in params:
            n_e = params["embedding"].shape[0]
            params["embedding"].uniform_(-1.0 / n_e, 1.0 / n_e, generator=gen)
    return model
