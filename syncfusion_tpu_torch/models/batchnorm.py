"""Flax's BatchNorm for the port's convolutional nets: the onset net's
R(2+1)D-18 (5-D maps) and the VQGAN's PatchGAN discriminator (4-D maps).

Training takes Flax's batch statistics and moves the running ones by
``BN_MOMENTUM`` with the biased variance; ``sync_batchnorm`` makes the
statistics a process group's global batch's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # Flax's convention: the share of the old running value
BN_EPS = 1e-5


def _stat_dims(x) -> tuple:
    """Every dim of ``x`` but the channels' (dim 1)."""
    return (0, *range(2, x.ndim))


def _per_channel(v, x):
    """A per-channel vector (C,) viewed to broadcast over ``x`` (B, C, ...)."""
    return v.view((1, -1) + (1,) * (x.ndim - 2))


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode normalisation over every dim but the channels' (dim 1:
    (0, 2, 3, 4) of a 3-D net's maps, (0, 2, 3) of a 2-D one's) with Flax's batch
    statistics: mean, and the biased variance as mean(x^2) - mean^2
    floored at 0; y = (x - mean)·(rsqrt(var + eps)·weight) + bias.  The
    backward is batch norm's closed form, (weight·rstd)·(gy - mean(gy) -
    x̂·mean(gy·x̂)), from the saved input alone: autograd through the
    formula would keep x - mean as well, a second activation-sized tensor
    per BatchNorm (both give the same gradients within f32 rounding).
    Returns (y, mean, var).

    With a process ``group`` the statistics are the global batch's
    (synchronised BatchNorm, the reference's ``sync_batchnorm=True``): the
    ranks' shares of the batch are equal (``core.mesh.local_batch_size``),
    so each rank's mean(x) and mean(x^2), times 1/ranks, are all-reduced
    into the global ones; the backward all-reduces sum(gy) and sum(gy·x̂)
    before ``gx``.  The weight's and bias's gradients stay the rank's own,
    which DDP averages.  At one rank the all-reduces leave every number as
    the single-process path computes it."""

    @staticmethod
    def forward(ctx, x, weight, bias, group=None):
        dims = _stat_dims(x)
        mean, meansq = x.mean(dims), (x * x).mean(dims)
        ranks = 1
        if group is not None:
            ranks = dist.get_world_size(group)
            stats = torch.cat([mean, meansq]) * (1.0 / ranks)
            dist.all_reduce(stats, group=group)
            mean, meansq = stats.chunk(2)
        var = (meansq - mean * mean).clamp_min(0.0)
        rstd = torch.rsqrt(var + BN_EPS)
        ctx.save_for_backward(x, mean, rstd, weight)
        ctx.group, ctx.count = group, x.numel() // x.shape[1] * ranks
        y = ((x - _per_channel(mean, x)) * _per_channel(rstd * weight, x)
             + _per_channel(bias, x))
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, rstd, weight = ctx.saved_tensors
        dims = _stat_dims(x)
        n = ctx.count
        xhat = (x - _per_channel(mean, x)) * _per_channel(rstd, x)
        gbias = gy.sum(dims)
        gweight = (gy * xhat).sum(dims)
        sum_gy, sum_gy_xhat = gbias, gweight
        if ctx.group is not None:
            sums = torch.cat([gbias, gweight])
            dist.all_reduce(sums, group=ctx.group)
            sum_gy, sum_gy_xhat = sums.chunk(2)
        gx = _per_channel(weight * rstd, x) * (
            gy - _per_channel(sum_gy / n, x) - xhat * _per_channel(sum_gy_xhat / n, x))
        return gx, gweight, gbias, None


class BatchNorm(nn.Module):
    """Flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    (dim 1) of a map of any rank, (B, C, T, H, W) in the onset net, (B, C,
    H, W) in the VQGAN's discriminator, in at least f32 (a bf16 input is promoted, as Flax
    promotes it to its f32 parameters' type).

    Training normalises with the batch's statistics as Flax computes them
    (``_BatchNormTrain``) and moves the running statistics by ``0.9·old +
    0.1·batch`` with the *biased* variance, as Flax does;
    ``torch.nn.BatchNorm3d`` moves ``running_var`` by the unbiased one,
    n/(n-1) times larger.  Eval normalises with the running statistics.
    ``process_group`` (set by ``sync_batchnorm``) makes the training
    statistics, and so the running ones, the global batch's.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.process_group = None

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                             self.process_group)
        with torch.no_grad():
            self.running_mean.lerp_(mean, 1.0 - BN_MOMENTUM)
            self.running_var.lerp_(var, 1.0 - BN_MOMENTUM)
        return y


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Every ``BatchNorm`` of ``model`` takes its training statistics over
    ``group``'s ranks (None: its own batch).  Returns ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    return model
