"""Onset model training: pos-weighted BCE, metrics and the BatchNorm-aware
train step (port of ``syncfusion_tpu/train/onset_trainer.py``).

Loss and metrics reproduce the reference ``BCLoss``
(main/module_onset.py:268-353):
  * pos-weighted BCE-with-logits, ``pos_weight = (N - sum y) / sum y`` per
    batch;
  * AP on a positives/negatives-balanced subsample, computed as
    scikit-learn's ``average_precision_score`` does
    (``eval/onset_metrics.average_precision``, numpy: the card's machine has
    no scikit-learn);
  * binary accuracy at 0.75 on the sigmoid probabilities;
  * "OnsNumAcc": the share of chunks whose predicted onset count, after the
    reference's consecutive-onset zeroing loop, equals the target count.

Over a ``core.mesh.Mesh`` (one process per card under torchrun) each step
takes the rank's rows of a global batch: the net is wrapped in DDP, its
BatchNorms take the global batch's statistics (``batchnorm.sync_batchnorm``,
the reference's ``sync_batchnorm=True``), ``pos_weight`` comes from the
global labels and the reported loss is the global mean, so that N ranks
compute what one process computes on the whole batch.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from syncfusion_tpu_torch.core.mesh import DATA_AXIS, Mesh, all_reduce_mean_
from syncfusion_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from syncfusion_tpu_torch.eval.onset_metrics import average_precision
from syncfusion_tpu_torch.models.batchnorm import sync_batchnorm
from syncfusion_tpu_torch.models.onset_net import VideoOnsetNet
from syncfusion_tpu_torch.ops.augment import apply_color_jitter, draw_jitter
from syncfusion_tpu_torch.train import sharding
from syncfusion_tpu_torch.train.diffusion_trainer import (
    Optimizer,
    OptimizerConfig,
    TrainState,
)

THRESHOLD = 0.75  # reference main/module_onset.py:272


def bc_loss(logits, targets, group=None):
    """Pos-weighted BCE-with-logits, the mean over every frame (reference
    BCLoss.forward:274-286); ``pos_weight`` from the batch's labels, with
    at least one positive counted.  With a process ``group``, the batch is
    the global one: the count and the positives are summed over its ranks
    (whose shares are equal), and the loss is this rank's frames' mean."""
    x = logits.reshape(-1)
    y = targets.reshape(-1).to(x.dtype)
    pos, count = y.sum(), y.shape[0]
    if group is not None:
        dist.all_reduce(pos, group=group)
        count *= dist.get_world_size(group)
    pos_weight = (count - pos) / pos.clamp_min(1.0)
    losses = -(pos_weight * y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x))
    return losses.mean()


def _collapse_consecutive(pred: np.ndarray) -> np.ndarray:
    """The reference's sequential consecutive-onset zeroing
    (module_onset.py:344-347): runs of 1s become alternating 1,0,1,0,..."""
    pred = pred.copy()
    for i in range(pred.shape[0]):
        row = pred[i]
        for j in range(row.shape[-1] - 1):
            if row[j] == 1 and row[j + 1] == 1:
                row[j + 1] = 0
    return pred


def onset_metrics(logits, targets) -> dict[str, float]:
    """AP, Acc and OnsNumAcc on the host (reference BCLoss.evaluate:288-353)."""
    probs2d = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
    targets2d = np.asarray(targets)

    binarized = (probs2d > THRESHOLD).astype(int)
    collapsed = _collapse_consecutive(binarized)
    ons_num_acc = float(
        np.mean(collapsed.sum(axis=-1) == targets2d.astype(int).sum(axis=-1)))

    pred = probs2d.reshape(-1)
    target = targets2d.reshape(-1)
    pos_index = np.nonzero(target == 1)[0]
    neg_index = np.nonzero(target == 0)[0]
    balance = min(pos_index.shape[0], neg_index.shape[0])
    index = np.concatenate((pos_index[:balance], neg_index[:balance]))
    pred, target = pred[index], target[index]

    ap = average_precision(target, pred) if balance else float("nan")
    binary = (pred > THRESHOLD).astype(np.float64)
    acc = float(np.sum(binary == target) / max(target.shape[0], 1))
    return {"AP": ap, "Acc": acc, "OnsNumAcc": ons_num_acc}


class OnsetTrainer:
    """AdamW trainer of a ``VideoOnsetNet`` on one device or over a
    ``mesh`` (reference recipe, cfg/model/model-onset.yaml: lr 1e-4, betas
    (0.9, 0.999), eps 1e-8, weight decay 1e-3; no clipping, no
    accumulation).

    ``jitter=(brightness, contrast, saturation, hue)`` turns on the device
    ColorJitter in ``train_step``.  ``train_step`` updates the state in
    place (parameters, BatchNorm buffers, AdamW) and returns device
    tensors: reading them syncs the host.  Over a mesh, ``train_step`` and
    ``forward`` take the rank's rows of a global batch (``Mesh.rows``), and
    ``gather_rows`` joins the ranks' rows again.
    """

    def __init__(self, model: VideoOnsetNet, opt_cfg: Optional[OptimizerConfig] = None,
                 jitter: Optional[tuple] = None, mesh: Optional[Mesh] = None):
        self.model = model
        self.opt_cfg = opt_cfg or OptimizerConfig(
            lr_beta1=0.9, lr_eps=1e-8, gradient_clip_val=1e9,
            accumulate_grad_batches=1)
        self.jitter = tuple(jitter) if jitter else None
        self.mesh = mesh or Mesh.single()
        self.group = self.mesh.axis_group(DATA_AXIS)
        sync_batchnorm(model, self.group)
        self.module, _ = sharding.wrap(model, self.mesh)

    def create_state(self) -> TrainState:
        return TrainState(step=0, model=self.module,
                          optimizer=Optimizer(self.module.parameters(), self.opt_cfg),
                          distributed=self.mesh.distributed)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' rows of ``x``, joined in rank order (the global
        batch's); ``x`` itself in a single process."""
        if not self.mesh.distributed:
            return x
        parts = [torch.empty_like(x) for _ in range(self.mesh.data)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    @staticmethod
    def yuv420_to_rgb(packed):
        """Packed planar 4:2:0 uint8 ``(..., H + H/2, W)`` -> RGB in [0, 1]
        ``(..., H, W, 3)``, the inverse of ``transforms.rgb_to_yuv420``;
        chroma upsampled by nearest-neighbour repeats."""
        hp, w = packed.shape[-2], packed.shape[-1]
        h = hp * 2 // 3
        f = packed.float() / 255.0
        y = f[..., :h, :]
        uv = f[..., h:, :]
        pb = uv[..., :, : w // 2] - 0.5
        pr = uv[..., :, w // 2:] - 0.5
        pb = pb.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
        pr = pr.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
        r = y + 1.402 * pr
        b = y + 1.772 * pb
        g = (y - 0.299 * r - 0.114 * b) / 0.587
        return torch.stack([r, g, b], dim=-1).clamp(0.0, 1.0)

    @staticmethod
    def decode_wire(frames):
        """Wire format -> RGB in [0, 1], or None for frames normalised on
        the host already (f32).  The wires are told apart by shape: RGB
        carries a trailing channel dim of 3, packed 4:2:0 none (its last dim
        is the frame width)."""
        if frames.dtype == torch.uint8 and frames.shape[-1] != 3:
            return OnsetTrainer.yuv420_to_rgb(frames)
        if frames.dtype == torch.uint8:
            return frames.float() / 255.0
        return None

    @staticmethod
    def normalize(rgb):
        mean = torch.from_numpy(IMAGENET_MEAN).to(rgb.device)
        std = torch.from_numpy(IMAGENET_STD).to(rgb.device)
        return (rgb - mean) / std

    @staticmethod
    def prep_frames(frames):
        """Wire format -> ImageNet-normalised f32 frames, on their device;
        normalised f32 frames pass through."""
        rgb = OnsetTrainer.decode_wire(frames)
        return frames if rgb is None else OnsetTrainer.normalize(rgb)

    def train_frames(self, frames, generator: Optional[torch.Generator] = None):
        """Train-time prep: decode, the device jitter when configured, then
        normalise.  The jitter needs a quantised wire: f32 frames are
        normalised already.  Its factors are drawn for the global batch, and
        the rank's rows of them taken."""
        if self.jitter is None:
            return self.prep_frames(frames)
        rgb = self.decode_wire(frames)
        if rgb is None:
            raise ValueError("OnsetTrainer(jitter=...) needs a uint8 or yuv420 "
                             f"frame wire, got {frames.dtype}")
        b = rgb.shape[0] * self.mesh.data
        drawn = draw_jitter(b, generator, *self.jitter, device=rgb.device)
        rows = self.mesh.rows(b)
        return self.normalize(apply_color_jitter(rgb, *(d[rows] for d in drawn)))

    def train_step(self, state: TrainState, batch: Mapping,
                   generator: Optional[torch.Generator] = None) -> tuple:
        """One step on ``batch`` (``frames`` in a wire format, ``label``
        (B, T)): train-mode forward (the BatchNorm buffers move), loss,
        backward, AdamW.  Returns (``{"loss/train": loss}``, logits), the
        loss the global batch's mean, the logits this rank's rows."""
        model = state.model.train()
        logits = model(self.train_frames(batch["frames"], generator))
        loss = bc_loss(logits, batch["label"], self.group)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        loss = loss.detach().clone()
        if self.mesh.distributed:
            all_reduce_mean_(loss, self.group)
        return {"loss/train": loss}, logits.detach()

    @torch.no_grad()
    def forward(self, state: TrainState, frames):
        """Eval-mode logits (B, T) of frames in a wire format."""
        return state.model.eval()(self.prep_frames(frames))
