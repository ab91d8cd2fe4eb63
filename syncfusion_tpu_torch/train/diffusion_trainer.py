"""v-diffusion trainer (port of ``syncfusion_tpu/train/diffusion_trainer.py``).

One optimizer over the UNet and the onset encoder, the reference's recipe
(exp/model/diffusion.yaml, exp/train_diffusion_gh.yaml): gradient clip 0.5
by global norm, then AdamW (lr 1e-4, betas (0.95, 0.999), eps 1e-6, weight
decay 1e-3 on every parameter), with gradient accumulation over
``accumulate_grad_batches`` micro-batches.  ``Optimizer`` reproduces the JAX
package's ``make_optimizer`` (optax ``clip_by_global_norm`` + ``adamw``
under ``MultiSteps``) update for update.

One device.  Data parallelism across cards, ``fsdp`` and ``model_parallel``
are ROADMAP's port queue item 'Multi-device sampling and training'
and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional

import torch
from torch import nn

MULTI_DEVICE_TODO = ("multi-device training (data parallel, fsdp, "
                     "model_parallel) is not ported yet (ROADMAP.md, port "
                     "queue: 'Multi-device sampling and training')")


@dataclasses.dataclass
class OptimizerConfig:
    lr: float = 1e-4
    lr_beta1: float = 0.95
    lr_beta2: float = 0.999
    lr_eps: float = 1e-6
    lr_weight_decay: float = 1e-3
    gradient_clip_val: float = 0.5
    accumulate_grad_batches: int = 1


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: every gradient times
    ``max_norm / norm`` when the global norm is at least ``max_norm`` (no
    epsilon), untouched below it.  Returns the norm, taken in at least f32;
    never syncs the host."""
    acc = torch.promote_types(grads[0].dtype, torch.float32)
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=acc) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


class Optimizer:
    """Clip, then AdamW, once every ``accumulate_grad_batches`` micro-steps.

    Call ``step`` after each micro-batch's ``backward``; ``.grad`` then holds
    the sum of the micro-batch gradients since the last update.  On every
    k-th call the update takes their mean (optax ``MultiSteps`` keeps a
    running mean: the two differ in the last bit), clips it and applies
    AdamW; Adam's step count advances only then, and the parameters are not
    touched in between.  A parameter that got no gradient gets a zero one
    first, so that AdamW decays it by ``lr·wd`` as optax does (torch's AdamW
    skips a parameter whose ``.grad`` is None).  optax takes Adam's bias
    correction ``1 - beta^t`` in f32 and torch in f64: each update differs
    by up to ~``lr·1e-5`` relative.
    """

    def __init__(self, params: Iterable[nn.Parameter], cfg: OptimizerConfig):
        self.cfg = cfg
        self.params = list(params)
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.lr, betas=(cfg.lr_beta1, cfg.lr_beta2),
            eps=cfg.lr_eps, weight_decay=cfg.lr_weight_decay)
        self.mini_step = 0

    def step(self) -> bool:
        """One micro-step; True when the parameters were updated."""
        k = self.cfg.accumulate_grad_batches
        self.mini_step += 1
        if self.mini_step < k:
            return False
        self.mini_step = 0
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif k > 1:
                p.grad.div_(k)
        clip_by_global_norm_([p.grad for p in self.params],
                             self.cfg.gradient_clip_val)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        return True

    def state_dict(self) -> dict:
        """AdamW's state, the micro-step and, mid-accumulation, the
        gradients summed so far."""
        grads = ([p.grad for p in self.params] if self.mini_step else None)
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step,
                "grads": grads}

    def load_state_dict(self, state: Mapping) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        grads = state["grads"] or [None] * len(self.params)
        for p, g in zip(self.params, grads, strict=True):
            p.grad = None if g is None else g.to(p.device, p.dtype)


@dataclasses.dataclass
class TrainState:
    """The trained model, its optimizer and the count of micro-steps."""

    step: int
    model: nn.Module
    optimizer: Optimizer

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])


class DiffusionTrainer:
    """Train and eval steps of a ``SyncFusionDiffusion`` on one device.

    ``train_step`` updates the state in place (the JAX package returns a
    new one) and returns its metrics as device tensors: reading them syncs
    the host, so a loop reads them only where it logs.
    """

    def __init__(self, model: nn.Module, opt_cfg: Optional[OptimizerConfig] = None,
                 embedding_mask_proba: float = 0.0, fsdp: bool = False,
                 model_parallel: int = 1):
        if fsdp or model_parallel > 1:
            raise NotImplementedError(MULTI_DEVICE_TODO)
        self.model = model
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.embedding_mask_proba = embedding_mask_proba

    def create_state(self) -> TrainState:
        return TrainState(step=0, model=self.model,
                          optimizer=Optimizer(self.model.parameters(), self.opt_cfg))

    def _loss(self, model, batch: Mapping, generator):
        # wire formats, dequantized on the device: int16 wav (opt-in,
        # wire_int16) and uint8 onsets (lossless: the track is binary)
        wav, onsets = batch["wav"], batch["onsets"]
        if wav.dtype == torch.int16:
            wav = wav.float() / 32767.0
        return model.loss(wav, onsets.float(), batch.get("embedding"),
                          embedding_mask_proba=self.embedding_mask_proba,
                          generator=generator)

    def train_step(self, state: TrainState, batch: Mapping,
                   generator: Optional[torch.Generator] = None) -> dict:
        """One micro-batch: loss, backward, ``Optimizer.step``."""
        loss = self._loss(state.model, batch, generator)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"train_loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Mapping,
                  generator: Optional[torch.Generator] = None) -> dict:
        return {"valid_loss": self._loss(state.model, batch, generator)}
