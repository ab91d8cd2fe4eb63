"""Progressive distillation of the v-diffusion sampler (port of
``syncfusion_tpu/train/distill.py``).

Each round halves the sampler's step count: a student learns to match TWO
DDIM steps of a frozen teacher with ONE of its own (Salimans & Ho,
"Progressive Distillation for Fast Sampling of Diffusion Models", ICLR
2022, in this repository's angle-space v-sampler).  In angle space a DDIM
step is a rotation,

    x_psi = cos(psi - phi)·x + sin(psi - phi)·v(x, phi),

so the one-step target that takes x at angle phi to the teacher's
two-step result x'' is exactly

    v* = (x'' - cos(D)·x) / sin(D),   D = psi'' - phi.

x is clean data noised to an angle of the STUDENT's step grid, where the
distilled model is queried.  The student starts each round as a copy of
the teacher and trains with a fresh optimizer; the teacher is a frozen
copy (``requires_grad_(False)``, run under ``torch.no_grad()``).  The
distilled model has the same parameters as any ``SyncFusionDiffusion``
and samples through ``model.sample(..., num_steps=<few>)`` unchanged.

``loss`` takes its draws (each row's grid index and the noise) as
arguments, so that a caller can feed the JAX side's; ``distill`` draws them
from a ``torch.Generator``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional

import torch

from syncfusion_tpu_torch.train.diffusion_trainer import Optimizer, OptimizerConfig


def _rotate(x, v, delta):
    return torch.cos(delta) * x + torch.sin(delta) * v


@dataclasses.dataclass
class DistillConfig:
    start_steps: int = 64          # teacher's sampler grid at round 0
    final_steps: int = 8           # stop when the student reaches this
    steps_per_round: int = 400     # optimizer steps per halving
    lr: float = 1e-4
    grad_clip: float = 0.5
    # != 1.0: guided distillation: the teacher's v is the CFG combine
    # v_u + (v_c - v_u)·scale (cond and uncond as one 2B forward, as
    # v_sample runs them), baked into a one-forward student, which is then
    # sampled with embedding_scale 1.0
    cfg_scale: float = 1.0


class ProgressiveDistiller:
    """Distills a trained ``SyncFusionDiffusion`` to fewer sampler steps."""

    def __init__(self, model, cfg: Optional[DistillConfig] = None):
        self.model = model
        self.cfg = cfg or DistillConfig()

    def optimizer(self, student) -> Optimizer:
        """optax's ``chain(clip_by_global_norm(grad_clip), adamw(lr, b1=0.9,
        b2=0.999, weight_decay=0))`` over every parameter of ``student``
        (the JAX distiller's, eps at optax's 1e-8)."""
        return Optimizer(student.parameters(), OptimizerConfig(
            lr=self.cfg.lr, lr_beta1=0.9, lr_beta2=0.999, lr_eps=1e-8,
            lr_weight_decay=0.0, gradient_clip_val=self.cfg.grad_clip))

    @staticmethod
    def draws(wav, num_student_steps: int, generator=None) -> tuple:
        """Each row's student grid index ``i`` (B,), uniform over
        0..N-1, and the noise (like ``wav``), from ``generator``."""
        i = torch.randint(0, num_student_steps, (wav.shape[0],),
                          generator=generator, device=wav.device)
        noise = torch.randn(wav.shape, generator=generator, device=wav.device,
                            dtype=wav.dtype)
        return i, noise

    def _teacher_v(self, teacher, context, embedding):
        """``(x, sigma) -> v``: the teacher's UNet, the CFG combine of one
        2B forward when guided (as ``v_sample`` builds it)."""
        scale = self.cfg.cfg_scale
        if scale == 1.0 or embedding is None:
            return lambda x, sigma: teacher.unet(x, sigma, context=context,
                                                 embedding=embedding)
        b = embedding.shape[0]
        ctx2 = [torch.cat([c, c]) for c in context]
        emb2 = torch.cat([embedding, torch.zeros_like(embedding)])
        mask = torch.cat([torch.zeros(b, 1, 1), torch.ones(b, 1, 1)]).to(embedding.device)

        def guided(x, sigma):
            v2 = teacher.unet(torch.cat([x, x]), torch.cat([sigma, sigma]),
                              context=ctx2, embedding=emb2, embedding_cfg_mask=mask)
            v_c, v_u = v2.chunk(2)
            return v_u + (v_c - v_u) * scale

        return guided

    def loss(self, student, teacher, wav, onsets, embedding,
             num_student_steps: int, *, i, noise):
        """MSE(v_student, v*) on the student's step grid, a 0-dim tensor
        with a gradient into ``student`` (its UNet and onset encoder).

        ``num_student_steps`` is the grid AFTER the halving (the teacher
        runs twice as fine); ``i`` (B,) the rows' grid indices and
        ``noise`` (like ``wav``) the draws; the sigma grid is
        linspace(1, 0, N + 1)[:-1], as ``v_sample``'s.  The student's
        forward drops no embedding (no CFG dropout)."""
        n = num_student_steps
        i = i.to(torch.float32)
        half_pi = math.pi / 2
        sig_now = 1.0 - i / n
        sig_half = 1.0 - (i + 0.5) / n
        sig_next = 1.0 - (i + 1.0) / n
        phi_now, phi_half, phi_next = (s * half_pi for s in (sig_now, sig_half, sig_next))

        def bc(t):
            return t.reshape(t.shape + (1,) * (wav.dim() - t.dim()))

        x = torch.cos(bc(phi_now)) * wav + torch.sin(bc(phi_now)) * noise
        with torch.no_grad():
            teacher_v = self._teacher_v(teacher, teacher.encode_context(onsets),
                                        embedding)
            # two teacher DDIM steps (rotations), no gradient into the teacher
            x_half = _rotate(x, teacher_v(x, sig_now), bc(phi_half - phi_now))
            x_next = _rotate(x_half, teacher_v(x_half, sig_half),
                             bc(phi_next - phi_half))
        # exact one-step target: x_next = cos(D)·x + sin(D)·v*
        delta = bc(phi_next - phi_now)
        v_star = (x_next - torch.cos(delta) * x) / torch.sin(delta)
        v_pred = student.unet(x, sig_now, context=student.encode_context(onsets),
                              embedding=embedding)
        return torch.mean(torch.square(v_pred - v_star))

    def distill(self, batch_fn: Callable[[int], dict],
                generator: Optional[torch.Generator] = None,
                log_fn: Optional[Callable[[dict], None]] = None,
                log_every: int = 100) -> tuple:
        """Run the halving schedule from ``self.model``; returns (distilled
        model, num_steps).

        ``batch_fn(step) -> {"wav", "onsets", "embedding"}``: device tensors
        (``wav`` and ``onsets`` (B, L, 1) f32, ``embedding`` (B, 1,
        features) or absent).  ``self.model`` is not changed: the student
        is a copy.  ``log_fn`` gets ``{"round_steps", "step",
        "distill_loss"}`` every ``log_every`` steps of a round and at its
        last (reading the loss syncs the device)."""
        cfg = self.cfg
        n = cfg.start_steps
        student = copy.deepcopy(self.model).requires_grad_(True)
        while n > cfg.final_steps:
            n_half = n // 2
            teacher = copy.deepcopy(student).requires_grad_(False)
            opt = self.optimizer(student)
            for step in range(cfg.steps_per_round):
                batch = batch_fn(step)
                i, noise = self.draws(batch["wav"], n_half, generator)
                loss = self.loss(student, teacher, batch["wav"], batch["onsets"],
                                 batch.get("embedding"), n_half, i=i, noise=noise)
                loss.backward()
                opt.step()
                if log_fn and (step % log_every == 0 or step == cfg.steps_per_round - 1):
                    log_fn({"round_steps": n_half, "step": step,
                            "distill_loss": loss.item()})
            del teacher, opt
            n = n_half
        return student, n
