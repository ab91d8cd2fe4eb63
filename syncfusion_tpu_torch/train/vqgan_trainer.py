"""Two-optimizer VQGAN training, the CondFoleyGen codebook's (port of
``syncfusion_tpu/train/vqgan_trainer.py``).

A step on one batch, as the JAX step computes it:

  G: the L1 reconstruction plus ``perceptual_weight``·LPAPS, plus
     d_weight·``disc_weight``·disc_factor·(−mean D(x̂)), plus
     ``codebook_weight``·(the quantizer's loss); D runs in eval mode here
     (its running statistics) and G's gradients are taken over the VQ's
     parameters alone; Adam (lr 4.5e-6, betas (0.5, 0.9), eps 1e-8).
  D: 0.5·[mean relu(1 − D(x)) + mean relu(1 + D(x̂))]·disc_factor on the
     reconstruction of G's forward (before G's update), detached; D in
     train mode, real then fake, the running statistics moving after each
     call; the same Adam.

disc_factor is 0 before step ``disc_start`` and ``DISC_FACTOR`` from it on
(a constant, as the JAX script leaves it at its default): D still runs in train mode
there (its statistics move) and its Adam still steps on zero gradients, so
that its step count, and with it the bias correction, stays optax's.
d_weight is ``min_adapt_weight`` when it equals ``max_adapt_weight`` (the
GH config: no second backward), else ‖∇nll‖ / (‖∇g‖ + 1e-4) with respect to
the decoder's ``conv_out`` weight, clipped and detached.

``train_step`` and ``eval_step`` return device tensors: reading one syncs
the host.  ``VQGANTrainState.state_dict`` is the checkpoint: the VQ, the
discriminator with its BatchNorm buffers, both optimizers and the step.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from syncfusion_tpu_torch.core.config import VQGANLossConfig
from syncfusion_tpu_torch.models.init import flax_init
from syncfusion_tpu_torch.models.vqgan.discriminator import NLayerDiscriminator
from syncfusion_tpu_torch.models.vqgan.lpaps import LPAPS
from syncfusion_tpu_torch.models.vqgan.model import VQModel

__all__ = ["DISC_FACTOR", "VQGANLossConfig", "VQGANTrainState", "VQGANTrainer",
           "hinge_d_loss"]

DISC_FACTOR = 1.0


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def _adam(params, lr: float) -> torch.optim.Adam:
    """optax ``adam(lr, b1=0.5, b2=0.9)``: eps 1e-8 outside the root, no
    weight decay."""
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.9), eps=1e-8, weight_decay=0.0)


def _step(opt: torch.optim.Adam, params: list, loss: torch.Tensor) -> None:
    """``opt``'s update on the gradients of ``loss`` over ``params`` alone
    (no other module's ``.grad`` is touched); a parameter the loss does not
    reach gets a zero gradient, so that Adam still counts the step."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    opt.zero_grad(set_to_none=True)


@dataclasses.dataclass
class VQGANTrainState:
    step: int
    model: VQModel
    disc: NLayerDiscriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam

    def state_dict(self) -> dict:
        return {"step": self.step, "vq": self.model.state_dict(),
                "disc": self.disc.state_dict(), "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        """Restore ``state_dict``'s state, strictly."""
        self.model.load_state_dict(state["vq"], strict=True)
        self.disc.load_state_dict(state["disc"], strict=True)
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.step = int(state["step"])


class VQGANTrainer:
    """The VQGAN step over a ``VQModel``, an ``NLayerDiscriminator``
    (default ``ndf=64, n_layers=3``) and a frozen ``LPAPS`` (``lpaps``
    None: a seeded one, made by ``init``; unused when
    ``perceptual_weight`` is 0).  The modules stay where the caller put
    them; ``init`` seeds them."""

    def __init__(self, model: Optional[VQModel] = None,
                 loss_cfg: Optional[VQGANLossConfig] = None,
                 learning_rate: float = 4.5e-6, lpaps: Optional[LPAPS] = None,
                 discriminator: Optional[NLayerDiscriminator] = None):
        self.model = model if model is not None else VQModel()
        self.cfg = loss_cfg or VQGANLossConfig()
        self.disc = discriminator if discriminator is not None else NLayerDiscriminator()
        self.learning_rate = learning_rate
        self.lpaps = lpaps

    def init(self, seed: int, spec_shape: tuple = (1, 1, 80, 160)) -> VQGANTrainState:
        """Seed the VQ (``seed``), the discriminator (``seed + 1``) and,
        when it has none and the perceptual term is on, a new LPAPS
        (``seed + 2``) on the VQ's device; then ``create_state``."""
        flax_init(self.model, seed)
        flax_init(self.disc, seed + 1)
        if self.lpaps is None and self.cfg.perceptual_weight > 0:
            device = next(self.model.parameters()).device
            self.lpaps = flax_init(LPAPS().to(device), seed + 2)
        return self.create_state(spec_shape)

    def create_state(self, spec_shape: tuple = (1, 1, 80, 160)) -> VQGANTrainState:
        """Step 0 and both optimizers over the modules' present weights; the
        LPAPS frozen.  Raises when the discriminator leaves no patch of
        ``spec_shape``, or the perceptual term is on without an LPAPS."""
        p = next(self.disc.parameters())
        with torch.no_grad():
            patch = self.disc.eval()(torch.zeros(spec_shape, device=p.device,
                                                 dtype=p.dtype)).shape
        if 0 in patch:
            raise ValueError(f"discriminator collapses {tuple(spec_shape)} to an empty "
                             f"patch grid {tuple(patch)}; use fewer n_layers")
        if self.cfg.perceptual_weight > 0 and self.lpaps is None:
            raise ValueError("perceptual_weight > 0 needs an LPAPS")
        if self.lpaps is not None:
            self.lpaps.eval().requires_grad_(False)
        return VQGANTrainState(step=0, model=self.model, disc=self.disc,
                               opt_g=_adam(self.model.parameters(), self.learning_rate),
                               opt_d=_adam(self.disc.parameters(), self.learning_rate))

    def recon_loss(self, x: torch.Tensor, xrec: torch.Tensor) -> torch.Tensor:
        """mean(|x − x̂| + ``perceptual_weight``·LPAPS(x, x̂))."""
        rec = (x - xrec).abs()
        if self.cfg.perceptual_weight > 0:
            p = self.lpaps(x, xrec)
            rec = rec + self.cfg.perceptual_weight * p[:, None, None, None]
        return rec.mean()

    def _adaptive_weight(self, model: VQModel, nll: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
        last = model.decoder.conv_out.weight
        g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
        g_g = torch.autograd.grad(g, last, retain_graph=True)[0]
        w = torch.linalg.vector_norm(g_nll) / (torch.linalg.vector_norm(g_g) + 1e-4)
        return w.clamp(self.cfg.min_adapt_weight, self.cfg.max_adapt_weight).detach()

    def g_loss(self, model: VQModel, disc: NLayerDiscriminator, spec: torch.Tensor,
               disc_factor: float) -> tuple:
        """G's loss on ``spec`` with D in eval mode: (loss, reconstruction,
        metrics with the quantizer's ``indices``)."""
        cfg = self.cfg
        xrec, qloss, info = model.train_forward(spec)
        nll = self.recon_loss(spec, xrec)
        g = -torch.mean(disc.eval()(xrec))
        if cfg.min_adapt_weight == cfg.max_adapt_weight:
            d_weight = cfg.min_adapt_weight
        else:
            d_weight = self._adaptive_weight(model, nll, g)
        loss = nll + d_weight * cfg.disc_weight * disc_factor * g + cfg.codebook_weight * qloss
        return loss, xrec, {"loss/nll": nll, "loss/quant": qloss, "loss/g": g, **info}

    def d_loss(self, disc: NLayerDiscriminator, spec: torch.Tensor, xrec: torch.Tensor,
               disc_factor: float) -> torch.Tensor:
        """D's loss in train mode, real then fake (``xrec`` detached): the
        running statistics move after each call."""
        disc.train()
        logits_real = disc(spec)
        logits_fake = disc(xrec.detach())
        return disc_factor * hinge_d_loss(logits_real, logits_fake)

    def train_step(self, state: VQGANTrainState, spec: torch.Tensor) -> dict:
        """One G and one D update on ``spec`` (B, 1, H, W); returns the
        metrics ``loss/g_total``, ``loss/nll``, ``loss/quant``, ``loss/g``,
        ``perplexity`` and ``loss/disc``."""
        disc_factor = DISC_FACTOR if state.step >= self.cfg.disc_start else 0.0
        model = state.model.train()
        loss, xrec, info = self.g_loss(model, state.disc, spec, disc_factor)
        _step(state.opt_g, list(model.parameters()), loss)
        d_loss = self.d_loss(state.disc, spec, xrec, disc_factor)
        _step(state.opt_d, list(state.disc.parameters()), d_loss)
        state.step += 1
        return {"loss/g_total": loss.detach(), "loss/nll": info["loss/nll"].detach(),
                "loss/quant": info["loss/quant"].detach(), "loss/g": info["loss/g"].detach(),
                "perplexity": info["perplexity"], "loss/disc": d_loss.detach()}

    @torch.no_grad()
    def eval_step(self, state: VQGANTrainState, spec: torch.Tensor) -> dict:
        """``val/rec_loss`` (L1), ``val/quant_loss``, ``val/perplexity``,
        ``val/codebook_usage`` (the share of codes used) and
        ``val/code_counts`` (a bincount over ``n_embed``)."""
        xrec, qloss, info = state.model.train_forward(spec)
        counts = torch.bincount(info["indices"].reshape(-1),
                                minlength=state.model.quantize.embedding.shape[0])
        return {"val/rec_loss": (spec - xrec).abs().mean(), "val/quant_loss": qloss,
                "val/perplexity": info["perplexity"],
                "val/codebook_usage": (counts > 0).float().mean(),
                "val/code_counts": counts}
