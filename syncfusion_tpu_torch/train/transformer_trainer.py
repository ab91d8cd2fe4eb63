"""The AV-conditional GPT's trainer, CondFoleyGen's stage 2 (port of
``syncfusion_tpu/train/transformer_trainer.py``).

The optimizer is minGPT's grouping as the JAX package writes it: the
global gradient norm clipped to 1.0, then AdamW (lr 1e-4, betas (0.9,
0.95), eps 1e-8, weight decay 0.01) with the decay on the Dense and conv
kernels alone, ``decay_mask``'s leaves: here the ``.weight`` of every
``nn.Linear`` and ``nn.Conv*``; LayerNorm weights, the token embedding, the
positional table and every bias take none.  The first-stage VQ and the
video net are frozen: eval mode, no gradient, outside the optimizer and the
state.

Over a ``core.mesh.Mesh`` (one process per card) the GPT is wrapped by
``train.sharding.wrap`` (DDP, or FSDP2 when ``fsdp`` and ``model > 1``),
and the frozen stages by ``sharding.shard_frozen`` (sharded by the same
``fsdp_min_size`` rule under FSDP, whole otherwise).  A step takes the
rank's rows of a global batch; the token corruption (``pkeep < 1``) is
drawn for the global batch and sliced, so N ranks compute what one process
computes on the whole batch.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn
from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

from syncfusion_tpu_torch.core.mesh import DATA_AXIS, Mesh, all_reduce_mean_
from syncfusion_tpu_torch.models.transformer_av import AVCondTransformer
from syncfusion_tpu_torch.train import sharding
from syncfusion_tpu_torch.train.diffusion_trainer import Optimizer, OptimizerConfig, TrainState


def decay_params(module: nn.Module) -> list[nn.Parameter]:
    """The parameters that take weight decay: the weights of ``module``'s
    ``nn.Linear`` and ``nn.Conv*`` layers (the JAX ``decay_mask``'s
    kernels)."""
    return [m.weight for m in module.modules()
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d))]


class FrozenStages(nn.Module):
    """The frozen VQ and video net of an ``AVCondTransformer`` as one module
    whose ``forward`` is the model's ``encode`` (the unit that FSDP gathers
    around)."""

    def __init__(self, model: AVCondTransformer):
        super().__init__()
        self.vq, self.video = model.vq, model.video
        self._encode = model.encode

    def forward(self, spec, cond_spec, frames):
        return self._encode(spec, cond_spec, frames)


class TransformerTrainer:
    """Train and eval steps of an ``AVCondTransformer``'s GPT, on one device
    or over a ``mesh``.  ``train_step`` updates the state in place and
    returns device tensors (reading them syncs the host)."""

    def __init__(self, model: AVCondTransformer, learning_rate: float = 1e-4,
                 weight_decay: float = 0.01, betas: tuple = (0.9, 0.95),
                 grad_clip: float = 1.0, mesh: Optional[Mesh] = None, fsdp: bool = False,
                 fsdp_min_size: int = 2**14):
        self.model = model
        self.opt_cfg = OptimizerConfig(lr=learning_rate, lr_beta1=betas[0],
                                       lr_beta2=betas[1], lr_eps=1e-8,
                                       lr_weight_decay=weight_decay,
                                       gradient_clip_val=grad_clip)
        self.mesh = mesh or Mesh.single()
        self.fsdp = fsdp and self.mesh.model > 1
        for frozen in (model.vq, model.video):
            frozen.eval().requires_grad_(False)
        self.frozen = sharding.shard_frozen(FrozenStages(model), self.mesh, self.fsdp,
                                            fsdp_min_size)
        self.module, self._whole = sharding.wrap(model.gpt, self.mesh, self.fsdp,
                                                 fsdp_min_size)

    def create_state(self) -> TrainState:
        """Step 0, the GPT as wrapped, and the optimizer (two groups: the
        decayed kernels and the rest)."""
        decay = {id(p) for p in decay_params(self.model.gpt)}
        no_decay = [p for p in self.module.parameters() if id(p) not in decay]
        return TrainState(step=0, model=self.module,
                          optimizer=Optimizer(self.module.parameters(), self.opt_cfg,
                                              no_decay=no_decay),
                          distributed=self.mesh.distributed)

    def _draws(self, z: torch.Tensor, generator: Optional[torch.Generator]):
        """The token corruption's draws for the global batch, this rank's
        rows of them; None at ``pkeep`` 1."""
        if self.model.pkeep >= 1.0:
            return None
        b = z.shape[0] * self.mesh.data
        rows = self.mesh.rows(b)
        mask, rand = self.model.draw_pkeep((b, 2 * self.model.clip), generator, z.device)
        return mask[rows], rand[rows]

    def _global_mean(self, loss):
        if self.mesh.distributed:
            loss = loss.clone()
            all_reduce_mean_(loss, self.mesh.axis_group(DATA_AXIS))
        return loss

    def train_step(self, state: TrainState, batch: Mapping,
                   generator: Optional[torch.Generator] = None) -> dict:
        """One step on ``batch`` (``spec``, ``cond_spec`` (B, 1, 80, 160),
        ``frames`` (B, 2T, H, W, 3)): loss, backward (gradients averaged over
        the data ranks), clip and AdamW.  Returns ``{"train/loss"}``, the
        global batch's mean."""
        codes = self.frozen(batch["spec"], batch["cond_spec"], batch["frames"])
        loss = self.model.loss_on_codes(*codes, draws=self._draws(codes[0], generator),
                                        gpt=state.model)
        loss.backward()
        sharding.average_grads(self._whole, self.mesh)
        state.optimizer.step()
        state.step += 1
        return {"train/loss": self._global_mean(loss.detach())}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Mapping) -> dict:
        """``{"val/loss"}``: the loss without corruption, the global batch's
        mean."""
        codes = self.frozen(batch["spec"], batch["cond_spec"], batch["frames"])
        loss = self.model.loss_on_codes(*codes, gpt=state.model)
        return {"val/loss": self._global_mean(loss)}

    def full_state_dict(self) -> dict:
        """The whole model's state (``AVCondTransformer``'s keys: the frozen
        stages and the GPT as trained), on the CPU, for a copy with whole
        parameters (``log_images`` cannot run on FSDP's shards).  Collective
        under ``torch.distributed``: every rank calls it, rank 0 gets the
        state."""
        options = StateDictOptions(full_state_dict=True, cpu_offload=True)
        sd = get_model_state_dict(self.frozen, options=options)
        sd.update({f"gpt.{k}": v for k, v in
                   get_model_state_dict(self.module, options=options).items()})
        return sd
