"""v-diffusion trainer (port of ``syncfusion_tpu/train/diffusion_trainer.py``).

One optimizer over the UNet and the onset encoder, the reference's recipe
(exp/model/diffusion.yaml, exp/train_diffusion_gh.yaml): gradient clip 0.5
by global norm, then AdamW (lr 1e-4, betas (0.95, 0.999), eps 1e-6, weight
decay 1e-3 on every parameter), with gradient accumulation over
``accumulate_grad_batches`` micro-batches.  ``Optimizer`` reproduces the JAX
package's ``make_optimizer`` (optax ``clip_by_global_norm`` + ``adamw``
under ``MultiSteps``) update for update.

Over a ``core.mesh.Mesh`` (one process per card under torchrun), the batch a
step takes is the rank's rows of a global batch, and the model is wrapped by
``train.sharding.wrap``: DDP, or FSDP2 with ``fsdp`` on a mesh whose
``model`` axis is wider than 1.  Sigma, the noise and the CFG-dropout mask
are drawn for the global batch and sliced, so that N ranks compute what one
process computes on the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.checkpoint.state_dict import (
    StateDictOptions,
    get_state_dict,
    set_model_state_dict,
    set_optimizer_state_dict,
)
from torch.distributed.tensor import DTensor, distribute_tensor

from syncfusion_tpu_torch.core.mesh import DATA_AXIS, Mesh, all_reduce_mean_, rank_zero
from syncfusion_tpu_torch.models.unet1d import cfg_dropout_mask
from syncfusion_tpu_torch.train import sharding


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
    never syncs the host.  A gradient that FSDP shards (a ``DTensor``) adds
    its whole tensor's norm, all-reduced over the shard group."""
    acc = torch.promote_types(grads[0].dtype, torch.float32)
    norms = [torch.linalg.vector_norm(g, dtype=acc) for g in grads]
    norm = torch.linalg.vector_norm(torch.stack(
        [n.full_tensor() if isinstance(n, DTensor) else n for n in norms]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        (g.to_local() if isinstance(g, DTensor) else g).mul_(factor.to(g.dtype))
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
    by up to ~``lr·1e-5`` relative.  ``no_decay`` names parameters that
    take no weight decay (a second parameter group).
    """

    def __init__(self, params: Iterable[nn.Parameter], cfg: OptimizerConfig,
                 no_decay: Iterable[nn.Parameter] = ()):
        self.cfg = cfg
        self.params = list(params)
        skip = {id(p) for p in no_decay}
        groups = [{"params": [p for p in self.params if id(p) not in skip]}]
        if skip:  # optax's decay mask: these take no weight decay
            groups.append({"params": [p for p in self.params if id(p) in skip],
                           "weight_decay": 0.0})
        self.adamw = torch.optim.AdamW(
            groups, lr=cfg.lr, betas=(cfg.lr_beta1, cfg.lr_beta2),
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

    def full_grads(self) -> Optional[list]:
        """Mid-accumulation, the gradients summed so far, whole and on the
        CPU (on rank 0; None elsewhere), in parameter order; else None.
        Collective under FSDP: every rank calls it."""
        if not self.mini_step:
            return None
        grads = []
        for p in self.params:
            g = p.grad
            if isinstance(g, DTensor):
                g = g.full_tensor()
            grads.append(None if g is None or not rank_zero() else g.detach().cpu())
        return grads

    def load_grads(self, grads: Optional[list], distributed: bool) -> None:
        """Set the gradients ``full_grads`` returned (rank 0's, sent to every
        rank when ``distributed``; the other ranks pass None)."""
        if distributed:
            holder = [None if grads is None else [g is not None for g in grads]]
            dist.broadcast_object_list(holder, src=0)
            if holder[0] is None:
                grads = None
            else:
                grads = [self._receive(p, grads[i] if rank_zero() else None)
                         if has else None for i, (p, has) in enumerate(
                             zip(self.params, holder[0], strict=True))]
        grads = grads or [None] * len(self.params)
        for p, g in zip(self.params, grads, strict=True):
            if g is not None and not isinstance(g, DTensor):
                g = g.to(p.device, p.dtype)
            p.grad = g

    @staticmethod
    def _receive(p, g):
        """Rank 0's whole gradient ``g`` of ``p``, as ``p`` is laid out on
        this rank."""
        if isinstance(p, DTensor):
            full = g if g is not None else torch.empty(p.shape, dtype=p.dtype)
            return distribute_tensor(full.to(p.device_mesh.device_type, p.dtype),
                                     p.device_mesh, p.placements, src_data_rank=0)
        full = (g.to(p.device, p.dtype) if g is not None
                else torch.empty(p.shape, dtype=p.dtype, device=p.device))
        dist.broadcast(full, src=0)
        return full


@dataclasses.dataclass
class TrainState:
    """The trained model (as the trainer wrapped it), its optimizer and the
    count of micro-steps."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    distributed: bool = False

    def state_dict(self) -> dict:
        """The full state, in one format at every world size: the model's
        state dict (whole tensors, the unwrapped module's keys), AdamW's
        keyed by parameter name, the micro-step and the gradients
        ``Optimizer.full_grads`` gives, all on the CPU.  Under
        ``torch.distributed`` every rank calls it and rank 0 gets the state
        (the other ranks' dicts are empty)."""
        model_sd, adamw_sd = get_state_dict(
            self.model, self.optimizer.adamw,
            options=StateDictOptions(full_state_dict=True, cpu_offload=True))
        return {"step": self.step, "model": model_sd,
                "optimizer": {"adamw": adamw_sd, "mini_step": self.optimizer.mini_step,
                              "grads": self.optimizer.full_grads()}}

    def load_state_dict(self, state: Mapping) -> None:
        """Restore ``state_dict``'s state, strictly.  Under
        ``torch.distributed`` rank 0 passes it and the other ranks an empty
        dict: rank 0 sends every tensor, each rank keeps its shards."""
        opt = self.optimizer
        if not self.distributed:
            self.model.load_state_dict(state["model"], strict=True)
            set_optimizer_state_dict(self.model, opt.adamw,
                                     state["optimizer"]["adamw"])
            self.step, opt.mini_step = int(state["step"]), int(state["optimizer"]["mini_step"])
            opt.load_grads(state["optimizer"]["grads"], False)
            return
        head = [state["step"], state["optimizer"]["mini_step"]] if rank_zero() else [0, 0]
        dist.broadcast_object_list(head, src=0)
        self.step, opt.mini_step = int(head[0]), int(head[1])
        options = StateDictOptions(full_state_dict=True, broadcast_from_rank0=True,
                                   strict=True)
        set_model_state_dict(self.model, state.get("model", {}), options=options)
        set_optimizer_state_dict(self.model, opt.adamw,
                                 state["optimizer"]["adamw"] if rank_zero() else {},
                                 options=options)
        opt.load_grads(state["optimizer"]["grads"] if rank_zero() else None, True)


class DiffusionTrainer:
    """Train and eval steps of a ``SyncFusionDiffusion``, on one device or
    over a ``mesh`` (one rank per card).

    ``train_step`` updates the state in place (the JAX package returns a
    new one) and returns its metrics as device tensors: reading them syncs
    the host, so a loop reads them only where it logs.  Over a mesh each
    step takes the rank's rows of the global batch (``mesh.rows``) and
    reports the global batch's mean loss.  ``fsdp`` shards the parameters,
    their gradients and AdamW's moments over the mesh's ``model`` axis when
    it is wider than 1 (``fsdp_min_size``: see ``train.sharding``).
    """

    def __init__(self, model: nn.Module, opt_cfg: Optional[OptimizerConfig] = None,
                 embedding_mask_proba: float = 0.0, mesh: Optional[Mesh] = None,
                 fsdp: bool = False, fsdp_min_size: int = 2**14):
        self.model = model
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.embedding_mask_proba = embedding_mask_proba
        self.mesh = mesh or Mesh.single()
        self.fsdp = fsdp and self.mesh.model > 1
        self.module, self._whole = sharding.wrap(model, self.mesh, self.fsdp,
                                                 fsdp_min_size)

    def create_state(self) -> TrainState:
        return TrainState(step=0, model=self.module,
                          optimizer=Optimizer(self.module.parameters(), self.opt_cfg),
                          distributed=self.mesh.distributed)

    def _draws(self, wav, embedding, generator) -> dict:
        """Sigma, the noise and (when the UNet drops embeddings for CFG)
        the CFG mask of the global batch, in the order one process draws
        them on the whole batch; this rank's rows of each."""
        b = wav.shape[0] * self.mesh.data
        rows = self.mesh.rows(b)
        draws = {
            "sigma": torch.rand((b,), generator=generator, device=wav.device)[rows],
            "noise": torch.randn((b, *wav.shape[1:]), generator=generator,
                                 device=wav.device, dtype=wav.dtype)[rows]}
        if (embedding is not None and self.embedding_mask_proba > 0.0
                and self.model.unet.cfg.use_embedding_cfg):
            draws["embedding_cfg_mask"] = cfg_dropout_mask(
                b, self.embedding_mask_proba, generator, wav.device)[rows]
        return draws

    def _loss(self, module, batch: Mapping, generator):
        # wire formats, dequantized on the device: int16 wav (opt-in,
        # wire_int16) and uint8 onsets (lossless: the track is binary)
        wav, onsets = batch["wav"], batch["onsets"]
        if wav.dtype == torch.int16:
            wav = wav.float() / 32767.0
        embedding = batch.get("embedding")
        return module(wav, onsets.float(), embedding,
                      embedding_mask_proba=self.embedding_mask_proba,
                      **self._draws(wav, embedding, generator))

    def _global_mean(self, loss):
        """The global batch's mean of the ranks' losses (each the mean of
        equally many rows)."""
        if self.mesh.distributed:
            loss = loss.clone()
            all_reduce_mean_(loss, self.mesh.axis_group(DATA_AXIS))
        return loss

    def train_step(self, state: TrainState, batch: Mapping,
                   generator: Optional[torch.Generator] = None) -> dict:
        """One micro-batch: loss, backward (gradients averaged over the
        data ranks), ``Optimizer.step``."""
        loss = self._loss(state.model, batch, generator)
        loss.backward()
        sharding.average_grads(self._whole, self.mesh)
        state.optimizer.step()
        state.step += 1
        return {"train_loss": self._global_mean(loss.detach())}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Mapping,
                  generator: Optional[torch.Generator] = None) -> dict:
        return {"valid_loss": self._global_mean(self._loss(state.model, batch, generator))}
