"""How a trainer spreads its model over a mesh (the port of
``syncfusion_tpu/train/sharding.py``'s ``ShardedStep`` and of the FSDP rule
of ``syncfusion_tpu/core/mesh.py``).

The JAX package jits each step with the batch sharded over ``data`` and lets
GSPMD insert the gradient reductions.  Here the model is wrapped once:

  * DDP over the ``data`` group: parameters replicated, each rank's
    gradients averaged over the data ranks after every backward, as the JAX
    package's ``jax.grad`` of a batch-sharded loss averages them.  The ranks
    of one ``model`` group (``model_parallel > 1`` without FSDP) hold whole
    replicas and take the same rows, as the JAX package shards the batch
    over ``data`` alone there.
  * FSDP2 (``fully_shard``) over the 2-D mesh when ``fsdp`` and ``model >
    1``: replicated over ``data``, each parameter of at least
    ``fsdp_min_size`` elements sharded over ``model`` along the dimension
    ``core.mesh.fsdp_shard_dim`` picks; smaller ones stay whole on every
    rank, their gradients averaged by ``average_grads``.  It wraps each of
    the model's top-level blocks and the root.

Frozen modules (the CondFoleyGen GPT's VQ and video net) are sharded by
the same rule with ``shard_frozen``, as one unit: their parameters are
all-gathered around each call of the module's ``forward`` and resharded
after it, the JAX package's ``place_frozen``.

A single process is left as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from syncfusion_tpu_torch.core.mesh import (
    DATA_AXIS,
    Mesh,
    all_reduce_mean_,
    fsdp_shard_dim,
    replicate_check,
)


def _mean_hook(group, bucket):
    """DDP communication hook: the bucket's mean over ``group`` (NCCL's
    average, gloo's sum over the group's size)."""
    buf = bucket.buffer()
    return all_reduce_mean_(buf, group, async_op=True).get_future().then(
        lambda fut: fut.value()[0])


def wrap(model: nn.Module, mesh: Mesh, fsdp: bool = False,
         fsdp_min_size: int = 2**14) -> tuple[nn.Module, list[nn.Parameter]]:
    """``(module to train, parameters whose gradients average_grads must
    average)``.  Checks first that every rank holds the same parameters and
    buffers (``replicate_check``)."""
    if not mesh.distributed:
        return model, []
    replicate_check([*model.parameters(), *model.buffers()], mesh)
    if fsdp and mesh.model > 1:
        return _fully_shard(model, mesh, fsdp_min_size)
    device = next(model.parameters()).device
    group = mesh.axis_group(DATA_AXIS)
    # static_graph: the parameters the loss reaches are the same every step
    # (the encoder's last level feeds no context map, so some never get a
    # gradient); DDP learns them in the first step instead of searching the
    # graph after every forward
    ddp = nn.parallel.DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        process_group=group, static_graph=True, broadcast_buffers=False)
    ddp.register_comm_hook(group, _mean_hook)
    return ddp, []


def _fully_shard(model: nn.Module, mesh: Mesh, min_size: int, blocks: bool = True):
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dims = {p: fsdp_shard_dim(tuple(p.shape), mesh.model, min_size)
            for p in model.parameters()}
    whole = {p for p, d in dims.items() if d is None}

    def shard(module):
        fully_shard(module, mesh=mesh.device_mesh, ignored_params=whole,
                    shard_placement_fn=lambda p: Shard(dims[p]))

    for block in model.children() if blocks else ():
        if any(p not in whole for p in block.parameters()):
            shard(block)
    shard(model)
    return model, [p for p in model.parameters() if p in whole]


def shard_frozen(module: nn.Module, mesh: Mesh, fsdp: bool = False,
                 fsdp_min_size: int = 2**14) -> nn.Module:
    """Place a frozen module (no gradients) for the mesh: with ``fsdp`` and
    ``model > 1``, FSDP2 over the whole module as one unit, each parameter
    of at least ``fsdp_min_size`` elements sharded over ``model`` (call the
    module's ``forward``: that is where the parameters are gathered);
    otherwise whole on every rank, checked alike (``replicate_check``)."""
    if not mesh.distributed:
        return module
    replicate_check([*module.parameters(), *module.buffers()], mesh)
    if fsdp and mesh.model > 1:
        _fully_shard(module, mesh, fsdp_min_size, blocks=False)
    return module


def average_grads(params: list[nn.Parameter], mesh: Mesh) -> None:
    """Average the gradients of ``params`` over the mesh, in one collective
    (FSDP leaves the parameters it keeps whole to the caller).  Ranks of a
    model group hold equal gradients, so the mesh's mean is the data
    ranks'."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_mean_(flat, mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
