"""The multi-device layer over ``torch.distributed`` (port of
``syncfusion_tpu/core/mesh.py``).

The JAX package runs one process over a 2-D ``(data, model)`` device mesh;
the port runs one process per card, launched by ``python -m
torch.distributed.run`` (torchrun), which tells each process its ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``.  The semantics are the JAX package's:

  * ``data``: a global batch's rows are split over the data ranks; rank r
    sits at mesh coordinate ``(r // model, r % model)``, as the JAX mesh
    reshapes its device list;
  * ``model``: parameters are sharded over it under FSDP
    (``train/sharding.py``); without FSDP the ranks of one model group keep
    whole replicas and take the same rows.

A single process that was not launched by torchrun runs on its own, with no
process group and no collective: ``Mesh.single()``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from syncfusion_tpu_torch.device import default_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def rank_zero() -> bool:
    """True in a single process and on rank 0 of a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def launched() -> bool:
    """True in a process that torchrun started (it sets ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``, which ``init_distributed`` and
    ``device.default_device`` read)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    The device is ``default_device(device)``: ``cuda:LOCAL_RANK`` under
    torchrun, or the one the caller names.  The backend follows it: NCCL on
    a card, gloo only when the caller asks for the CPU.  ``init_method``,
    ``rank`` and ``world_size`` default to torchrun's environment (the tests
    pass a ``file://`` store and both numbers).  Joining twice is a no-op.
    """
    device = default_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {} if init_method is None else {
            "init_method": init_method, "rank": rank, "world_size": world_size}
        if device.type == "cuda":
            kw["device_id"] = device
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", **kw)
    return device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. ``data=-1`` means "all remaining ranks"."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"MeshSpec(data={self.data}, model={self.model}) does not "
                f"tile {n_devices} devices"
            )
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh over ranks ``0 .. data·model - 1``.

    ``device_mesh`` is the torch ``DeviceMesh`` named ``("data", "model")``
    and ``group`` the process group of all the mesh's ranks (None: the
    default group, which the mesh fills); both are None in a single
    process.  A rank at or beyond ``data·model`` sits out: it owns no rows.
    """

    data: int
    model: int = 1
    rank: int = 0
    device_mesh: object = None
    group: object = None

    @classmethod
    def single(cls) -> "Mesh":
        return cls(1, 1)

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    def axis_group(self, axis: str):
        """The process group of this rank along ``axis`` (None in a single
        process)."""
        return self.device_mesh.get_group(axis) if self.distributed else None

    def rows(self, global_batch: int) -> slice:
        """The global rows this rank owns: its data index's block."""
        if self.rank >= self.size:
            raise ValueError(f"rank {self.rank} sits out of the {self.data}x{self.model} mesh")
        n = local_batch_size(global_batch, self)
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.group)


def create_mesh(spec: MeshSpec | None = None, world_size: Optional[int] = None) -> Mesh:
    """The ``(data, model)`` mesh over all ``world_size`` ranks (default:
    the process group's, or one process).  Every rank calls it: building
    the groups is a collective."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    data, model = (spec or MeshSpec()).resolve(world_size)
    return _mesh(data, model)


def mesh_for_batch(batch_size: int, world_size: Optional[int] = None) -> Mesh:
    """Mesh whose data axis is the largest divisor of ``batch_size`` that
    fits the world, so that a small batch still runs on a large world: the
    ranks beyond it sit out (the JAX package leaves its surplus devices
    out the same way)."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh(data_axis_for_batch(batch_size, world_size), 1)


def data_axis_for_batch(batch_size: int, world_size: int) -> int:
    """The largest divisor of ``batch_size`` that is at most ``world_size``."""
    return next(d for d in range(min(world_size, batch_size), 0, -1)
                if batch_size % d == 0)


def _mesh(data: int, model: int) -> Mesh:
    if not dist.is_initialized():
        if data * model != 1:
            raise ValueError(f"a ({data}, {model}) mesh needs "
                             "torch.distributed; launch with torchrun")
        return Mesh.single()
    from torch.distributed.device_mesh import DeviceMesh

    size = data * model
    ranks = torch.arange(size).reshape(data, model)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = DeviceMesh(device_type, ranks, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    # new_group is a collective of the default group: every rank builds it
    group = (None if size == dist.get_world_size()
             else dist.new_group(list(range(size))))
    return Mesh(data, model, dist.get_rank(), device_mesh, group)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    if global_batch % mesh.data:
        raise ValueError(f"batch {global_batch} not divisible by data axis {mesh.data}")
    return global_batch // mesh.data


def all_reduce_mean_(tensor: torch.Tensor, group=None, async_op: bool = False):
    """``tensor`` becomes its mean over ``group``, in place: NCCL's
    average (one pass, the divide folded in), gloo's sum over the group's
    size (gloo has no average).  Returns the work handle with
    ``async_op``."""
    if dist.get_backend(group) == "nccl":
        return dist.all_reduce(tensor, op=dist.ReduceOp.AVG, group=group,
                               async_op=async_op)
    tensor.div_(dist.get_world_size(group))
    return dist.all_reduce(tensor, group=group, async_op=async_op)


def fsdp_shard_dim(shape: tuple, model: int, min_size: int = 2**14) -> Optional[int]:
    """The dimension a parameter of ``shape`` is sharded over ``model``
    along, or None to keep it whole (the JAX package's
    ``fsdp_param_specs``): the last dimension divisible by the model axis,
    for a parameter of at least ``min_size`` elements."""
    numel = 1
    for s in shape:
        numel *= s
    if model == 1 or numel < min_size:
        return None
    for d in reversed(range(len(shape))):
        if shape[d] % model == 0 and shape[d] >= model:
            return d
    return None


def replicate_check(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Raise ``ValueError`` when ``tensors`` differ across the mesh's ranks.

    Each rank reduces its tensors to one f64 digest on its device (count,
    sizes and the sum of |x|, in a fixed order, so equal tensors give equal
    bits), and the ranks all-gather the digests.  DDP would broadcast rank
    0's parameters silently; this is where a rank that built or restored
    other weights is caught.  A single process has nothing to check.
    """
    if not mesh.distributed or mesh.size == 1:
        return
    tensors = [t.detach() for t in tensors]
    device = tensors[0].device
    digest = torch.tensor(len(tensors) + 0.31 * sum(t.numel() for t in tensors),
                          dtype=torch.float64, device=device)
    for t in tensors:
        digest += t.double().abs().sum()
    gathered = [torch.empty_like(digest) for _ in range(mesh.size)]
    dist.all_gather(gathered, digest, group=mesh.group)
    values = [g.item() for g in gathered]
    if len(set(values)) != 1:
        raise ValueError(
            f"replicate_check: parameters differ across ranks (digests {values}); "
            "every rank must build the same parameters (same seed, same "
            "restored checkpoint)")
