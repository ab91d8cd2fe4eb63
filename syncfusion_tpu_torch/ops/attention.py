"""Attention for the UNet's self-attention levels, differentiable.

``flash_attention(q, k, v)`` in the JAX package's (B, L, H, D) layout is one
``torch.autograd.Function`` on every device, the counterpart of the JAX
package's custom VJP.  On a CUDA tensor its forward is the hand-written
kernel of ``csrc/flash_fwd.cu`` (the port of the TPU kernel
``_flash_kernel``, K1: bf16 on TMA and wgmma, its launch plan
``fwd_plan``'s; f32 as 3xTF32 on mma.sync) and its backward
the two kernels of ``csrc/flash_bwd.cu`` (``_flash_bwd_dq_kernel``, K2a,
then ``_flash_bwd_dkv_kernel``, K2b; on the tensor cores likewise).  All
three copy with ``cp.async`` (or TMA) and so take 16-byte aligned operands
with B, L and H strides in multiples of 16 bytes, see
``cp_async_misalignment``.
Those kernels are built for heads of 64 and of 128 features
(``KERNEL_WIDTHS``).  A wider head goes, by width (``kernel_source``), to
the Hopper kernels of ``csrc/flash_fwd_wide_sm90.cu`` (K1) and
``csrc/flash_bwd_wide_sm90.cu`` (K2a, K2b) at any multiple of 64 from 192 to
``WIDE_FWD_MAX`` (TMA loads into an mbarrier-signalled ring, bf16 on wgmma,
f32 as 3xTF32 on mma.sync; K1 holds O and K2 dQ, dK and dV at the full width
in registers, with S computed once a key tile, never once per chunk of
output columns; their tiles are ``wide_fwd_plan``'s and ``wide_bwd_plan``'s),
and above that: K1 to the kernel of ``csrc/flash_fwd_cluster_sm90.cu`` up to
``CLUSTER_FWD_MAX`` (thread-block clusters of up to 8 blocks, each holding a
slice of O's columns; the blocks' partial sums of S added across the
cluster's shared memory, so S is computed once a key tile; its tiles are
``cluster_fwd_plan``'s), and K2a and K2b, and K1 wider still, to the three
chunked kernels of ``csrc/flash_wide.cu`` (any multiple of 64: the head dim
in pieces of 64 columns, a grid dimension over chunks of 128 output
columns, S and dP recomputed once a chunk).  Each width has one
hand-written kernel of each of the three.  On the card
the Function zero-pads a head to ``kernel_width(D)`` (64, 128, or the
least multiple of 64 not below D) and passes the kernels the true width's
scale: the zero columns change no logit, LSE or delta, and the padded
columns of O, dq, dk and dv come out exactly 0 and are sliced off.  On a
CPU tensor the same Function runs their plain versions, so the CPU tests
reach the wiring the card runs.  It never falls back from a kernel to a
plain version on the card.

Each wrapper (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) launches
its kernel on a CUDA tensor and takes its plain version on a CPU tensor, and
counts which, on ``flash_attention``: ``kernel_launches`` (K1),
``dq_launches`` (K2a), ``dkv_launches`` (K2b), at every head width;
``plain_calls`` (K1's plain version) and ``plain_bwd_calls`` (K2a's and
K2b's); and ``entry_launches``, the launches by C entry (each source's
entries have names of their own), which shows which source ran.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from syncfusion_tpu_torch.ops import _build

KERNEL_WIDTHS = (64, 128)  # the widths of flash_fwd.cu's and flash_bwd.cu's kernels
WIDE_STEP = 64  # the wide kernels take multiples of this above KERNEL_WIDTHS
WIDE_FWD_MAX = 512  # the widest head of the Hopper sources (*_wide_sm90.cu)
# K1 above WIDE_FWD_MAX: csrc/flash_fwd_cluster_sm90.cu, clusters of at most
# CLUSTER_MAX blocks of at most CLUSTER_SLICE_MAX columns, each cluster
# aiming at blocks of CLUSTER_TARGET columns (by type)
CLUSTER_MAX = 8
CLUSTER_SLICE_MAX = 512
CLUSTER_FWD_MAX = CLUSTER_MAX * CLUSTER_SLICE_MAX
CLUSTER_TARGET = {"bfloat16": 512, "float32": 256}
SMEM_MAX = 232448  # shared memory a block may have on an H100
# flash_fwd.cu's bf16 K1 by head width: keys a tile, and slots of each of
# its K and V rings (as many as fit a block)
FWD_KEY_TILE = {64: 64, 128: 128}
FWD_STAGES = {64: 4, 128: 3}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _up(x):
    """``x`` in at least f32: the plain versions' arithmetic type (f64 for
    f64 inputs, which only the CPU takes)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def kernel_width(d: int) -> int:
    """The width of the kernel that takes a head of ``d`` features: the
    least of ``KERNEL_WIDTHS`` not below it, and above those the least
    multiple of ``WIDE_STEP`` not below it (the wide kernels)."""
    for width in KERNEL_WIDTHS:
        if d <= width:
            return width
    return -(-d // WIDE_STEP) * WIDE_STEP


def _scale(q, scale):
    """The softmax scale: ``scale``, or 1/sqrt(D) of q's head width."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def attention_reference(q, k, v, causal: bool = False,
                        return_lse: bool = False, scale: float | None = None):
    """Plain attention, (B, L, H, D) layout, math in f32 (f64 for f64
    inputs).

    Returns O in ``q``'s dtype and, with ``return_lse``, the row logsumexp
    of the scaled logits as a (B, H, Lq) f32 tensor.  ``causal`` masks keys
    after the query's own index (top-left aligned, as the TPU kernel does).
    ``scale`` multiplies the logits (default 1/sqrt(D)).
    """
    s = torch.einsum("blhd,bmhd->bhlm", _up(q) * _scale(q, scale), _up(k))
    if causal:
        s = s.masked_fill(~_causal_keep(s), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhlm,bmhd->blhd", p, _up(v)).to(q.dtype)
    return (o, lse) if return_lse else o


def _causal_keep(s):
    lq, lk = s.shape[-2:]
    return torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril()


def _softmax_grad(q, k, v, lse, do, delta, causal, scale):
    """(q·scale, P, dS) in f32 by recompute: P = exp(q kᵀ·scale - lse),
    dS = P∘(dO vᵀ - delta), masked pairs 0."""
    qs = _up(q) * _scale(q, scale)
    s = torch.einsum("blhd,bmhd->bhlm", qs, _up(k))
    if causal:
        s = s.masked_fill(~_causal_keep(s), float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("blhd,bmhd->bhlm", _up(do), _up(v))
    return qs, p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, o, lse, do, causal: bool = False,
                           scale: float | None = None):
    """Plain version of K2a: ``(dq, delta)``, delta = rowsum(dO∘O) as a
    (B, H, Lq) f32 tensor, dq in ``q``'s dtype; ``scale`` as the
    forward's."""
    delta = (_up(do) * _up(o)).sum(-1).transpose(1, 2)
    _, _, ds = _softmax_grad(q, k, v, lse, do, delta, causal, scale)
    dq = torch.einsum("bhlm,bmhd->blhd", ds, _up(k))
    dq = dq / math.sqrt(q.shape[-1]) if scale is None else dq * scale
    return dq.to(q.dtype), delta


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = False,
                            scale: float | None = None):
    """Plain version of K2b: ``(dk, dv)`` in ``k``'s dtype; ``scale`` as
    the forward's."""
    qs, p, ds = _softmax_grad(q, k, v, lse, do, delta, causal, scale)
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qs)
    dv = torch.einsum("bhlm,blhd->bmhd", p, _up(do))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                        scale: float | None = None):
    """The attention backward by recompute in plain PyTorch: ``(dq, dk,
    dv)`` from q, k, v, the forward's O and row LSE (B, H, Lq), and dO."""
    dq, delta = flash_bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def fwd_plan(width: int, batch_heads: int, lq: int, sms: int) -> dict:
    """The launch plan of the bf16 K1 of ``csrc/flash_fwd.cu`` at a head
    ``width`` of 64 or 128, ``batch_heads`` (B x H) and q length ``lq`` on a
    card of ``sms`` SMs, as its ``fwd_groups`` and ``Bf16Plan`` set it (its
    C entry ``flash_fwd_plan`` returns the same): consumer warpgroups a
    block (two, 128 q rows sharing every K and V tile, where a grid of such
    blocks still has one for each SM; else one, 64 rows), q rows a block,
    keys a tile, slots of the K ring and of the V ring, threads (thread 0
    also issues the TMA loads), dynamic shared memory (two q tiles, the
    rings, the barriers and 1024 bytes for the alignment, whatever the
    groups), the columns of a TMA box, the operations per (query, key) pair
    in units of the width, against the function's 4 (S on wgmma, P·V as hi
    + lo bf16), and the blocks of the grid."""
    if width not in KERNEL_WIDTHS:
        raise ValueError(f"the bf16 K1 of flash_fwd.cu takes widths {KERNEL_WIDTHS}; "
                         f"got {width}")
    groups = 2 if -(-lq // 128) * batch_heads >= sms else 1
    rows = 64 * groups
    key_tile, stages = FWD_KEY_TILE[width], FWD_STAGES[width]
    row = width * 2  # bytes of a bf16 row
    return {"q_rows": rows, "groups": groups, "key_tile": key_tile, "stages": stages,
            "threads": 128 * groups,
            "smem_bytes": (1024 + 2 * 64 * row + 2 * stages * key_tile * row
                           + 8 * (4 * stages + 1)),
            "box_cols": 64, "ops_per_pair": 6, "blocks": -(-lq // rows) * batch_heads}


def wide_fwd_plan(width: int, dtype) -> dict:
    """The launch plan of the wide K1 at a head ``width`` (a multiple of
    ``WIDE_STEP`` above 128, at most ``WIDE_FWD_MAX``) and ``dtype``, as
    ``Plan`` of ``csrc/flash_fwd_wide_sm90.cu`` sets it (its C entry
    ``flash_fwd_wide_plan`` returns the same): q rows a block, keys a tile,
    ring slots, the block's two warpgroups split over q tiles of 64 rows
    (``row_groups`` 2: up to 256 columns, each group all of O's columns) or
    over O's 64-column pieces (``col_groups`` 2: each group half of them and
    S itself), threads (thread 0 also issues the TMA loads), dynamic shared
    memory (the q tiles, the slots, the barriers and 1024 bytes for the
    alignment), the columns of a TMA box (128 bytes) and the
    operations per (query, key) pair in units of the width, against the
    function's 4 (bf16: S on wgmma once a column group, P·V as hi + lo
    bf16; f32: tf32 products of 3xTF32 on mma.sync)."""
    if width % WIDE_STEP or not KERNEL_WIDTHS[-1] < width <= WIDE_FWD_MAX:
        raise ValueError(f"the wide K1 takes multiples of {WIDE_STEP} from "
                         f"{KERNEL_WIDTHS[-1] + WIDE_STEP} to {WIDE_FWD_MAX}; got {width}")
    f32 = dtype == torch.float32
    esize = 4 if f32 else 2
    row_groups = 2 if width <= 256 else 1
    col_groups = 2 // row_groups

    def smem(q_tiles, key_tile):
        return 1024 + q_tiles * 64 * width * esize + 2 * key_tile * width * esize + 64

    key_tile = (32 if smem(row_groups, 32) <= SMEM_MAX else 16) if f32 else 64
    return {"q_rows": 64 * row_groups, "key_tile": key_tile, "stages": 2,
            "row_groups": row_groups, "col_groups": col_groups, "threads": 256,
            "smem_bytes": smem(row_groups, key_tile), "box_cols": 128 // esize,
            "ops_per_pair": 3 * (2 * col_groups + 2) if f32 else 2 * col_groups + 4}


def cluster_fwd_plan(width: int, dtype) -> dict:
    """The launch plan of K1 on thread-block clusters at a head ``width`` (a
    multiple of ``WIDE_STEP`` above ``WIDE_FWD_MAX``, at most
    ``CLUSTER_FWD_MAX``) and ``dtype``, as ``cluster_shape`` and
    ``ClusterPlan`` of ``csrc/flash_fwd_cluster_sm90.cu`` set it (its C entry
    ``flash_fwd_cluster_plan`` returns the same): blocks a cluster (N =
    ceil(width / CLUSTER_TARGET), at most CLUSTER_MAX, then as few as cover
    the width with the slice), columns a block (the slice: the least
    multiple of 64 that N of cover the width), keys a tile (bf16 64, f32 32,
    halved where that does not fit), ring slots, threads (two warpgroups;
    thread 0 also issues the TMA loads), dynamic shared memory (the q slice,
    the ring's slots, five 64 x key tile f32 tiles of S: two group
    partials, two exchange buffers, the sum; the barriers and 1024 bytes for
    the alignment), the columns of a TMA box and the operations per (query,
    key) pair in units of the width, against the function's 4 (bf16: S once
    on wgmma, P·V as hi + lo bf16; f32: tf32 products of 3xTF32)."""
    if width % WIDE_STEP or not WIDE_FWD_MAX < width <= CLUSTER_FWD_MAX:
        raise ValueError(f"the cluster K1 takes multiples of {WIDE_STEP} from "
                         f"{WIDE_FWD_MAX + WIDE_STEP} to {CLUSTER_FWD_MAX}; got {width}")
    f32 = dtype == torch.float32
    esize = 4 if f32 else 2
    target = CLUSTER_TARGET["float32" if f32 else "bfloat16"]
    n = min(CLUSTER_MAX, -(-width // target))
    per_block = -(-width // n)
    slice_ = -(-per_block // WIDE_STEP) * WIDE_STEP
    n = -(-width // slice_)

    def smem(key_tile):
        return (1024 + 64 * slice_ * esize + 2 * key_tile * slice_ * esize
                + 5 * 64 * key_tile * 4 + 64)

    full = 32 if f32 else 64
    key_tile = full if smem(full) <= SMEM_MAX else full // 2
    return {"cluster": n, "slice": slice_, "key_tile": key_tile, "stages": 2,
            "threads": 256, "smem_bytes": smem(key_tile), "box_cols": 128 // esize,
            "ops_per_pair": 12 if f32 else 6}


def wide_bwd_plan(width: int, dtype) -> dict:
    """The launch plan of the wide K2a and K2b at a head ``width`` (a
    multiple of ``WIDE_STEP`` above 128, at most ``WIDE_FWD_MAX``) and
    ``dtype``, as ``BwdPlan`` of ``csrc/flash_bwd_wide_sm90.cu`` sets it (its
    C entry ``flash_bwd_wide_plan`` returns the same): the block's own rows
    (K2a q rows, K2b keys: one wgmma M of 64 in bf16, two m16 tiles in f32),
    the rows of a ring tile (the other side's), ring slots, the column parts
    the outputs are split into (bf16: the two warpgroups; f32: four, each
    the columns of two warps, which also split S's and dP's sums), K2b's
    blocks a row tile (bf16: a dK and a dV block), threads, dynamic shared
    memory (the two own tiles, the ring, f32's exchange buffers of partial
    sums, 512 bytes of LSE and delta, the barriers and 1024 bytes for the
    alignment), the columns of a TMA box and K2a's and K2b's operations per
    (query, key) pair in units of the width, against the function's 6 and
    8 (bf16: each warpgroup S and dP on wgmma, the outputs as hi + lo bf16;
    f32: tf32 products of 3xTF32, none repeated)."""
    if width % WIDE_STEP or not KERNEL_WIDTHS[-1] < width <= WIDE_FWD_MAX:
        raise ValueError(f"the wide K2 takes multiples of {WIDE_STEP} from "
                         f"{KERNEL_WIDTHS[-1] + WIDE_STEP} to {WIDE_FWD_MAX}; got {width}")
    f32 = dtype == torch.float32
    esize = 4 if f32 else 2
    rows, parts = (32, 4) if f32 else (64, 2)

    def smem(ring_rows):
        return (1024 + 2 * rows * width * esize + 2 * ring_rows * width * esize
                + (2 * 2 * parts * rows * ring_rows * 4 if f32 else 0) + 512 + 64)

    ring_rows = (32 if smem(32) <= SMEM_MAX else 16) if f32 else 32
    return {"rows": rows, "ring_rows": ring_rows, "stages": 2, "parts": parts,
            "roles": 1 if f32 else 2, "threads": 256, "smem_bytes": smem(ring_rows),
            "box_cols": 128 // esize, "dq_ops_per_pair": 18 if f32 else 12,
            "dkv_ops_per_pair": 24 if f32 else 20}


def wide_bwd_blocks(width: int, dtype, batch_heads: int, lq: int, lk: int) -> dict:
    """The blocks of one call of the wide K2a and K2b (``wide_bwd_plan``'s
    tiles) at ``batch_heads`` (B x H) and sequence lengths ``lq``, ``lk``."""
    plan = wide_bwd_plan(width, dtype)
    rows = plan["rows"]
    return {"dq": -(-lq // rows) * batch_heads,
            "dkv": -(-lk // rows) * batch_heads * plan["roles"]}


def kernel_source(index: int, d: int) -> str:
    """The source (``csrc/<name>.cu``) of K1 (``index`` 0), K2a (1) or K2b
    (2) at kernel width ``d``: ``flash_fwd`` and ``flash_bwd`` at 64 and
    128, the Hopper sources ``flash_fwd_wide_sm90`` and
    ``flash_bwd_wide_sm90`` at 192 to ``WIDE_FWD_MAX``; above, K1 on
    thread-block clusters, ``flash_fwd_cluster_sm90``, up to
    ``CLUSTER_FWD_MAX``, and ``flash_wide`` (the chunked kernels) for K1
    wider still and for K2a and K2b."""
    if d <= KERNEL_WIDTHS[-1]:
        return "flash_fwd" if index == 0 else "flash_bwd"
    if d <= WIDE_FWD_MAX:
        return "flash_fwd_wide_sm90" if index == 0 else "flash_bwd_wide_sm90"
    if index == 0 and d <= CLUSTER_FWD_MAX:
        return "flash_fwd_cluster_sm90"
    return "flash_wide"


# the C entries of each source, by kernel index: K1 0, K2a 1, K2b 2
_ENTRIES = {"flash_fwd": {0: "flash_fwd"},
            "flash_bwd": {1: "flash_bwd_dq", 2: "flash_bwd_dkv"},
            "flash_fwd_wide_sm90": {0: "flash_fwd_wide"},
            "flash_bwd_wide_sm90": {1: "flash_bwd_dq_wide", 2: "flash_bwd_dkv_wide"},
            "flash_fwd_cluster_sm90": {0: "flash_fwd_cluster"},
            "flash_wide": {0: "flash_fwd_chunked", 1: "flash_bwd_dq_chunked",
                           2: "flash_bwd_dkv_chunked"}}


@functools.cache
def _kernels(source: str) -> dict:
    """The C entries of ``csrc/<source>.cu`` by kernel index, typed: every
    K1 takes one argument list, every K2a and K2b another."""
    lib = _build.library(source)
    i, ll, p, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
    fns = {}
    for index, name in _ENTRIES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = ([i, p, p, p, p, p, i, i, i, i, i, *([ll] * 12), i, f, p]
                       if index == 0 else
                       [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p, i, f, p])
        fn.restype = i
        fns[index] = fn
    return fns


def cp_async_misalignment(name: str, ptr: int, shape, strides,
                          esize: int = 2) -> str | None:
    """Why the kernels' 16-byte ``cp.async`` copies cannot take a (B, L, H,
    D) operand of ``esize``-byte elements (bf16 by default) at address
    ``ptr`` with these element ``strides`` of B, L and H, or None if they
    can: the address must be a multiple of 16 bytes and each stride (of a
    dim longer than 1) a multiple of 16 bytes, i.e. of ``16 // esize``
    elements."""
    if ptr % 16:
        return f"{name}: data_ptr {ptr:#x} is not 16-byte aligned"
    per = 16 // esize
    for dim, size, stride in zip("BLH", shape, strides):
        if size > 1 and stride % per:
            return (f"{name}: its {dim} stride {stride} is not a multiple "
                    f"of {per} elements")
    return None


def _check(q, k, v):
    if q.device.type != "cuda":
        raise RuntimeError(f"the kernels run on cuda, not {q.device.type}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, L, H, D)")
    (b, _, h, d), (bk, lk, hk, dk) = q.shape, k.shape
    if d != kernel_width(d) or dk != d or v.shape[-1] != d:
        raise ValueError(f"the kernels take head dims {KERNEL_WIDTHS} and "
                         f"multiples of {WIDE_STEP} above; got q {d}, k {dk}, "
                         f"v {v.shape[-1]} (flash_attention pads a head of {d} "
                         f"to {kernel_width(d)})")
    if (bk, hk) != (b, h) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def _check_aligned(**tensors):
    for name, x in tensors.items():
        why = cp_async_misalignment(name, x.data_ptr(), x.shape[:3],
                                    x.stride()[:3], x.element_size())
        if why is not None:
            raise ValueError(f"the attention kernels copy with TMA or cp.async: {why}")


def _for_cp_async(x):
    """``x`` if the kernels' ``cp.async`` copies can take it, else a
    contiguous copy of it (freshly allocated, so 16-byte aligned)."""
    why = cp_async_misalignment("x", x.data_ptr(), x.shape[:3], x.stride()[:3],
                                x.element_size())
    return x if why is None else x.clone(memory_format=torch.contiguous_format)


def _check_rows(q, **tensors):
    """o and dO: q's shape, dtype and device with a contiguous head dim;
    lse and delta: contiguous (B, H, Lq) f32 on q's device."""
    b, lq, h, _ = q.shape
    for name, x in tensors.items():
        if name in ("lse", "delta"):
            ok = (x.dtype == torch.float32 and x.shape == (b, h, lq)
                  and x.is_contiguous())
        else:
            ok = x.dtype == q.dtype and x.shape == q.shape and x.stride(-1) == 1
        if not ok or x.device != q.device:
            raise ValueError(f"{name} does not fit q {tuple(q.shape)} "
                             f"{q.dtype}: {tuple(x.shape)} {x.dtype} {x.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q, k, v, causal: bool = False, scale: float | None = None):
    """K1: ``(o, lse)``, O in q's dtype, LSE (B, H, Lq) f32; ``scale``
    multiplies the logits (default 1/sqrt(D)).  The kernel of
    ``kernel_source`` on a CUDA tensor of head dim 64, 128 or a multiple of
    64 above (raises ``ValueError`` for another width or a q, k or v
    ``cp.async`` or TMA cannot take), ``attention_reference`` on a CPU
    tensor."""
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        return attention_reference(q, k, v, causal, return_lse=True, scale=scale)
    _check(q, k, v)
    _check_aligned(q=q, k=k, v=v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)]
    _raise_on(_entry(0, d)(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d, *strides, int(causal),
        _scale(q, scale), _stream(q)), "flash_fwd")
    _launched(0, d)
    return o, lse


def _stride_array(*tensors):
    return (ctypes.c_longlong * 18)(
        *[t.stride(i) for t in tensors for i in (0, 1, 2)])


def _entry(index: int, d: int):
    """The C entry of K1 (0), K2a (1) or K2b (2) for heads of ``d``."""
    return _kernels(kernel_source(index, d))[index]


_COUNT_OF = ("kernel_launches", "dq_launches", "dkv_launches")


def _launched(index: int, d: int) -> None:
    """Count one launch of K1 (0), K2a (1) or K2b (2) at heads of ``d``:
    the kernel's count and its C entry's."""
    name = _COUNT_OF[index]
    setattr(flash_attention, name, getattr(flash_attention, name) + 1)
    flash_attention.entry_launches[_ENTRIES[kernel_source(index, d)][index]] += 1


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = False,
                 scale: float | None = None):
    """K2a: ``(dq, delta)`` as ``flash_bwd_dq_reference``.  The kernel on a
    CUDA tensor (raises ``ValueError`` as ``flash_fwd``), that plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        flash_attention.plain_bwd_calls += 1
        return flash_bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    _check(q, k, v)
    _check_rows(q, o=o, do=do, lse=lse)
    _check_aligned(q=q, k=k, v=v, o=o, do=do)
    b, lq, h, d = q.shape
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _raise_on(_entry(1, d)(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, h, lq, k.shape[1], d, _stride_array(q, k, v, o, do, dq),
        int(causal), _scale(q, scale), _stream(q)), "flash_bwd_dq")
    _launched(1, d)
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  scale: float | None = None):
    """K2b: ``(dk, dv)`` as ``flash_bwd_dkv_reference``.  The kernel on a
    CUDA tensor (raises ``ValueError`` as K2a), that plain version on a CPU
    tensor."""
    if q.device.type == "cpu":
        flash_attention.plain_bwd_calls += 1
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v)
    _check_rows(q, do=do, lse=lse, delta=delta)
    _check_aligned(q=q, k=k, v=v, do=do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    b, lq, h, d = q.shape
    _raise_on(_entry(2, d)(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, lq, k.shape[1], d, _stride_array(q, k, v, do, dk, dv),
        int(causal), _scale(q, scale), _stream(q)), "flash_bwd_dkv")
    _launched(2, d)
    return dk, dv


def _pads(q) -> bool:
    """Whether the Function zero-pads q's head to a kernel width: on the
    card, where the kernels run (the plain versions take any width)."""
    return q.device.type == "cuda"


def _pad_head(x, width):
    """x (B, L, H, D) zero-padded to ``width`` features (a new contiguous
    tensor), or x itself at that width."""
    d = x.shape[-1]
    return x if d == width else torch.nn.functional.pad(x, (0, width - d))


def _cut_head(x, d):
    """The first ``d`` features of x (a view), or x itself at that width."""
    return x if x.shape[-1] == d else x[..., :d]


class _FlashAttention(torch.autograd.Function):
    """Forward K1, backward K2a then K2b (each wrapper takes its plain
    version on a CPU tensor).  On the card a head of D features is
    zero-padded to ``kernel_width(D)``, the kernels take 1/sqrt(D), and O,
    dq, dk and dv are sliced back to D.  Saves q, k, v, O (padded) and the
    LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        d = q.shape[-1]
        scale = 1.0 / math.sqrt(d)
        if _pads(q):
            width = kernel_width(d)
            if width != d:
                q, k, v = (_pad_head(x, width) for x in (q, k, v))
            elif q.device.type == "cuda" and q.dtype == torch.float32:
                # training's f32 path takes any strides (autograd may hand
                # over a view cp.async cannot take): K1 gets copies of
                # those, and K2a and K2b the same tensors; bf16 views that
                # do not fit raise
                q, k, v = map(_for_cp_async, (q, k, v))
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.causal, ctx.scale, ctx.d = causal, scale, d
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return _cut_head(o, d), lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        d = ctx.d
        if do.stride(-1) != 1:
            do = do.contiguous()
        do = _pad_head(do, q.shape[-1])
        if q.device.type == "cuda":
            # autograd may hand over a dO that cp.async cannot take (a slice
            # of a cat's gradient, an odd stride): K2a and K2b get a copy
            q, k, v, o, do = map(_for_cp_async, (q, k, v, o, do))
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return _cut_head(dq, d), _cut_head(dk, d), _cut_head(dv, d), None


def flash_attention(q, k, v, causal: bool = False, return_lse: bool = False):
    """Attention in (B, L, H, D) layout, differentiable in q, k and v: the
    CUDA kernels on the card, the plain versions on the CPU.  Same returns
    as ``attention_reference`` (the LSE carries no gradient)."""
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_attention runs on cuda or cpu, "
                           f"not {q.device.type}")
    o, lse = _FlashAttention.apply(q, k, v, causal)
    return (o, lse) if return_lse else o


def reset_counts() -> None:
    """Set every launch and plain-call count of ``flash_attention`` to 0,
    and empty its launches by C entry."""
    for name in COUNTS:
        setattr(flash_attention, name, 0)
    flash_attention.entry_launches = collections.Counter()


COUNTS = ("kernel_launches", "dq_launches", "dkv_launches", "plain_calls",
          "plain_bwd_calls")
reset_counts()
