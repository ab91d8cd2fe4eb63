"""K1 for heads wider than 512 on thread-block clusters
(``syncfusion_tpu_torch/csrc/flash_fwd_cluster_sm90.cu``) run on the CPU,
its CUDA source compiled by g++ against ``tests/cuda_shim``
(``cuda_shim_build``): the blocks of each cluster run together, one
std::thread per CUDA thread, each block with its own shared window, all of
them on one cluster barrier; ``mapa`` and ``ld.shared::cluster`` read a
peer's window; and the instructions of ``csrc/sm90.cuh`` (mbarrier phases,
TMA with zero fill and the 128-byte swizzle, wgmma run when its group is
waited for) and ``csrc/ptx.cuh`` (mma.sync m16n8k8 tf32) are modelled
lane-exact.  The library's C entry runs on CPU tensors against
``attention_reference``: both types, causal and not, at W = 576, at the
narrowest width whose last slice is ragged, at W = 1024, a sequence below
one tile and a ragged one; every element written (the outputs start as
NaN) and the same bits from a second call.  The library's launch plan is
``cluster_fwd_plan``'s at every width it takes.

What this cannot see: registers and spills (``chip_smoke.py`` phase 2 gates
them), speed, the card's own scheduling of a cluster and the ordering of
its distributed shared memory beyond the barrier's (the card tests in
``tests/test_torch_cuda.py``).
"""

import ctypes
import math

import pytest
import torch

import cuda_shim_build
from syncfusion_tpu_torch.ops import attention as ta

PLAN_KEYS = ("cluster", "slice", "key_tile", "stages", "threads", "smem_bytes",
             "box_cols", "ops_per_pair")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = cuda_shim_build.load(tmp_path_factory, "flash_fwd_cluster_sm90.cu", 0, 1)
    i, ll, p, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
    so.flash_fwd_cluster.argtypes = [i, p, p, p, p, p, i, i, i, i, i, *([ll] * 12), i, f,
                                     p]
    so.flash_fwd_cluster.restype = i
    so.flash_fwd_cluster_plan.argtypes = [i, i, ctypes.POINTER(i)]
    return so


def run(lib, q, k, v, causal, scale):
    """The C entry as ``ta.flash_fwd`` calls it, on CPU tensors; O and the
    LSE start as NaN, so an element the kernel never writes shows."""
    b, lq, h, d = q.shape
    o = torch.full((b, lq, h, d), float("nan"), dtype=q.dtype)
    lse = torch.full((b, h, lq), float("nan"))
    strides = [t.stride(j) for t in (q, k, v, o) for j in (0, 1, 2)]
    err = lib.flash_fwd_cluster(int(q.dtype == torch.bfloat16), q.data_ptr(),
                                k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                lse.data_ptr(), b, h, lq, k.shape[1], d, *strides,
                                int(causal), scale, None)
    assert err == 0
    return o, lse


def ragged_width(dtype) -> int:
    """The narrowest width whose last slice holds fewer pieces than the
    others."""
    for width in range(576, ta.CLUSTER_FWD_MAX + 1, 64):
        plan = ta.cluster_fwd_plan(width, dtype)
        if plan["cluster"] * plan["slice"] > width:
            return width
    raise AssertionError("no width with a ragged last slice")


# width (None: ragged_width), batch, heads, Lq, Lk: q, k and v views of one
# packed (B, L, 3, H, W) projection
SHAPES = {"576": (576, 1, 1, 70, 70), "ragged_slice": (None, 1, 1, 40, 40),
          "1024_below_a_tile": (1024, 1, 1, 40, 40), "1024_ragged_length": (1024, 1, 2, 100, 100)}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cluster_forward_through_the_shim(lib, shape, dtype, causal):
    """O within the f32 rounding of the sums (1e-5; bf16: one ulp of |O| <
    2, 8e-3, and at most 5e-3 of its elements rounded otherwise than the
    plain version) and the LSE within 1e-5 of the plain version; the same
    bits from a second call (S summed in rank order, no atomics)."""
    width, b, h, lq, lk = SHAPES[shape]
    width = width or ragged_width(dtype)
    gen = torch.Generator().manual_seed(width + lq + causal)
    q, k, v = torch.randn((b, lq, 3, h, width), generator=gen).to(dtype).unbind(2)
    scale = 1.0 / math.sqrt(width)
    o, lse = run(lib, q, k, v, causal, scale)
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True,
                                            scale=scale)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    assert (o.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        assert (o != want).float().mean().item() <= 5e-3
    assert (lse - want_lse).abs().max().item() <= 1e-5
    if shape == "576" and not causal:
        o2, lse2 = run(lib, q, k, v, causal, scale)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_library_plan_is_cluster_fwd_plans(lib, dtype):
    for width in range(576, ta.CLUSTER_FWD_MAX + 1, 64):
        out = (ctypes.c_int * len(PLAN_KEYS))()
        assert lib.flash_fwd_cluster_plan(int(dtype == torch.bfloat16), width, out) == 0
        assert dict(zip(PLAN_KEYS, out)) == ta.cluster_fwd_plan(width, dtype)
    for width in (512, 600, ta.CLUSTER_FWD_MAX + 64):
        assert lib.flash_fwd_cluster_plan(0, width, (ctypes.c_int * 8)()) == -1
