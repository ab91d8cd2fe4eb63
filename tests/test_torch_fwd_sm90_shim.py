"""K1 at heads of 64 and 128 (``syncfusion_tpu_torch/csrc/flash_fwd.cu``) run
on the CPU, its CUDA source compiled by g++ against ``tests/cuda_shim``
(``cuda_shim_build``): one std::thread per CUDA thread, and lane-exact
models of the instructions of ``csrc/sm90.cuh`` (mbarrier phases, the TMA
tile copy with zero fill and the 128-byte swizzle, the wgmma descriptor,
wgmma m64n64k16 and m64n128k16 bf16 run when their group is waited for, so that an
accumulator read before its wait or a P fragment reused while its product
is in flight shows) and of ``csrc/ptx.cuh`` (cp.async, mma.sync m16n8k8
tf32 for the f32 kernel).  The library's C entry runs on CPU tensors
against ``attention_reference``: the bf16 kernel (TMA, mbarrier rings,
wgmma) with one and two warpgroups a block, a ragged length, Lq != Lk both
ways, causal, q, k and v as views of one packed projection, a q length
below one tile, more key tiles than ring slots; and the f32 kernel at two
shapes.  The shim reports a card of 4 SMs, so these small grids reach both
of the plan's choices; the library's plan is ``fwd_plan``'s.

What this cannot see: registers and spills (``chip_smoke.py`` phase 2
gates them, and ptxas's C7520), speed, and the hardware's own reading of a
descriptor or a tensor map beyond the models' (the card tests in
``tests/test_torch_cuda.py``).
"""

import ctypes
import math

import pytest
import torch

import cuda_shim_build
from syncfusion_tpu_torch.ops import attention as ta

SHIM_SMS = 4  # tests/cuda_shim/shim.h's kShimSmCount
PLAN_KEYS = ("q_rows", "groups", "key_tile", "stages", "threads", "smem_bytes",
             "box_cols", "ops_per_pair", "blocks")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = cuda_shim_build.load(tmp_path_factory, "flash_fwd.cu", 2)
    i, ll, p, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
    so.flash_fwd.argtypes = [i, p, p, p, p, p, i, i, i, i, i, *([ll] * 12), i, f, p]
    so.flash_fwd.restype = i
    so.flash_fwd_plan.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    so.flash_fwd_smem.argtypes = [i, i]
    return so


def plan_of(lib, width, batch_heads, lq, sms):
    out = (ctypes.c_int * len(PLAN_KEYS))()
    assert lib.flash_fwd_plan(width, batch_heads, lq, sms, out) == 0
    return dict(zip(PLAN_KEYS, out))


def run(lib, q, k, v, causal, scale):
    """The C entry as ``ta.flash_fwd`` calls it, on CPU tensors; O and the
    LSE start as NaN, so an element the kernel never writes shows."""
    b, lq, h, d = q.shape
    o = torch.full((b, lq, h, d), float("nan"), dtype=q.dtype)
    lse = torch.full((b, h, lq), float("nan"))
    strides = [t.stride(j) for t in (q, k, v, o) for j in (0, 1, 2)]
    err = lib.flash_fwd(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, lq,
                        k.shape[1], d, *strides, int(causal), scale, None)
    assert err == 0
    return o, lse


# width, type, batch, heads, Lq, Lk, causal, packed (q, k, v views of one
# (B, L, 3, H, W) projection; else q apart from a (2, B, Lk, H, W) k and v),
# warpgroups the plan gives on the shim's 4 SMs; key tiles of 64 and rings
# of 4 slots at 64, of 128 and 3 slots at 128
CASES = [(64, torch.bfloat16, 2, 2, 200, 200, False, True, 2),   # ragged, 2 groups
         (64, torch.bfloat16, 1, 2, 300, 300, True, True, 2),    # causal, 5 key tiles
         (64, torch.bfloat16, 1, 1, 200, 200, True, True, 1),    # causal, one group
         (64, torch.bfloat16, 1, 1, 70, 700, False, False, 1),   # Lq < Lk, 11 key tiles
         (64, torch.bfloat16, 2, 2, 130, 70, False, False, 2),   # Lq > Lk
         (64, torch.bfloat16, 1, 1, 40, 40, False, True, 1),     # Lq below a tile
         (128, torch.bfloat16, 1, 1, 200, 200, False, True, 1),  # ragged, one group
         (128, torch.bfloat16, 2, 2, 260, 260, True, True, 2),   # causal, 2 groups
         (128, torch.bfloat16, 2, 1, 100, 600, False, False, 1),  # Lq < Lk, 5 key tiles
         (64, torch.float32, 1, 2, 100, 130, True, True, None),
         (128, torch.float32, 1, 1, 70, 70, False, False, None)]


@pytest.mark.parametrize("width,dtype,b,h,lq,lk,causal,packed,groups", CASES)
def test_forward_through_the_shim(lib, width, dtype, b, h, lq, lk, causal, packed,
                                  groups):
    """O within the f32 rounding of the sums (1e-5; bf16: one ulp of |O| <
    2, 8e-3, and at most 5e-3 of its elements rounded otherwise than the
    plain version, phase 5's bound in chip_smoke.py: P fed as hi + lo bf16
    keeps it) and the LSE within 1e-5 of the plain version."""
    if dtype == torch.bfloat16:
        assert plan_of(lib, width, b * h, lq, SHIM_SMS)["groups"] == groups
    gen = torch.Generator().manual_seed(width + lq + lk)
    if packed:
        q, k, v = torch.randn((b, lq, 3, h, width), generator=gen).to(dtype).unbind(2)
    else:
        q = torch.randn((b, lq, h, width), generator=gen).to(dtype)
        k, v = torch.randn((2, b, lk, h, width), generator=gen).to(dtype).unbind(0)
    scale = 1.0 / math.sqrt(width)
    o, lse = run(lib, q, k, v, causal, scale)
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True,
                                            scale=scale)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    assert (o.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        assert (o != want).float().mean().item() <= 5e-3
    assert (lse - want_lse).abs().max().item() <= 1e-5


def test_the_same_bits_twice(lib):
    """No atomics and a fixed order of sums: two launches give the same O
    and LSE bits (causal, two warpgroups)."""
    q, k, v = torch.randn((1, 200, 3, 2, 64),
                          generator=torch.Generator().manual_seed(3)).to(
                              torch.bfloat16).unbind(2)
    first = run(lib, q, k, v, True, 0.125)
    second = run(lib, q, k, v, True, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width", ta.KERNEL_WIDTHS)
def test_library_plan_is_fwd_plans(lib, width):
    """At the main path's shapes (BH 8-128, T 256-2048) on a card of 132
    SMs, at the shim's 4, and at ragged lengths, the library's plan and its
    shared memory for bf16 are the mirror's."""
    for sms in (SHIM_SMS, 132):
        for batch_heads in (1, 8, 16, 64, 128):
            for lq in (40, 200, 256, 512, 1000, 1024, 2048):
                assert plan_of(lib, width, batch_heads, lq, sms) == \
                    ta.fwd_plan(width, batch_heads, lq, sms)
    assert lib.flash_fwd_smem(1, width) == ta.fwd_plan(width, 1, 64, 1)["smem_bytes"]
    assert lib.flash_fwd_plan(192, 1, 64, 132, (ctypes.c_int * len(PLAN_KEYS))()) == -1
