"""K2a and K2b in bf16 at heads of 64 and 128
(``syncfusion_tpu_torch/csrc/flash_bwd_sm90.cu``) run on the CPU, their CUDA
source compiled by g++ against ``tests/cuda_shim`` (``cuda_shim_build``):
one std::thread per CUDA thread, and lane-exact models of the instructions
of ``csrc/sm90.cuh`` (mbarrier phases, the TMA tile copy with zero fill and
the 128-byte swizzle, the wgmma descriptor, wgmma m64n64k16 and m64n32k16
``ss`` and m64n64k16 ``rs`` bf16, run when their group is waited for, so
that an accumulator read before its wait or a P or dS fragment reused while
its product is in flight shows).  Both C entries run on CPU tensors against
``flash_bwd_reference``: both widths, one and two warpgroups a block (the
shim reports 4 SMs, so these small grids reach both of the plan's
choices), a ragged length, Lq != Lk both ways, causal, q, k and v as views
of one packed projection, a q length below one tile, more tiles than ring
slots; the same bits from a second launch; the library's plan is
``bwd_plan``'s.

What this cannot see: registers, spills and ptxas's C7520 (``chip_smoke.py``
phase 2 gates them), speed, and the hardware's own reading of a descriptor
or a tensor map beyond the models' (the card tests in
``tests/test_torch_cuda.py``).
"""

import ctypes
import math

import pytest
import torch

import cuda_shim_build
from syncfusion_tpu_torch.ops import attention as ta

SHIM_SMS = 4  # tests/cuda_shim/shim.h's kShimSmCount
PLAN_KEYS = ("dq_rows", "dq_groups", "key_tile", "dq_stages", "dq_threads",
             "dq_smem_bytes", "dq_blocks", "dkv_rows", "dkv_groups", "q_tile",
             "dkv_stages", "dkv_threads", "dkv_smem_bytes", "dkv_blocks", "box_cols",
             "dq_ops_per_pair", "dkv_ops_per_pair")
BF16_TOL = 8e-3  # chip_smoke.py's BWD_TOL for bf16


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = cuda_shim_build.load(tmp_path_factory, "flash_bwd_sm90.cu", 2)
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    for fn in (so.flash_bwd_dq_sm90, so.flash_bwd_dkv_sm90):
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p, i, f, p]
        fn.restype = i
    so.flash_bwd_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    return so


def plan_of(lib, width, batch_heads, lq, lk, sms):
    out = (ctypes.c_int * len(PLAN_KEYS))()
    assert lib.flash_bwd_plan(width, batch_heads, lq, lk, sms, out) == 0
    return dict(zip(PLAN_KEYS, out))


def run(lib, q, k, v, o, lse, do, causal, scale):
    """Both C entries as ``ta.flash_bwd_dq`` and ``ta.flash_bwd_dkv`` call
    them, on CPU tensors; every output starts as NaN, so an element a kernel
    never writes shows."""
    b, lq, h, d = q.shape
    nan = float("nan")
    dq = torch.full(q.shape, nan, dtype=q.dtype)
    delta = torch.full((b, h, lq), nan)
    dk, dv = torch.full(k.shape, nan, dtype=k.dtype), torch.full(v.shape, nan, dtype=v.dtype)
    err = lib.flash_bwd_dq_sm90(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                dq.data_ptr(), b, h, lq, k.shape[1], d,
                                ta._stride_array(q, k, v, o, do, dq), int(causal), scale,
                                None)
    assert err == 0
    err = lib.flash_bwd_dkv_sm90(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), b, h, lq, k.shape[1], d,
                                 ta._stride_array(q, k, v, do, dk, dv), int(causal), scale,
                                 None)
    assert err == 0
    return dq, delta, dk, dv


def inputs(width, b, h, lq, lk, packed, seed):
    """bf16 q, k, v (views of one (B, L, 3, H, W) projection when
    ``packed``, else q apart from a (2, B, Lk, H, W) k and v) and dO."""
    gen = torch.Generator().manual_seed(seed)
    if packed:
        q, k, v = torch.randn((b, lq, 3, h, width), generator=gen).to(
            torch.bfloat16).unbind(2)
    else:
        q = torch.randn((b, lq, h, width), generator=gen).to(torch.bfloat16)
        k, v = torch.randn((2, b, lk, h, width), generator=gen).to(
            torch.bfloat16).unbind(0)
    do = torch.randn((b, lq, h, width), generator=gen).to(torch.bfloat16)
    return q, k, v, do


# width, batch, heads, Lq, Lk, causal, packed, K2a's and K2b's warpgroups on
# the shim's 4 SMs.  Rings of 4 slots: K2a 64-key tiles, K2b q tiles of 64
# rows at 64 and 32 at 128, so 300 and 260 rows are more tiles than slots
CASES = [(64, 2, 2, 200, 200, False, True, 2, 2),    # ragged, 2 groups
         (64, 1, 2, 300, 300, True, True, 2, 2),     # causal, 2 groups
         (64, 1, 1, 200, 200, True, True, 1, 1),     # causal, one group
         (64, 1, 1, 70, 300, True, False, 1, 1),     # Lq < Lk, causal: keys no query sees
         (64, 2, 2, 150, 70, True, False, 2, 2),     # Lq > Lk, causal
         (64, 1, 1, 20, 20, False, True, 1, 1),      # Lq below a tile
         (128, 1, 1, 200, 200, False, True, 1, 1),   # ragged, one group
         (128, 2, 2, 260, 260, True, True, 2, 2),    # causal, 2 groups
         (128, 2, 1, 100, 330, False, False, 1, 2)]  # Lq < Lk


@pytest.mark.parametrize("width,b,h,lq,lk,causal,packed,gq,gk", CASES)
def test_backward_through_the_shim(lib, width, b, h, lq, lk, causal, packed, gq, gk):
    """dq, dk and dv within BF16_TOL of max |plain| (both round the same f32
    values to bf16: one ulp, 2^-8, may flip), at most 2e-2 of their
    elements rounded otherwise than the plain version (P and dS fed as hi +
    lo bf16; flash_bwd_wide_sm90.cu's shim bound), delta within 1e-5 of max
    |plain delta|; every element written."""
    plan = plan_of(lib, width, b * h, lq, lk, SHIM_SMS)
    assert (plan["dq_groups"], plan["dkv_groups"]) == (gq, gk)
    q, k, v, do = inputs(width, b, h, lq, lk, packed, width + lq + lk)
    scale = 1.0 / math.sqrt(width)
    o, lse = ta.attention_reference(q, k, v, causal, return_lse=True, scale=scale)
    dq, delta, dk, dv = run(lib, q, k, v, o, lse, do, causal, scale)
    want_dq, want_delta = ta.flash_bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    want_dk, want_dv = ta.flash_bwd_dkv_reference(q, k, v, do, lse, want_delta, causal,
                                                  scale)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == want.dtype and not got.isnan().any()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_TOL * want.float().abs().max().item()
        assert (got != want).float().mean().item() <= 2e-2
    assert (delta - want_delta).abs().max().item() <= 1e-5 * want_delta.abs().max().item()


def test_the_same_bits_twice(lib):
    """No atomics and a fixed order of sums: two launches give the same dq,
    delta, dk and dv bits (causal, ragged, two warpgroups)."""
    q, k, v, do = inputs(64, 1, 2, 150, 150, True, 3)
    o, lse = ta.attention_reference(q, k, v, True, return_lse=True)
    first = run(lib, q, k, v, o, lse, do, True, 0.125)
    second = run(lib, q, k, v, o, lse, do, True, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_other_types_and_widths_are_refused(lib):
    """The entries take bf16 at 64 and 128 only: f32 is flash_bwd.cu's, and
    a launch they refuse writes nothing."""
    q, k, v, do = inputs(64, 1, 1, 64, 64, False, 5)
    o, lse = ta.attention_reference(q, k, v, return_lse=True)
    dq = torch.full(q.shape, float("nan"), dtype=q.dtype)
    delta = torch.full((1, 1, 64), float("nan"))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), 1, 1, 64, 64]
    strides = ta._stride_array(q, k, v, o, do, dq)
    assert lib.flash_bwd_dq_sm90(0, *args, 64, strides, 0, 0.125, None) != 0
    assert lib.flash_bwd_dq_sm90(1, *args, 192, strides, 0, 0.125, None) != 0
    assert dq.isnan().all() and delta.isnan().all()
    assert lib.flash_bwd_plan(192, 1, 64, 64, 132, (ctypes.c_int * len(PLAN_KEYS))()) == -1


@pytest.mark.parametrize("width", ta.KERNEL_WIDTHS)
def test_library_plan_is_bwd_plans(lib, width):
    """At the main path's shapes (BH 8-128, T 256-2048) on a card of 132
    SMs, at the shim's 4, and at ragged and unequal lengths, the library's
    plans are the mirror's."""
    for sms in (SHIM_SMS, 132):
        for batch_heads in (1, 8, 16, 32, 64, 128):
            for lq in (20, 200, 256, 512, 1000, 1024, 2048):
                for lk in {lq, 300}:
                    assert plan_of(lib, width, batch_heads, lq, lk, sms) == \
                        ta.bwd_plan(width, batch_heads, lq, sms, lk)
