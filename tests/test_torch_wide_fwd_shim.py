"""K1 for heads wider than 128 (``syncfusion_tpu_torch/csrc/flash_fwd_wide_sm90.cu``)
run on the CPU, its CUDA source compiled by g++ against ``tests/cuda_shim``
(``cuda_shim_build``): one std::thread per CUDA thread, and lane-exact
models of the instructions of ``csrc/sm90.cuh`` (mbarrier phases, the TMA tile copy with zero fill and the
128-byte swizzle, the wgmma descriptor, wgmma m64n64k16 bf16 run when its
group is waited for) and of ``csrc/ptx.cuh`` (mma.sync m16n8k8 tf32, each
operand read with its low 13 bits dropped).  The library's C entry runs on
CPU tensors against ``attention_reference``: both types, widths with the
warpgroups over the rows and over O's columns, ragged and causal sequences,
a sequence below one tile, q, k and v as views of one packed projection.
The library's launch plan is ``wide_fwd_plan``'s at every width.

What this cannot see: registers and spills (``chip_smoke.py`` phase 2 gates
them), speed, and the hardware's own reading of a descriptor or a tensor
map beyond the models' (the card tests in ``tests/test_torch_cuda.py``).
"""

import ctypes
import math

import pytest
import torch

import cuda_shim_build
from syncfusion_tpu_torch.ops import attention as ta


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = cuda_shim_build.load(tmp_path_factory, "flash_fwd_wide_sm90.cu", 1)
    i, ll, p, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
    so.flash_fwd_wide.argtypes = [i, p, p, p, p, p, i, i, i, i, i, *([ll] * 12), i, f, p]
    so.flash_fwd_wide.restype = i
    so.flash_fwd_wide_plan.argtypes = [i, i, ctypes.POINTER(i)]
    return so


def run(lib, q, k, v, causal, scale):
    """The C entry as ``ta.flash_fwd`` calls it, on CPU tensors; O and the
    LSE start as NaN, so an element the kernel never writes shows."""
    b, lq, h, d = q.shape
    o = torch.full((b, lq, h, d), float("nan"), dtype=q.dtype)
    lse = torch.full((b, h, lq), float("nan"))
    strides = [t.stride(j) for t in (q, k, v, o) for j in (0, 1, 2)]
    err = lib.flash_fwd_wide(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                             v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, lq,
                             k.shape[1], d, *strides, int(causal), scale, None)
    assert err == 0
    return o, lse


# width, type, batch, heads, Lq, Lk, causal, packed (q, k, v views of one
# (B, L, 3, H, W) projection): up to 256 the warpgroups split the rows (two
# q tiles a block; causal: one group releases the tiles past its rows
# unread), above 256 O's columns
CASES = [(192, torch.bfloat16, 1, 2, 70, 70, False, True),
         (256, torch.bfloat16, 1, 1, 200, 200, True, True),
         (320, torch.bfloat16, 1, 1, 70, 70, False, False),
         (512, torch.bfloat16, 1, 1, 130, 130, True, True),
         (192, torch.float32, 1, 1, 70, 100, False, False),
         (256, torch.float32, 2, 1, 40, 40, True, True),
         (448, torch.float32, 1, 1, 50, 50, True, False)]


@pytest.mark.parametrize("width,dtype,b,h,lq,lk,causal,packed", CASES)
def test_wide_forward_through_the_shim(lib, width, dtype, b, h, lq, lk, causal, packed):
    """O within the f32 rounding of the sums (1e-5; bf16: one ulp of |O| <
    2, 8e-3, and at most 5e-3 of its elements rounded otherwise than the
    plain version, phase 5's bound in chip_smoke.py: P fed as hi + lo bf16
    keeps it, P rounded once to bf16 reads ~0.36 here) and the LSE within
    1e-5 of the plain version."""
    gen = torch.Generator().manual_seed(width + lq)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_library_plan_is_wide_fwd_plans(lib, dtype):
    for width in range(192, ta.WIDE_FWD_MAX + 1, 64):
        out = (ctypes.c_int * 9)()
        assert lib.flash_fwd_wide_plan(int(dtype == torch.bfloat16), width, out) == 0
        keys = ("q_rows", "key_tile", "stages", "row_groups", "col_groups", "threads",
                "smem_bytes", "box_cols", "ops_per_pair")
        assert dict(zip(keys, out)) == ta.wide_fwd_plan(width, dtype)
    assert lib.flash_fwd_wide_plan(0, 576, (ctypes.c_int * 9)()) == -1
