"""K2a and K2b for heads of 192-512 features
(``syncfusion_tpu_torch/csrc/flash_bwd_wide_sm90.cu``) run on the CPU, their
CUDA source compiled by g++ against ``tests/cuda_shim`` (``cuda_shim_build``:
one std::thread per CUDA thread, lane-exact models of the mbarrier phases,
the TMA tile copy with zero fill and the 128-byte swizzle, the wgmma
descriptor and products, and mma.sync m16n8k8 tf32).  Both C entries run on
CPU tensors against ``flash_bwd_dq_reference`` and
``flash_bwd_dkv_reference``: both types, a width whose bf16 warpgroups
split an odd number of 64-column pieces, widths with f32 ring tiles of 32
and of 16 rows, ragged and causal sequences, a sequence below one tile, q,
k and v as views of one packed projection.

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
    so = cuda_shim_build.load(tmp_path_factory, "flash_bwd_wide_sm90.cu", 2)
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    for fn in (so.flash_bwd_dq_wide, so.flash_bwd_dkv_wide):
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p, i, f, p]
        fn.restype = i
    so.flash_bwd_wide_plan.argtypes = [i, i, ctypes.POINTER(i)]
    return so


def run(lib, q, k, v, o, lse, do, causal, scale):
    """Both C entries as ``ta.flash_bwd_dq`` and ``ta.flash_bwd_dkv`` call
    them, on CPU tensors; every output starts as NaN, so an element a kernel
    never writes shows."""
    b, lq, h, d = q.shape
    nan = float("nan")
    dq = torch.full(q.shape, nan, dtype=q.dtype)
    delta = torch.full((b, h, lq), nan)
    dk, dv = torch.full(k.shape, nan, dtype=k.dtype), torch.full(v.shape, nan, dtype=v.dtype)
    code = int(q.dtype == torch.bfloat16)
    err = lib.flash_bwd_dq_wide(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                dq.data_ptr(), b, h, lq, k.shape[1], d,
                                ta._stride_array(q, k, v, o, do, dq), int(causal), scale,
                                None)
    assert err == 0
    err = lib.flash_bwd_dkv_wide(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), b, h, lq, k.shape[1], d,
                                 ta._stride_array(q, k, v, do, dk, dv), int(causal), scale,
                                 None)
    assert err == 0
    return dq, delta, dk, dv


# width, type, batch, heads, Lq, Lk, causal, packed (q, k, v views of one
# (B, L, 3, H, W) projection).  bf16: 64-row blocks and 32-row ring tiles,
# W = 192 and 448 an odd number of pieces for the two warpgroups; f32:
# 32-row blocks, ring tiles of 32 rows up to 320 and 16 from 384
CASES = [(192, torch.bfloat16, 1, 2, 70, 70, False, True),
         (256, torch.bfloat16, 1, 1, 300, 300, True, True),
         (448, torch.bfloat16, 1, 1, 40, 100, False, False),
         (512, torch.bfloat16, 1, 1, 130, 130, True, False),
         (192, torch.float32, 1, 1, 70, 100, False, False),
         (256, torch.float32, 1, 1, 150, 150, True, True),
         (320, torch.float32, 1, 1, 20, 20, False, True),
         (448, torch.float32, 1, 1, 50, 50, True, False),
         (512, torch.float32, 1, 1, 40, 70, False, True)]


@pytest.mark.parametrize("width,dtype,b,h,lq,lk,causal,packed", CASES)
def test_wide_backward_through_the_shim(lib, width, dtype, b, h, lq, lk, causal, packed):
    """dq, dk and dv within 1e-5 (f32: orders of summation) or 8e-3 (bf16:
    one bf16 ulp both sides round) of max |plain|, delta within 1e-5 of
    max |plain delta|; every element written.  bf16: at most 2e-2 of the
    gradients' elements rounded otherwise than the plain version (P and dS
    fed as hi + lo bf16 read 0.2-1% here; rounded once to bf16, ~41%)."""
    gen = torch.Generator().manual_seed(width + lq)
    if packed:
        q, k, v = torch.randn((b, lq, 3, h, width), generator=gen).to(dtype).unbind(2)
    else:
        q = torch.randn((b, lq, h, width), generator=gen).to(dtype)
        k, v = torch.randn((2, b, lk, h, width), generator=gen).to(dtype).unbind(0)
    do = torch.randn((b, lq, h, width), generator=gen).to(dtype)
    scale = 1.0 / math.sqrt(width)
    o, lse = ta.attention_reference(q, k, v, causal, return_lse=True, scale=scale)
    dq, delta, dk, dv = run(lib, q, k, v, o, lse, do, causal, scale)
    want_dq, want_delta = ta.flash_bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    want_dk, want_dv = ta.flash_bwd_dkv_reference(q, k, v, do, lse, want_delta, causal,
                                                  scale)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == want.dtype and not got.isnan().any()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()
        if dtype == torch.bfloat16:
            assert (got != want).float().mean().item() <= 2e-2
    assert (delta - want_delta).abs().max().item() <= 1e-5 * want_delta.abs().max().item()
