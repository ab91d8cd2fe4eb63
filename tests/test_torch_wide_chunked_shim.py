"""The chunked kernels of ``syncfusion_tpu_torch/csrc/flash_wide.cu``, the
port's K2a and K2b for heads wider than 512 and its K1 above
``CLUSTER_FWD_MAX`` (its C entry still takes any multiple of 64 above 128),
run on the CPU: the source
compiled by g++ against ``tests/cuda_shim`` (``cuda_shim_build``; cp.async
copies at once, mma.sync m16n8k8 tf32 lane-exact), each C entry on CPU
tensors against its plain version: K1 at W = 576 (nine 64-column pieces,
five 128-column chunks, the last of one piece), both types, a ragged
sequence below one tile, causal too.  K2a and K2b there are the bodies that
served 192-512 before, held on the card; the shim's mma.sync model runs a
block's 128 threads in lock step, and their grids (five chunks, two blocks
a chunk for K2b) would take minutes.  The card tests and chip_smoke.py hold
K2a and K2b at 576 and 1024 and K1 at 4160."""

import ctypes
import math

import pytest
import torch

import cuda_shim_build
from syncfusion_tpu_torch.ops import attention as ta


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = cuda_shim_build.load(tmp_path_factory, "flash_wide.cu", 3)
    i, ll, p, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
    so.flash_fwd_chunked.argtypes = [i, p, p, p, p, p, i, i, i, i, i, *([ll] * 12), i, f, p]
    so.flash_fwd_chunked.restype = i
    return so


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_chunked_forward_at_576_through_the_shim(lib, dtype, causal):
    """O within 1e-5 (f32) or 8e-3 (bf16) of the plain version and the LSE
    within 1e-5; every element written (the outputs start as NaN)."""
    width, b, lq, h = 576, 1, 40, 1
    gen = torch.Generator().manual_seed(576 + causal)
    q, k, v = torch.randn((b, lq, 3, h, width), generator=gen).to(dtype).unbind(2)
    do = torch.randn((b, lq, h, width), generator=gen).to(dtype)
    scale = 1.0 / math.sqrt(width)
    code = int(dtype == torch.bfloat16)
    nan = float("nan")
    o = torch.full(q.shape, nan, dtype=dtype)
    lse = torch.full((b, h, lq), nan)
    strides = [x.stride(j) for x in (q, k, v, o) for j in (0, 1, 2)]
    assert lib.flash_fwd_chunked(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b, h, lq, lq, width,
                                 *strides, int(causal), scale, None) == 0
    want_o, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True,
                                              scale=scale)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    assert (o.float() - want_o.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-5
