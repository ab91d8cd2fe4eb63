"""The launch plan of K2a and K2b for heads of 192-512 features
(``ops.attention.wide_bwd_plan``, the mirror of ``BwdPlan`` in
``syncfusion_tpu_torch/csrc/flash_bwd_wide_sm90.cu``): the library's own
plan, built for the CPU against ``tests/cuda_shim``, equals it at every
width in both types (``chip_smoke.py`` phase 2 holds the card's library to
it too); its shared memory fits a block of an H100, its TMA boxes keep
within TMA's limits, the outputs fit the threads' registers, its operation
counts are the source note's, the blocks of a call are those of the source
note, and other widths are refused."""

import ctypes

import pytest
import torch

import cuda_shim_build
from syncfusion_tpu_torch.ops import attention as ta

WIDTHS = list(range(192, ta.WIDE_FWD_MAX + 1, 64))
DTYPES = [torch.bfloat16, torch.float32]
KEYS = ("rows", "ring_rows", "stages", "parts", "roles", "threads", "smem_bytes",
        "box_cols", "dq_ops_per_pair", "dkv_ops_per_pair")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = cuda_shim_build.load(tmp_path_factory, "flash_bwd_wide_sm90.cu", 2)
    so.flash_bwd_wide_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    return so


@pytest.mark.parametrize("dtype", DTYPES)
def test_library_plan_is_wide_bwd_plans(lib, dtype):
    code = int(dtype == torch.bfloat16)
    for width in WIDTHS:
        out = (ctypes.c_int * len(KEYS))()
        assert lib.flash_bwd_wide_plan(code, width, out) == 0
        assert dict(zip(KEYS, out)) == ta.wide_bwd_plan(width, dtype)
    for width in (128, 576, 1024):
        assert lib.flash_bwd_wide_plan(code, width, (ctypes.c_int * len(KEYS))()) == -1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_plan_fits_the_card(width, dtype):
    plan = ta.wide_bwd_plan(width, dtype)
    esize = torch.tensor([], dtype=dtype).element_size()
    rows, ring = plan["rows"], plan["ring_rows"]
    # shared memory: two own tiles, the ring's slots, f32's two exchange
    # buffers of S's and dP's partial sums (one per column part and row),
    # 512 bytes of LSE and delta, five 8-byte barriers, 1024 bytes to align
    # the tiles for the 128-byte swizzle
    exchange = 2 * 2 * plan["parts"] * rows * ring * 4 if dtype == torch.float32 else 0
    assert plan["smem_bytes"] == (1024 + 2 * rows * width * esize
                                  + plan["stages"] * ring * width * esize
                                  + exchange + 512 + 64)
    assert plan["smem_bytes"] <= ta.SMEM_MAX
    assert plan["stages"] >= 2
    # K2a's O tile (rows x W) lands in the ring's slots before the ring starts
    assert rows <= plan["stages"] * ring
    # TMA boxes: 128-byte rows (the 128-byte swizzle's limit), at most 256
    # rows, the width in whole boxes, each box a whole number of 1024-byte
    # swizzle atoms
    assert plan["box_cols"] * esize == 128
    assert width % plan["box_cols"] == 0
    assert max(rows, ring) <= 256 and (ring * 128) % 1024 == 0
    # two warpgroups (8 warps: up to 255 registers a thread)
    assert plan["threads"] == 256
    if dtype == torch.bfloat16:
        # one wgmma M of 64 rows, S on wgmma n32; each warpgroup ceil or
        # floor of half of the 64-column pieces, at most 128 registers an
        # output; a dK and a dV block a row tile
        assert (rows, ring, plan["parts"], plan["roles"]) == (64, 32, 2, 2)
        assert -(-width // 64 // 2) * 32 <= 128
    else:
        # two m16 tiles a block; four column parts of W / 4, each warp's
        # share of an output W / 8 registers (K2b holds two)
        assert (rows, plan["parts"], plan["roles"]) == (32, 4, 1)
        assert ring == (32 if width <= 320 else 16)
        assert 2 * width // 8 <= 128


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_plan_operation_count_is_the_source_notes(width, dtype):
    """Per (query, key) pair, in units of the width, against the function's
    6 (K2a: S, dP, dS·K) and 8 (K2b: S, dP, Pᵀ·dO, dSᵀ·q), the same at
    every width (no per-chunk recompute): bf16 S and dP once a warpgroup,
    the outputs as hi + lo: 12 and 20 (2x, 2.5x); f32 tf32 products, three
    a product, none repeated: 18 and 24 (3 x 6, 3 x 8)."""
    plan = ta.wide_bwd_plan(width, dtype)
    if dtype == torch.bfloat16:
        assert (plan["dq_ops_per_pair"], plan["dkv_ops_per_pair"]) == (2 * 4 + 4, 4 + 4 + 8 + 4)
    else:
        assert (plan["dq_ops_per_pair"], plan["dkv_ops_per_pair"]) == (3 * 6, 3 * 8)


@pytest.mark.parametrize("dtype,blocks", [
    # phase 21c(a): B = 2, T = 1024, heads x W = 512 (D = 192: 3 heads)
    (torch.float32, {192: (192, 192), 256: (128, 128), 320: (128, 128), 512: (64, 64)}),
    (torch.bfloat16, {192: (96, 192), 256: (64, 128), 320: (64, 128), 512: (32, 64)})])
def test_blocks_of_a_call(dtype, blocks):
    heads = {192: 3, 256: 2, 320: 2, 512: 1}
    for width, (dq, dkv) in blocks.items():
        got = ta.wide_bwd_blocks(width, dtype, 2 * heads[width], 1024, 1024)
        assert (got["dq"], got["dkv"]) == (dq, dkv)
    # the 2 x 256 UNet's training call: f32, 4 rows x 2 heads, T = 2048
    assert ta.wide_bwd_blocks(256, torch.float32, 8, 2048, 2048) == {"dq": 512, "dkv": 512}


@pytest.mark.parametrize("width", [128, 200, 576, 1024])
def test_plan_refuses_other_widths(width):
    with pytest.raises(ValueError, match="multiples of 64"):
        ta.wide_bwd_plan(width, torch.bfloat16)
