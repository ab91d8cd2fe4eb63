"""The launch plan of K1 on thread-block clusters (``ops.attention.
cluster_fwd_plan``, the mirror of ``cluster_shape`` and ``ClusterPlan`` in
``syncfusion_tpu_torch/csrc/flash_fwd_cluster_sm90.cu``; ``chip_smoke.py``
phase 2 holds the library's own plan equal to it on the card, and
``tests/test_torch_cluster_fwd_shim.py`` on the CPU) at every multiple of 64
the kernel takes and at a sample of padded widths, in both types: its
shared memory fits a block of an H100, its cluster the portable limit, its
slices cover the head with no empty block, its TMA boxes keep within TMA's
limits, O fits the warpgroups' registers, and its operation count is the
source note's."""

import math

import pytest
import torch

from syncfusion_tpu_torch.ops import attention as ta

WIDTHS = list(range(ta.WIDE_FWD_MAX + 64, ta.CLUSTER_FWD_MAX + 1, 64))
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [513, 600, 1000, 2049, 4000, 4096])
def test_padded_widths_take_the_cluster_kernel(d, dtype):
    """A head of d features, padded to the least multiple of 64 not below
    it, goes to the cluster kernel, whose plan takes that width."""
    width = ta.kernel_width(d)
    assert width % 64 == 0 and width - 64 < d <= width
    assert ta.kernel_source(0, width) == "flash_fwd_cluster_sm90"
    plan = ta.cluster_fwd_plan(width, dtype)
    assert plan["slice"] * plan["cluster"] >= width


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_the_card_at_every_width(dtype):
    esize = torch.tensor([], dtype=dtype).element_size()
    for width in WIDTHS:
        plan = ta.cluster_fwd_plan(width, dtype)
        n, s, kt = plan["cluster"], plan["slice"], plan["key_tile"]
        # the cluster: at most 8 blocks (the portable limit), slices of whole
        # 64-column pieces covering the head, every block at least one piece
        assert 2 <= n <= ta.CLUSTER_MAX
        assert s % 64 == 0 and 64 <= s <= ta.CLUSTER_SLICE_MAX
        assert n * s >= width and (n - 1) * s < width
        # shared memory: the q slice, the ring's slots, five f32 S tiles (two
        # group partials, two exchange buffers, the sum), five 8-byte
        # barriers and 1024 bytes to align the tiles for the 128-byte swizzle
        assert plan["smem_bytes"] == (1024 + 64 * s * esize + plan["stages"] * kt * s * esize
                                      + 5 * 64 * kt * 4 + 64)
        assert plan["smem_bytes"] <= ta.SMEM_MAX
        assert plan["stages"] >= 2
        # TMA boxes: 128-byte rows (the 128-byte swizzle's limit), each box
        # dimension at most 256 elements, a slice in whole boxes
        assert plan["box_cols"] * esize == 128
        assert s % plan["box_cols"] == 0
        assert max(plan["box_cols"], 64, kt) <= 256
        # key tiles: bf16 one wgmma n64 or n32 for S, f32 whole 8-key n-tiles
        # of mma.sync; the full tile unless it does not fit
        full = 64 if dtype == torch.bfloat16 else 32
        assert kt in (full, full // 2)
        # the exchange: every thread of the block sums whole float4s of S
        assert (64 * kt // 4) % plan["threads"] == 0
        # two warpgroups (8 warps: up to 255 registers a thread); each holds
        # ceil or floor of half of the slice's 64-column pieces of O, at most
        # 128 f32 registers a thread
        assert plan["threads"] == 2 * 128
        assert math.ceil(s // 64 / 2) * 32 <= 128


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_key_tiles_by_slice(dtype):
    """The full key tile (bf16 64, f32 32) where it fits beside the q slice,
    the ring and the S tiles, half of it where it does not."""
    tiles = {}
    for width in WIDTHS:
        plan = ta.cluster_fwd_plan(width, dtype)
        tiles.setdefault(plan["slice"], set()).add(plan["key_tile"])
    assert all(len(v) == 1 for v in tiles.values())
    esize = torch.tensor([], dtype=dtype).element_size()
    full = 64 if dtype == torch.bfloat16 else 32

    def fits(s, kt):  # the q slice, two ring slots, five S tiles
        return 1024 + 64 * s * esize + 2 * kt * s * esize + 5 * 64 * kt * 4 + 64 <= ta.SMEM_MAX

    assert {s: v.pop() for s, v in tiles.items()} == {
        s: full if fits(s, full) else full // 2 for s in tiles}


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_operation_count_is_the_source_notes(dtype):
    """Per (query, key) pair, in units of the width, against the function's
    4: S once across the cluster (2) and P·V (bf16 as hi + lo, 4): 1.5x;
    f32 three tf32 products of 2 for each: 3x.  The chunked kernel did
    (NC + 1) / 2: 3x at 576, 4.5x at 1024."""
    for width in WIDTHS:
        ops = ta.cluster_fwd_plan(width, dtype)["ops_per_pair"]
        assert ops == (6 if dtype == torch.bfloat16 else 3 * (2 + 2))


@pytest.mark.parametrize("width", [128, 512, 600, ta.CLUSTER_FWD_MAX + 64])
def test_plan_refuses_other_widths(width):
    with pytest.raises(ValueError, match="multiples of 64"):
        ta.cluster_fwd_plan(width, torch.bfloat16)
