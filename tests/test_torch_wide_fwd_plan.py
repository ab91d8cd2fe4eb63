"""The launch plan of K1 for heads wider than 128 (``ops.attention.
wide_fwd_plan``, the mirror of ``Plan`` in
``syncfusion_tpu_torch/csrc/flash_fwd_wide_sm90.cu``; ``chip_smoke.py``
phase 2 holds the library's own plan equal to it on the card) at every
width the kernel takes and at D = 160 (padded to 192), in both types: its
shared memory fits a block of an H100, its TMA boxes keep within TMA's
limits, O fits the consumer warpgroups' registers, and its operation count
is the source note's."""

import math

import pytest
import torch

from syncfusion_tpu_torch.ops import attention as ta

WIDTHS = list(range(192, ta.WIDE_FWD_MAX + 1, 64))
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [160, *WIDTHS])
def test_plan_fits_the_card(d, dtype):
    width = ta.kernel_width(d)
    assert width == (192 if d == 160 else d)
    plan = ta.wide_fwd_plan(width, dtype)
    esize = torch.tensor([], dtype=dtype).element_size()
    # shared memory: the q tiles, the ring's slots, five 8-byte barriers and
    # 1024 bytes to align the tiles for the 128-byte swizzle
    assert plan["smem_bytes"] == (1024 + plan["q_rows"] * width * esize
                                  + plan["stages"] * plan["key_tile"] * width * esize
                                  + 64)
    assert plan["smem_bytes"] <= ta.SMEM_MAX
    assert plan["stages"] >= 2
    # TMA boxes: 128-byte rows (the 128-byte swizzle's limit), each box
    # dimension at most 256 elements, the width in whole boxes
    assert plan["box_cols"] * esize == 128
    assert width % plan["box_cols"] == 0
    assert max(plan["box_cols"], 64, plan["key_tile"]) <= 256
    # wgmma m64n64: 64 q rows a group; key tiles in whole 16-key steps
    # (bf16: one n64)
    assert plan["q_rows"] == 64 * plan["row_groups"]
    assert plan["key_tile"] % 16 == 0
    if dtype == torch.bfloat16:
        assert plan["key_tile"] == 64
    # two warpgroups (8 warps: up to 255 registers a thread); O at the full
    # width in registers: each group's share of the 64-column pieces at most
    # 128 f32 registers a thread
    assert plan["row_groups"] * plan["col_groups"] == 2
    assert plan["threads"] == 2 * 128
    assert math.ceil(width // 64 / plan["col_groups"]) * 32 <= 128
    assert plan["col_groups"] == (2 if width > 256 else 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_plan_operation_count_is_the_source_notes(width, dtype):
    """Per (query, key) pair, in units of the width, against the
    function's 4: bf16 S once a column group on wgmma (2) and P·V as hi +
    lo (4): 1.5x with the groups over the rows (up to 256 columns), 2x over
    O's columns; f32 3xTF32 on mma.sync, three tf32 products of 2 for S a
    column group and for P·V: 3x and 4.5x.  No per-chunk recompute of S."""
    plan = ta.wide_fwd_plan(width, dtype)
    if dtype == torch.bfloat16:
        assert plan["ops_per_pair"] == 2 * plan["col_groups"] + 4
        assert plan["ops_per_pair"] / 4 == (1.5 if width <= 256 else 2.0)
    else:
        assert plan["ops_per_pair"] == 3 * (2 * plan["col_groups"] + 2)
        assert plan["ops_per_pair"] / 4 == (3.0 if width <= 256 else 4.5)


@pytest.mark.parametrize("width", [128, 200, 576, 1024])
def test_plan_refuses_other_widths(width):
    with pytest.raises(ValueError, match="multiples of 64"):
        ta.wide_fwd_plan(width, torch.bfloat16)


def test_plan_key_tiles_by_width():
    """bf16 takes 64-key tiles (one wgmma n64 for S) at every width; f32 32,
    16 at 512, where the q tile alone is 128 KB."""
    assert {ta.wide_fwd_plan(w, torch.bfloat16)["key_tile"] for w in WIDTHS} == {64}
    f32 = {w: ta.wide_fwd_plan(w, torch.float32)["key_tile"] for w in WIDTHS}
    assert f32 == {192: 32, 256: 32, 320: 32, 384: 32, 448: 32, 512: 16}
