"""The launch plans of the bf16 K2a and K2b at heads of 64 and 128
(``ops.attention.bwd_plan``, the mirror of ``BwdPlan`` and ``bwd_groups``
in ``syncfusion_tpu_torch/csrc/flash_bwd_sm90.cu``; the library's own plan
equals it in tests/test_torch_bwd_sm90_shim.py and, on the card, in
``chip_smoke.py`` phase 2): its shared memory fits a block of an H100, its
tiles are whole wgmma shapes and TMA boxes, its warpgroups and blocks are
those of the source note at the training shapes, its operation counts are
the source note's, and other widths are refused."""

import pytest

from syncfusion_tpu_torch.ops import attention as ta

H100_SMS = 132
TRAIN_BH = 32  # the training call: 4 rows x 8 heads
TRAIN_T = (2048, 1024, 512, 256)


@pytest.mark.parametrize("width", ta.KERNEL_WIDTHS)
def test_plan_fits_the_card(width):
    plan = ta.bwd_plan(width, TRAIN_BH, 2048, H100_SMS)
    row = 2 * width  # bytes of a bf16 row
    # 1024 bytes to align the tiles for the 128-byte swizzle; two own tiles
    # (K2a q and dO, K2b K and V) of 64 rows for each of two warpgroups; the
    # ring's slots, each a tile of both streamed operands; K2a's LSE and
    # delta of 128 rows; a full and an empty barrier a slot and one for the
    # own tiles
    assert plan["dq_smem_bytes"] == (1024 + 4 * 64 * row + plan["dq_stages"] * 2
                                     * plan["key_tile"] * row + 2 * 128 * 4
                                     + 8 * (2 * plan["dq_stages"] + 1))
    assert plan["dkv_smem_bytes"] == (1024 + 4 * 64 * row + plan["dkv_stages"] * 2
                                      * plan["q_tile"] * row
                                      + 8 * (2 * plan["dkv_stages"] + 1))
    assert max(plan["dq_smem_bytes"], plan["dkv_smem_bytes"]) <= ta.SMEM_MAX
    # K2a's O tiles (two groups of 64 rows) fill the ring's last slot
    assert 2 * plan["key_tile"] == 2 * 64
    # S (K2a) and Sᵀ (K2b) are wgmma N of 64, and of 32 at 128 wide (where
    # dK and dV hold 128 registers); the output products' k-steps of 16
    # split each streamed tile whole; boxes of 128 bytes
    assert plan["key_tile"] == 64 and plan["q_tile"] == (64 if width == 64 else 32)
    assert plan["box_cols"] * 2 == 128 and width % plan["box_cols"] == 0
    assert plan["dq_stages"] >= 2 and plan["dkv_stages"] >= 2
    # S 2, dP 2 and each output as hi + lo, 2 x 2, in units of the width:
    # 1.33x and 1.5x the function's 6 and 8
    assert (plan["dq_ops_per_pair"], plan["dkv_ops_per_pair"]) == (8, 12)


@pytest.mark.parametrize("width", ta.KERNEL_WIDTHS)
def test_groups_and_blocks_at_the_training_call(width):
    """Two warpgroups a block where the grid of 128-row blocks fills the
    card's 132 SMs (T = 2048 and 1024 at BH = 32), else one: 1024, 512,
    256 and 128 warpgroups of 64 rows either way."""
    for t in TRAIN_T:
        plan = ta.bwd_plan(width, TRAIN_BH, t, H100_SMS)
        groups = 2 if t >= 1024 else 1
        for key in ("dq", "dkv"):
            assert plan[f"{key}_groups"] == groups
            assert plan[f"{key}_rows"] == 64 * groups
            assert plan[f"{key}_threads"] == 128 * groups
            assert plan[f"{key}_blocks"] * groups == TRAIN_BH * t // 64


def test_unequal_lengths_and_small_grids():
    """K2a's grid follows Lq and K2b's Lk; a grid too small for the card
    takes one warpgroup a block, and a ragged length a last partial block."""
    plan = ta.bwd_plan(64, 2, 1000, H100_SMS, lk=300)
    assert (plan["dq_groups"], plan["dkv_groups"]) == (1, 1)
    assert (plan["dq_blocks"], plan["dkv_blocks"]) == (2 * 16, 2 * 5)
    plan = ta.bwd_plan(128, 2, 1000, 4, lk=300)
    assert (plan["dq_groups"], plan["dkv_groups"]) == (2, 2)
    assert (plan["dq_blocks"], plan["dkv_blocks"]) == (2 * 8, 2 * 3)
    assert ta.bwd_plan(64, 8, 512, H100_SMS) == ta.bwd_plan(64, 8, 512, H100_SMS, 512)


@pytest.mark.parametrize("width", [32, 192, 256])
def test_other_widths_are_refused(width):
    with pytest.raises(ValueError, match="flash_bwd_sm90"):
        ta.bwd_plan(width, 1, 64, H100_SMS)
