"""The port's CUDA kernels against their plain versions, on the card:
K1 (the flash-attention forward), K2a and K2b (its backward), all on the
tensor cores with f32 as 3xTF32, and K3 and K4 (the fused resnet chain, on
the tensor cores too: bf16 with hi + lo bf16 activations, f32 as 3xTF32);
the DeepCache samplers through K1 against the plain attention; the onset
net and its train step, the CLAP embedder, VGGish (with the on-device
resampler) and the full-width CondFoleyGen baseline, on the card against
the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports nothing of JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, as chip_smoke.py states them: f32 for orders of summation;
bf16 for one bf16 ulp of an output both sides round (O below 1: 2^-8
absolute; gradients: relative to max |plain|).
"""

import math

import pytest
import torch

from syncfusion_tpu_torch.models.blocks import SelfAttention1d
from syncfusion_tpu_torch.models.onset_net import VideoOnsetNet
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops import attention as ta
from syncfusion_tpu_torch.ops import fused_resblock as fr
from syncfusion_tpu_torch.train.onset_trainer import OnsetTrainer, bc_loss

pytestmark = pytest.mark.cuda

CASES = [(2048, False), (256, False), (1000, False), (512, True)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _qkv(rows, length, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((rows, length, 3, 8, 64), generator=gen, device="cuda")
    do = torch.randn((rows, length, 8, 64), generator=gen, device="cuda")
    q, k, v = qkv.to(dtype).unbind(2)  # views of one qkv, as the UNet makes
    return q, k, v, do.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("length,causal", CASES)
def test_kernel_matches_plain_on_card(card, dtype, tol, length, causal):
    """K1 against its plain version."""
    q, k, v, _ = _qkv(8, length, dtype, length)
    o, lse = ta.flash_attention(q, k, v, causal, return_lse=True)
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    assert (o.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("length", [2048, 1024, 512, 256])
def test_bf16_kernel_at_the_main_path_lengths_on_card(card, length, rows):
    """The tensor-core kernel at each length of the UNet's attention levels,
    BH = 64 and 128 from qkv views (the in-band CFG batch of 4 clips, and of
    the 8 clips of the serving configuration), against its plain version."""
    q, k, v, _ = _qkv(rows, length, torch.bfloat16, length + rows // 4)
    ta.reset_counts()
    o, lse = ta.flash_fwd(q, k, v)
    assert ta.flash_attention.kernel_launches == 1
    want, want_lse = ta.attention_reference(q, k, v, return_lse=True)
    assert (o.float() - want.float()).abs().max().item() <= 8e-3
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_128_wide_kernel_from_packed_views_on_card(card, causal):
    """The 128-wide bf16 kernel (TMA and wgmma) at a ragged length, q, k and
    v views of one packed (B, T, 3, H, 128) projection: one launch, against
    its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(128 + int(causal))
    q, k, v = torch.randn((2, 1000, 3, 4, 128), generator=gen,
                          device="cuda").to(torch.bfloat16).unbind(2)
    ta.reset_counts()
    o, lse = ta.flash_fwd(q, k, v, causal)
    assert ta.flash_attention.kernel_launches == 1
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    assert (o.float() - want.float()).abs().max().item() <= 8e-3
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("rows", [1, 2])
def test_bf16_kernel_on_small_grids_on_card(card, rows):
    """Video to Foley's BH = 8 and 16 at T = 256: the plan takes one
    warpgroup of 64 q rows a block, so 32 or 64 blocks run, fewer than the
    card's SMs; against the plain version."""
    q, k, v, _ = _qkv(rows, 256, torch.bfloat16, 31 + rows)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ta.fwd_plan(64, rows * 8, 256, sms)
    assert plan["groups"] == 1 and plan["blocks"] == 32 * rows < sms
    ta.reset_counts()
    o, lse = ta.flash_fwd(q, k, v)
    assert ta.flash_attention.kernel_launches == 1
    want, want_lse = ta.attention_reference(q, k, v, return_lse=True)
    assert (o.float() - want.float()).abs().max().item() <= 8e-3
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_misaligned_bf16_input_raises_on_card(card):
    """TMA takes 16-byte aligned operands and strides: an L stride that is
    not a multiple of 8 elements, or an address off 16 bytes, raises and
    launches nothing."""
    q, k, v, _ = _qkv(2, 256, torch.bfloat16, 5)
    odd = torch.zeros((2, 256, 8 * 64 + 1), dtype=torch.bfloat16, device="cuda")
    flat = torch.zeros(2 * 256 * 512 + 1, dtype=torch.bfloat16, device="cuda")
    ta.reset_counts()
    for bad in (odd[..., :512].unflatten(-1, (8, 64)), flat[1:].view(2, 256, 8, 64)):
        with pytest.raises(ValueError, match="cp.async"):
            ta.flash_attention(bad, k, v)
        with pytest.raises(ValueError, match="cp.async"):
            ta.flash_attention(q, k, bad)
    assert ta.flash_attention.kernel_launches == 0


@pytest.mark.parametrize("lq,lk,causal", [(300, 1000, False), (1000, 300, True),
                                           (2048, 2048, True)])
def test_f32_kernel_with_other_key_length_on_card(card, lq, lk, causal):
    """The 3xTF32 kernel with Lq != Lk (ragged both ways, causal and not)
    and at the longest causal level, q, k, v as views of projections, one
    launch, against its plain version within the f32 tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(lq + lk)
    q = torch.randn((4, lq, 2, 8, 64), generator=gen, device="cuda")[:, :, 0]
    kv = torch.randn((4, lk, 2, 8, 64), generator=gen, device="cuda")
    k, v = kv.unbind(2)
    ta.reset_counts()
    o, lse = ta.flash_fwd(q, k, v, causal)
    assert ta.flash_attention.kernel_launches == 1
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    assert (o - want).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_is_deterministic_on_card(card, dtype):
    """Each block owns its rows and adds in a fixed order: two calls on the
    same inputs give bitwise equal O and LSE (ragged and causal)."""
    q, k, v, _ = _qkv(4, 1000, dtype, 19)
    first = ta.flash_fwd(q, k, v, True)
    second = ta.flash_fwd(q, k, v, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_misaligned_f32_input_raises_on_card(card):
    """The f32 kernel copies with cp.async too: an L stride that is not a
    multiple of 4 elements, or an address off 16 bytes, raises in
    ``flash_fwd`` and launches nothing (the autograd forward copies such
    views instead, see the gradient test of views below)."""
    q, k, v, _ = _qkv(2, 256, torch.float32, 5)
    odd = torch.zeros((2, 256, 8 * 64 + 2), device="cuda")
    flat = torch.zeros(2 * 256 * 512 + 1, device="cuda")
    ta.reset_counts()
    for bad in (odd[..., :512].unflatten(-1, (8, 64)), flat[1:].view(2, 256, 8, 64)):
        with pytest.raises(ValueError, match="cp.async"):
            ta.flash_fwd(bad, k, v)
        with pytest.raises(ValueError, match="cp.async"):
            ta.flash_fwd(q, bad, v)
    assert ta.flash_attention.kernel_launches == 0


def _backward(q, k, v, do, causal=False):
    o, lse = ta.flash_fwd(q, k, v, causal)
    ta.reset_counts()
    dq, delta = ta.flash_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = ta.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return o, lse, (dq, delta, dk, dv)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("length,causal", CASES + [(1024, False), (512, False)])
def test_backward_kernels_match_plain_on_card(card, dtype, tol, length, causal):
    """K2a (dq and delta) and K2b (dk, dv) on the tensor cores (f32 as
    3xTF32), one launch each, against their plain versions relative to max
    |plain|: BH = 32 from qkv views as training makes them, at each length
    of the UNet's attention levels, ragged and causal."""
    q, k, v, do = _qkv(4, length, dtype, length + 1)
    o, lse, got = _backward(q, k, v, do, causal)
    assert (ta.flash_attention.dq_launches, ta.flash_attention.dkv_launches) == (1, 1)
    want_dq, want_delta = ta.flash_bwd_dq_reference(q, k, v, o, lse, do, causal)
    want = (want_dq, want_delta,
            *ta.flash_bwd_dkv_reference(q, k, v, do, lse, want_delta, causal))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_are_deterministic_on_card(card, dtype):
    """Each block owns its output rows and nothing is added atomically, so
    two calls on the same inputs give bitwise equal dq, delta, dk and dv
    (ragged and causal)."""
    q, k, v, do = _qkv(4, 1000, dtype, 11)
    _, _, first = _backward(q, k, v, do, causal=True)
    _, _, second = _backward(q, k, v, do, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_backward_operand_raises_on_card(card, dtype):
    """cp.async takes 16-byte rows: a q, O or dO whose L stride is not a
    multiple of 16 bytes, or whose address is off 16 bytes, raises in K2a
    and K2b and launches nothing."""
    q, k, v, do = _qkv(2, 256, dtype, 13)
    o, lse = ta.flash_fwd(q, k, v)
    delta = torch.zeros_like(lse)
    odd = torch.zeros((2, 256, 8 * 64 + 1), dtype=dtype, device="cuda")
    flat = torch.zeros(2 * 256 * 512 + 1, dtype=dtype, device="cuda")
    ta.reset_counts()
    for bad in (odd[..., :512].unflatten(-1, (8, 64)), flat[1:].view(2, 256, 8, 64)):
        with pytest.raises(ValueError, match="cp.async"):
            ta.flash_bwd_dq(bad, k, v, o, lse, do)
        with pytest.raises(ValueError, match="cp.async"):
            ta.flash_bwd_dq(q, k, v, bad, lse, do)
        with pytest.raises(ValueError, match="cp.async"):
            ta.flash_bwd_dkv(q, k, v, bad, lse, delta)
    assert ta.flash_attention.dq_launches == ta.flash_attention.dkv_launches == 0


def _head_width_case(d, heads, dtype, tol, length, causal):
    """``flash_attention`` at head width d, forward and backward: one launch
    of K1, K2a and K2b each, no plain call, against the plain versions at
    the true width (O absolute, the gradients relative to max |plain|)."""
    gen = torch.Generator(device="cuda").manual_seed(d + length)
    qkv = torch.randn((2, length, 3, heads, d), generator=gen, device="cuda").to(dtype)
    do = torch.randn((2, length, heads, d), generator=gen, device="cuda").to(dtype)
    q, k, v = (x.detach().requires_grad_() for x in qkv.unbind(2))
    ta.reset_counts()
    o, lse = ta.flash_attention(q, k, v, causal, return_lse=True)
    o.backward(do)
    assert {c: getattr(ta.flash_attention, c) for c in ta.COUNTS} == {
        "kernel_launches": 1, "dq_launches": 1, "dkv_launches": 1, "plain_calls": 0,
        "plain_bwd_calls": 0}
    qr, kr, vr = (x.detach().requires_grad_() for x in qkv.unbind(2))
    want, want_lse = ta.attention_reference(qr, kr, vr, causal, return_lse=True)
    want.backward(do)
    assert o.shape == want.shape and o.dtype == want.dtype
    assert (o.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for got, ref in ((q, qr), (k, kr), (v, vr)):
        err = (got.grad.float() - ref.grad.float()).abs().max().item()
        assert err <= tol * ref.grad.float().abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("length,causal", [(1024, False), (1000, True)])
@pytest.mark.parametrize("d", [8, 32, 128])
def test_any_head_width_forward_and_backward_on_card(card, d, dtype, tol, length, causal):
    """Fault 7: D = 8 and 32 are zero-padded to the 64-wide kernels, D = 128
    runs their 128-wide instantiations."""
    _head_width_case(d, 8, dtype, tol, length, causal)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("length,causal", [(1024, False), (1000, True)])
@pytest.mark.parametrize("d", [192, 256])
def test_head_width_above_128_runs_on_card(card, d, dtype, tol, length, causal):
    """Fault 7's rest: heads wider than 128 run K1 of
    ``csrc/flash_fwd_wide_sm90.cu`` and K2a and K2b of
    ``csrc/flash_bwd_wide_sm90.cu`` (heads x D = 512 as in the UNet's
    levels)."""
    _head_width_case(d, 512 // d, dtype, tol, length, causal)


def _wide_forward_case(d, heads, rows, length, dtype, tol, causal, seed):
    """K1 alone at head width d above 128: q, k, v views of one packed qkv
    (as the UNet makes them), zero-padded to the kernel width where d is
    not one; one launch, no plain call, O and the LSE against the plain
    version at the true width."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((rows, length, 3, heads, d), generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    width = ta.kernel_width(d)
    qp, kp, vp = (torch.nn.functional.pad(x, (0, width - d)) if width != d else x
                  for x in (q, k, v))
    ta.reset_counts()
    o, lse = ta.flash_fwd(qp, kp, vp, causal, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert {c: getattr(ta.flash_attention, c) for c in ta.COUNTS} == {
        "kernel_launches": 1, "dq_launches": 0, "dkv_launches": 0, "plain_calls": 0,
        "plain_bwd_calls": 0}
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    assert o.shape == (rows, length, heads, width) and o.dtype == dtype
    assert (o[..., :d].float() - want.float()).abs().max().item() <= tol
    assert not o[..., d:].any()
    assert (lse - want_lse).abs().max().item() <= 1e-4
    return o, lse


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("length,causal", [(40, False), (1001, False), (1001, True)])
@pytest.mark.parametrize("d", [160, 192, 256, 320, 384, 448, 512])
def test_wide_forward_kernel_matches_plain_on_card(card, d, dtype, tol, length, causal):
    """K1 of ``csrc/flash_fwd_wide_sm90.cu`` (TMA into an mbarrier ring;
    bf16 on wgmma, f32 as 3xTF32 on mma.sync) at every width it takes, a
    sequence below one tile and a ragged one, causal too."""
    _wide_forward_case(d, max(1, round(512 / d)), 2, length, dtype, tol, causal, d + length)


@pytest.mark.parametrize("dtype,tol,rows", [(torch.bfloat16, 8e-3, 16),
                                            (torch.float32, 1e-4, 4)])
def test_wide_forward_kernel_at_the_2x256_unets_largest_call_on_card(card, dtype, tol,
                                                                     rows):
    """The 2 x 256 UNet's largest K1 calls, T = 2048: its in-band forward's
    16 rows in bf16 and its training forward's 4 in f32; O and the LSE the
    same bits on a second call (no atomics)."""
    o, lse = _wide_forward_case(256, 2, rows, 2048, dtype, tol, False, 7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn((rows, 2048, 3, 2, 256), generator=gen, device="cuda").to(dtype)
    o2, lse2 = ta.flash_fwd(*qkv.unbind(2), False, 1.0 / 16)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("length,causal", [(1000, False), (1000, True)])
@pytest.mark.parametrize("d", [576, 1024])
def test_heads_wider_than_512_run_the_cluster_and_chunked_kernels_on_card(
        card, d, dtype, tol, length, causal):
    """Fault 8: no head width raises on the card.  Above 512 K1 is the
    cluster kernel of ``csrc/flash_fwd_cluster_sm90.cu``, K2a and K2b the
    chunked kernels of ``csrc/flash_wide.cu``: one launch each, no plain
    call, against the plain versions (the gradients within 1e-4 of max
    |plain| in f32)."""
    _head_width_case(d, 1, dtype, tol, length, causal)
    assert dict(ta.flash_attention.entry_launches) == {
        "flash_fwd_cluster": 1, "flash_bwd_dq_chunked": 1, "flash_bwd_dkv_chunked": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,causal", [(40, False), (1001, False), (1001, True)])
@pytest.mark.parametrize("d", [576, 640, 1000, 1024, 2048, 4096])
def test_cluster_forward_kernel_matches_plain_on_card(card, d, dtype, length, causal):
    """K1 of ``csrc/flash_fwd_cluster_sm90.cu`` (clusters of blocks that
    split the head's columns and sum S across the cluster's shared memory)
    on views of one packed qkv, zero-padded where d is not a multiple of 64
    (1000): a sequence below one tile and a ragged one, causal too, at
    widths with clusters of 3 to 8 blocks and ragged last slices.  O within
    1e-4 of max |plain| (f32) or at most 5e-3 of its elements rounded
    otherwise than the plain version (bf16), the LSE within 1e-5, one launch
    of ``flash_fwd_cluster``, and the same bits from a second call."""
    gen = torch.Generator(device="cuda").manual_seed(d + length)
    qkv = torch.randn((2, length, 3, 1, d), generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    width = ta.kernel_width(d)
    qp, kp, vp = (torch.nn.functional.pad(x, (0, width - d)) if width != d else x
                  for x in (q, k, v))
    ta.reset_counts()
    o, lse = ta.flash_fwd(qp, kp, vp, causal, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert dict(ta.flash_attention.entry_launches) == {"flash_fwd_cluster": 1}
    assert ta.flash_attention.plain_calls == 0
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    got = o[..., :d]
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    else:
        assert (got != want).float().mean().item() <= 5e-3
    assert not o[..., d:].any()
    assert (lse - want_lse).abs().max().item() <= 1e-5
    o2, lse2 = ta.flash_fwd(qp, kp, vp, causal, 1.0 / math.sqrt(d))
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
def test_heads_wider_than_the_cluster_kernel_run_the_chunked_forward_on_card(
        card, dtype, tol):
    """Above ``CLUSTER_FWD_MAX`` (8 blocks of 512 columns) K1 stays the
    chunked kernel of ``csrc/flash_wide.cu``, one body a type: one head of
    4160, a short sequence, one launch of ``flash_fwd_chunked``."""
    d = ta.CLUSTER_FWD_MAX + 64
    _wide_forward_case(d, 1, 2, 200, dtype, tol, False, 41)
    assert dict(ta.flash_attention.entry_launches) == {"flash_fwd_chunked": 1}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("length,causal", [(40, False), (1001, False), (1001, True)])
@pytest.mark.parametrize("d", [192, 320, 448, 512])
def test_wide_backward_kernels_match_plain_on_card(card, d, dtype, tol, length, causal):
    """K2a and K2b of ``csrc/flash_bwd_wide_sm90.cu`` (TMA into an mbarrier
    ring; bf16 on wgmma, f32 as 3xTF32 on mma.sync) through
    ``flash_attention`` on views of one packed qkv, at widths with f32 ring
    tiles of 32 and 16 rows and bf16 warpgroups over an odd number of
    pieces, a sequence below one tile and a ragged one, causal too."""
    _head_width_case(d, max(1, round(512 / d)), dtype, tol, length, causal)
    assert dict(ta.flash_attention.entry_launches) == {
        "flash_fwd_wide": 1, "flash_bwd_dq_wide": 1, "flash_bwd_dkv_wide": 1}


def test_wide_backward_kernels_at_the_2x256_unets_training_call_on_card(card):
    """The 2 x 256 UNet's training backward, f32, 4 rows x 2 heads, T = 2048,
    on views of one packed qkv: dq, dk and dv within 1e-4 of max |plain|,
    delta within 1e-4, one launch each, and the same bits on a second call
    (no atomics)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = torch.randn((4, 2048, 3, 2, 256), generator=gen, device="cuda").unbind(2)
    do = torch.randn((4, 2048, 2, 256), generator=gen, device="cuda")
    o, lse = ta.flash_fwd(q, k, v)
    ta.reset_counts()
    dq, delta = ta.flash_bwd_dq(q, k, v, o, lse, do)
    dk, dv = ta.flash_bwd_dkv(q, k, v, do, lse, delta)
    assert dict(ta.flash_attention.entry_launches) == {"flash_bwd_dq_wide": 1,
                                                        "flash_bwd_dkv_wide": 1}
    want_dq, want_delta = ta.flash_bwd_dq_reference(q, k, v, o, lse, do)
    want_dk, want_dv = ta.flash_bwd_dkv_reference(q, k, v, do, lse, want_delta)
    assert (delta - want_delta).abs().max().item() <= 1e-4
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    dq2, delta2 = ta.flash_bwd_dq(q, k, v, o, lse, do)
    dk2, dv2 = ta.flash_bwd_dkv(q, k, v, do, lse, delta)
    assert all(torch.equal(a, b) for a, b in ((dq, dq2), (delta, delta2), (dk, dk2),
                                               (dv, dv2)))


# the tiny parity config of tests/test_diffusion_stack.py as it is: 2 heads
# of 8 features
TINY_MODEL = {
    "model": dict(in_channels=1, channels=(4, 8, 16, 16), factors=(1, 4, 4, 2),
                  items=(1, 1, 1, 2), attentions=(0, 0, 1, 1),
                  cross_attentions=(1, 1, 1, 1), context_channels=(2, 8, 16, 16),
                  attention_heads=2, attention_features=8, embedding_features=16,
                  modulation_features=32, resnet_groups=2),
    "onsets_encoder": dict(in_channels=1, channels=2, multipliers=(1, 1, 4, 8, 8),
                           factors=(1, 4, 4, 2), num_blocks=(1, 1, 1, 1),
                           resnet_groups=2)}


def test_tiny_parity_config_runs_on_card(no_tf32):
    """The UNet of the repo's tiny parity config (``attention_features`` 8)
    on the card against the same weights on the CPU, f32 without TF32:
    within 1e-4 of max |CPU| (sums in other orders through the net), 5 K1
    launches a forward (as SMALL_MODEL's below, whose levels it shares)."""
    cpu = SyncFusionDiffusion.from_config(TINY_MODEL, device="cpu", seed=0)
    gpu = SyncFusionDiffusion.from_config(TINY_MODEL, device="cuda", seed=0)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4096, 1), generator=gen)
    onsets = torch.zeros((2, 4096, 1))
    onsets[:, ::300] = 1.0
    emb = torch.randn((2, 1, 16), generator=gen)
    sigma = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        want = cpu.unet(x, sigma, context=cpu.encode_context(onsets), embedding=emb)
        ta.reset_counts()
        got = gpu.unet(x.cuda(), sigma.cuda(), context=gpu.encode_context(onsets.cuda()),
                       embedding=emb.cuda())
        torch.cuda.synchronize()
    assert ta.flash_attention.kernel_launches == 5 and ta.flash_attention.plain_calls == 0
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_wide_head_tiny_config_runs_on_card(no_tf32):
    """The tiny parity config with one head of 192 features (the UNet of
    tests/test_torch_wide_heads.py) on the card against the same weights on
    the CPU, f32 without TF32, within 1e-4 of max |CPU|, through the wide
    kernels: 5 K1 launches a forward, no plain call."""
    cfg = {**TINY_MODEL, "model": {**TINY_MODEL["model"], "attention_heads": 1,
                                   "attention_features": 192}}
    cpu = SyncFusionDiffusion.from_config(cfg, device="cpu", seed=0)
    gpu = SyncFusionDiffusion.from_config(cfg, device="cuda", seed=0)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 4096, 1), generator=gen)
    onsets = torch.zeros((2, 4096, 1))
    onsets[:, ::300] = 1.0
    emb = torch.randn((2, 1, 16), generator=gen)
    sigma = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        want = cpu.unet(x, sigma, context=cpu.encode_context(onsets), embedding=emb)
        ta.reset_counts()
        got = gpu.unet(x.cuda(), sigma.cuda(), context=gpu.encode_context(onsets.cuda()),
                       embedding=emb.cuda())
        torch.cuda.synchronize()
    assert ta.flash_attention.kernel_launches == 5 and ta.flash_attention.plain_calls == 0
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_gradient_goes_through_the_kernels_on_card(card):
    """Fault 1 on the card: a loss through ``flash_attention`` gets its
    gradient from K2a and K2b, equal to autograd through the plain
    attention within the f32 tolerance."""
    q, k, v, w = _qkv(2, 512, torch.float32, 7)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ta.reset_counts()
    (ta.flash_attention(*leaves) * w).sum().backward()
    assert (ta.flash_attention.kernel_launches, ta.flash_attention.dq_launches,
            ta.flash_attention.dkv_launches) == (1, 1, 1)
    assert ta.flash_attention.plain_calls == ta.flash_attention.plain_bwd_calls == 0
    plain = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    (ta.attention_reference(*plain) * w).sum().backward()
    for got, want in zip(leaves, plain):
        err = (got.grad - want.grad).abs().max().item()
        assert err <= 1e-4 * want.grad.abs().max().item()


def test_gradient_of_views_cp_async_cannot_take_on_card(card):
    """An f32 q, k, v with an odd L stride and one off 16 bytes, and a dO
    sliced out of a cat's gradient (H stride 65): the autograd forward
    copies the views for K1, the backward copies dO for K2a and K2b, each
    launches once, and the gradients equal autograd through the plain
    attention within the f32 tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    odd = torch.randn((2, 256, 8 * 64 + 1), generator=gen, device="cuda")
    flat = torch.randn(2 * 256 * 512 + 1, generator=gen, device="cuda")
    k = torch.randn((2, 256, 8, 64), generator=gen, device="cuda")
    pad = torch.randn((2, 256, 8, 1), generator=gen, device="cuda")
    w = torch.randn((2, 256, 8, 65), generator=gen, device="cuda")
    seen = []

    def grads(attend):
        leaves = [x.detach().clone().requires_grad_() for x in (odd, flat, k)]
        q = leaves[0][..., :512].unflatten(-1, (8, 64))
        v = leaves[1][1:].view(2, 256, 8, 64)
        o = attend(q, leaves[2], v)
        o.register_hook(seen.append)
        (torch.cat([o, pad], dim=-1) * w).sum().backward()
        return [x.grad for x in leaves]

    ta.reset_counts()
    got = grads(ta.flash_attention)
    for name, x in (("q", got[0][..., :512].unflatten(-1, (8, 64))),
                    ("dO", seen[0])):
        assert ta.cp_async_misalignment(name, x.data_ptr(), x.shape[:3],
                                        x.stride()[:3], 4) is not None
    assert (ta.flash_attention.kernel_launches, ta.flash_attention.dq_launches,
            ta.flash_attention.dkv_launches) == (1, 1, 1)
    assert ta.flash_attention.plain_calls == ta.flash_attention.plain_bwd_calls == 0
    for g, want in zip(got, grads(ta.attention_reference)):
        assert (g - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# K3 and K4 at the shapes of the UNet's fused resnet chain (full width,
# exp/model/diffusion.yaml): (C, Cout, L) of each conv, with or without
# the residual for K4; plus a ragged and a wide case.
K3_SHAPES = [(40, 32, 65536), (32, 32, 65536), (64, 32, 65536), (80, 64, 16384),
             (64, 64, 16384), (128, 64, 16384), (128, 128, 4096), (64, 64, 1000),
             (1024, 1024, 256)]
K4_SHAPES = [(10, 8, 2**18, False), (8, 8, 2**18, True), (16, 8, 2**18, False),
             (40, 32, 65536, False), (32, 32, 65536, True), (64, 32, 65536, False),
             (32, 32, 1000, True), (1024, 1024, 256, True)]
# y: relative to max |plain|, f32 sums in other orders, bf16 one ulp of a
# value both round (2^-8); s and ss: relative to the bound of each sum
# (sqrt(n·ss) and ss), both sum the same f32 values in other orders
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
STATS_TOL = 1e-5


@pytest.fixture
def no_tf32(card):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield card
    torch.backends.cudnn.allow_tf32 = before


def _fused_inputs(rows, c, cout, length, dtype, seed, residual=False):
    """x and the residual as (B, L, C) views of (B, C, L) tensors, as the
    UNet's blocks pass them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = randn(rows, c, length).to(dtype).transpose(1, 2)
    scale, shift = randn(rows, c) * 0.3 + 1.0, randn(rows, c) * 0.5
    w = (randn(3, c, cout) / math.sqrt(3 * c)).to(dtype)
    bias = randn(cout) * 0.1
    r = randn(rows, cout, length).to(dtype).transpose(1, 2) if residual else None
    return x, scale, shift, w, bias, r


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 8), (torch.float32, 4)])
@pytest.mark.parametrize("c,cout,length", K3_SHAPES)
def test_k3_matches_plain_on_card(no_tf32, dtype, rows, c, cout, length):
    x, scale, shift, w, bias, _ = _fused_inputs(rows, c, cout, length, dtype, c)
    fr.reset_counts()
    y = fr.fused_affine_silu_conv_blocked(x, scale, shift, w, bias)
    assert fr.affine_silu_conv.kernel_launches == 1
    want = fr._reference(x, scale, shift, w, bias)
    assert y.dtype == dtype and y.shape == want.shape
    assert _rel(y, want) <= FUSED_TOL[dtype]


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 8), (torch.float32, 4)])
@pytest.mark.parametrize("c,cout,length,residual", K4_SHAPES)
def test_k4_matches_plain_on_card(no_tf32, dtype, rows, c, cout, length, residual):
    x, scale, shift, w, bias, r = _fused_inputs(rows, c, cout, length, dtype,
                                                c + 1, residual)
    fr.reset_counts()
    y, s, ss = fr.fused_affine_silu_conv_stats(x, scale, shift, w, bias, r,
                                               num_groups=8)
    assert fr.affine_silu_conv_stats.kernel_launches == 1
    want, want_s, want_ss = fr._stats_reference(x, scale, shift, w, bias, r, 8)
    assert _rel(y, want) <= FUSED_TOL[dtype]
    n = length * cout // 8
    assert ((s - want_s).abs() / (n * want_ss).sqrt()).max().item() <= STATS_TOL
    assert ((ss - want_ss).abs() / want_ss).max().item() <= STATS_TOL


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 8), (torch.float32, 4)])
@pytest.mark.parametrize("kind,c,cout,length,residual",
                         [("k3", c, co, n, False) for c, co, n in K3_SHAPES]
                         + [("k4", c, co, n, r) for c, co, n, r in K4_SHAPES]
                         + [("k4", 40, 32, 1001, True), ("k3", 10, 8, 1001, False)])
def test_bf16_kernel_in_the_channel_last_layout_on_card(no_tf32, dtype, rows, kind, c,
                                                         cout, length, residual):
    """Both tensor-core bodies (bf16, and f32 as 3xTF32) with x, the
    residual and y as contiguous (B, L, C) tensors (the other stride
    layout: no 16-byte rows along L), at every shape of the chain and at an
    L that is no multiple of 8, against their plain versions."""
    x, scale, shift, w, bias, r = _fused_inputs(rows, c, cout, length, dtype,
                                                c + 2, residual)
    x = x.contiguous()
    r = r.contiguous() if r is not None else None
    fr.reset_counts()
    if kind == "k3":
        y = fr.affine_silu_conv(x, scale, shift, w, bias)
        want = fr._reference(x, scale, shift, w, bias)
    else:
        y, s, ss = fr.affine_silu_conv_stats(x, scale, shift, w, bias, r, 8)
        want, want_s, want_ss = fr._stats_reference(x, scale, shift, w, bias, r, 8)
        n = length * cout // 8
        assert ((s - want_s).abs() / (n * want_ss).sqrt()).max().item() <= STATS_TOL
        assert ((ss - want_ss).abs() / want_ss).max().item() <= STATS_TOL
    assert fr.affine_silu_conv.kernel_launches + fr.affine_silu_conv_stats.kernel_launches == 1
    assert y.is_contiguous() and _rel(y, want) <= FUSED_TOL[dtype]


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 8), (torch.float32, 4)])
def test_bf16_kernel_is_deterministic_and_takes_a_bf16_weight_on_card(no_tf32, dtype,
                                                                      rows):
    """The group sums are per-tile partials added in a fixed order (no
    atomics): two calls give bitwise equal y, s and ss, in both bodies.  An
    f32 weight with a bf16 x raises instead of being rounded behind the
    caller's back; a bf16 weight with an f32 x is widened, exactly."""
    x, scale, shift, w, bias, r = _fused_inputs(rows, 40, 32, 65536, dtype, 3, True)
    first = fr.affine_silu_conv_stats(x, scale, shift, w, bias, r, 8)
    second = fr.affine_silu_conv_stats(x, scale, shift, w, bias, r, 8)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    if dtype == torch.bfloat16:
        with pytest.raises(TypeError, match="bf16 weight"):
            fr.affine_silu_conv(x, scale, shift, w.float(), bias)
    else:
        w16 = w.to(torch.bfloat16)
        assert torch.equal(fr.affine_silu_conv(x, scale, shift, w16, bias),
                           fr.affine_silu_conv(x, scale, shift, w16.float(), bias))


def test_misaligned_f32_fused_input_runs_on_card(no_tf32):
    """The 3xTF32 body moves x and the residual in 16-byte pieces only
    where they allow it (L contiguous, a 16-byte address, strides in
    multiples of 4): an odd L stride, or an address off 16 bytes, takes
    4-byte copies and loads and still matches the plain version, one launch
    each."""
    x, scale, shift, w, bias, r = _fused_inputs(4, 33, 32, 1000, torch.float32, 7, True)
    odd_l = x.contiguous()  # (B, L, C) with C = 33: L stride 33
    flat = torch.zeros(x.numel() + 1, device="cuda")
    off16 = flat[1:].view(4, 33, 1000).copy_(x.transpose(1, 2)).transpose(1, 2)
    rflat = torch.zeros(r.numel() + 1, device="cuda")
    r_off = rflat[1:].view(4, 32, 1000).copy_(r.transpose(1, 2)).transpose(1, 2)
    for xx, rr in ((odd_l, r), (off16, r_off)):
        fr.reset_counts()
        y = fr.affine_silu_conv(xx, scale, shift, w, bias)
        ys, s, ss = fr.affine_silu_conv_stats(xx, scale, shift, w, bias, rr, 8)
        assert fr.affine_silu_conv.kernel_launches == 1
        assert fr.affine_silu_conv_stats.kernel_launches == 1
        want = fr._reference(xx, scale, shift, w, bias)
        want_s, s_ref, ss_ref = fr._stats_reference(xx, scale, shift, w, bias, rr, 8)
        assert _rel(y, want) <= FUSED_TOL[torch.float32]
        assert _rel(ys, want_s) <= FUSED_TOL[torch.float32]
        n = 1000 * 32 // 8
        assert ((s - s_ref).abs() / (n * ss_ref).sqrt()).max().item() <= STATS_TOL
        assert ((ss - ss_ref).abs() / ss_ref).max().item() <= STATS_TOL


def test_gradient_through_the_fused_block_on_card(no_tf32):
    """A loss through a fused ResnetBlock1d (K3 forward, plain recompute
    backward) and through its stats path (K4) against the plain block on
    the same parameters: the gradient of the input and of every parameter
    within 1e-4 of max |plain|, f32."""
    from syncfusion_tpu_torch.models.blocks import ResnetBlock1d

    torch.manual_seed(0)
    block = ResnetBlock1d(40, 32, 8, 64, fused=True, fused_block_l=4096).cuda()
    for p in block.parameters():
        torch.nn.init.normal_(p, 0.0, 0.2)
    x = torch.randn(2, 40, 8192, device="cuda")
    temb = torch.randn(2, 64, device="cuda")
    w = torch.randn(2, 32, 8192, device="cuda")

    def grads(fn):
        block.zero_grad()
        xg = x.clone().requires_grad_()
        (fn(xg) * w).sum().backward()
        return [xg.grad] + [p.grad.clone() for p in block.parameters()]

    fr.reset_counts()
    fused = grads(lambda xg: block(xg, temb))
    stats = grads(lambda xg: block.forward_stats(xg, temb)[0])
    assert fr.affine_silu_conv.kernel_launches == 2
    assert fr.affine_silu_conv_stats.kernel_launches == 2
    assert fr.affine_silu_conv.plain_calls == fr.affine_silu_conv_stats.plain_calls == 0
    block.fused = False
    plain = grads(lambda xg: block(xg, temb))
    for got_fused, got_stats, want in zip(fused, stats, plain):
        scale = want.abs().max().item()
        assert (got_fused - want).abs().max().item() <= 1e-4 * scale
        assert (got_stats - want).abs().max().item() <= 1e-4 * scale


# a small SyncFusion whose attention takes K1's head dim (64): the tiny
# config of tests/test_diffusion_stack.py with 2 heads of 64 features
SMALL_MODEL = {
    "model": dict(in_channels=1, channels=(4, 8, 16, 16), factors=(1, 4, 4, 2),
                  items=(1, 1, 1, 2), attentions=(0, 0, 1, 1),
                  cross_attentions=(1, 1, 1, 1), context_channels=(2, 8, 16, 16),
                  attention_heads=2, attention_features=64, embedding_features=16,
                  modulation_features=32, resnet_groups=2),
    "onsets_encoder": dict(in_channels=1, channels=2, multipliers=(1, 1, 4, 8, 8),
                           factors=(1, 4, 4, 2), num_blocks=(1, 1, 1, 1),
                           resnet_groups=2)}


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_cached_sampling_through_the_kernel_on_card(no_tf32, sampler):
    """DeepCache sampling (K = 2, split 2, 4 steps, CFG 2.0 in the band
    (0.2, 0.8)) through K1 against the plain attention on the same weights,
    f32: within 1e-3 of max |plain| (chip_smoke.py's CROSS_TOL).  The band's
    segments of 1 and 3 steps refresh at 0 and at 0, 2: 3 full forwards of
    5 attention calls each; the cached forwards launch none."""
    model = SyncFusionDiffusion.from_config(SMALL_MODEL, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.randn((2, 2048, 1), generator=gen, device="cuda")
    onsets = torch.zeros((2, 2048, 1), device="cuda")
    onsets[:, [100, 900], 0] = 1.0
    emb = torch.randn((2, 1, 16), generator=gen, device="cuda")
    kw = dict(num_steps=4, embedding_scale=2.0, guidance_interval=(0.2, 0.8),
              sampler=sampler, deep_cache_interval=2, deep_split=2)
    ta.reset_counts()
    got = model.sample(noise, onsets, emb, **kw)
    assert ta.flash_attention.kernel_launches == 3 * 5
    assert ta.flash_attention.plain_calls == 0
    for m in model.modules():
        if isinstance(m, SelfAttention1d):
            m.attend = ta.attention_reference
    want = model.sample(noise, onsets, emb, **kw)
    assert torch.isfinite(got).all() and got.shape == (2, 2048, 1)
    assert _rel(got, want) <= 1e-3


@pytest.fixture
def exact_f32(card):
    """f32 without TF32 in cuDNN and in matmuls, as precision 32 trains."""
    from syncfusion_tpu_torch import device

    with device.exact_f32():
        yield card


def test_onset_net_and_train_step_on_card_match_cpu(exact_f32):
    """The onset net (R(2+1)D-10, 2 chunks of 8 frames at 32x32) in f32:
    on the card against the CPU on the same weights and frames, the
    eval-mode logits and the train-mode loss within 1e-4 relative, the
    BatchNorm buffers after the train forward within 1e-4 of each one's
    largest value, the gradients within 1e-3 of max(max |g|, 1e-3 of the
    largest gradient) per tensor (chip_smoke.py's TRAIN_GRAD_TOL and
    GRAD_FLOOR), the CPU taking the card's ReLU masks (f32 rounding flips a
    few ReLU inputs, and a flip moves a weight gradient by far more than
    rounding: chip_smoke.py, ONSET_TOL); then one OnsetTrainer step on the
    card on the uint8 wire."""
    import copy

    from syncfusion_tpu_torch.models.onset_net import ReluTape

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, 32, 32, 3), generator=gen)
    labels = (torch.rand((2, 8), generator=gen) < 0.3).float()
    cpu = VideoOnsetNet((1, 1, 1, 1)).init(0)
    gpu = copy.deepcopy(cpu).cuda()
    with torch.no_grad():
        assert _rel(gpu.eval()(x.cuda()).cpu(), cpu.eval()(x)) <= 1e-4

    def loss_and_grads(net, frames, y, tape):
        with tape:
            net.train().zero_grad()
            loss = bc_loss(net(frames), y)
            loss.backward()
        return loss.item(), {k: p.grad.cpu() for k, p in net.named_parameters()}

    card = ReluTape()
    loss_g, grads_g = loss_and_grads(gpu, x.cuda(), labels.cuda(), card)
    loss_c, grads_c = loss_and_grads(cpu, x, labels, ReluTape(replay=card))
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    buffers_g = dict(gpu.named_buffers())
    for name, b in cpu.named_buffers():
        assert _rel(buffers_g[name].cpu(), b) <= 1e-4, name
    top = max(g.abs().max().item() for g in grads_c.values())
    for name, g in grads_c.items():
        scale = max(g.abs().max().item(), 1e-3 * top)
        assert (grads_g[name] - g).abs().max().item() <= 1e-3 * scale, name

    trainer = OnsetTrainer(gpu)
    state = trainer.create_state()
    wire = torch.randint(0, 256, (2, 8, 32, 32, 3), dtype=torch.uint8, device="cuda")
    metrics, logits = trainer.train_step(state, {"frames": wire, "label": labels.cuda()})
    assert state.step == 1 and logits.shape == (2, 8)
    assert math.isfinite(metrics["loss/train"].item())


def test_clap_embedder_on_card_matches_cpu(exact_f32):
    """CLAP at full width (HTSAT-tiny, roberta-base), seeded weights on the
    card copied to the CPU: ``embed_audio`` of a clip repeat-padded to 10 s
    and ``embed_text`` (hashed tokenizer when no roberta files exist)
    agree to 1e-4 on unit-norm embeddings, f32 without TF32 (chip_smoke.py,
    CLAP_EMB_TOL)."""
    from syncfusion_tpu_torch.models.clap.model import ClapEmbedder, ClapModel

    gpu = ClapEmbedder(device="cuda", seed=3)
    cpu = ClapEmbedder(device="cpu", model=ClapModel())
    cpu.model.load_state_dict(gpu.model.state_dict(), strict=True)
    wav = 0.1 * torch.randn((2, 96000, 1), generator=torch.Generator().manual_seed(2))
    for fn, arg in ((lambda e, a: e.embed_audio(a), wav.numpy()),
                    (lambda e, a: e.embed_text(a), ["hit wood", "scratch metal"])):
        got, want = fn(gpu, arg), fn(cpu, arg)
        assert got.device.type == "cuda" and got.shape == (2, 1, 512)
        assert (got.cpu() - want).abs().max().item() <= 1e-4
        assert (got.norm(dim=-1) - 1.0).abs().max().item() <= 1e-5


def test_vggish_on_card_matches_cpu(card):
    """VGGish at full width (72 M parameters), seeded weights on the card
    copied to the CPU, f32 without TF32 (``device.exact_f32``): the
    embeddings of a 2-s clip's patches agree to 1e-4 of max |embedding|
    (chip_smoke.py, VGGISH_TOL); ``resample_torch`` on the card agrees
    with the host resampler to 1e-5 (RESAMPLE_TOL)."""
    import numpy as np

    from syncfusion_tpu_torch import device
    from syncfusion_tpu_torch.eval import fad
    from syncfusion_tpu_torch.ops.resample import resample, resample_torch

    gpu = fad.VGGishEmbedder()
    assert gpu.device.type == "cuda"
    cpu = fad.VGGish()
    cpu.load_state_dict(gpu.net.state_dict(), strict=True)
    y = (0.1 * np.random.default_rng(2).standard_normal(44100)).astype(np.float32)
    got = gpu.embed(y, 22050)
    with torch.no_grad(), device.exact_f32():
        want = cpu(torch.from_numpy(fad.vggish_log_mel(y, 22050))).numpy()
    assert got.shape == want.shape == (2, 128)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    x = np.random.default_rng(3).standard_normal((2, 9600)).astype(np.float32)
    back = resample_torch(torch.from_numpy(x).to(card), 48000, 22050)
    assert back.device.type == "cuda"
    assert np.abs(back.cpu().numpy() - resample(x, 48000, 22050)).max() <= 1e-5


@pytest.fixture(scope="module")
def nccl_rank():
    """This process as rank 0 of a one-rank NCCL group, as torchrun would
    start it (its environment, a free localhost port); the device
    ``init_distributed`` picked."""
    import os
    import socket

    import torch.distributed as dist

    from syncfusion_tpu_torch.core.mesh import init_distributed

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield init_distributed()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def test_init_distributed_picks_nccl_and_the_local_card(nccl_rank):
    import torch.distributed as dist

    assert nccl_rank == torch.device("cuda", 0) and dist.get_backend() == "nccl"
    assert torch.cuda.current_device() == 0


def test_data_parallel_sampler_rows_equal_sample_on_card(nccl_rank):
    """The sampler's rows at world size 1, 2 f32 steps in the band, equal
    ``SyncFusionDiffusion.sample`` on the same noise: the same kernels on
    the same batch (chip_smoke.py's MD_SAMPLE_TOL)."""
    from syncfusion_tpu_torch import device
    from syncfusion_tpu_torch.core.mesh import create_mesh
    from syncfusion_tpu_torch.parallel.sampling import DataParallelSampler

    with device.exact_f32():
        model = SyncFusionDiffusion.from_config(SMALL_MODEL, device=nccl_rank, seed=0)
        onsets = torch.zeros((2, 2048, 1), device=nccl_rank)
        onsets[:, [100, 900], 0] = 1.0
        emb = torch.randn((2, 1, 16), device=nccl_rank,
                          generator=torch.Generator(device=nccl_rank).manual_seed(1))
        kw = dict(num_steps=2, embedding_scale=2.0, guidance_interval=(0.2, 0.8))
        sampler = DataParallelSampler(model, create_mesh(), per_chip_batch=2,
                                      length=2048, **kw)
        ta.reset_counts()
        rows = sampler(onsets, emb, torch.Generator(device=nccl_rank).manual_seed(4))
        assert ta.flash_attention.kernel_launches > 0
        assert ta.flash_attention.plain_calls == 0
        noise = torch.randn((2, 2048, 1), device=nccl_rank,
                            generator=torch.Generator(device=nccl_rank).manual_seed(4))
        want = model.sample(noise, onsets, emb, **kw)[:, :, 0]
    assert sampler.local_indices().tolist() == [0, 1]
    assert _rel(rows, want) <= 1e-6


def test_ddp_micro_step_runs_nccl_on_card(nccl_rank):
    """One micro-step of the trainer over the one-rank mesh: the model in
    DDP, whose gradient average NCCL runs on the device (its one-rank
    average kernel inside an ``nccl:all_reduce`` range)."""
    from torch.profiler import ProfilerActivity, profile

    from syncfusion_tpu_torch.core.mesh import create_mesh
    from syncfusion_tpu_torch.train.diffusion_trainer import DiffusionTrainer

    model = SyncFusionDiffusion.from_config(SMALL_MODEL, device=nccl_rank, seed=0)
    trainer = DiffusionTrainer(model, mesh=create_mesh())
    assert isinstance(trainer.module, torch.nn.parallel.DistributedDataParallel)
    state = trainer.create_state()
    gen = torch.Generator(device=nccl_rank).manual_seed(0)
    batch = {"wav": torch.randn((2, 2048, 1), device=nccl_rank, generator=gen),
             "onsets": torch.zeros((2, 2048, 1), device=nccl_rank, dtype=torch.uint8),
             "embedding": torch.randn((2, 1, 16), device=nccl_rank, generator=gen)}
    trainer.train_step(state, batch, gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics = trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
    assert math.isfinite(metrics["train_loss"].item())
    names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
    assert any("nccl" in name.lower() for name in names), sorted(names)[:20]


def test_condfoleygen_baseline_on_card_matches_cpu(card):
    """The full-width baseline of cfg/condfoleygen/*.yaml (seeded) on the
    card against a CPU copy on one item: chip_smoke.py's phase-17 cross
    check (spectrogram, VQ codes under the tie rule, video features,
    teacher-forced logits, top-k 1 tokens cached and uncached, decoded mel,
    MelGAN, Griffin-Lim from one phase) under its tolerances."""
    import chip_smoke
    from syncfusion_tpu_torch.core.config import BaselineConfig
    from syncfusion_tpu_torch.generate_audio import build_model
    from syncfusion_tpu_torch.models.melgan import Vocoder

    model = build_model(BaselineConfig(), card, seed=0)
    vocoder = Vocoder(device=card)
    wav, frames = chip_smoke.baseline_inputs(1)
    err = chip_smoke.baseline_cross_check(model, vocoder, wav, frames)
    assert chip_smoke.baseline_failed_gates(err) == [], err


def test_distillation_step_kernel_counts_on_card(exact_f32):
    """One distillation step of SMALL_MODEL, f32: two teacher forwards and
    one student forward through K1 (5 attention calls each: 15), the
    student's backward through K2a and K2b (5 each), the plain versions
    never; then the guided loss (one 2B teacher forward a step): the same
    counts.  The step's loss through the kernels against the plain
    attention within chip_smoke.py's phase-7 tolerance (1e-5 relative)."""
    from syncfusion_tpu_torch.train.distill import DistillConfig, ProgressiveDistiller

    model = SyncFusionDiffusion.from_config(SMALL_MODEL, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    wav = 0.3 * torch.randn((2, 2048, 1), generator=gen, device="cuda")
    onsets = torch.zeros((2, 2048, 1), device="cuda")
    onsets[:, [100, 900], 0] = 1.0
    emb = torch.randn((2, 1, 16), generator=gen, device="cuda")
    batch = {"wav": wav, "onsets": onsets, "embedding": emb}
    for scale in (1.0, 2.0):
        ta.reset_counts()
        _, steps = ProgressiveDistiller(model, DistillConfig(4, 2, 1, cfg_scale=scale)).distill(
            lambda step: batch, torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
        assert steps == 2
        assert (ta.flash_attention.kernel_launches, ta.flash_attention.dq_launches,
                ta.flash_attention.dkv_launches) == (15, 5, 5)
        assert ta.flash_attention.plain_calls == ta.flash_attention.plain_bwd_calls == 0
    teacher = SyncFusionDiffusion.from_config(SMALL_MODEL, device="cuda", seed=1)
    d = ProgressiveDistiller(model)
    i, noise = d.draws(wav, 2, torch.Generator(device="cuda").manual_seed(4))
    kernels = d.loss(model, teacher, wav, onsets, emb, 2, i=i, noise=noise).item()
    for m in list(model.modules()) + list(teacher.modules()):
        if isinstance(m, SelfAttention1d):
            m.attend = ta.attention_reference
    plain = d.loss(model, teacher, wav, onsets, emb, 2, i=i, noise=noise).item()
    assert math.isfinite(kernels) and abs(kernels - plain) <= 1e-5 * abs(plain)


@pytest.mark.parametrize("fused", [False, True])
def test_remat_loss_and_gradients_equal_on_card(exact_f32, fused):
    """A training loss and every gradient of SMALL_MODEL with remat against
    without, same parameters and draws, f32: the loss within 1e-6 relative
    and the gradients within 1e-5 of the largest; K1/K2 launch as often
    either way, the fused blocks' K3/K4 twice as often with remat (the
    backward recomputes them)."""
    import copy

    node = copy.deepcopy(SMALL_MODEL)
    if fused:
        # the fused gate takes 32-128 channels
        node["model"].update(channels=(32, 32, 32, 32), fused_resnet=True,
                             fused_block_l=64)
    runs = []
    for remat in (False, True):
        node["model"]["remat"] = remat
        model = SyncFusionDiffusion.from_config(node, device="cuda", seed=0)
        gen = torch.Generator(device="cuda").manual_seed(5)
        wav = 0.3 * torch.randn((2, 2048, 1), generator=gen, device="cuda")
        onsets = torch.zeros((2, 2048, 1), device="cuda")
        onsets[:, [100, 900], 0] = 1.0
        emb = torch.randn((2, 1, 16), generator=gen, device="cuda")
        sigma = torch.rand((2,), generator=gen, device="cuda")
        noise = torch.randn(wav.shape, generator=gen, device="cuda")
        ta.reset_counts()
        fr.reset_counts()
        loss = model.loss(wav, onsets, emb, sigma=sigma, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        counts = (ta.flash_attention.kernel_launches, ta.flash_attention.dq_launches,
                  fr.affine_silu_conv.kernel_launches)
        runs.append((loss.item(), {k: p.grad for k, p in model.named_parameters()},
                     counts))
    (loss_a, ga, ca), (loss_b, gb, cb) = runs
    assert abs(loss_b - loss_a) <= 1e-6 * abs(loss_a)
    top = max(g.abs().max().item() for g in ga.values() if g is not None)
    for k, g in ga.items():
        if g is not None:
            assert (gb[k] - g).abs().max().item() <= 1e-5 * top, k
    assert ca[:2] == cb[:2] == (5, 5)
    assert cb[2] == 2 * ca[2] and (ca[2] > 0) == fused
