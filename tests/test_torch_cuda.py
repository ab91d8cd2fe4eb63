"""The port's CUDA kernels against their plain versions, on the card:
K1 (bf16 on the tensor cores, f32 on the CUDA cores), K2a and K2b (flash
attention backward, on the tensor cores), K3 and K4 (the fused resnet
chain).

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

from syncfusion_tpu_torch.ops import attention as ta
from syncfusion_tpu_torch.ops import fused_resblock as fr

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


@pytest.mark.parametrize("length", [2048, 1024, 512, 256])
def test_bf16_kernel_at_the_main_path_lengths_on_card(card, length):
    """The tensor-core kernel at each length of the UNet's attention levels,
    BH = 64 from qkv views, against its plain version."""
    q, k, v, _ = _qkv(8, length, torch.bfloat16, length + 2)
    ta.reset_counts()
    o, lse = ta.flash_fwd(q, k, v)
    assert ta.flash_attention.kernel_launches == 1
    want, want_lse = ta.attention_reference(q, k, v, return_lse=True)
    assert (o.float() - want.float()).abs().max().item() <= 8e-3
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_misaligned_bf16_input_raises_on_card(card):
    """cp.async takes 16-byte rows: an L stride that is not a multiple of 8
    elements, or an address off 16 bytes, raises and launches nothing."""
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
    """An f32 q, k, v with an odd L stride and one off 16 bytes (the f32
    forward takes both), and a dO sliced out of a cat's gradient (H stride
    65): the backward copies them for K2a and K2b, which launch once each,
    and the gradients equal autograd through the plain attention within the
    f32 tolerance."""
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
