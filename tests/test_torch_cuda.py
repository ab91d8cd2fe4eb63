"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports nothing of JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, as chip_smoke.py states them: f32 for orders of summation;
bf16 for one bf16 ulp of an output both sides round (O below 1: 2^-8
absolute; gradients: relative to max |plain|).
"""

import pytest
import torch

from syncfusion_tpu_torch.ops import attention as ta

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("length,causal", CASES)
def test_backward_kernels_match_plain_on_card(card, dtype, tol, length, causal):
    """K2a (dq and delta) and K2b (dk, dv) against their plain versions,
    relative to max |plain|."""
    q, k, v, do = _qkv(4, length, dtype, length + 1)
    o, lse = ta.flash_fwd(q, k, v, causal)
    dq, delta = ta.flash_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = ta.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    want_dq, want_delta = ta.flash_bwd_dq_reference(q, k, v, o, lse, do, causal)
    want_dk, want_dv = ta.flash_bwd_dkv_reference(q, k, v, do, lse, want_delta, causal)
    for got, want in ((dq, want_dq), (delta, want_delta), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == want.dtype and got.shape == want.shape
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()


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
