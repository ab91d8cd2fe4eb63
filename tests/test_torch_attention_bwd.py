"""The port's attention backward against the JAX package's.

``flash_bwd_reference`` (the plain versions of K2a and K2b) is held against
``_flash_bwd`` run in interpret mode, the Pallas backward kernels as
tests/test_attention.py runs them (blocks of 128), on the same q, k, v, O,
LSE and dO; and the gradients of ``flash_attention`` through the port's
``torch.autograd.Function`` against ``jax.grad`` of the JAX
``flash_attention(interpret=True)``.  Tolerance ``atol 2e-4, rtol 1e-3`` in
f32, as tests/test_attention.py holds the Pallas backward against XLA's
gradients (sums over 256 keys in other orders).  The CUDA kernels are held
against the plain versions on the card by tests/test_torch_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.ops import attention as ja
from syncfusion_tpu_torch.ops import attention as ta
from torch_port_helpers import n, t

TOL = dict(rtol=1e-3, atol=2e-4)


def _arrays(b, l, h, d, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d)).astype(np.float32)
            for _ in range(count)]


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_interpret(causal):
    b, l, h, d = 2, 256, 2, 64
    q, k, v, do = _arrays(b, l, h, d, 4, seed=11 + causal)
    qf, kf, vf, dof = (ja._fold_heads(jnp.asarray(x)) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    of, lse = ja._flash_fwd(qf, kf, vf, causal, 128, 128, scale, True)
    want = ja._flash_bwd(qf, kf, vf, of, lse, dof, causal, 128, 128, scale, True)
    o = n(ja._unfold_heads(of, b, h))
    got = ta.flash_bwd_reference(t(q), t(k), t(v), t(o),
                                 t(n(lse).reshape(b, h, l)), t(do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(n(g), n(ja._unfold_heads(w, b, h)), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_gradients_match_jax_grad(causal):
    """Gradients of sum(O·w) through the port's Function (on the CPU: the
    plain forward and the plain K2a and K2b) against jax.grad of the JAX
    flash attention, whose custom VJP runs the Pallas kernels."""
    q, k, v, w = _arrays(2, 256, 2, 64, 4, seed=21 + causal)

    def loss(q, k, v):
        o = ja.flash_attention(q, k, v, causal=causal, block_q=128,
                               block_k=128, interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    (ta.flash_attention(qt, kt, vt, causal) * t(w)).sum().backward()
    for name, g, wg in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(n(g), n(wg), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_equals_autograd_of_reference_ragged(causal, dtype):
    """A ragged length (no block multiple) and views of one qkv tensor, as
    the UNet makes them: the recompute backward against torch autograd
    through ``attention_reference``.  f32: 1e-5 (orders of summation);
    bf16: both round their f32 gradient to bf16, one ulp (2^-7 relative)."""
    rng = np.random.default_rng(5)
    qkv = t(rng.standard_normal((2, 300, 3, 2, 64)).astype(np.float32)).to(dtype)
    q, k, v = qkv.unbind(2)
    do = t(rng.standard_normal((2, 300, 2, 64)).astype(np.float32)).to(dtype)
    o, lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    got = ta.flash_bwd_reference(q, k, v, o, lse, do, causal)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ta.attention_reference(*leaves, causal).backward(do)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    for g, leaf in zip(got, leaves):
        assert g.dtype == dtype
        ref = leaf.grad.float()
        assert (g.float() - ref).abs().max() <= tol * ref.abs().max()


def test_gradient_flows_through_the_function_on_cpu():
    """Fault 1: the output of ``flash_attention`` carries the Function's
    backward on every device, so a loss through the UNet's attention gets
    its gradient from K2a and K2b (their plain versions here)."""
    q, k, v = (t(x).requires_grad_() for x in _arrays(1, 64, 2, 64, 3, seed=3))
    o = ta.flash_attention(q, k, v)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    ta.reset_counts()
    o.square().sum().backward()
    counts = {name: getattr(ta.flash_attention, name) for name in ta.COUNTS}
    assert counts == {"kernel_launches": 0, "dq_launches": 0, "dkv_launches": 0,
                      "plain_calls": 0, "plain_bwd_calls": 2}
    assert all(x.grad is not None and x.grad.abs().max() > 0 for x in (q, k, v))


def test_lse_carries_no_gradient():
    q, k, v = (t(x).requires_grad_() for x in _arrays(1, 64, 1, 64, 3, seed=4))
    o, lse = ta.flash_attention(q, k, v, return_lse=True)
    assert o.requires_grad and not lse.requires_grad


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """On a CPU tensor each wrapper returns its plain version's result and
    counts a plain call, never a launch."""
    q, k, v, do = map(t, _arrays(1, 100, 2, 64, 4, seed=8))
    ta.reset_counts()
    o, lse = ta.flash_fwd(q, k, v, True)
    dq, delta = ta.flash_bwd_dq(q, k, v, o, lse, do, True)
    dk, dv = ta.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    for got, want in zip((dq, dk, dv), ta.flash_bwd_reference(q, k, v, o, lse, do, True)):
        assert torch.equal(got, want)
    assert (ta.flash_attention.plain_calls, ta.flash_attention.plain_bwd_calls) == (1, 2)
    assert ta.flash_attention.dq_launches == ta.flash_attention.dkv_launches == 0
