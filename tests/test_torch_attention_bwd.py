"""The port's attention backward against the JAX package's.

``flash_bwd_reference`` (the plain versions of K2a and K2b) is held against
``_flash_bwd`` run in interpret mode, the Pallas backward kernels as
tests/test_attention.py runs them (blocks of 128), on the same q, k, v, O,
LSE and dO; and the gradients of ``flash_attention`` through the port's
``torch.autograd.Function`` against ``jax.grad`` of the JAX
``flash_attention(interpret=True)``.  Tolerance ``atol 2e-4, rtol 1e-3`` in
f32, as tests/test_attention.py holds the Pallas backward against XLA's
gradients (sums over 256 keys in other orders).  The arithmetic of the
tensor-core kernels (3xTF32 products) is modelled here in plain PyTorch and
held to the card's f32 gate, and so is their rule on alignment in f32.  The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
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


# The arithmetic of the tensor-core kernels K2a and K2b, in plain PyTorch on
# the CPU: each of the five products (S, dP, dQ, dK, dV) on mma.sync
# m16n8k8 with tf32 operands, in k-steps of 8 added to one f32 accumulator;
# an f32 operand x as big = x rounded to tf32 (to nearest, ties away from
# zero, as cvt.rna.tf32.f32 rounds) and small = x - big, which the tensor
# cores read truncated to tf32; the product as small·big + big·small +
# big·big (3xTF32).  Held to the card's f32 gate
# (chip_smoke.BWD_TOL, tests/test_torch_cuda.py): max |error| / max |plain|
# <= 1e-4 for each of dq, dk and dv.
BWD_TOL_F32 = 1e-4
THREE_TF32 = ("small_big", "big_small", "big_big")


def _tf32(x):
    """x rounded to tf32 (10 mantissa bits) as cvt.rna.tf32.f32 does it:
    add half of the dropped 13 bits' range to the int32 view and clear
    them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x):
    """x as the tensor cores read a tf32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b, f32, as the kernels take it: per k-step of 8, the products of
    the tf32 parts named in ``passes`` (small terms first), each added to
    one f32 accumulator."""
    a_big, b_big = _tf32(a), _tf32(b)
    terms = {"small_big": (_tf32_read(a - a_big), b_big),
             "big_small": (a_big, _tf32_read(b - b_big)),
             "big_big": (a_big, b_big)}
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        for name in passes:
            x, y = terms[name]
            acc = acc + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    return acc


def _tc_backward(q, k, v, o, lse, do, causal, passes):
    """(dq, dk, dv) by the kernels' arithmetic: the products through
    ``_mm_tf32``, P and dS in f32 between them."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh, oh, doh = (x.float().transpose(1, 2) for x in (q, k, v, o, do))
    s = _mm_tf32(qh, kh.transpose(-1, -2), passes) * scale
    if causal:
        s = s.masked_fill(~ta._causal_keep(s), float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = _mm_tf32(doh, vh.transpose(-1, -2), passes)
    ds = p * (dp - (doh * oh).sum(-1)[..., None])
    dq = _mm_tf32(ds, kh, passes) * scale
    dk = _mm_tf32(ds.transpose(-1, -2), qh, passes) * scale
    dv = _mm_tf32(p.transpose(-1, -2), doh, passes)
    return [x.transpose(1, 2) for x in (dq, dk, dv)]


def _tc_errors(heads, causal, seed, passes):
    """max |model - plain| / max |plain| of dq, dk and dv at T = 2048."""
    q, k, v, do = map(t, _arrays(1, 2048, heads, 64, 4, seed=seed))
    o, lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    got = _tc_backward(q, k, v, o, lse, do, causal, passes)
    want = ta.flash_bwd_reference(q, k, v, o, lse, do, causal)
    return [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]


@pytest.mark.parametrize("heads,causal", [(2, False), (1, True)])
def test_three_tf32_products_hold_the_f32_gate(heads, causal):
    """The kernels' 3xTF32 arithmetic at the UNet's longest attention level
    (T = 2048, D = 64) stays within the f32 gate of the plain version."""
    errors = _tc_errors(heads, causal, seed=0, passes=THREE_TF32)
    assert max(errors) <= BWD_TOL_F32, errors


def test_one_tf32_product_breaks_the_f32_gate():
    """Why the kernels split f32 operands: the products on plain TF32 (big
    parts only) miss the f32 gate."""
    errors = _tc_errors(1, False, seed=1, passes=("big_big",))
    assert max(errors) > BWD_TOL_F32, errors


@pytest.mark.parametrize("ptr,strides,reason", [
    (16, (98304, 1536, 64), None),  # an f32 qkv view of the training shapes
    (4, (98304, 1536, 64), "data_ptr 0x4 is not 16-byte aligned"),
    (16, (98304, 1538, 64), "L stride 1538 is not a multiple of 4"),
    (16, (98304, 1536, 66), "H stride 66 is not a multiple of 4"),
    (16, (98306, 1536, 64), "B stride 98306 is not a multiple of 4"),
])
def test_cp_async_misalignment_in_f32(ptr, strides, reason):
    got = ta.cp_async_misalignment("do", ptr, (2, 64, 8), strides, esize=4)
    assert got == reason if reason is None else reason in got


def test_misaligned_f32_backward_operand_raises():
    """An f32 view whose L stride is not a multiple of 4 elements, and one
    whose address is off 16 bytes, raise ValueError naming cp.async; the
    views of one f32 qkv tensor pass."""
    ta._check_aligned(**dict(zip("qkv", torch.zeros((2, 64, 3, 8, 64)).unbind(2))))
    q = torch.zeros((2, 64, 8 * 64 + 2))[..., :512].unflatten(-1, (8, 64))
    with pytest.raises(ValueError, match="cp.async: q: its L stride 514"):
        ta._check_aligned(q=q)
    do = torch.zeros(2 * 64 * 512 + 1)[1:].view(2, 64, 8, 64)
    with pytest.raises(ValueError, match="cp.async: do: data_ptr .* not 16-byte"):
        ta._check_aligned(do=do)


def test_backward_copies_what_cp_async_cannot_take():
    """The autograd backward gives K2a and K2b an aligned copy of a q, k, v,
    O or dO the kernels' cp.async copies cannot take (an odd stride, an
    address off 16 bytes), and the operand itself otherwise."""
    q = torch.zeros((2, 64, 8 * 64 + 2))[..., :512].unflatten(-1, (8, 64))
    do = torch.zeros(2 * 64 * 512 + 1)[1:].view(2, 64, 8, 64)
    for bad in (q, do):
        got = ta._for_cp_async(bad)
        assert got.data_ptr() != bad.data_ptr() and torch.equal(got, bad)
        ta._check_aligned(x=got)
    good = torch.zeros((2, 64, 3, 8, 64)).unbind(2)[0]
    assert ta._for_cp_async(good) is good
