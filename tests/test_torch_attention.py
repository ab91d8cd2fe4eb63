"""The port's attention against the JAX package's.

On the CPU, ``flash_attention`` takes the plain version; it is held against
the Pallas kernel run in interpret mode (``block_q = block_k = 128``, as
tests/test_attention.py runs it) and against ``attention_reference``, O and
the row LSE, causal and not.  Tolerance 2e-5 abs in f32, as
tests/test_attention.py holds the Pallas kernel.  The CUDA kernel itself
is compared with the plain version on the card by tests/test_torch_cuda.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.ops import attention as ja
from syncfusion_tpu_torch.ops import attention as ta
from torch_port_helpers import n, t

TOL = dict(rtol=0, atol=2e-5)


def _qkv(b, l, h, d, seed):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((b, l, h, d))).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,l,h,d", [(1, 512, 2, 64), (2, 256, 4, 32)])
def test_plain_attention_matches_pallas_interpret(b, l, h, d, causal):
    q, k, v = _qkv(b, l, h, d, seed=l + h)
    want = ja.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              block_q=128, block_k=128, interpret=True)
    qf, kf, vf = (ja._fold_heads(jnp.asarray(x)) for x in (q, k, v))
    _, want_lse = ja._flash_fwd(qf, kf, vf, causal, 128, 128,
                                1.0 / math.sqrt(d), True)
    got, got_lse = ta.attention_reference(t(q), t(k), t(v), causal, return_lse=True)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(got_lse), n(want_lse).reshape(b, h, l), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_reference_ragged(causal):
    q, k, v = _qkv(2, 300, 2, 64, seed=7)
    want = ja.attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = ta.attention_reference(t(q), t(k), t(v), causal)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_cpu_tensors_take_the_plain_path():
    q, k, v = map(t, _qkv(1, 64, 2, 64, seed=3))
    before = (ta.flash_attention.kernel_launches, ta.flash_attention.plain_calls)
    o, lse = ta.flash_attention(q, k, v, return_lse=True)
    want, want_lse = ta.attention_reference(q, k, v, return_lse=True)
    assert torch.equal(o, want) and torch.equal(lse, want_lse)
    assert ta.flash_attention.kernel_launches == before[0]
    assert ta.flash_attention.plain_calls == before[1] + 1
