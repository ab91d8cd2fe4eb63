"""Attention at any head width: the port's padding against the unpadded
plain versions and the JAX package.

The kernels are built for heads of 64 and 128 features, and above 128 for
any multiple of 64 (the Hopper sources ``csrc/*_wide_sm90.cu`` up to 512;
above, K1 on thread-block clusters, ``csrc/flash_fwd_cluster_sm90.cu``, up
to ``CLUSTER_FWD_MAX`` and the chunked ``csrc/flash_wide.cu`` for K1 wider
still and for K2a and K2b; ``kernel_source``); on the card
``flash_attention``'s autograd Function zero-pads a head to its kernel
width (``kernel_width``), passes the true width's scale and slices O, dq,
dk and dv back.  Here that padded path runs through the plain versions on
the CPU (``ta._pads`` patched to say yes), so the padding, the scale and
the slicing are held without a card: forward and backward equal the
unpadded plain versions within 1e-6 (f32 and f64; zero columns add exact
zeros to every sum), the padded columns of O, dq, dk and dv are exactly 0,
and the padded path matches the JAX Pallas kernels in interpret mode
within tests/test_attention.py's tolerances.  The kernels themselves run
at these widths in tests/test_torch_cuda.py and chip_smoke.py phases 21a
and 21c.
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

WIDTHS = [8, 32, 48, 128, 160, 192, 200, 256, 320, 576]
DTYPES = [torch.float32, torch.float64]


def _inputs(d, dtype, seed, b=2, length=40, h=3):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, length, h, d)) for _ in range(4))
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v, do)]


@pytest.fixture
def padded(monkeypatch):
    """The autograd Function takes the card's padded path on the CPU."""
    monkeypatch.setattr(ta, "_pads", lambda q: True)


def _run(q, k, v, do, causal):
    """O, LSE and the gradients of flash_attention, with its counts."""
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ta.reset_counts()
    o, lse = ta.flash_attention(*leaves, causal=causal, return_lse=True)
    o.backward(do)
    counts = {c: getattr(ta.flash_attention, c) for c in ta.COUNTS}
    return [o.detach(), lse] + [x.grad for x in leaves], counts


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_padded_path_equals_the_unpadded_plain_versions(monkeypatch, d, dtype, causal):
    q, k, v, do = _inputs(d, dtype, seed=d)
    want, _ = _run(q, k, v, do, causal)
    monkeypatch.setattr(ta, "_pads", lambda q: True)
    got, counts = _run(q, k, v, do, causal)
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert (g - w).abs().max().item() <= 1e-6, name
    # one plain call per wrapper, as one launch per kernel on the card
    assert counts == {"kernel_launches": 0, "dq_launches": 0, "dkv_launches": 0,
                      "plain_calls": 1, "plain_bwd_calls": 2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_versions_on_padded_operands_leave_zero_columns(d, dtype):
    """The wrappers' plain versions on operands padded to the kernel width
    with the true width's scale: O, dq, dk and dv equal the unpadded ones
    in their first d columns and are exactly 0 past them."""
    q, k, v, do = _inputs(d, dtype, seed=d + 1)
    width = ta.kernel_width(d)
    pq, pk, pv, pdo = (torch.nn.functional.pad(x, (0, width - d)) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    o, lse = ta.flash_fwd(q, k, v, True)
    po, plse = ta.flash_fwd(pq, pk, pv, True, scale)
    assert (po[..., :d] - o).abs().max().item() <= 1e-6
    assert (plse - lse).abs().max().item() <= 1e-6
    want = ta.flash_bwd_reference(q, k, v, o, lse, do, True)
    got = ta.flash_bwd_reference(pq, pk, pv, po, plse, pdo, True, scale)
    for g, w in zip(got, want):
        assert (g[..., :d] - w).abs().max().item() <= 1e-6
    for x in (po, *got):
        assert x.shape[-1] == width and not x[..., d:].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 4e-6), (torch.float64, 1e-12)])
def test_padded_path_at_1000_features(monkeypatch, dtype, tol, causal):
    """D = 1000, padded to 1024 (flash_wide.cu's chunked kernels on the
    card): the padded path against the unpadded plain versions, as above,
    within f32's (f64's) rounding of sums over 1000 columns taken in another
    blocking than 1024's (1.4e-6 and 3e-15 read), the padded columns of O,
    dq, dk and dv exactly 0, one plain call a wrapper."""
    q, k, v, do = _inputs(1000, dtype, seed=1000)
    want, _ = _run(q, k, v, do, causal)
    monkeypatch.setattr(ta, "_pads", lambda q: True)
    got, counts = _run(q, k, v, do, causal)
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert (g - w).abs().max().item() <= tol, name
    assert counts == {"kernel_launches": 0, "dq_launches": 0, "dkv_launches": 0,
                      "plain_calls": 1, "plain_bwd_calls": 2}
    pq, pk, pv, pdo = (torch.nn.functional.pad(x, (0, 24)) for x in (q, k, v, do))
    po, plse = ta.flash_fwd(pq, pk, pv, causal, 1.0 / math.sqrt(1000))
    for x in (po, *ta.flash_bwd_reference(pq, pk, pv, po, plse, pdo, causal,
                                          1.0 / math.sqrt(1000))):
        assert x.shape[-1] == 1024 and not x[..., 1000:].any()


@pytest.mark.parametrize("causal", [False, True])
def test_the_scale_argument_keeps_the_default_at_64(causal):
    """Each wrapper's ``scale`` at 1/sqrt(64) gives what its default gives,
    bit for bit."""
    q, k, v, do = _inputs(64, torch.float32, seed=5)
    s = 1.0 / math.sqrt(64)
    o, lse = ta.flash_fwd(q, k, v, causal)
    for got, want in zip(ta.flash_fwd(q, k, v, causal, s), (o, lse)):
        assert torch.equal(got, want)
    dq, delta = ta.flash_bwd_dq(q, k, v, o, lse, do, causal)
    for got, want in zip(ta.flash_bwd_dq(q, k, v, o, lse, do, causal, s), (dq, delta)):
        assert torch.equal(got, want)
    dkv = ta.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    for got, want in zip(ta.flash_bwd_dkv(q, k, v, do, lse, delta, causal, s), dkv):
        assert torch.equal(got, want)


@pytest.mark.parametrize("d,width", [
    (1, 64), (8, 64), (64, 64), (65, 128), (128, 128),
    # above 128, the wide kernels' widths: the least multiple of 64 not below d
    (129, 192), (160, 192), (192, 192), (200, 256), (256, 256), (320, 320),
    (512, 512), (513, 576), (576, 576), (1000, 1024)])
def test_kernel_width(d, width):
    assert ta.kernel_width(d) == width


@pytest.mark.parametrize("width,sources", [
    (64, ("flash_fwd", "flash_bwd", "flash_bwd")),
    (128, ("flash_fwd", "flash_bwd", "flash_bwd")),
    (192, ("flash_fwd_wide_sm90", "flash_bwd_wide_sm90", "flash_bwd_wide_sm90")),
    (512, ("flash_fwd_wide_sm90", "flash_bwd_wide_sm90", "flash_bwd_wide_sm90")),
    (576, ("flash_fwd_cluster_sm90", "flash_wide", "flash_wide")),
    (1024, ("flash_fwd_cluster_sm90", "flash_wide", "flash_wide")),
    (4096, ("flash_fwd_cluster_sm90", "flash_wide", "flash_wide")),
    (4160, ("flash_wide",) * 3)])
def test_kernel_source_by_width(width, sources):
    """One hand-written source for each of K1, K2a and K2b at each kernel
    width, each exporting that kernel's C entry: above 512 K1 on clusters up
    to ``CLUSTER_FWD_MAX`` and the chunked K1 beyond it, K2a and K2b
    chunked."""
    got = tuple(ta.kernel_source(index, width) for index in range(3))
    assert got == sources
    for index, source in enumerate(got):
        assert index in ta._ENTRIES[source]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 128, 192, 256])
def test_padded_path_matches_the_pallas_kernels(padded, d, causal):
    """The padded path's O and gradients against ``jax.grad`` of the JAX
    ``flash_attention`` in interpret mode (the Pallas forward and backward
    kernels at head width d), f32, within tests/test_attention.py's
    tolerances."""
    q, k, v, w = (x.numpy().astype(np.float32) for x in
                  _inputs(d, torch.float32, seed=3 * d, b=1, length=256, h=2))

    def loss(q_, k_, v_):
        o = ja.flash_attention(q_, k_, v_, causal=causal, block_q=128, block_k=128,
                               interpret=True)
        return jnp.sum(o * w), o

    (_, want_o), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    got, _ = _run(t(q), t(k), t(v), t(w), causal)
    np.testing.assert_allclose(n(got[0]), np.asarray(want_o), rtol=0, atol=2e-5)
    for name, g, wg in zip("qkv", got[2:], want_g):
        np.testing.assert_allclose(n(g), np.asarray(wg), rtol=1e-3, atol=2e-4,
                                   err_msg=f"d{name}")
