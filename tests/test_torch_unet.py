"""Encoder and UNet of the port against the JAX package's, on the tiny
config of tests/test_diffusion_stack.py, in f32, with the JAX parameters
carried over by the converter.  Tolerance 1e-4 abs + 1e-4 rel: f32 through
~20 layers whose convolutions and GroupNorm statistics sum in other orders
(measured differences are ~1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import L, n, t, tiny_pair

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0)


def _onsets(batch, at):
    on = np.zeros((batch, L, 1), np.float32)
    on[:, at, 0] = 1.0
    return on


def test_encoder_xs(pair):
    jm, params, tm = pair
    on = _onsets(2, [5, 130, 400])
    _, info = jm.onsets_encoder.apply(params["encoder"], jnp.asarray(on), with_info=True)
    got = tm.onsets_encoder(t(on))
    assert len(got) == len(info["xs"])
    for i, (a, b) in enumerate(zip(info["xs"], got)):
        assert b.shape == a.shape, i
        np.testing.assert_allclose(n(b), n(a), **TOL, err_msg=f"xs[{i}]")


@pytest.mark.parametrize("case", ["cond", "cfg_mask", "uncond"])
def test_unet_forward(pair, case):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, L, 1)).astype(np.float32)
    sigma = np.array([0.3, 0.85], np.float32)
    emb = rng.standard_normal((2, 1, 16)).astype(np.float32)
    mask = np.array([0.0, 1.0], np.float32).reshape(2, 1, 1)
    on = _onsets(2, [17, 260])
    kw_j, kw_t = {}, {}
    if case != "uncond":
        kw_j["embedding"], kw_t["embedding"] = jnp.asarray(emb), t(emb)
    if case == "cfg_mask":
        kw_j["embedding_cfg_mask"], kw_t["embedding_cfg_mask"] = jnp.asarray(mask), t(mask)
    ctx = jm.encode_context(params["encoder"], jnp.asarray(on))
    want = jm.unet.apply(params["unet"], jnp.asarray(x), jnp.asarray(sigma),
                         context=ctx, **kw_j)
    with torch.no_grad():
        got = tm.unet(t(x), t(sigma), context=tm.encode_context(t(on)), **kw_t)
    assert got.shape == want.shape == (2, L, 1)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_param_count_equals_jax(pair):
    jm, params, tm = pair
    assert tm.param_count() == jm.param_count(params)
