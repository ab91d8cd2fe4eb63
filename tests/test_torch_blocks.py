"""Each block of syncfusion_tpu/models/blocks.py against its port, in f32:
the same numpy inputs through the Flax module's ``apply`` and the port's
module, with the Flax parameters carried over by the converter.
Tolerance 1e-5 abs + 1e-5 rel (f32, one block, other summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from syncfusion_tpu.models import blocks as jb
from syncfusion_tpu_torch.convert import convert_leaf, flatten
from syncfusion_tpu_torch.models import blocks as tb
from torch_port_helpers import n, t, to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(flax_params, module):
    sd = {}
    for path, leaf in flatten(to_numpy(flax_params)["params"]).items():
        key, a = convert_leaf(path, leaf)
        sd[key] = t(a)
    module.load_state_dict(sd, strict=True)
    return module


def _ncl(x):
    return t(x).transpose(1, 2)


def _nlc(y):
    return n(y.transpose(1, 2))


def test_fourier_time_embedding():
    sigma = np.random.default_rng(0).uniform(size=(5,)).astype(np.float32)
    mod = jb.FourierTimeEmbedding(32)
    p = mod.init(jax.random.key(0), jnp.asarray(sigma))
    want = mod.apply(p, jnp.asarray(sigma))
    got = _port(p, tb.FourierTimeEmbedding(32))(t(sigma))
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("in_ch,ch,film", [(8, 8, True), (12, 8, True), (6, 6, False)])
def test_resnet_block(in_ch, ch, film):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, in_ch)).astype(np.float32)
    temb = rng.standard_normal((2, 16)).astype(np.float32) if film else None
    mod = jb.ResnetBlock1d(ch, groups=2)
    args = (jnp.asarray(x),) + ((jnp.asarray(temb),) if film else ())
    p = mod.init(jax.random.key(1), *args)
    want = mod.apply(p, *args)
    port = _port(p, tb.ResnetBlock1d(in_ch, ch, 2, 16 if film else None))
    got = port(_ncl(x), t(temb) if film else None)
    np.testing.assert_allclose(_nlc(got), n(want), **TOL)


def test_self_attention():
    x = np.random.default_rng(2).standard_normal((2, 32, 16)).astype(np.float32)
    mod = jb.SelfAttention1d(heads=2, head_features=8)
    p = mod.init(jax.random.key(2), jnp.asarray(x))
    want = mod.apply(p, jnp.asarray(x))
    got = _port(p, tb.SelfAttention1d(16, 2, 8))(_ncl(x))
    np.testing.assert_allclose(_nlc(got), n(want), **TOL)


@pytest.mark.parametrize("tokens", [1, 3])
def test_cross_attention(tokens):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, tokens, 12)).astype(np.float32)
    mod = jb.CrossAttention1d(heads=2, head_features=8)
    p = mod.init(jax.random.key(3), jnp.asarray(x), jnp.asarray(ctx))
    want = mod.apply(p, jnp.asarray(x), jnp.asarray(ctx))
    port = _port(p, tb.CrossAttention1d(16, 12, 2, 8, tokens))
    np.testing.assert_allclose(_nlc(port(_ncl(x), t(ctx))), n(want), **TOL)


@pytest.mark.parametrize("kind,factor", [("down", 1), ("down", 4), ("down", 2),
                                         ("up", 1), ("up", 4), ("up", 2)])
def test_resample(kind, factor):
    x = np.random.default_rng(4).standard_normal((2, 32, 6)).astype(np.float32)
    jcls, tcls = ((jb.Downsample1d, tb.Downsample1d) if kind == "down"
                  else (jb.Upsample1d, tb.Upsample1d))
    mod = jcls(8, factor)
    p = mod.init(jax.random.key(4), jnp.asarray(x))
    want = mod.apply(p, jnp.asarray(x))
    got = _nlc(_port(p, tcls(6, 8, factor))(_ncl(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, n(want), **TOL)
