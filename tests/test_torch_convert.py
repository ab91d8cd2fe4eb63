"""Each layout trap of the Flax -> torch weight bridge, one layer at a time:
the Flax layer and the port's layer on the same numpy input, with the
parameters carried over by ``syncfusion_tpu_torch.convert.convert_leaf``.
All in f32; tolerance 1e-5 (one layer, different summation order)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from syncfusion_tpu_torch.convert import convert_leaf, flatten
from syncfusion_tpu_torch.models import blocks
from torch_port_helpers import n, t, to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _load(flax_params, module, name):
    """Convert ``flax_params`` of a layer the port names ``name`` (its Flax
    parent name) into ``module``."""
    sd = {}
    for path, leaf in flatten(to_numpy(flax_params)["params"]).items():
        key, a = convert_leaf((name, *path), leaf)
        sd[key.split(".", 1)[1]] = t(a)
    module.load_state_dict(sd, strict=True)
    return module


def _run(flax_mod, x_nlc, port_mod, name, seed=0):
    p = flax_mod.init(jax.random.key(seed), jnp.asarray(x_nlc))
    want = flax_mod.apply(p, jnp.asarray(x_nlc))
    _load(p, port_mod, name)
    return n(want), port_mod


def _trap_groupnorm_eps(rng):
    # variance ~1e-6: eps 1e-5 (torch's default) would move the output by ~40%
    x = (1e-3 * rng.standard_normal((2, 64, 8))).astype(np.float32)
    want, mod = _run(fnn.GroupNorm(num_groups=4), x, blocks.GroupNorm(4, 8), "GroupNorm_0")
    got = n(mod(t(x).transpose(1, 2)).transpose(1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _trap_dense_kernel(rng):
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    want, mod = _run(fnn.Dense(7), x, blocks.Linear(12, 7), "out")
    np.testing.assert_allclose(n(mod(t(x))), want, **TOL)


def _trap_dense_general_qkv(rng):
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    want, mod = _run(fnn.DenseGeneral((3, 2, 8), axis=-1), x,
                     blocks.Linear(16, 48), "qkv")
    got = n(mod(t(x)).view(2, 9, 3, 2, 8))
    np.testing.assert_allclose(got, want, **TOL)


def _trap_conv_same_strided(rng):
    # kernel 2·f, stride f: XLA's SAME pads (f//2, f - f//2), uneven for odd f
    for f, length in ((4, 64), (3, 31), (2, 17)):
        x = rng.standard_normal((2, length, 5)).astype(np.float32)
        want, mod = _run(fnn.Conv(6, (2 * f,), strides=(f,)), x,
                         blocks.Conv1d(5, 6, 2 * f, stride=f), "Conv_0")
        got = n(mod(t(x).transpose(1, 2)).transpose(1, 2))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def _trap_conv_transpose_no_flip(rng):
    # Flax ConvTranspose: SAME, transpose_kernel=False (no flip)
    for f in (2, 4, 3):
        x = rng.standard_normal((2, 16, 5)).astype(np.float32)
        want, mod = _run(fnn.ConvTranspose(6, (2 * f,), strides=(f,)), x,
                         blocks.ConvTranspose1d(5, 6, 2 * f, f), "ConvTranspose_0")
        got = n(mod(t(x).transpose(1, 2)).transpose(1, 2))
        assert got.shape == want.shape == (2, 16 * f, 6)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("trap", [
    _trap_groupnorm_eps, _trap_dense_kernel, _trap_dense_general_qkv,
    _trap_conv_same_strided, _trap_conv_transpose_no_flip,
], ids=lambda f: f.__name__[6:])
def test_weight_bridge_trap(trap):
    trap(np.random.default_rng(0))
