"""The port's serving samplers against the JAX package's: the
DPM-Solver++(2M) coefficients, DeepCache DDIM and DPM++ sampling against the
JAX ``sample``, and both samplers on the closed-form Gaussian ODE.  (Split
from tests/test_torch_deepcache.py, which holds the UNet's DeepCache split,
so that the two run on two workers.)

Tiny config of tests/test_diffusion_stack.py, f32, JAX computed live.
Tolerance: a sample 2e-4 abs (tests/test_torch_sampler.py's: per-forward
differences of ~1e-5 accumulated over the steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import diffusion as jd
from syncfusion_tpu.models.unet1d_folded import folded_apply
from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig
from syncfusion_tpu_torch.models import diffusion as td
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion as TorchSyncFusion
from syncfusion_tpu_torch.ops import attention as ta
from test_torch_deepcache import ATTN_FULL, _inputs
from torch_port_helpers import ENC, UNET, L, n, t, tiny_pair

SAMPLE_ATOL = 2e-4


@pytest.mark.parametrize("num_steps", [1, 2, 3, 4, 5, 10, 32, 150])
def test_dpm_coefficients_equal_jax(num_steps):
    got = td._dpm_coefficients(num_steps)
    want = jd._dpm_coefficients(num_steps)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32 and g.shape == (num_steps,)
        np.testing.assert_array_equal(n(g), np.asarray(w))
        assert torch.isfinite(g).all()


def _jax_sample(jm, params, noise, on, emb, fold_cap, **kw):
    """JAX ``sample``.  It takes DeepCache on its folded apply only (it
    raises at fold_cap 0), so at fold_cap 0 with a cache the sampler runs
    on ``folded_apply`` at fold_cap 0, which folds no level."""
    args = (jnp.asarray(noise), jnp.asarray(on), jnp.asarray(emb))
    if fold_cap or not kw.get("deep_cache_interval"):
        return jm.sample(params, *args, **kw)
    sampler = {"ddim": jd.v_sample, "dpm": jd.dpm_sample}[kw.pop("sampler", "ddim")]

    def apply_fn(variables, x, sigma, **net_kw):
        return folded_apply(jm.unet, variables, x, sigma, fold_cap=0, **net_kw)

    return sampler(apply_fn, params["unet"], args[0], kw.pop("num_steps"),
                   context=jm.encode_context(params["encoder"], args[1]),
                   embedding=args[2], **kw)


# 10 steps, band (0.2, 0.8): segments of 2, 7 and 1 steps; the 7-step
# segment refreshes at 0, 2, 4, 6 with pow 1 and at 0, 3, 4, 6 with pow 2
@pytest.mark.parametrize("fold_cap", [0, 256])
@pytest.mark.parametrize("pow", [1.0, 2.0])
def test_deepcache_ddim_equals_jax(fold_cap, pow):
    jm, params, tm = tiny_pair(seed=3, fold_cap=fold_cap)
    noise, on, emb = _inputs(4)
    kw = dict(num_steps=10, embedding_scale=2.0, guidance_interval=(0.2, 0.8),
              deep_cache_interval=2, deep_split=2, deep_cache_pow=pow)
    assert [e - s for s, e, _ in td.band_segments(10, 0.2, 0.8)] == [2, 7, 1]
    want = _jax_sample(jm, params, noise, on, emb, fold_cap, **kw)
    ta.reset_counts()
    got = tm.sample(t(noise), t(on), t(emb), **kw)
    # full forwards: 1 + 4 + 1 refreshes; cached at split 2 run no attention
    assert ta.flash_attention.plain_calls == ATTN_FULL * 6
    assert got.shape == (2, L, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=SAMPLE_ATOL)
    plain = tm.sample(t(noise), t(on), t(emb), num_steps=10, embedding_scale=2.0,
                      guidance_interval=(0.2, 0.8))
    assert (got - plain).abs().max() > 1e-4


# the model cases of tests/test_diffusion_stack.py's DPM++ tests: CFG over
# all steps and in the band (0.3, 0.7), 5 steps, and fold_cap 64 at B = 1
DPM_CASES = {"cfg": (0, 2, 5, None), "band": (0, 2, 5, (0.3, 0.7)),
             "fold_cap_64": (64, 1, 4, None)}


@pytest.mark.parametrize("interval", [0, 2])
@pytest.mark.parametrize("case", sorted(DPM_CASES))
def test_dpm_sample_equals_jax(case, interval):
    fold_cap, batch, steps, band = DPM_CASES[case]
    jm, params, tm = tiny_pair(seed=5, fold_cap=fold_cap)
    noise, on, emb = _inputs(6, batch)
    kw = dict(num_steps=steps, embedding_scale=2.0, guidance_interval=band,
              sampler="dpm", deep_cache_interval=interval, deep_split=2)
    want = _jax_sample(jm, params, noise, on, emb, fold_cap, **kw)
    got = tm.sample(t(noise), t(on), t(emb), **kw)
    assert got.shape == (batch, L, 1) and torch.isfinite(got).all()
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=SAMPLE_ATOL)


def _oracle(s, alpha_beta, xp):
    """The exact v-net of Gaussian data x0 ~ N(0, s²): the ODE maps noise z
    to s·z (tests/test_diffusion_stack.py's ``_gaussian_oracle_net``)."""
    def net(x, sigma, **_):
        a, b = alpha_beta(sigma.reshape((-1,) + (1,) * (x.ndim - 1)))
        x0 = (a * s * s) / (a * a * s * s + b * b) * x
        eps = (x - a * x0) / xp.maximum(b, xp.asarray(1e-20))
        return a * eps - b * x0
    return net


def test_dpm_on_the_gaussian_ode_equals_jax_and_is_second_order():
    """On the closed-form Gaussian ODE the port's samplers give the JAX
    ones' results, and DPM++(2M)'s error falls ~4x per doubling of the
    steps against DDIM's ~2x."""
    noise = np.random.default_rng(7).standard_normal((2, 64, 1)).astype(np.float32)
    net_t = _oracle(0.35, td.alpha_beta, torch)
    net_j = _oracle(0.35, jd.alpha_beta, jnp)
    err = {}
    for name, fj, ft in (("ddim", jd.v_sample, td.v_sample),
                         ("dpm", jd.dpm_sample, td.dpm_sample)):
        for steps in (16, 32):
            want = fj(lambda p, x, s, **kw: net_j(x, s), {}, jnp.asarray(noise), steps)
            got = ft(net_t, t(noise), steps)
            np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-5)
            err[name, steps] = np.abs(n(got) - 0.35 * noise).max()
    assert err["dpm", 16] < err["ddim", 16] / 3
    assert err["dpm", 32] < err["ddim", 32] / 5
    assert err["dpm", 16] / err["dpm", 32] > 3.0
    assert err["ddim", 16] / err["ddim", 32] < 3.0


def test_sample_rejects_unknown_sampler_and_cache_without_split():
    tm = TorchSyncFusion(UNetConfig(**UNET), EncoderConfig(**ENC))
    x = torch.zeros((1, L, 1))
    emb = torch.zeros((1, 1, 16))
    with pytest.raises(ValueError, match="unknown sampler"):
        tm.sample(x, x, emb, num_steps=2, sampler="euler")
    with pytest.raises(ValueError, match="requires deep_split"):
        tm.sample(x, x, emb, num_steps=2, deep_cache_interval=2, deep_split=0)
