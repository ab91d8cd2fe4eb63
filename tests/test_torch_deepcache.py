"""The port's serving path against the JAX package's: the DeepCache split
of the UNet (plain, and with the fused resnet chain on) against
``unet1d_folded.folded_apply``, the refresh cadence and the
DPM-Solver++(2M) coefficients against the JAX functions, and DeepCache
DDIM and DPM++ sampling against the JAX ``sample``.

Tiny config of tests/test_diffusion_stack.py, f32, JAX computed live.
Tolerances: one UNet forward 1e-4 (tests/test_torch_unet.py's TOL); a
sample 2e-4 abs (tests/test_torch_sampler.py's: per-forward differences of
~1e-5 accumulated over the steps).  JAX's deep feature is in the folded
layout ``(B, L/f, C·f)``; it is unfolded and transposed to the port's
``(B, C, L)`` before a comparison.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import diffusion as jd
from syncfusion_tpu.models.unet1d_folded import compute_folds, folded_apply
from syncfusion_tpu.ops.folded import unfold
from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig
from syncfusion_tpu_torch.models import diffusion as td
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion as TorchSyncFusion
from syncfusion_tpu_torch.ops import attention as ta
from syncfusion_tpu_torch.ops import fused_resblock as tfr
from torch_port_helpers import ENC, UNET, L, n, t, tiny_pair

TOL = dict(rtol=1e-4, atol=1e-4)
SAMPLE_ATOL = 2e-4
# self-attention calls of one tiny forward: levels 2 and 3 down and up, and
# the bottleneck; a cached forward runs those of the levels below the split
ATTN_FULL = 5
ATTN_CACHED = {1: 0, 2: 0, 3: 2}
# K4 calls of one tiny forward with the fused chain on: two a block of
# levels 0-1, down and up; a cached forward runs those below the split
K4_FULL = 8
K4_CACHED = {1: 4, 2: 8, 3: 8}


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0, fold_cap=256)


@pytest.fixture(scope="module")
def fused_pair():
    """Both switches of the fused resnet chain at fold_cap 256: levels 0-1
    run K4 with the group sums threaded block to block, below any split."""
    return tiny_pair(seed=0, fold_cap=256, fused_resnet=True, fused_stats=True)


def _inputs(seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, L, 1)).astype(np.float32)
    emb = rng.standard_normal((batch, 1, 16)).astype(np.float32)
    on = np.zeros((batch, L, 1), np.float32)
    on[:, [40, 333], 0] = 1.0
    return x, on, emb


def _forward_args(jm, params, tm, seed):
    x, on, emb = _inputs(seed)
    sigma = np.array([0.3, 0.85], np.float32)
    mask = np.array([0.0, 1.0], np.float32).reshape(2, 1, 1)
    jax_kw = dict(context=jm.encode_context(params["encoder"], jnp.asarray(on)),
                  embedding=jnp.asarray(emb), embedding_cfg_mask=jnp.asarray(mask))
    with torch.no_grad():
        ctx = tm.encode_context(t(on))
    torch_kw = dict(context=ctx, embedding=t(emb), embedding_cfg_mask=t(mask))
    return x, sigma, jax_kw, torch_kw


@pytest.mark.parametrize("split", [1, 2, 3])
def test_full_path_with_split_is_bitwise_unchanged(pair, split):
    _, _, tm = pair
    x, on, emb = _inputs(1)
    sigma = t(np.array([0.3, 0.85], np.float32))
    with torch.no_grad():
        ctx = tm.encode_context(t(on))
        base = tm.unet(t(x), sigma, context=ctx, embedding=t(emb))
        out, deep = tm.unet(t(x), sigma, context=ctx, embedding=t(emb),
                            deep_split=split, return_deep=True)
    assert torch.equal(out, base)
    level = split - 1  # the feature enters level S-1's concat
    length = L
    for f in UNET["factors"][:split]:
        length //= f
    assert deep.shape == (2, UNET["channels"][level], length)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("split", [1, 2, 3])
def test_cached_forward_matches_folded_apply(request, split, fused):
    """The deep feature of a full forward, and a cached forward at other x
    and sigma on it, against ``folded_apply`` (fold_cap 256, which folds
    levels 0-1 of the tiny UNet) with its own feature; plain, and with the
    fused resnet chain on (K4 on levels 0-1, on every forward)."""
    jm, params, tm = request.getfixturevalue("fused_pair" if fused else "pair")
    if fused:
        assert tm.unet.stats_levels(L) == [True, True, False, False]
    x, sigma, jax_kw, torch_kw = _forward_args(jm, params, tm, 2)
    x2 = x + 0.3 * np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    sigma2 = sigma - 0.1
    up = params["unet"]
    want, deep_j = folded_apply(jm.unet, up, jnp.asarray(x), jnp.asarray(sigma),
                                fold_cap=256, deep_split=split, return_deep=True,
                                **jax_kw)
    want2 = folded_apply(jm.unet, up, jnp.asarray(x2), jnp.asarray(sigma2),
                         fold_cap=256, deep_split=split, deep_cache=deep_j, **jax_kw)
    full2 = folded_apply(jm.unet, up, jnp.asarray(x2), jnp.asarray(sigma2),
                         fold_cap=256, **jax_kw)
    ta.reset_counts()
    tfr.reset_counts()
    with torch.no_grad():
        got, deep_t = tm.unet(t(x), t(sigma), deep_split=split, return_deep=True,
                              **torch_kw)
        assert ta.flash_attention.plain_calls == ATTN_FULL
        k4_full = tfr.affine_silu_conv_stats.plain_calls
        got2 = tm.unet(t(x2), t(sigma2), deep_split=split, deep_cache=deep_t,
                       **torch_kw)
    assert ta.flash_attention.plain_calls == ATTN_FULL + ATTN_CACHED[split]
    k4_cached = tfr.affine_silu_conv_stats.plain_calls - k4_full
    assert (k4_full, k4_cached) == ((K4_FULL, K4_CACHED[split]) if fused else (0, 0))
    f = compute_folds(jm.unet, 256, L)[split - 1]
    np.testing.assert_allclose(n(deep_t), np.swapaxes(n(unfold(deep_j, f)), 1, 2), **TOL)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(got2), n(want2), **TOL)
    # the cache took effect: a stale feature is not the full forward
    assert np.abs(n(want2) - n(full2)).max() > 1e-3


@pytest.mark.parametrize("kw,match", [
    (dict(deep_split=4), r"in \[1, 3\]"),
    (dict(deep_split=-1), r"in \[1, 3\]"),
    (dict(deep_cache=torch.zeros((2, 8, 128))), "require deep_split"),
    (dict(return_deep=True), "require deep_split"),
])
def test_split_validation(pair, kw, match):
    _, _, tm = pair
    x, on, emb = _inputs(4)
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        tm.unet(t(x), torch.full((2,), 0.5), context=tm.encode_context(t(on)),
                embedding=t(emb), **kw)


# the JAX package's grid (tests/test_diffusion_stack.py) and more lengths
@pytest.mark.parametrize("pow", [1.0, 0.25, 0.5, 2.0, 4.0, 8.0])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_refresh_mask_equals_jax(K, pow):
    for seg_len in [1, 2, 3, 5, 7, 8, 19, 29, 30, 91, 150]:
        got = td.deep_cache_refresh_mask(seg_len, K, pow)
        assert got == jd.deep_cache_refresh_mask(seg_len, K, pow), seg_len
        assert got[0] and sum(got) == -(-seg_len // K)


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
