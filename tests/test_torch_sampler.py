"""The port's sampler against the JAX package's: the band segmentation is
equal, and a banded-CFG DDIM sample from the same noise equals the JAX
``SyncFusionDiffusion.sample`` on the plain (fold_cap=0) and the folded
(fold_cap=256) apply.  Tolerance 2e-4 abs in f32 over 6 steps of the tiny
model (per-forward differences ~1e-5, accumulated by the sampler)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import diffusion as jd
from syncfusion_tpu_torch.models import diffusion as td
from torch_port_helpers import L, n, t, tiny_pair


@pytest.mark.parametrize("steps", [1, 6, 32, 150])
@pytest.mark.parametrize("band", [(0.2, 0.8), (0.0, 1.0), (0.3, 0.7), (0.5, 0.5)])
def test_band_segments_equal_jax(steps, band):
    assert td.guidance_band_mask(steps, *band) == jd.guidance_band_mask(steps, *band)
    assert td.band_segments(steps, *band) == jd.band_segments(steps, *band)


@pytest.mark.parametrize("fold_cap", [0, 256])
def test_banded_cfg_ddim_equals_jax(fold_cap):
    jm, params, tm = tiny_pair(seed=3, fold_cap=fold_cap)
    rng = np.random.default_rng(4)
    noise = rng.standard_normal((2, L, 1)).astype(np.float32)
    emb = rng.standard_normal((2, 1, 16)).astype(np.float32)
    on = np.zeros((2, L, 1), np.float32)
    on[:, [40, 333], 0] = 1.0
    kw = dict(num_steps=6, embedding_scale=2.0, guidance_interval=(0.2, 0.8))
    # 6 steps, sigma 1, .83, .67, .5, .33, .17: out, in x4, out of the band
    assert [s[2] for s in td.band_segments(6, 0.2, 0.8)] == [False, True, False]
    want = jm.sample(params, jnp.asarray(noise), jnp.asarray(on), jnp.asarray(emb), **kw)
    got = tm.sample(t(noise), t(on), t(emb), **kw)
    assert got.shape == (2, L, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-4)

