"""A UNet whose attention heads are wider than 128 features, against the JAX
package's.

tests/test_diffusion_stack.py's tiny config with one head of 192 features
(and, padded to 192 by the card's path, 160), or two of 256, in place of two
of 8: the JAX UNet takes any ``attention_features``, and so does the port,
whose kernels above 128 features are those of ``csrc/flash_wide.cu``.  The
parameters are the JAX init's, carried over by
``syncfusion_tpu_torch.convert``, whose qkv and out projections at two heads
of 256 take the shapes they take at eight of 64.  On the CPU the
attention runs the plain versions, here through the card's padding
(``ta._pads`` patched to say yes).  f32; the forward to 1e-4 abs + 1e-4
rel (tests/test_torch_unet.py's tolerance), the loss to 1e-5 relative and
each gradient to ``2e-4·max|g| + 1e-7`` (tests/test_torch_train.py's).
The kernels themselves run this config on the card in
tests/test_torch_cuda.py, and the full-width UNet with two heads of 256 in
chip_smoke.py phase 21c.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models.encoder1d import Encoder1d
from syncfusion_tpu.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu.models.unet1d import UNet1d
from syncfusion_tpu_torch.convert import to_state_dict
from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion as TorchSyncFusion
from syncfusion_tpu_torch.ops import attention as ta
from torch_port_helpers import ENC, L, UNET, n, t, to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)


# (heads, features): one head of 192, one of 160 (padded to 192 on the
# card), two of 256 (chip_smoke.py phase 21c's full-width model's heads)
HEADS = [(1, 192), (1, 160), (2, 256)]


def wide_unet(heads: int, features: int) -> dict:
    return {**UNET, "attention_heads": heads, "attention_features": features}


@functools.lru_cache(maxsize=None)
def _jax_pair(heads: int, features: int):
    jm = SyncFusionDiffusion(unet=UNet1d(**wide_unet(heads, features)),
                             onsets_encoder=Encoder1d(**ENC))
    return jm, jm.init(jax.random.key(4), L, batch=2)


def wide_pair(heads: int, features: int):
    """(JAX model, JAX params, port model on the CPU with those params)."""
    jm, params = _jax_pair(heads, features)
    tm = TorchSyncFusion(UNetConfig(**wide_unet(heads, features)), EncoderConfig(**ENC))
    tm.load_state_dict(to_state_dict(to_numpy(params)), strict=True)
    return jm, params, tm.eval()


def _self_attention(state: dict) -> dict:
    """The qkv and out projections of the self-attention levels."""
    return {k: v for k, v in state.items()
            if "_attn_" in k and (".qkv." in k or ".out." in k)}


@pytest.fixture
def padded(monkeypatch):
    """The autograd Function takes the card's padded path on the CPU."""
    monkeypatch.setattr(ta, "_pads", lambda q: True)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, 1)).astype(np.float32)
    onsets = np.zeros((2, L, 1), np.float32)
    onsets[:, [17, 260], 0] = 1.0
    emb = rng.standard_normal((2, 1, 16)).astype(np.float32)
    return x, onsets, emb


def test_converter_maps_two_heads_of_256_as_eight_of_64():
    """The converter's state dict of the JAX init at two heads of 256 has
    the names and shapes of that at eight of 64 (heads x features = 512
    both), its qkv projection is the JAX kernel (C, 3, heads, features)
    flattened and transposed, and the port's model loads it strictly."""
    trees = {hf: to_state_dict(to_numpy(_jax_pair(*hf)[1])) for hf in ((8, 64), (2, 256))}
    narrow, wide = (_self_attention(tree) for tree in trees.values())
    assert narrow and {k: v.shape for k, v in narrow.items()} == {
        k: v.shape for k, v in wide.items()}
    assert any(v.shape == (3 * 512, 16) for v in wide.values())
    _, params = _jax_pair(2, 256)
    jax_qkv = to_numpy(params)["unet"]["params"]["down_attn_2"]["qkv"]["kernel"]
    assert jax_qkv.shape == (16, 3, 2, 256)
    assert np.array_equal(n(wide["unet.down_attn_2.qkv.weight"]),
                          jax_qkv.reshape(16, -1).T)
    tm = TorchSyncFusion(UNetConfig(**wide_unet(2, 256)), EncoderConfig(**ENC))
    tm.load_state_dict(trees[2, 256], strict=True)


@pytest.mark.parametrize("heads,features", HEADS)
def test_wide_head_unet_forward_matches_jax(padded, heads, features):
    jm, params, tm = wide_pair(heads, features)
    x, onsets, emb = _inputs()
    sigma = np.array([0.3, 0.85], np.float32)
    ctx = jm.encode_context(params["encoder"], jnp.asarray(onsets))
    want = jm.unet.apply(params["unet"], jnp.asarray(x), jnp.asarray(sigma),
                         context=ctx, embedding=jnp.asarray(emb))
    ta.reset_counts()
    with torch.no_grad():
        got = tm.unet(t(x), t(sigma), context=tm.encode_context(t(onsets)),
                      embedding=t(emb))
    assert got.shape == want.shape == (2, L, 1)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    # levels 2-3 down and up, and the bottleneck: one K1 plain call each
    assert ta.flash_attention.plain_calls == 5


@pytest.mark.parametrize("heads,features", HEADS)
def test_wide_head_loss_and_gradients_match_jax(padded, heads, features):
    jm, params, tm = wide_pair(heads, features)
    wav, onsets, emb = _inputs(seed=2)
    key = jax.random.key(5)

    def loss_fn(p):
        return jm.loss(p, key, jnp.asarray(wav), jnp.asarray(onsets), jnp.asarray(emb))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    sigma = jax.random.uniform(k_sigma, (wav.shape[0],), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, wav.shape, dtype=jnp.float32)
    ta.reset_counts()
    got_loss = tm.loss(t(wav), t(onsets), t(emb), sigma=t(n(sigma)), noise=t(n(noise)))
    got_loss.backward()
    assert (ta.flash_attention.plain_calls, ta.flash_attention.plain_bwd_calls) == (5, 10)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = to_state_dict(to_numpy(want_grads))
    got = dict(tm.named_parameters())
    assert want.keys() == got.keys()
    attention_grads = 0
    for key_, w in want.items():
        g = got[key_].grad
        g = torch.zeros_like(w) if g is None else g
        scale = max(w.abs().max().item(), 1e-3)
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=2e-4 * scale + 1e-7,
                                   err_msg=key_)
        attention_grads += "_attn_" in key_ and bool(w.any())
    assert attention_grads > 0
