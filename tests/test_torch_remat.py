"""``remat`` in the port's ``UNet1d`` and ``UNetV0Compat`` (the JAX
``nn.remat`` of each resnet block) against the plain nets and the JAX ones.

* remat against no remat, same parameters: outputs within 1e-6 and the
  gradient of sum(out²) within 1e-5, as tests/test_diffusion_stack.py
  asserts for JAX; on the tiny UNet, with ``deep_split`` (a DeepCache
  call), and on tests/test_unet_folded.py's ``small_unet`` with
  ``fused_resnet`` and ``fused_stats`` (K3 and K4's plain versions here),
  where the recompute runs the fused blocks again in the backward.
* against the JAX ``remat=True`` nets on converted parameters: outputs
  within 1e-5 and each gradient within tests/test_torch_train.py's
  2e-4·max|g| + 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import adp_compat as jcompat
from syncfusion_tpu.models import adp_convert as jconvert
from syncfusion_tpu.models import adp_torch_recon as jrecon
from syncfusion_tpu.models.unet1d import UNet1d as JaxUNet1d
from syncfusion_tpu_torch.convert import to_state_dict
from syncfusion_tpu_torch.core.config import UNetConfig
from syncfusion_tpu_torch.models import adp_compat
from syncfusion_tpu_torch.models.unet1d import UNet1d
from syncfusion_tpu_torch.ops import fused_resblock as tfr
from test_adp_compat import SMALL
from test_torch_adp_compat import PORT_SMALL, _port_unet, _recon_sd
from test_torch_adp_compat import _inputs as _compat_inputs
from test_unet_folded import small_unet
from torch_port_helpers import L, UNET, n, t, to_numpy

OUT_TOL, GRAD_TOL = 1e-6, 1e-5


def _inputs(b, length, context_shapes, features, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, 1)).astype(np.float32)
    sigma = rng.uniform(0.1, 0.9, b).astype(np.float32)
    ctx = [rng.standard_normal((b, length // f, c)).astype(np.float32)
           for f, c in context_shapes]
    emb = rng.standard_normal((b, 1, features)).astype(np.float32)
    return x, sigma, ctx, emb


def _seeded(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen) + (p.dim() == 1) * 0.5)
    return model


def _out_and_grads(model, args, **kw):
    x, sigma, ctx, emb = args
    for p in model.parameters():
        p.grad = None
    out = model(t(x), t(sigma), context=[None if c is None else t(c) for c in ctx],
                embedding=t(emb), **kw)
    out = out[0] if isinstance(out, tuple) else out
    (out ** 2).sum().backward()
    return n(out), {k: n(p.grad) for k, p in model.named_parameters()
                    if p.grad is not None}


def _same(model, remat, args, **kw):
    remat.load_state_dict(model.state_dict(), strict=True)
    out_a, ga = _out_and_grads(model, args, **kw)
    out_b, gb = _out_and_grads(remat, args, **kw)
    np.testing.assert_allclose(out_b, out_a, rtol=0, atol=OUT_TOL)
    assert ga.keys() == gb.keys()
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], rtol=0, atol=GRAD_TOL, err_msg=k)


TINY_CTX = [(1, 2), (4, 8), (16, 16)]  # (length divisor, channels) of xs[2:-1]


@pytest.mark.parametrize("deep", [False, True])
def test_tiny_unet_remat_matches_plain(deep):
    cfg = UNetConfig(**UNET)
    model = _seeded(UNet1d(cfg, context_levels=3), 1)
    args = _inputs(2, L, TINY_CTX, 16, 2)
    kw = {"deep_split": 2, "return_deep": True} if deep else {}
    _same(model, UNet1d(dataclasses.replace(cfg, remat=True), context_levels=3),
          args, **kw)


def test_fused_unet_remat_matches_plain_and_recomputes_the_fused_blocks():
    """small_unet with both switches (K4 on levels 0-1, K3 on the blocks of
    levels 2-3 that pass its gate): remat gives the plain forward's numbers
    and runs each fused call once more, in the backward."""
    u = small_unet()
    names = ("channels", "factors", "items", "attentions", "cross_attentions",
             "context_channels", "resnet_groups")
    cfg = UNetConfig(**{k: getattr(u, k) for k in names}, fused_resnet=True,
                     fused_block_l=64, fused_stats=True, fold_cap=256)
    model = _seeded(UNet1d(cfg, context_levels=3), 3)
    length = 4096
    assert model.stats_levels(length) == [True, True, False, False]
    args = _inputs(1, length, [(1, 2), (4, 8), (16, 16)], 512, 4)
    counts = []
    for m in (model, UNet1d(dataclasses.replace(cfg, remat=True), context_levels=3)):
        m.load_state_dict(model.state_dict(), strict=True)
        tfr.reset_counts()
        _out_and_grads(m, args)
        counts.append((tfr.affine_silu_conv.plain_calls,
                       tfr.affine_silu_conv_stats.plain_calls))
    (k3, k4), (k3_remat, k4_remat) = counts
    assert k4 == 12 and k3 > 0
    assert (k3_remat, k4_remat) == (2 * k3, 2 * k4)
    _same(model, UNet1d(dataclasses.replace(cfg, remat=True), context_levels=3), args)


def test_remat_unet_matches_the_jax_remat_unet():
    jnet = JaxUNet1d(**UNET, remat=True)
    x, sigma, ctx, emb = _inputs(2, L, TINY_CTX, 16, 5)
    jargs = (jnp.asarray(x), jnp.asarray(sigma))
    jkw = dict(context=[jnp.asarray(c) for c in ctx], embedding=jnp.asarray(emb))
    params = jnet.init({"params": jax.random.key(0), "cfg": jax.random.key(1)},
                       *jargs, **jkw)

    def f(p):
        return jnp.sum(jnet.apply(p, *jargs, **jkw) ** 2)

    want = n(jnet.apply(params, *jargs, **jkw))
    want_grads = to_state_dict({"unet": to_numpy(jax.jit(jax.grad(f))(params)),
                                "encoder": {}})
    port = UNet1d(UNetConfig(**UNET, remat=True), context_levels=3)
    port.load_state_dict({k[len("unet."):]: v for k, v in to_state_dict(
        {"unet": to_numpy(params), "encoder": {}}).items()}, strict=True)
    got, grads = _out_and_grads(port, (x, sigma, ctx, emb))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for key, w in want_grads.items():
        g = grads.get(key[len("unet."):], np.zeros(w.shape, np.float32))
        scale = max(float(w.abs().max()), 1e-3)
        np.testing.assert_allclose(g, n(w), rtol=0, atol=2e-4 * scale + 1e-7,
                                   err_msg=key)


def test_compat_twin_remat_matches_plain_and_the_jax_twin():
    """The twins' remat against the plain port twin (1e-6, 1e-5) and the
    JAX ``UNetV0Compat(remat=True)`` with tests/test_torch_adp_compat.py's
    tolerances: output 1e-4 of its largest, every gradient 1e-4 of the
    largest."""
    tree = jconvert.convert_unet_state(_recon_sd(jrecon.build_unet_recon, SMALL, 2),
                                       SMALL)
    x, sigma, emb, ctx = _compat_inputs(SMALL)
    jnet = jcompat.UNetV0Compat(cfg=SMALL, remat=True)
    jargs = (jnp.asarray(x), jnp.asarray(sigma))
    jkw = dict(context=[None if c is None else jnp.asarray(c) for c in ctx],
               embedding=jnp.asarray(emb))

    def f(p):
        return jnp.sum(jnet.apply(p, *jargs, **jkw) ** 2)

    want = n(jnet.apply(tree, *jargs, **jkw))
    want_grads = {k[len("unet."):]: v for k, v in to_state_dict(
        {"unet": to_numpy(jax.jit(jax.grad(f))(tree)), "encoder": {}}).items()}
    plain = _port_unet(SMALL, tree)
    remat = adp_compat.UNetV0Compat(PORT_SMALL, remat=True)
    args = (x, sigma, ctx, emb)
    _same(plain, remat, args)
    got, grads = _out_and_grads(remat, args)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    top = max(float(w.abs().max()) for w in want_grads.values())
    for key, w in want_grads.items():
        g = grads.get(key, np.zeros(w.shape, np.float32))
        assert np.abs(g - n(w)).max() <= 1e-4 * top, key
