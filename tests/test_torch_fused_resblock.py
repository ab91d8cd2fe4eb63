"""The fused resnet chain of the port against the JAX package's, on the CPU.

Inputs from numpy seeds go through ``syncfusion_tpu/ops/fused_resblock.py``
(its Pallas kernels in interpret mode, as tests/test_fused_resblock.py runs
them) and through the port's ``ops/fused_resblock.py``, whose wrappers take
their plain versions on a CPU tensor.  x is passed to the port as a
(B, L, C) view of a (B, C, L) tensor, as its blocks pass it.  Tolerances
(f32): the ops' outputs 2e-5 absolute (tests/test_fused_resblock.py's own);
the group sums 2e-5 relative (sums of up to 10^4 values in other orders);
gradients 1e-4 absolute plus 1e-5 relative (a bias's gradient through
the sum of squares sums 10^3 terms of size 1); the UNet 2e-4 (tests/test_unet_folded.py's
tolerance for the fused-stats path).  The UNet is that test's
``small_unet`` at L = 4096 with ``fused_block_l`` = 64, whose levels of 32
to 128 channels pass the fused gate (the tiny UNet of
tests/test_diffusion_stack.py has none).  The arithmetic of both
tensor-core bodies of the kernel is modelled here and held to the card's
gates: bf16 (the activation as hi + lo bf16 operands) and f32 (3xTF32),
each with per-chunk f32 partial sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import blocks as jb
from syncfusion_tpu.models.unet1d_folded import compute_folds as jax_compute_folds
from syncfusion_tpu.models.unet1d_folded import folded_apply
from syncfusion_tpu.ops import folded as jfolded
from syncfusion_tpu.ops import fused_resblock as jfr
from syncfusion_tpu_torch.convert import convert_leaf, flatten, to_state_dict
from syncfusion_tpu_torch.core.config import UNetConfig
from syncfusion_tpu_torch.models import blocks as tb
from syncfusion_tpu_torch.models.unet1d import UNet1d, compute_folds
from syncfusion_tpu_torch.ops import fused_resblock as tfr
from test_unet_folded import L, small_unet
from torch_port_helpers import L as TINY_L
from torch_port_helpers import THREE_TF32, n, t, tf32, tf32_read, tiny_pair, to_numpy

ATOL = 2e-5
SUM_RTOL = 2e-5
GRAD_TOL = dict(rtol=1e-5, atol=1e-4)
UNET_TOL = dict(rtol=2e-4, atol=2e-4)


def _op_inputs(b, length, c, cout, seed, residual=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, c)).astype(np.float32)
    scale = (rng.standard_normal((b, c)) * 0.3 + 1.0).astype(np.float32)
    shift = (rng.standard_normal((b, c)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, c, cout)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    r = rng.standard_normal((b, length, cout)).astype(np.float32) if residual else None
    return [x, scale, shift, w, bias, r]


def _nlc(a):
    """numpy (B, L, C) -> torch (B, L, C) view of a (B, C, L) tensor."""
    return t(np.ascontiguousarray(a.transpose(0, 2, 1))).transpose(1, 2)


def _port_args(arrays, requires_grad=False):
    out = []
    for i, a in enumerate(arrays):
        if a is None:
            out.append(None)
            continue
        x = (_nlc(a) if a.ndim == 3 and i != 3 else t(a)).detach()
        out.append(x.requires_grad_(requires_grad))
    return out


def _jax_args(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("entry", ["k3a", "k3b"])
@pytest.mark.parametrize("b,length,c,cout", [(2, 256, 16, 24), (1, 128, 40, 32)])
def test_k3_entries_match_jax(entry, b, length, c, cout):
    """K3a (halo DMA, interpret mode) and K3b (block-local + boundary fix)
    against the port's op, which computes both; block edges included."""
    arrays = _op_inputs(b, length, c, cout, seed=length + c)[:5]
    if entry == "k3a":
        want = jfr.fused_affine_silu_conv(*_jax_args(arrays), 64, True)
        got = tfr.fused_affine_silu_conv(*_port_args(arrays), 64)
    else:
        want = jfr.fused_affine_silu_conv_blocked(*_jax_args(arrays), block_l=64)
        got = tfr.fused_affine_silu_conv_blocked(*_port_args(arrays), block_l=64)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("groups,cout", [(8, 32), (4, 16)])
def test_k4_matches_jax(residual, groups, cout):
    arrays = _op_inputs(2, 256, 24, cout, seed=cout + residual, residual=residual)
    jy, js, jss = jfr.fused_affine_silu_conv_stats(
        *_jax_args(arrays), num_groups=groups, block_l=64)
    y, s, ss = tfr.fused_affine_silu_conv_stats(*_port_args(arrays),
                                                num_groups=groups)
    np.testing.assert_allclose(n(y), n(jy), atol=ATOL)
    assert s.shape == ss.shape == (2, groups)
    np.testing.assert_allclose(n(s), n(js), rtol=SUM_RTOL,
                               atol=SUM_RTOL * float(np.abs(jss).max()) ** 0.5)
    np.testing.assert_allclose(n(ss), n(jss), rtol=SUM_RTOL)


def _cotangents(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_k3_gradients_match_jax():
    """The port's backward (plain recompute) against ``jax.grad`` of the
    custom VJP, for x, scale, shift, weight and bias."""
    arrays = _op_inputs(2, 128, 16, 24, seed=3)[:5]
    (gy,) = _cotangents([(2, 128, 24)], seed=4)

    def loss(*a):
        return jnp.sum(jfr.fused_affine_silu_conv(*a, 64, True) * gy)

    want = jax.grad(loss, argnums=tuple(range(5)))(*_jax_args(arrays))
    args = _port_args(arrays, requires_grad=True)
    (tfr.fused_affine_silu_conv(*args) * t(gy)).sum().backward()
    for arg, w in zip(args, want):
        np.testing.assert_allclose(n(arg.grad), n(w), **GRAD_TOL)


@pytest.mark.parametrize("residual", [False, True])
def test_k4_gradients_match_jax(residual):
    """Gradients of every input, through y and through the sums s and ss
    (the next GroupNorm's affine is computed from them)."""
    arrays = _op_inputs(2, 128, 16, 32, seed=5, residual=residual)
    gy, gs, gss = _cotangents([(2, 128, 32), (2, 8), (2, 8)], seed=6)
    gss = gss * 0.01
    k = 6 if residual else 5

    def loss(*a):
        y, s, ss = jfr.fused_affine_silu_conv_stats(
            *a[:5], a[5] if residual else None, num_groups=8, block_l=64)
        return jnp.sum(y * gy) + jnp.sum(s * gs) + jnp.sum(ss * gss)

    want = jax.grad(loss, argnums=tuple(range(k)))(*_jax_args(arrays)[:k])
    args = _port_args(arrays, requires_grad=True)
    y, s, ss = tfr.fused_affine_silu_conv_stats(*args, num_groups=8)
    ((y * t(gy)).sum() + (s * t(gs)).sum() + (ss * t(gss)).sum()).backward()
    assert args[0].grad is not None and args[3].grad is not None
    for arg, w in zip(args[:k], want):
        np.testing.assert_allclose(n(arg.grad), n(w), **GRAD_TOL)


def test_fold_groupnorm_film_group_stats_and_stats_affine_match_jax():
    rng = np.random.default_rng(7)
    b, length, c, groups = 2, 64, 16, 4
    x = rng.standard_normal((b, length, c)).astype(np.float32) * 2 + 0.5
    gamma, beta = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    fs, ft = (rng.standard_normal((b, c)).astype(np.float32) * 0.3 for _ in range(2))
    want = jfr.fold_groupnorm_film(*_jax_args([x, gamma, beta, fs, ft]), groups)
    got = tfr.fold_groupnorm_film(_nlc(x), t(gamma), t(beta), t(fs), t(ft), groups)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-5)

    js, jss = jfolded.folded_group_stats(jnp.asarray(x), groups)
    s, ss = tfr.group_stats(_nlc(x), groups)
    np.testing.assert_allclose(n(s), n(js), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(n(ss), n(jss), rtol=1e-5)
    count = length * c // groups
    for film in (True, False):
        kw = dict(film_scale=fs, film_shift=ft) if film else {}
        want = jfolded.folded_stats_affine(
            js, jss, count, *_jax_args([gamma, beta]), groups, 1,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tfr.stats_affine(s, ss, count, t(gamma), t(beta), groups,
                               **{k: t(v) for k, v in kw.items()})
        for g, w in zip(got, want):
            np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-5)


def _port_module(flax_params, module):
    sd = {}
    for path, leaf in flatten(to_numpy(flax_params)["params"]).items():
        key, a = convert_leaf(path, leaf)
        sd[key] = t(a)
    module.load_state_dict(sd, strict=True)
    return module


@pytest.fixture(scope="module")
def block_pair():
    """A JAX ResnetBlock1d on the fused path (40 -> 32 channels: FiLM and
    skip projection) and the port's block with its parameters."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 128, 40)).astype(np.float32)
    temb = rng.standard_normal((2, 16)).astype(np.float32)
    mod = jb.ResnetBlock1d(32, groups=8, fused=True, fused_block_l=64)
    p = mod.init(jax.random.key(8), jnp.asarray(x), jnp.asarray(temb))
    p = jax.tree_util.tree_map(  # non-trivial norms and biases
        lambda a: a + 0.1 * jax.random.normal(jax.random.key(a.size), a.shape), p)
    want = mod.apply(p, jnp.asarray(x), jnp.asarray(temb))
    port = _port_module(p, tb.ResnetBlock1d(40, 32, 8, 16, fused=True,
                                            fused_block_l=64))
    return port, x, temb, n(want)


def test_fused_block_matches_jax_and_plain(block_pair):
    port, x, temb, want = block_pair
    assert port.uses_fused(x.shape[1])
    tfr.reset_counts()
    with torch.no_grad():
        fused = port(t(x).transpose(1, 2), t(temb)).transpose(1, 2)
        port.fused = False
        plain = port(t(x).transpose(1, 2), t(temb)).transpose(1, 2)
        port.fused = True
    assert tfr.affine_silu_conv.plain_calls == 2
    np.testing.assert_allclose(n(fused), want, atol=ATOL)
    np.testing.assert_allclose(n(fused), n(plain), atol=ATOL)


def test_block_stats_path_matches_jax(block_pair):
    """``forward_stats`` (two K4 calls) gives the JAX block's output and the
    group sums of it; handing it the sums of x gives the same output."""
    port, x, temb, want = block_pair
    xt = t(x).transpose(1, 2)
    tfr.reset_counts()
    with torch.no_grad():
        out, (s, ss) = port.forward_stats(xt, t(temb))
        again, _ = port.forward_stats(xt, t(temb), tfr.group_stats(t(x), 8))
    assert tfr.affine_silu_conv_stats.plain_calls == 4
    np.testing.assert_allclose(n(out.transpose(1, 2)), want, atol=ATOL)
    np.testing.assert_allclose(n(again), n(out), atol=ATOL)
    groups = want.reshape(2, 128, 8, 4)
    np.testing.assert_allclose(n(s), groups.sum((1, 3)), rtol=SUM_RTOL, atol=1e-4)
    np.testing.assert_allclose(n(ss), (groups**2).sum((1, 3)), rtol=SUM_RTOL)


# ---------------------------------------------------------------- the UNet
def _port_cfg(u, **kw):
    names = ("channels", "factors", "items", "attentions", "cross_attentions",
             "context_channels", "resnet_groups")
    return UNetConfig(**{k: tuple(v) if isinstance(v, tuple) else v
                         for k, v in ((k, getattr(u, k)) for k in names)}, **kw)


@pytest.fixture(scope="module")
def unet_setup():
    """tests/test_unet_folded.py's set-up (the same calls, so its compiled
    programs are shared) and the port's UNet with its parameters."""
    u = small_unet()
    x = jax.random.normal(jax.random.key(0), (2, L, 1))
    ctx = [jax.random.normal(jax.random.key(i + 1), (2, L // (4 ** i), c))
           for i, c in enumerate((2, 8, 16))] + [None]
    emb = jax.random.normal(jax.random.key(9), (2, 1, 512))
    sigma = jnp.array([0.3, 0.8])
    p = u.init({"params": jax.random.key(5), "cfg": jax.random.key(6)},
               x, sigma, context=ctx, embedding=emb)
    port = _port_module(p, UNet1d(_port_cfg(u), context_levels=3))
    return u, p, (x, sigma, ctx, emb), port


def _port_forward(port, cfg, args):
    x, sigma, ctx, emb = args
    state = port.state_dict()
    model = UNet1d(cfg, context_levels=3)
    model.load_state_dict(state, strict=True)
    tfr.reset_counts()
    with torch.no_grad():
        return model(t(n(x)), t(n(sigma)), context=[t(n(c)) for c in ctx[:3]],
                     embedding=t(n(emb)))


def _count_jax_calls(monkeypatch):
    """Count the JAX package's K3b and K4 entries as its UNet calls them."""
    calls = {"k3": 0, "k4": 0}
    for key, name in (("k3", "fused_affine_silu_conv_blocked"),
                      ("k4", "fused_affine_silu_conv_stats")):
        fn = getattr(jfr, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(jfr, name, counted)
    return calls


def test_compute_folds_matches_jax():
    u = small_unet()
    cfg = _port_cfg(u)
    for cap, length in ((256, L), (64, L), (32, L), (256, L + 4)):
        assert compute_folds(cfg, cap, length) == jax_compute_folds(u, cap, length)
    assert compute_folds(UNetConfig(), 256, 2**18) == [16, 4, 1, 1, 1, 1, 1, 1]


def test_fused_resnet_unet_matches_jax(unet_setup, monkeypatch):
    """``fused_resnet``: the port's UNet against ``UNet1d(fused_resnet=True)
    .apply``; K3 runs on exactly the blocks whose JAX gate passes."""
    u, p, args, port = unet_setup
    x, sigma, ctx, emb = args
    calls = _count_jax_calls(monkeypatch)
    want = u.clone(fused_resnet=True, fused_block_l=64).apply(
        p, x, sigma, context=ctx, embedding=emb)
    got = _port_forward(port, _port_cfg(u, fused_resnet=True, fused_block_l=64),
                        args)
    np.testing.assert_allclose(n(got), n(want), **UNET_TOL)
    assert calls["k3"] > 0 and calls["k4"] == 0
    assert tfr.affine_silu_conv.plain_calls == calls["k3"] == 22
    assert tfr.affine_silu_conv_stats.plain_calls == 0


def test_fused_stats_unet_matches_jax(unet_setup, monkeypatch):
    """``fused_stats`` at ``fold_cap`` 256: the port against the JAX folded
    apply with ``fused_stats``; K4 runs twice per block of the folded
    levels, as in JAX."""
    u, p, args, port = unet_setup
    x, sigma, ctx, emb = args
    calls = _count_jax_calls(monkeypatch)
    want = folded_apply(u.clone(fused_stats=True), p, x, sigma, context=ctx,
                        embedding=emb, fold_cap=256)
    got = _port_forward(port, _port_cfg(u, fused_stats=True, fold_cap=256), args)
    np.testing.assert_allclose(n(got), n(want), **UNET_TOL)
    assert calls["k4"] == 12 and calls["k3"] == 0
    assert tfr.affine_silu_conv_stats.plain_calls == calls["k4"]
    assert tfr.affine_silu_conv.plain_calls == 0


def test_both_switches_launch_set(unet_setup):
    """Both switches: K4 on levels 0-1 (6 blocks), K3 on the blocks of
    levels 2-3 that pass the gate, the bottleneck never; the output equals
    the plain UNet's."""
    u, _, args, port = unet_setup
    cfg = _port_cfg(u, fused_resnet=True, fused_block_l=64, fused_stats=True,
                    fold_cap=256)
    got = _port_forward(port, cfg, args)
    model = UNet1d(cfg, context_levels=3)
    length = args[0].shape[1]
    level_len = [length // 4**i for i in range(4)]
    want_k3 = sum(
        2 for name, m in model.named_modules()
        if isinstance(m, tb.ResnetBlock1d) and not name.startswith("mid")
        and int(name.split("_")[2]) >= 2
        and m.uses_fused(level_len[int(name.split("_")[2])]))
    assert model.stats_levels(length) == [True, True, False, False]
    assert tfr.affine_silu_conv_stats.plain_calls == 12
    assert tfr.affine_silu_conv.plain_calls == want_k3 == 14
    plain = _port_forward(port, dataclasses.replace(cfg, fused_resnet=False,
                                                    fused_stats=False), args)
    np.testing.assert_allclose(n(got), n(plain), **UNET_TOL)


def test_fused_stats_loss_and_gradients_match_jax():
    """The training slice with ``fused_stats`` at ``fold_cap`` 256 on the
    tiny model of tests/test_diffusion_stack.py (levels 0-1 fold, so their
    blocks run K4): the port's loss and the gradient of every parameter
    against the JAX model's (its folded apply, K4 in interpret mode, the
    custom VJP's recompute), with tests/test_torch_train.py's tolerances:
    loss 1e-5 relative, each gradient 2e-4·max|g| + 1e-7."""
    jm, params, tm = tiny_pair(seed=2, fold_cap=256, fused_stats=True)
    assert tm.unet.stats_levels(TINY_L) == [True, True, False, False]
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((2, TINY_L, 1)).astype(np.float32)
    onsets = np.zeros((2, TINY_L, 1), np.float32)
    onsets[:, rng.integers(0, TINY_L, size=8), 0] = 1.0
    emb = rng.standard_normal((2, 1, 16)).astype(np.float32)
    key = jax.random.key(5)

    def loss_fn(p):
        return jm.loss(p, key, jnp.asarray(wav), jnp.asarray(onsets),
                       jnp.asarray(emb))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    sigma = jax.random.uniform(k_sigma, (2,), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, wav.shape, dtype=jnp.float32)
    tfr.reset_counts()
    got_loss = tm.loss(t(wav), t(onsets), t(emb), sigma=t(n(sigma)),
                       noise=t(n(noise)))
    got_loss.backward()
    assert tfr.affine_silu_conv_stats.plain_calls == 8  # 4 blocks x 2 convs
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = to_state_dict(to_numpy(want_grads))
    got = dict(tm.named_parameters())
    assert want.keys() == got.keys()
    for key_, w in want.items():
        g = got[key_].grad
        g = torch.zeros_like(w) if g is None else g
        scale = max(w.abs().max().item(), 1e-3)
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=2e-4 * scale + 1e-7,
                                   err_msg=key_)


def test_launch_wrapper_refuses_cpu_and_lays_out_y_as_x():
    """The launch never takes a CPU tensor (the wrappers route those to the
    plain versions); y is laid out as x, so a (B, L, C) view of a (B, C, L)
    tensor gives one of a (B, Cout, L) tensor; the channel tile covers
    Cout up to 64 channels a block."""
    x, scale, shift, w, bias, r = _port_args(_op_inputs(1, 16, 8, 8, seed=9,
                                                        residual=True))
    with pytest.raises(RuntimeError, match="runs on cuda"):
        tfr._launch(x, scale, shift, w, bias)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        tfr._launch(x, scale, shift, w, bias, r, num_groups=8)
    y = tfr._out_tensor(x, 24)
    assert y.shape == (1, 16, 24) and y.transpose(1, 2).is_contiguous()
    assert tfr._out_tensor(x.contiguous(), 24).is_contiguous()
    assert [tfr._channel_tile(c) for c in (1, 8, 9, 16, 24, 32, 33, 1024)] == [
        8, 8, 16, 16, 32, 32, 64, 64]


# The bf16 kernel's arithmetic, in plain PyTorch on the CPU: the activation
# h = silu(x·scale + shift) in f32 enters the products as two bf16 operands,
# hi = h rounded and lo = (h - hi) rounded (or, as a control, as hi alone);
# the bf16 weight is exact; the products of each chunk of input channels (16
# for the 8- and 16-channel tiles, 32 above) are summed in f32 and added to
# the running sum in f32; bias and residual are added in f32; y is rounded to
# bf16 once and the group sums are taken of the f32 y.  Held to the card's
# gates (chip_smoke.FUSED_TOL, STATS_TOL; tests/test_torch_cuda.py): y within
# 8e-3 of max |plain|, the sums within 1e-5 of their bounds.  Inputs drawn as
# chip_smoke.py draws them, at the main path's (C, Cout) pairs, L cut to 2048.
FUSED_TOL_BF16, STATS_TOL = 8e-3, 1e-5
MAIN_PAIRS = [(40, 32), (32, 32), (64, 32), (80, 64), (64, 64), (128, 64),
              (128, 128), (10, 8), (8, 8), (16, 8)]


def _chain_inputs(c, cout, length, residual, seed, rows=2, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    x = randn(rows, c, length).to(dtype).transpose(1, 2)
    scale, shift = randn(rows, c) * 0.3 + 1.0, randn(rows, c) * 0.5
    w = (randn(3, c, cout) / np.sqrt(3 * c)).to(dtype)
    bias = randn(cout) * 0.1
    r = randn(rows, cout, length).to(dtype).transpose(1, 2) if residual else None
    return x, scale, shift, w, bias, r


def _tc_model(x, scale, shift, w, bias, residual, num_groups, split=True):
    """``(y, s, ss)`` by the kernel's arithmetic (see above)."""
    c, cout = w.shape[1:]
    chunk = 16 if cout <= 16 else 32
    h = torch.nn.functional.silu(x.float() * scale[:, None, :] + shift[:, None, :])
    hi = h.to(torch.bfloat16).float()
    parts = [hi, (h - hi).to(torch.bfloat16).float()] if split else [hi]
    acc = 0.0
    for c0 in range(0, c, chunk):
        wk = w.float()[:, c0:c0 + chunk].permute(2, 1, 0)
        part = sum(torch.nn.functional.conv1d(a[..., c0:c0 + chunk].transpose(1, 2), wk,
                                              padding=1) for a in parts)
        acc = acc + part
    y = acc + bias.float()[None, :, None]
    if residual is not None:
        y = y + residual.float().transpose(1, 2)
    yg = y.reshape(y.shape[0], num_groups, -1)
    return y.to(x.dtype).transpose(1, 2), yg.sum(-1), (yg * yg).sum(-1)


def _gaps(c, cout, residual, seed, split=True):
    """(y error / max |plain|, worst sum error against its bound)."""
    x, scale, shift, w, bias, r = _chain_inputs(c, cout, 2048, residual, seed)
    y, s, ss = _tc_model(x, scale, shift, w, bias, r, 8, split)
    want, want_s, want_ss = tfr._stats_reference(x, scale, shift, w, bias, r, 8)
    if r is None:
        assert torch.equal(want, tfr._reference(x, scale, shift, w, bias))
    rel = ((y.float() - want.float()).abs().max() / want.float().abs().max()).item()
    n_ = 2048 * cout // 8
    rel_s = max(((s - want_s).abs() / (n_ * want_ss).sqrt()).max().item(),
                ((ss - want_ss).abs() / want_ss).max().item())
    return rel, rel_s


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c,cout", MAIN_PAIRS)
def test_bf16_operand_scheme_holds_the_card_gates(c, cout, residual):
    """The chosen scheme (hi + lo bf16 activation, f32 sums) keeps y within
    FUSED_TOL[bf16] of ``_reference``/``_stats_reference`` and the group
    sums within STATS_TOL, at every (C, Cout) of the main path."""
    rel, rel_s = _gaps(c, cout, residual, seed=c + cout + residual)
    assert rel <= FUSED_TOL_BF16 and rel_s <= STATS_TOL, (rel, rel_s)


def test_activation_rounded_once_breaks_the_sums_gate():
    """Why the kernel carries the activation as hi + lo: rounded to bf16
    once, the group sums miss STATS_TOL."""
    _, rel_s = _gaps(32, 32, True, seed=5, split=False)
    assert rel_s > STATS_TOL, rel_s


# The f32 kernel's arithmetic (3xTF32 on mma.sync m16n8k8), in plain
# PyTorch on the CPU: the activation h = silu(x·scale + shift) and the
# weight enter as big = rounded to tf32 and small = the remainder, read
# truncated (``tf32``, ``tf32_read``); input channels go in chunks of 16
# (zero-padded), and within a chunk, for each k8 step and each tap, the
# products small·big, big·small and big·big of the 8 channels are added, in
# that order, to the chunk's partial sum, which is added to the running sum
# in f32.  The tensor cores' own adds, which truncate, are not modelled:
# that is what the per-chunk partial sums guard against.  Held to the
# card's gates (y within 1e-5 of max |plain|, the sums within 1e-5 of their
# bounds) at the main path's (C, Cout) pairs with L cut to 2048, and at the
# wide 1024-channel case at L = 256.
FUSED_TOL_F32, F32_CHUNK = 1e-5, 16


def _tf32_model(x, scale, shift, w, bias, residual, num_groups, passes=THREE_TF32):
    """``(y, s, ss)`` by the f32 kernel's arithmetic (see above)."""
    c, cout = w.shape[1:]
    length = x.shape[1]
    cp = -(-c // F32_CHUNK) * F32_CHUNK
    h = torch.nn.functional.silu(x.float() * scale[:, None, :] + shift[:, None, :])
    h = torch.nn.functional.pad(h, (0, cp - c, 1, 1))  # halo rows and channels
    wp = torch.nn.functional.pad(w.float(), (0, 0, 0, cp - c))
    h_big, w_big = tf32(h), tf32(wp)
    terms = {"small_big": (tf32_read(h - h_big), w_big),
             "big_small": (h_big, tf32_read(wp - w_big)),
             "big_big": (h_big, w_big)}
    acc = torch.zeros(x.shape[0], length, cout)
    for c0 in range(0, cp, F32_CHUNK):
        part = torch.zeros_like(acc)
        for k0 in range(c0, c0 + F32_CHUNK, 8):
            for tap in range(3):
                for name in passes:
                    a, b = terms[name]
                    part = part + a[:, tap:tap + length, k0:k0 + 8] @ b[tap, k0:k0 + 8]
        acc = acc + part
    y = (acc + bias.float()).transpose(1, 2)
    if residual is not None:
        y = y + residual.float().transpose(1, 2)
    yg = y.reshape(y.shape[0], num_groups, -1)
    return y.transpose(1, 2), yg.sum(-1), (yg * yg).sum(-1)


def _f32_gaps(c, cout, length, residual, seed, passes=THREE_TF32):
    """(y error / max |plain|, worst sum error against its bound) of the
    f32 model."""
    x, scale, shift, w, bias, r = _chain_inputs(c, cout, length, residual, seed,
                                                dtype=torch.float32)
    y, s, ss = _tf32_model(x, scale, shift, w, bias, r, 8, passes)
    want, want_s, want_ss = tfr._stats_reference(x, scale, shift, w, bias, r, 8)
    rel = ((y - want).abs().max() / want.abs().max()).item()
    n_ = length * cout // 8
    rel_s = max(((s - want_s).abs() / (n_ * want_ss).sqrt()).max().item(),
                ((ss - want_ss).abs() / want_ss).max().item())
    return rel, rel_s


@pytest.mark.parametrize("c,cout,length,residual",
                         [(c, co, 2048, res) for c, co in MAIN_PAIRS for res in (False, True)]
                         + [(1024, 1024, 256, True)])
def test_f32_3xtf32_scheme_holds_the_card_gates(c, cout, length, residual):
    """The f32 body's scheme (3xTF32, chunks of 16 channels, per-chunk f32
    partial sums) keeps y within FUSED_TOL[f32] of ``_stats_reference`` and
    the group sums within STATS_TOL at every (C, Cout) of the main path and
    at the wide 1024-channel case."""
    rel, rel_s = _f32_gaps(c, cout, length, residual, seed=c + cout + residual)
    assert rel <= FUSED_TOL_F32 and rel_s <= STATS_TOL, (rel, rel_s)


@pytest.mark.parametrize("c,cout", [(10, 8), (64, 64), (128, 128)])
def test_plain_tf32_products_break_the_y_gate(c, cout):
    """Why the f32 body takes three products: big·big alone (plain TF32)
    moves y past FUSED_TOL[f32]."""
    rel, _ = _f32_gaps(c, cout, 2048, False, seed=c + cout, passes=("big_big",))
    assert rel > FUSED_TOL_F32, rel

