"""The port's a-unet compat twins and their checkpoint loader against the
JAX package's (``models/adp_{torch_recon,compat,convert}.py``).

Reference-layout state dicts come from the JAX package's torch
reconstruction (``build_unet_recon``/``build_encoder_recon``) on the tiny
configurations of tests/test_adp_compat.py; both converters take them in,
the JAX twins run the JAX tree and the port's twins the same tree through
``convert.to_state_dict``.  Inputs are drawn with numpy; f32 outputs agree
to 1e-4 of max |JAX|, converter trees bitwise.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import adp_compat as jcompat
from syncfusion_tpu.models import adp_convert as jconvert
from syncfusion_tpu.models import adp_torch_recon as jrecon
from syncfusion_tpu.models.diffusion import v_sample as jax_v_sample
from syncfusion_tpu.models.syncfusion import SyncFusionDiffusion as JaxSyncFusion
from syncfusion_tpu_torch import evaluate_diffusion
from syncfusion_tpu_torch.convert import flatten, to_state_dict
from syncfusion_tpu_torch.models import adp_compat, adp_convert, adp_torch_recon
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops import attention as ta
from test_adp_compat import ENC_SMALL, SMALL
from torch_port_helpers import n, to_numpy

L = 16
PORT_SMALL = adp_torch_recon.UNetV0Config(**dataclasses.asdict(SMALL))
PORT_ENC_SMALL = adp_torch_recon.Encoder1dConfig(**dataclasses.asdict(ENC_SMALL))
MULTI_TOKEN = dict(channels=(4, 8), factors=(1, 2), items=(1, 1), attentions=(0, 1),
                   cross_attentions=(1, 1), context_channels=(0, 0),
                   embedding_max_length=3)


def _port_cfg(jcfg):
    return adp_torch_recon.UNetV0Config(**dataclasses.asdict(jcfg))


def _recon_sd(build, cfg, seed):
    torch.manual_seed(seed)  # the recon's own torch init, then kept as numpy
    return {k: v.detach().clone() for k, v in build(cfg).state_dict().items()}


def _inputs(cfg, b=2, length=L, ctx_levels=None, seed=0):
    """(x, sigma, embedding, context), numpy, NLC; context per level (None
    past ``ctx_levels``: a starved level)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, cfg.in_channels)).astype(np.float32)
    sigma = rng.uniform(size=(b,)).astype(np.float32)
    emb = rng.standard_normal((b, cfg.embedding_max_length,
                               cfg.embedding_features)).astype(np.float32)
    ctx, size = [], length
    for lvl, (f, cc) in enumerate(zip(cfg.factors, cfg.context_channels)):
        size //= f
        if ctx_levels is not None and lvl >= ctx_levels:
            break
        ctx.append(rng.standard_normal((b, size, cc)).astype(np.float32) if cc else None)
    return x, sigma, emb, ctx


def _port_unet(cfg, tree):
    m = adp_compat.UNetV0Compat(_port_cfg(cfg))
    m.load_state_dict({k[len("unet."):]: v for k, v in to_state_dict(
        {"unet": tree, "encoder": {}}).items()}, strict=True)
    return m.eval()


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("which", ["unet_small", "unet_full", "encoder_small",
                                   "encoder_full"])
def test_manifests_equal_the_jax_packages(which):
    if which.startswith("unet"):
        cfg = SMALL if which == "unet_small" else jrecon.UNetV0Config()
        want, got = jrecon.unet_manifest(cfg), adp_torch_recon.unet_manifest(_port_cfg(cfg))
    else:
        cfg = ENC_SMALL if which == "encoder_small" else jrecon.Encoder1dConfig()
        want = jrecon.encoder_manifest(cfg)
        got = adp_torch_recon.encoder_manifest(
            adp_torch_recon.Encoder1dConfig(**dataclasses.asdict(cfg)))
    assert got == want
    node = {"model": {"channels": [4, 8], "factors": [1, 2], "items": [1, 1],
                      "attentions": [0, 1], "cross_attentions": [1, 1],
                      "context_channels": [2, 0]},
            "onsets_encoder": {"channels": 2, "multipliers": [1, 1, 2],
                               "factors": [1, 2], "num_blocks": [1, 1]}}
    assert dataclasses.asdict(adp_torch_recon.UNetV0Config.from_node(node["model"])) == \
        dataclasses.asdict(jrecon.UNetV0Config.from_node(node["model"]))
    assert dataclasses.asdict(adp_torch_recon.Encoder1dConfig.from_node(
        node["onsets_encoder"])) == dataclasses.asdict(
        jrecon.Encoder1dConfig.from_node(node["onsets_encoder"]))


def _same_tree(got, want):
    fg, fw = flatten(got), flatten(want)
    assert fg.keys() == fw.keys()
    for k, v in fw.items():
        assert fg[k].dtype == v.dtype and fg[k].shape == v.shape, k
        np.testing.assert_array_equal(fg[k], v, err_msg=str(k))


def test_converter_trees_equal_the_jax_converters_bitwise():
    usd = _recon_sd(jrecon.build_unet_recon, SMALL, 0)
    esd = _recon_sd(jrecon.build_encoder_recon, ENC_SMALL, 1)
    _same_tree(adp_convert.convert_unet_state(usd, PORT_SMALL),
               jconvert.convert_unet_state(usd, SMALL))
    _same_tree(adp_convert.convert_encoder_state(esd, PORT_ENC_SMALL),
               jconvert.convert_encoder_state(esd, ENC_SMALL))
    # upstream's anonymous keys, matched by order and shape
    anon = {f"blocks.{i}.anon": v for i, v in enumerate(usd.values())}
    _same_tree(adp_convert.convert_unet_state(anon, PORT_SMALL),
               jconvert.convert_unet_state(anon, SMALL))
    # a whole Lightning module state dict
    ckpt = {f"model.net.{k}": v for k, v in usd.items()}
    ckpt.update({f"model.diffusion.net.{k}": v for k, v in usd.items()})
    ckpt.update({f"onsets_encoder.{k}": v for k, v in esd.items()})
    ckpt["embedder.model.dummy"] = torch.zeros(1)
    _same_tree(adp_convert.convert_diffusion_ckpt(ckpt, PORT_SMALL, PORT_ENC_SMALL),
               jconvert.convert_diffusion_ckpt(ckpt, SMALL, ENC_SMALL))
    bad = dict(anon)
    bad["blocks.3.anon"] = torch.zeros(7)
    with pytest.raises(ValueError, match="shape mismatch"):
        adp_convert.convert_unet_state(bad, PORT_SMALL)
    with pytest.raises(ValueError, match="model.net"):
        adp_convert.convert_diffusion_ckpt({"onsets_encoder.x": torch.zeros(1)})


def test_transposed_convolution_matches_the_jax_twins():
    """One block's upsample: the raw (k, in, out) kernel through the port's
    ``conv_transpose_torch`` equals the JAX twin's flipped, dilated
    correlation and torch's own ConvTranspose1d on the recon layout."""
    rng = np.random.default_rng(3)
    for k, c_in, c_out, length in ((4, 8, 4, 5), (2, 3, 1, 7), (1, 4, 4, 3)):
        x = rng.standard_normal((2, length, c_in)).astype(np.float32)
        kernel = rng.standard_normal((k, c_in, c_out)).astype(np.float32)
        bias = rng.standard_normal((c_out,)).astype(np.float32)
        want = np.asarray(jcompat._conv_transpose_torch(jnp.asarray(x), jnp.asarray(kernel),
                                                        jnp.asarray(bias), k))
        got = adp_compat.conv_transpose_torch(torch.from_numpy(x).transpose(1, 2),
                                              torch.from_numpy(kernel),
                                              torch.from_numpy(bias), k)
        assert _rel(n(got).transpose(0, 2, 1), want) < 1e-6
        ref = torch.nn.ConvTranspose1d(c_in, c_out, k, stride=k)
        with torch.no_grad():
            ref.weight.copy_(torch.from_numpy(kernel.transpose(1, 2, 0)))
            ref.bias.copy_(torch.from_numpy(bias))
            assert _rel(n(ref(torch.from_numpy(x).transpose(1, 2))), n(got)) < 1e-6


CASES = {
    "default": {},
    "starved_level": {"ctx_levels": 2},
    "multi_token_cross_attention": {"cfg": MULTI_TOKEN},
    "fixed_embedding": {"embedding": None},
    "cfg_mask": {"mask": True},
    "d4_skip_first": {"cfg": {"cat_order": "skip_first", "skip_scale": 2.0 ** -0.5}},
    "d4_x_first": {"cfg": {"cat_order": "x_first", "skip_scale": 1.0}},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_unet_forward_matches_the_jax_twin(case):
    spec = CASES[case]
    cfg = dataclasses.replace(SMALL, **spec.get("cfg", {}))
    tree = jconvert.convert_unet_state(_recon_sd(jrecon.build_unet_recon, cfg, 2), cfg)
    x, sigma, emb, ctx = _inputs(cfg, ctx_levels=spec.get("ctx_levels"))
    emb = spec.get("embedding", emb)
    mask = np.array([0.0, 1.0], np.float32).reshape(2, 1, 1) if spec.get("mask") else None
    jctx = [None if c is None else jnp.asarray(c) for c in ctx]
    want = np.asarray(jcompat.UNetV0Compat(cfg=cfg).apply(
        tree, jnp.asarray(x), jnp.asarray(sigma), context=jctx,
        embedding=None if emb is None else jnp.asarray(emb),
        embedding_cfg_mask=None if mask is None else jnp.asarray(mask)))
    port = _port_unet(cfg, tree)
    ta.reset_counts()
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(sigma),
                   context=[None if c is None else torch.from_numpy(c) for c in ctx],
                   embedding=None if emb is None else torch.from_numpy(emb),
                   embedding_cfg_mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(n(got), want) < 1e-4
    # the self-attention levels ran through flash_attention's plain version
    # (down and up, every item), and nothing else did
    calls = sum(cfg.attentions[i] * cfg.items[i] * 2 for i in range(len(cfg.channels)))
    assert ta.flash_attention.plain_calls == calls and ta.flash_attention.kernel_launches == 0
    if case.startswith("d4"):  # the other order is another function of the same weights
        other = dataclasses.replace(cfg, cat_order="x_first" if cfg.cat_order == "skip_first"
                                    else "skip_first")
        with torch.no_grad():
            flipped = _port_unet(other, tree)(
                torch.from_numpy(x), torch.from_numpy(sigma),
                context=[None if c is None else torch.from_numpy(c) for c in ctx],
                embedding=torch.from_numpy(emb))
        assert np.abs(n(flipped) - n(got)).max() > 1e-4


def test_encoder_forward_and_its_xs_contract():
    tree = jconvert.convert_encoder_state(
        _recon_sd(jrecon.build_encoder_recon, ENC_SMALL, 4), ENC_SMALL)
    x = np.random.default_rng(5).standard_normal((2, L, 1)).astype(np.float32)
    want_out, want_info = jcompat.Encoder1dCompat(cfg=ENC_SMALL).apply(
        tree, jnp.asarray(x), with_info=True)
    port = adp_compat.Encoder1dCompat(PORT_ENC_SMALL)
    port.load_state_dict({k[len("onsets_encoder."):]: v for k, v in to_state_dict(
        {"unet": {}, "encoder": tree}).items()}, strict=True)
    with torch.no_grad():
        out, info = port(torch.from_numpy(x), with_info=True)
        plain = port(torch.from_numpy(x))
    assert _rel(n(out), np.asarray(want_out)) < 1e-4
    np.testing.assert_array_equal(n(plain), n(out))
    assert len(info["xs"]) == len(want_info["xs"]) == len(ENC_SMALL.factors) + 2
    for got, want in zip(info["xs"], want_info["xs"]):
        assert got.shape == want.shape
        assert _rel(n(got), np.asarray(want)) < 1e-4


def _pair(seed=6):
    """(JAX compat SyncFusion, its params, the port's model with them)."""
    usd = _recon_sd(jrecon.build_unet_recon, SMALL, seed)
    esd = _recon_sd(jrecon.build_encoder_recon, ENC_SMALL, seed + 1)
    ckpt = {**{f"model.net.{k}": v for k, v in usd.items()},
            **{f"onsets_encoder.{k}": v for k, v in esd.items()}}
    params = jconvert.convert_diffusion_ckpt(ckpt, SMALL, ENC_SMALL)
    jm = JaxSyncFusion(unet=jcompat.UNetV0Compat(cfg=SMALL),
                       onsets_encoder=jcompat.Encoder1dCompat(cfg=ENC_SMALL))
    tm = SyncFusionDiffusion(PORT_SMALL, PORT_ENC_SMALL)
    tm.load_state_dict(to_state_dict(params), strict=True)
    return jm, params, tm.eval(), ckpt


def _clip_inputs(b=2, seed=7):
    rng = np.random.default_rng(seed)
    onsets = np.zeros((b, L, 1), np.float32)
    onsets[:, rng.integers(0, L, size=4), 0] = 1.0
    return (rng.standard_normal((b, L, 1)).astype(np.float32), onsets,
            rng.standard_normal((b, 1, SMALL.embedding_features)).astype(np.float32))


def test_v_sample_with_cfg_in_the_band_matches_jax():
    jm, params, tm, _ = _pair()
    noise, onsets, emb = _clip_inputs()
    kw = dict(num_steps=4, embedding_scale=2.0, guidance_interval=(0.2, 0.8))
    want = np.asarray(jm.sample(params, jnp.asarray(noise), jnp.asarray(onsets),
                                jnp.asarray(emb), **kw))
    got = tm.sample(torch.from_numpy(noise), torch.from_numpy(onsets),
                    torch.from_numpy(emb), **kw)
    assert got.shape == want.shape == noise.shape
    assert _rel(n(got), want) < 1e-4
    # the same sampler over the JAX twin's apply, as the facade calls it
    ctx = jm.encode_context(params["encoder"], jnp.asarray(onsets))
    direct = jax_v_sample(jm.unet.apply, params["unet"], jnp.asarray(noise), 4,
                          context=ctx, embedding=jnp.asarray(emb), embedding_scale=2.0,
                          guidance_interval=(0.2, 0.8))
    np.testing.assert_allclose(np.asarray(direct), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("proba", [0.0, 1.0])
def test_loss_and_every_gradient_match_jax(proba):
    jm, params, tm, _ = _pair(seed=8)
    wav, onsets, emb = _clip_inputs(seed=9)
    key = jax.random.key(11)

    def loss_fn(p):
        return jm.loss(p, key, jnp.asarray(wav), jnp.asarray(onsets), jnp.asarray(emb),
                       embedding_mask_proba=proba)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    sigma = jax.random.uniform(k_sigma, (wav.shape[0],), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, wav.shape, dtype=jnp.float32)
    got_loss = tm.loss(torch.from_numpy(wav), torch.from_numpy(onsets),
                       torch.from_numpy(emb), embedding_mask_proba=proba,
                       sigma=torch.from_numpy(np.array(sigma)),
                       noise=torch.from_numpy(np.array(noise)))
    got_loss.backward()
    assert abs(got_loss.item() - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    want = to_state_dict(to_numpy(want_grads))
    got = dict(tm.named_parameters())
    assert want.keys() == got.keys()
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        g = got[name].grad
        g = torch.zeros_like(w) if g is None else g
        assert (g - w).abs().max().item() <= 1e-4 * top, name
    assert ta.flash_attention.plain_bwd_calls > 0


# a configuration a model config's node can state: ``from_node`` keeps
# diffusion.yaml's modulation width, Fourier size and groups
NODE = {"model": {"channels": [4, 8], "factors": [1, 2], "items": [1, 2],
                  "attentions": [0, 1], "cross_attentions": [1, 1],
                  "context_channels": [2, 4], "attention_heads": 2,
                  "attention_features": 4, "embedding_features": 16},
        "onsets_encoder": {"channels": 2, "multipliers": [1, 1, 2, 4],
                           "factors": [1, 2, 2], "num_blocks": [1, 1, 1],
                           "resnet_groups": 1}}


def test_lightning_checkpoint_through_evaluate_diffusions_load_model(tmp_path):
    """A Lightning ``.ckpt`` of the reference module (the shared-module
    duplicates and the frozen CLAP included) -> ``evaluate_diffusion.
    load_model`` builds the twins at the model config's widths and loads it:
    every parameter equals the JAX loader's leaf, and a CFG sample equals
    the JAX twins' on the JAX loader's tree."""
    jucfg = jrecon.UNetV0Config.from_node(NODE["model"])
    jecfg = jrecon.Encoder1dConfig.from_node(NODE["onsets_encoder"])
    usd = _recon_sd(jrecon.build_unet_recon, jucfg, 14)
    esd = _recon_sd(jrecon.build_encoder_recon, jecfg, 15)
    blob = {}
    for prefix in ("model.net.", "model.diffusion.net.", "model.sampler.net."):
        blob.update({prefix + k: v for k, v in usd.items()})
    blob.update({f"onsets_encoder.{k}": v for k, v in esd.items()})
    blob["embedder.model.dummy"] = torch.zeros(1)
    path = tmp_path / "epoch=784-valid_loss=0.008.ckpt"
    torch.save({"state_dict": blob, "epoch": 784}, path)

    args = evaluate_diffusion.parse_args(["--exp", "evaluate_gh_gen", "--dataset_path", "x",
                                          "--experiment_path", "y", "--ckpt", str(path)])
    model = evaluate_diffusion.load_model(args, NODE, "cpu")
    assert model.compat and model.unet.cfg == adp_torch_recon.UNetV0Config.from_node(
        NODE["model"])
    tree = jconvert.load_diffusion_ckpt(path, jucfg, jecfg)
    want = to_state_dict(tree)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(n(got[k]), n(v), err_msg=k)

    jm = JaxSyncFusion(unet=jcompat.UNetV0Compat(cfg=jucfg),
                       onsets_encoder=jcompat.Encoder1dCompat(cfg=jecfg))
    noise, onsets, emb = _clip_inputs(seed=16)
    kw = dict(num_steps=2, embedding_scale=2.0)
    want_wav = np.asarray(jm.sample(tree, jnp.asarray(noise), jnp.asarray(onsets),
                                    jnp.asarray(emb), **kw))
    got_wav = model.sample(torch.from_numpy(noise), torch.from_numpy(onsets),
                           torch.from_numpy(emb), **kw)
    assert _rel(n(got_wav), want_wav) < 1e-4


def test_the_full_width_twins_take_the_manifests_tree():
    """At exp/model/diffusion.yaml's widths (built on the meta device, no
    memory): the tree of a checkpoint with the manifests' shapes has the
    port twins' keys and shapes, and the parameter count of a 196M-class
    UNet."""
    ucfg, ecfg = adp_torch_recon.UNetV0Config(), adp_torch_recon.Encoder1dConfig()
    zero = np.zeros((), np.float32)
    sd = {f"model.net.{k}": np.broadcast_to(zero, s)
          for k, s in adp_torch_recon.unet_manifest(ucfg)}
    sd.update({f"onsets_encoder.{k}": np.broadcast_to(zero, s)
               for k, s in adp_torch_recon.encoder_manifest(ecfg)})
    tree = adp_convert.convert_diffusion_ckpt(sd)
    want = {}
    for top, prefix in (("unet", "unet"), ("encoder", "onsets_encoder")):
        for path, a in flatten(tree[top]["params"]).items():
            name = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
            # convert_leaf's rule for the twins' kernels, (K, I, O) and (I, O):
            # reversed; the other leaves as they are
            shape = a.shape[::-1] if path[-1] == "kernel" else a.shape
            want[".".join((prefix, *path[:-1], name))] = tuple(shape)
    with torch.device("meta"):
        model = SyncFusionDiffusion(ucfg, ecfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert 1.5e8 < sum(v.numel() for v in model.unet.parameters()) < 5e8


def test_the_jax_init_tree_loads_into_the_port():
    """The JAX facade's init of the twins maps onto the port's twins by
    name (strict); ``from_config`` selects the twins by ``compat`` and draws
    their parameters from its seed: kernels, frequencies and the fixed
    embedding random, biases 0, norm scales 1.  The encoder gives every
    level a context: Flax creates no parameters for an injector that its
    init never calls."""
    enc = jrecon.Encoder1dConfig(channels=2, multipliers=(1, 1, 2, 2, 4),
                                 factors=(1, 2, 2, 2), num_blocks=(1, 1, 1, 1),
                                 resnet_groups=1)
    jm = JaxSyncFusion(unet=jcompat.UNetV0Compat(cfg=SMALL),
                       onsets_encoder=jcompat.Encoder1dCompat(cfg=enc))
    params = to_numpy(jm.init(jax.random.key(0), L, batch=1))
    tm = SyncFusionDiffusion(PORT_SMALL, adp_torch_recon.Encoder1dConfig(
        **dataclasses.asdict(enc)))
    tm.load_state_dict(to_state_dict(params), strict=True)

    node = {"compat": True, **NODE}
    model = SyncFusionDiffusion.from_config(node, device="cpu", seed=3)
    again = SyncFusionDiffusion.from_config(node, device="cpu", seed=3)
    assert model.compat
    norms = {name for name, m in model.named_modules()
             if isinstance(m, (adp_compat._GroupNorm, adp_compat._LayerNorm))}
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        owner, leaf = name.rsplit(".", 1)
        if owner in norms and leaf == "weight":
            assert torch.all(p == 1.0), name
        elif leaf in ("bias", "upsample_bias"):
            assert not p.any(), name
        else:
            assert p.std() > 0, name
    model.to(torch.float64)  # torch's own module conversions reach every parameter
    assert all(p.dtype == torch.float64 for p in model.parameters())
    assert not SyncFusionDiffusion.from_config({**node, "compat": False}, device="cpu").compat
    assert SyncFusionDiffusion.from_config(NODE, device="cpu", compat=True).compat


def test_deep_cache_and_the_fused_chain_raise_with_the_twins():
    _, _, tm, _ = _pair(seed=13)
    noise, onsets, emb = _clip_inputs()
    with pytest.raises(ValueError, match="deep split"):
        tm.sample(torch.from_numpy(noise), torch.from_numpy(onsets), torch.from_numpy(emb),
                  num_steps=2, deep_cache_interval=2, deep_split=1)
    node = {"compat": True, "model": {"channels": [4, 8], "factors": [1, 2],
                                      "items": [1, 1], "attentions": [0, 1],
                                      "cross_attentions": [1, 1],
                                      "context_channels": [2, 0], "fused_resnet": True},
            "onsets_encoder": {"channels": 2, "multipliers": [1, 1, 2],
                               "factors": [1, 2], "num_blocks": [1, 1]}}
    # the fused chain does not raise: a compat config ignores its switches
    # and builds the twins, as the JAX from_config does
    # (tests/test_torch_compat_fused_switches.py holds them against JAX)
    assert SyncFusionDiffusion.from_config(node, device="cpu").compat
    node["model"]["fused_resnet"] = False
    assert SyncFusionDiffusion.from_config(node, device="cpu", fused_stats=True).compat
    # remat is ported (tests/test_torch_remat.py holds it against JAX): it
    # builds, with the same parameters as the plain twin
    remat = adp_compat.UNetV0Compat(PORT_SMALL, remat=True)
    assert remat.net.remat and remat.state_dict().keys() == tm.unet.state_dict().keys()


def test_train_diffusion_trains_a_compat_config(tmp_path):
    """``train_diffusion`` builds the twins from a config with ``compat:
    true`` (the same ``from_config``) and trains them: 2 micro-steps, a
    validation and the sample logger, the attention through
    ``flash_attention`` (4 self-attention calls a forward), a checkpoint
    that reloads strictly into the twins."""
    from syncfusion_tpu_torch import train_diffusion
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
    from torch_port_helpers import make_shard

    shard = make_shard(tmp_path, n_tracks=3, seconds=0.02)
    cfg = tmp_path / "compat.json"
    cfg.write_text(json.dumps({"compat": True, **NODE}))
    ta.reset_counts()
    state = train_diffusion.main([
        "--train_path", shard, "--val_path", shard, "--logs_dir", str(tmp_path / "logs"),
        "--model_config", str(cfg), "--length", "256", "--batch_size", "2",
        "--max_steps", "2", "--log_every_n_steps", "1", "--val_check_interval", "2",
        "--val_batches", "1", "--sampling_steps", "2", "--embedder", "none",
        "--device", "cpu"])
    assert state.step == 2
    assert ta.flash_attention.plain_bwd_calls == 2 * 4 * 2
    assert ta.flash_attention.plain_calls >= 4 * (2 + 1 + 2)
    (run,) = (tmp_path / "logs" / "runs").iterdir()
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite([r["train_loss"] for r in records if "train_loss" in r]).all()
    assert any(p.name.startswith("sample_") for p in (run / "media").iterdir())
    model = SyncFusionDiffusion.from_config({"compat": True, **NODE}, device="cpu")
    model.load_state_dict(Checkpointer(CheckpointConfig(run / "ckpts")).restore()["model"],
                          strict=True)
    assert model.compat
