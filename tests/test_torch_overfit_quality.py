"""The port's overfit-to-quality entry points against the JAX scripts.

``syncfusion_tpu_torch/overfit_quality.py`` and ``overfit_quality_stage2.py``
against ``script/overfit_quality.py`` and ``script/overfit_quality_stage2.py``
(loaded from their files):

* the datasets, bit for bit (numpy draws from the same seeds, in the same
  order);
* the diffusion model at converted parameters: the loss on the JAX key's
  draws to 1e-5 relative, and one trainer step: its gradients to
  ``2e-4·max|g| + 1e-7`` (tests/test_torch_train.py's tolerances, f32) and
  the parameters after it within what those gradients' gap allows Adam's
  first step (below);
* the scoring of the same generated audio (a stub model's ``sample``
  returns it, so no JAX UNet runs): FAD of the mel statistics to 1e-4
  relative, the onset metrics exactly (scikit-learn's AP in JAX, the port's
  numpy AP);
* stage 2: the loss, ``greedy_acc`` and ``sample_acc`` at converted
  parameters, and two optimizer steps against optax in f64;
* each command line on the CPU at a few steps: its JSON lines and its exit
  code, which follows ``quality_improved``.

The diffusion comparisons run on the first 8192 samples of each clip (the
parameters do not depend on the length; the last level's attention then
takes 128 positions), so the file stays within a minute of one worker.
"""

import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from syncfusion_tpu.models.mingpt import GPTConfig as JaxGPTConfig
from syncfusion_tpu.models.mingpt import GPTFeats as JaxGPTFeats
from syncfusion_tpu.train.diffusion_trainer import DiffusionTrainer as JaxTrainer
from syncfusion_tpu.train.diffusion_trainer import OptimizerConfig as JaxOptimizerConfig
from syncfusion_tpu.train.transformer_trainer import decay_mask
from syncfusion_tpu_torch import convert
from syncfusion_tpu_torch import overfit_quality as oq
from syncfusion_tpu_torch import overfit_quality_stage2 as oq2
from syncfusion_tpu_torch.train.diffusion_trainer import DiffusionTrainer, OptimizerConfig
from torch_port_helpers import n, t, to_numpy

ROOT = Path(__file__).resolve().parents[1]
CROP = 8192
LR = 3e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "script" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jq():
    return _load("overfit_quality")


@pytest.fixture(scope="module")
def jq2():
    return _load("overfit_quality_stage2")


def test_diffusion_dataset_is_the_jax_scripts(jq):
    got, want = oq.build_dataset(3), jq.build_dataset(3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (3, oq.LENGTH, 1)
        assert np.array_equal(g, w)


def test_stage2_dataset_is_the_jax_scripts(jq2):
    patterns, batch = oq2.make_dataset(np.random.RandomState(0))
    jpatterns, jbatch = jq2.make_dataset(np.random.RandomState(0))
    assert np.array_equal(patterns, jpatterns)
    for size in (2, 64, 32, 32):
        for g, w in zip(batch(size), jbatch(size)):
            assert np.array_equal(g, np.asarray(w))


def random_tree(init, seed):
    """Parameters of the shapes ``init()`` would give, drawn with numpy
    instead of run (XLA's compile of the UNet's init costs seconds):
    kernels normal of variance 1/fan-in, GroupNorm scales 1 + 0.1·normal,
    the rest 0.1·normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(leaf(path, s), np.float32), jax.eval_shape(init))


@pytest.fixture(scope="module")
def pair(jq):
    """The JAX script's model and parameters, and the port's model on the
    CPU with those parameters."""
    model = jq.build_model()
    params = random_tree(lambda: model.init(jax.random.key(0), CROP, batch=1), seed=0)
    tm = oq.build_model("cpu")
    tm.load_state_dict(convert.to_state_dict(to_numpy(params)), strict=True)
    return model, params, tm


def test_the_model_is_the_jax_scripts(pair):
    model, params, tm = pair
    assert tm.param_count() == model.param_count(params)
    assert tm.unet.cfg.attention_features == 64 and tm.unet.cfg.attention_heads == 8


def test_loss_and_one_trainer_step_match_jax(pair):
    """The port's trainer step on the JAX key's draws against the JAX
    trainer's: the loss, the gradients, and the parameters after the step.

    Adam's first step moves each element by lr·f(ĝ) (plus the decay), f(x)
    = x / (|x| + eps), ĝ the clipped gradient.  f's slope is eps / (|x| +
    eps)², so an element whose gradient lies within the tolerance δ of 0
    may move either way (up to 2·lr apart), and one far from 0 agrees to
    lr·δ·eps / (|ĝ| - δ)²: every parameter is held to that bound, and 99% of
    the elements (all but ~1e-6 of them here) to 1e-6."""
    model, params, tm = pair
    wavs, tracks = oq.build_dataset(2)
    wav, onsets = wavs[:, :CROP], tracks[:, :CROP]
    jt = JaxTrainer(model, JaxOptimizerConfig(lr=LR, accumulate_grad_batches=1))
    key = jax.random.key(7)
    jbatch = {"wav": jnp.asarray(wav), "onsets": jnp.asarray(onsets)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(jt._loss))(params, jbatch, key)
    updates, _ = jt.tx.update(grads_j, jt.tx.init(params), params)
    after_j = convert.to_state_dict(to_numpy(optax.apply_updates(params, updates)))
    want_g = convert.to_state_dict(to_numpy(grads_j))
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    draws = {"sigma": t(n(jax.random.uniform(k_sigma, (2,), dtype=jnp.float32))),
             "noise": t(n(jax.random.normal(k_noise, wav.shape, dtype=jnp.float32)))}

    trainer = DiffusionTrainer(tm, OptimizerConfig(lr=LR, accumulate_grad_batches=1))
    trainer._draws = lambda *a: draws
    state = trainer.create_state()
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    grads = {}
    step = state.optimizer.step

    def capture():
        grads.update({k: p.grad.clone() for k, p in tm.named_parameters()
                      if p.grad is not None})
        return step()

    state.optimizer.step = capture
    metrics = trainer.train_step(state, {"wav": t(wav), "onsets": t(onsets)})
    np.testing.assert_allclose(metrics["train_loss"].item(), float(loss_j), rtol=1e-5)

    gnorm = math.sqrt(sum(float((w.double() ** 2).sum()) for w in want_g.values()))
    clip = min(1.0, 0.5 / gnorm)
    eps = trainer.opt_cfg.lr_eps
    tight = total = 0
    for name, p in tm.named_parameters():
        w = want_g[name]
        g = grads.get(name, torch.zeros_like(w))
        delta = 2e-4 * max(w.abs().max().item(), 1e-3) + 1e-7
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=delta, err_msg=name)
        gap = clip * w.abs().double() - clip * delta
        bound = LR * torch.clamp(clip * delta * eps / (gap.clamp_min(0) + eps) ** 2, max=2.0)
        tol = (bound + 1e-6).float()
        moved, want_moved = p.detach() - before[name], after_j[name] - before[name]
        gap_moved = (moved - want_moved).abs()
        assert (gap_moved <= tol).all(), name
        tight += int((gap_moved <= 1e-6).sum())
        total += tol.numel()
    assert tight >= 0.99 * total


class _StubModel:
    """The JAX evaluate's model: ``sample`` returns the given audio."""

    def __init__(self, gen):
        self.gen = jnp.asarray(gen[..., None])

    def sample(self, params, noise, tracks, embedding, num_steps):
        return self.gen


def _generated(variant):
    """Generated audio for the scoring test, from the training clips:
    "exact" the clips themselves; "perturbed" one burst muted, one clip
    scaled and noised, one replaced by noise."""
    wavs, tracks = oq.build_dataset(4)
    gen = wavs[..., 0].copy()
    if variant == "perturbed":
        rng = np.random.default_rng(0)
        first = int(np.flatnonzero(tracks[0, :, 0])[0])
        gen[0, first:first + 12000] = 0.0
        gen[1] = 0.5 * gen[1] + 0.05 * rng.standard_normal(gen.shape[1]).astype(np.float32)
        gen[2] = 0.3 * rng.standard_normal(gen.shape[1]).astype(np.float32)
    return gen, wavs, tracks


@pytest.mark.parametrize("variant", ["exact", "perturbed"])
def test_scoring_matches_jax_evaluate(jq, variant):
    gen, wavs, tracks = _generated(variant)
    want = jq.evaluate(_StubModel(gen), None, wavs, tracks, jax.random.key(0), num_steps=1)
    got = oq.score(gen, wavs, tracks)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["fad_melstats"], want["fad_melstats"], rtol=1e-4)
    for key in ("onset_acc", "onset_ap", "onset_count_acc"):
        assert got[key] == want[key], key


@pytest.fixture(scope="module")
def stage2(jq2):
    """The JAX GPT after 30 steps of the JAX script's recipe, and the port's
    GPT with those parameters."""
    cfg = JaxGPTConfig(vocab_size=jq2.VOCAB, block_size=jq2.N_FRAMES + 2 * jq2.CLIP,
                       n_layer=4, n_head=4, n_embd=128)
    gpt = JaxGPTFeats(cfg)
    _, batch_fn = jq2.make_dataset(np.random.RandomState(0))
    feats0, tokens0, _ = batch_fn(2)
    params = gpt.init(jax.random.key(0), tokens0[:, :-1], feats0)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.01, mask=decay_mask))
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, tokens, feats):
        grads = jax.grad(lambda p: jq2.ce_on_ref_half(gpt, p, tokens, feats)[0])(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(30):
        feats, tokens, _ = batch_fn(32)
        params, opt_state = step(params, opt_state, tokens, feats)
    tg = oq2.build_gpt("cpu")
    tg.load_state_dict(convert.gpt_state_dict(to_numpy(params)), strict=True)
    return gpt, params, tg


def test_stage2_loss_and_accuracies_match_jax(jq2, stage2):
    gpt, params, tg = stage2
    patterns, batch_fn = jq2.make_dataset(np.random.RandomState(1))
    _, port_batch = oq2.make_dataset(np.random.RandomState(1))
    feats, tokens, _ = batch_fn(64)
    want, _ = jq2.ce_on_ref_half(gpt, params, tokens, feats)
    port_feats, port_tokens = oq2.to_device(*port_batch(64)[:2], "cpu")
    got, _ = oq2.ce_on_ref_half(tg, port_tokens, port_feats)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_acc = jq2.evaluate(gpt, params, batch_fn, patterns, jax.random.key(1))
    got_acc = oq2.evaluate(tg, port_batch, patterns, torch.Generator().manual_seed(1))
    assert got_acc == want_acc
    assert 0.0 < want_acc["sample_acc"] < 1.0  # partly trained: a real test


def test_two_stage2_optimizer_steps_match_optax_f64(stage2):
    """``make_optimizer`` (clip 1.0, AdamW (0.9, 0.95), eps 1e-8, decay 0.01
    on the kernels alone) against the JAX script's optax chain on the same
    f64 parameters and gradients (the port's, step by step): 1e-12."""
    _, params, tg = stage2
    tg = tg.double()
    names = {convert.convert_leaf(path, np.zeros((1, 1)))[0]: bool(v)
             for path, v in convert.flatten(decay_mask(params["params"])).items()}
    assert {k for k, v in names.items() if v} == {
        k for k, p in tg.named_parameters() if any(p is q for q in oq2.decay_params(tg))}
    opt = oq2.make_optimizer(tg, LR)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.01, mask=names))
    _, batch = oq2.make_dataset(np.random.RandomState(2))
    with jax.enable_x64(True):
        # copies: a JAX array made from numpy may share the torch tensor's memory
        jp = {k: jnp.asarray(n(p).copy()) for k, p in tg.named_parameters()}
        state = tx.init(jp)
        for _ in range(2):
            feats, tokens = oq2.to_device(*batch(8)[:2], "cpu")
            loss, _ = oq2.ce_on_ref_half(tg, tokens, feats.double())
            loss.backward()
            jg = {k: jnp.asarray(n(p.grad).copy()) for k, p in tg.named_parameters()}
            assert math.sqrt(sum(float((g ** 2).sum()) for g in jg.values())) > 1.0
            opt.step()
            updates, state = tx.update(jg, state, jp)
            jp = optax.apply_updates(jp, updates)
        for k, p in tg.named_parameters():
            assert jp[k].dtype == jnp.float64
            np.testing.assert_allclose(n(p), np.asarray(jp[k]), rtol=0, atol=1e-12,
                                       err_msg=k)


def _json_lines(out):
    return [json.loads(line) for line in out.strip().splitlines()]


def test_diffusion_cli_on_the_cpu(capsys, tmp_path):
    rc = oq.main(["--device", "cpu", "--steps", "2", "--clips", "2", "--batch", "2",
                  "--sampling_steps", "2", "--out", str(tmp_path / "r.json")])
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0] == {"params": oq.build_model("cpu").param_count(), "clips": 2,
                        "length": oq.LENGTH, "steps": 2}
    assert [r["tag"] for r in lines[1:4]] == ["init", "mid", "final"]
    assert [r["step"] for r in lines[1:4]] == [0, 1, 2]
    last = lines[-1]
    assert last["results"] == lines[1:4]
    assert rc == (0 if last["quality_improved"] else 1)
    saved = json.loads((tmp_path / "r.json").read_text())
    assert saved == {**last, "distill": None}


def test_stage2_cli_on_the_cpu(capsys):
    rc = oq2.main(["--device", "cpu", "--steps", "100"])
    lines = _json_lines(capsys.readouterr().out)
    assert [r.get("tag") for r in lines] == ["init", "mid", None, "final", None]
    assert lines[1]["step"] == 50 and lines[2]["step"] == 100
    last = lines[-1]
    assert last["results"] == [lines[0], lines[1], lines[3]]
    assert last["quality_improved"] and rc == 0
    assert lines[3]["sample_acc"] > 0.9
