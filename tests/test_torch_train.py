"""The port's training path against the JAX package's.

* Loss and gradients: ``SyncFusionDiffusion.loss`` and the gradient of
  every parameter of the UNet and the onset encoder, against the JAX
  ``model.loss`` and ``jax.grad`` on the same converted parameters, with
  sigma and noise rebuilt from the JAX key (``split(key, 3)``).  f32;
  loss to 1e-5 relative, each gradient to ``2e-4·max|g| + 1e-7`` (the
  tolerance tests/test_trainer.py holds the sharded gradients to: other
  orders of summation through the tiny UNet).
* Optimizer: one sequence of gradients, some exactly zero and some absent,
  through the port's ``Optimizer`` and the JAX ``make_optimizer``; the
  parameters agree to 1e-6 after 3 updates.
* Checkpoints, the resume of a run, and the training command line end to
  end on the CPU at the tiny config of tests/test_trainer.py.
* Validation reads the reference script's val stream, bit for bit.
"""

import importlib
import itertools
import json
import logging
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from syncfusion_tpu.core.config import instantiate, load_config
from syncfusion_tpu.ops.wav import read_wav
from syncfusion_tpu.train.diffusion_trainer import OptimizerConfig as JaxOptimizerConfig
from syncfusion_tpu.train.diffusion_trainer import make_optimizer
from syncfusion_tpu_torch import generate, train_diffusion
from syncfusion_tpu_torch.convert import to_state_dict
from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.core.config import TrainConfig
from syncfusion_tpu_torch.models.embedder import build_embedder
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.models.unet1d import cfg_dropout_mask
from syncfusion_tpu_torch.ops import attention as ta
from syncfusion_tpu_torch.train.diffusion_trainer import (
    DiffusionTrainer,
    Optimizer,
    OptimizerConfig,
)
from test_trainer import ENC as TRAIN_ENC
from test_trainer import UNET as TRAIN_UNET
from torch_port_helpers import L, make_shard, n, t, tiny_pair, to_numpy

ROOT = Path(__file__).resolve().parents[1]

TRAIN_L = 256  # tests/test_trainer.py's length
# the parameters the loss does not reach, which JAX gives a zero gradient:
# the fixed (unconditional) embedding when no row is CFG-masked, the norm of
# the single-token cross-attention, the encoder level past the context
NO_GRAD = ("unet.fixed_embedding", "xattn", "onsets_encoder.down_3.",
           "onsets_encoder.block_3_")


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    onsets = np.zeros((b, L, 1), np.float32)
    onsets[:, rng.integers(0, L, size=8), 0] = 1.0
    return (rng.standard_normal((b, L, 1)).astype(np.float32), onsets,
            rng.standard_normal((b, 1, 16)).astype(np.float32))


@pytest.mark.parametrize("proba", [0.0, 1.0])
def test_loss_and_every_gradient_match_jax(proba):
    jm, params, tm = tiny_pair(seed=2)
    wav, onsets, emb = _batch()
    key = jax.random.key(5)

    def loss_fn(p):
        return jm.loss(p, key, jnp.asarray(wav), jnp.asarray(onsets),
                       jnp.asarray(emb), embedding_mask_proba=proba)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    sigma = jax.random.uniform(k_sigma, (wav.shape[0],), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, wav.shape, dtype=jnp.float32)
    got_loss = tm.loss(t(wav), t(onsets), t(emb), embedding_mask_proba=proba,
                       sigma=t(n(sigma)), noise=t(n(noise)))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)

    want = to_state_dict(to_numpy(want_grads))
    got = dict(tm.named_parameters())
    assert want.keys() == got.keys()
    no_grad = {k for k, p in got.items() if p.grad is None}
    for key_, w in want.items():
        g = got[key_].grad
        g = torch.zeros_like(w) if g is None else g
        scale = max(w.abs().max().item(), 1e-3)
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=2e-4 * scale + 1e-7,
                                   err_msg=key_)
    # the parameters torch leaves without .grad are those JAX zeroes
    assert no_grad and all(any(s in k for s in NO_GRAD) for k in no_grad)
    assert all(not want[k].any() for k in no_grad)
    if proba == 1.0:
        assert "unet.fixed_embedding" not in no_grad


def test_encode_context_keeps_gradients():
    """Fault 2: the onset encoder is trained, so its context carries a
    gradient; sampling still runs without one."""
    _, _, tm = tiny_pair(seed=0)
    _, onsets, emb = _batch()
    context = tm.encode_context(t(onsets))
    assert context and all(c.requires_grad for c in context)
    wav = tm.sample(torch.zeros((2, L, 1)), t(onsets), t(emb), num_steps=1)
    assert not wav.requires_grad


def test_cfg_dropout_mask_frequency():
    """JAX's Bernoulli bits cannot be reproduced, so an embedding_mask_proba
    between 0 and 1 is held to its frequency: 20000 rows, 4 sigma."""
    gen = torch.Generator().manual_seed(0)
    rows = cfg_dropout_mask(20000, 0.3, gen)
    assert rows.shape == (20000, 1, 1) and rows.dtype == torch.bool
    assert abs(rows.float().mean().item() - 0.3) < 4 * math.sqrt(0.3 * 0.7 / 20000)
    jax_rows = jax.random.bernoulli(jax.random.key(0), 0.3, (20000, 1, 1))
    assert abs(float(jax_rows.mean()) - 0.3) < 4 * math.sqrt(0.3 * 0.7 / 20000)


def test_cfg_dropout_takes_the_drawn_mask():
    """With a probability between 0 and 1 the UNet masks the rows the
    generator draws: the same as passing that mask explicitly."""
    _, _, tm = tiny_pair(seed=1)
    wav, _, emb = _batch(b=8)
    ctx = tm.encode_context(torch.zeros((8, L, 1)))
    sigma = torch.full((8,), 0.5)
    kw = dict(context=[c.detach() for c in ctx], embedding=t(emb))
    with torch.no_grad():
        drawn = tm.unet(t(wav), sigma, embedding_mask_proba=0.5,
                        generator=torch.Generator().manual_seed(3), **kw)
        mask = cfg_dropout_mask(8, 0.5, torch.Generator().manual_seed(3))
        explicit = tm.unet(t(wav), sigma, embedding_cfg_mask=mask, **kw)
        none = tm.unet(t(wav), sigma, **kw)
    assert 0 < mask.sum() < 8
    assert torch.equal(drawn, explicit)
    assert not torch.equal(drawn, none)


SHAPES = {"a": (3, 4), "b": (5,), "zero": (2, 2), "absent": (4,)}


def _grad_sequence(seed=0):
    """6 micro-batch gradients (3 updates of 2): 'zero' exactly zero, and
    'absent' never reached (JAX: zero).  Updates 1 and 3 have a global norm
    far above the clip (0.5), update 2 far below it."""
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(6):
        scale = 0.01 if i in (2, 3) else 3.0
        seq.append({k: (np.zeros(s, np.float32) if k == "zero" else
                        (scale * rng.standard_normal(s)).astype(np.float32))
                    for k, s in SHAPES.items() if k != "absent"})
    return seq


def _port_params(init):
    return {k: torch.nn.Parameter(t(v)) for k, v in init.items()}


def _feed(params, grads):
    """backward of sum(p·g) over the parameters that have a gradient: their
    .grad accumulates g as a micro-batch's backward does."""
    sum((params[k] * t(g)).sum() for k, g in grads.items()).backward()


@pytest.mark.parametrize("lr,wd,atol", [(1e-4, 1e-3, 1e-6), (0.1, 0.5, 1e-5)])
def test_optimizer_matches_optax(lr, wd, atol):
    """Clip by global norm, AdamW with weight decay on every parameter,
    MultiSteps(2): the JAX package's defaults to 1e-6.  The second case
    makes the decay (lr·wd = 0.05 a step) and Adam's step (~lr) large enough
    that a missing or wrong decay shows; its tolerance is 1e-5 because optax
    takes Adam's bias correction 1 - 0.999^t in f32 (1.3e-5 relative off at
    t = 1) and torch in f64, which moves each update by up to ~lr·1e-5."""
    rng = np.random.default_rng(1)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    cfg = dict(lr=lr, lr_weight_decay=wd, accumulate_grad_batches=2)
    tx = make_optimizer(JaxOptimizerConfig(**cfg))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    params = _port_params(init)
    opt = Optimizer(params.values(), OptimizerConfig(**cfg))
    for grads in _grad_sequence():
        jg = {k: jnp.asarray(grads.get(k, np.zeros(s, np.float32)))
              for k, s in SHAPES.items()}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        _feed(params, grads)
        opt.step()
    assert int(state.gradient_step) == 3
    for k in SHAPES:
        np.testing.assert_allclose(n(params[k]), np.asarray(jp[k]), rtol=0,
                                   atol=atol, err_msg=k)
    moved = SHAPES if lr > 1e-3 else ("a", "b")
    assert all(not np.allclose(np.asarray(jp[k]), init[k], atol=1e-5) for k in moved)


def test_parameters_change_only_every_k():
    rng = np.random.default_rng(2)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    params = _port_params(init)
    opt = Optimizer(params.values(), OptimizerConfig(accumulate_grad_batches=2))
    seq = _grad_sequence()
    _feed(params, seq[0])
    assert not opt.step()
    assert all(torch.equal(params[k].detach(), t(v)) for k, v in init.items())
    assert opt.adamw.state == {}  # Adam's step count has not advanced
    _feed(params, seq[1])
    assert opt.step()
    assert all(not torch.equal(params[k].detach(), t(v)) for k, v in init.items())
    assert all(p.grad is None for p in params.values())


def test_parameter_without_gradient_is_decayed():
    """Fault 3: a parameter that got no gradient is decayed by lr·wd on
    every update, as optax.adamw does; torch's AdamW alone would skip it."""
    params = _port_params({"w": np.ones(3, np.float32), "absent": np.ones(4, np.float32)})
    opt = Optimizer(params.values(), OptimizerConfig(lr=0.1, lr_weight_decay=0.5))
    _feed(params, {"w": np.ones(3, np.float32)})
    assert opt.step()
    np.testing.assert_allclose(n(params["absent"]), np.full(4, 1 - 0.1 * 0.5), rtol=1e-7)


def _tiny_trainer(**opt):
    model = SyncFusionDiffusion.from_config(
        {"model": TRAIN_UNET, "onsets_encoder": TRAIN_ENC}, device="cpu", seed=0)
    return DiffusionTrainer(model, OptimizerConfig(**opt))


def _train_batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    onsets = np.zeros((b, TRAIN_L, 1), np.uint8)
    onsets[:, rng.integers(0, TRAIN_L, size=8), 0] = 1
    wav = rng.uniform(-0.5, 0.5, (b, TRAIN_L, 1)).astype(np.float32)
    return {"wav": t(wav), "onsets": t(onsets),
            "embedding": t(rng.standard_normal((b, 1, 8)).astype(np.float32))}


def test_train_step_reduces_loss():
    """As tests/test_trainer.py: the same noise at steps 0 and 4, so the
    loss must drop on the identical subproblem."""
    trainer = _tiny_trainer(lr=1e-3)
    state = trainer.create_state()
    batch = _train_batch(4)
    losses = [trainer.train_step(state, batch, torch.Generator().manual_seed(i % 2))
              ["train_loss"].item() for i in range(5)]
    assert state.step == 5 and np.isfinite(losses).all()
    assert losses[4] < losses[0]


def test_wire_formats_are_dequantized():
    """int16 wav (wire_int16) and uint8 onsets give the loss of their f32
    values; eval_step takes no gradient."""
    trainer = _tiny_trainer()
    state = trainer.create_state()
    batch = _train_batch()
    wav16 = (batch["wav"].clamp(-1, 1) * 32767.0).to(torch.int16)
    as_f32 = dict(batch, wav=wav16.float() / 32767.0, onsets=batch["onsets"].float())
    a = trainer.eval_step(state, dict(batch, wav=wav16), torch.Generator().manual_seed(0))
    b = trainer.eval_step(state, as_f32, torch.Generator().manual_seed(0))
    assert torch.equal(a["valid_loss"], b["valid_loss"])
    assert not a["valid_loss"].requires_grad


def test_resume_continues_bit_identically(tmp_path):
    """Save mid-accumulation (after 3 micro-steps), restore into a fresh
    state and take the same 3 micro-steps as the original: the parameters,
    Adam's state and the step agree exactly."""
    trainer = _tiny_trainer(accumulate_grad_batches=2)
    state = trainer.create_state()
    batches = [_train_batch(seed=i) for i in range(6)]
    for i in range(3):
        trainer.train_step(state, batches[i], torch.Generator().manual_seed(i))
    ckpt = Checkpointer(CheckpointConfig(tmp_path / "ck"))
    ckpt.save(state.step, state.state_dict(), {"valid_loss": 1.0})

    other = _tiny_trainer(accumulate_grad_batches=2)
    resumed = other.create_state()
    resumed.load_state_dict(Checkpointer(CheckpointConfig(tmp_path / "ck")).restore())
    assert resumed.step == 3 and resumed.optimizer.mini_step == 1
    for tr, st in ((trainer, state), (other, resumed)):
        for i in range(3, 6):
            tr.train_step(st, batches[i], torch.Generator().manual_seed(i))
    assert resumed.step == state.step == 6
    a, b = state.state_dict(), resumed.state_dict()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert all(torch.equal(sa[i][m], sb[i][m]) for i in sa for m in sa[i])


def _state(v: float):
    return {"params": {"w": torch.full((4, 4), v)}, "step": int(v)}


def test_checkpoint_roundtrip(tmp_path):
    ckpt = Checkpointer(CheckpointConfig(directory=tmp_path / "ck"))
    ckpt.save(1, _state(3.0), {"valid_loss": 0.5})
    restored = ckpt.restore()
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 3.0))
    assert restored["step"] == 3


def test_checkpoint_keeps_best_k_and_latest(tmp_path):
    """As tests/test_checkpoint.py: best-1 AND always the last, not the
    best two by metric; a second Checkpointer on the directory agrees."""
    cfg = CheckpointConfig(directory=tmp_path / "ck", monitor="valid_loss",
                           save_top_k=1, save_last=True)
    ckpt = Checkpointer(cfg)
    for step, loss in [(1, 0.9), (2, 0.3), (3, 0.7), (4, 0.8)]:
        ckpt.save(step, _state(float(step)), {"valid_loss": loss})
    for c in (ckpt, Checkpointer(cfg)):
        assert c.best_step() == 2 and c.latest_step() == 4
        assert c.all_steps() == [2, 4]
    assert ckpt.restore(step=ckpt.best_step())["step"] == 2


def test_checkpoint_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(CheckpointConfig(directory=tmp_path / "empty")).restore()


def test_train_config_defaults_are_the_yaml():
    cfg = load_config(ROOT / "config.yaml", ["exp=train_diffusion_gh"])
    tr, cb, m = cfg.trainer, cfg.callbacks, cfg.model
    want = dict(
        seed=cfg.seed, sampling_rate=cfg.sampling_rate, length=cfg.length,
        max_steps=cfg.max_steps, embedding_mask_proba=cfg.embedding_mask_proba,
        batch_size=cfg.datamodule.batch_size,
        shuffle_size=cfg.datamodule.shuffle_size,
        wire_int16=cfg.datamodule.get("wire_int16", False),
        precision=str(tr.precision), gradient_clip_val=tr.gradient_clip_val,
        accumulate_grad_batches=tr.accumulate_grad_batches,
        log_every_n_steps=tr.log_every_n_steps,
        val_check_interval=tr.val_check_interval, val_batches=tr.val_batches,
        model_parallel=tr.model_parallel, fsdp=tr.fsdp,
        monitor=cb.model_checkpoint.monitor, mode=cb.model_checkpoint.mode,
        save_top_k=cb.model_checkpoint.save_top_k,
        save_last=cb.model_checkpoint.save_last,
        num_items=cb.audio_samples_logger.num_items,
        sampling_steps=tuple(cb.audio_samples_logger.sampling_steps),
        embedding_scale=cb.audio_samples_logger.embedding_scale,
        lr=m.lr, lr_beta1=m.lr_beta1, lr_beta2=m.lr_beta2, lr_eps=m.lr_eps,
        lr_weight_decay=m.lr_weight_decay, amodel=m.embedder.amodel)
    assert TrainConfig(**want) == TrainConfig()


def _cli_args(tmp_path, shard, *extra):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": TRAIN_UNET, "onsets_encoder": TRAIN_ENC}))
    return ["--train_path", shard, "--val_path", shard, "--logs_dir",
            str(tmp_path / "logs"), "--model_config", str(cfg), "--length",
            str(TRAIN_L), "--batch_size", "2", "--log_every_n_steps", "1",
            "--val_check_interval", "4", "--val_batches", "1",
            "--sampling_steps", "2", "--embedder", "none", *extra]


def _records(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_train_cli_end_to_end_and_resume(tmp_path):
    """4 micro-steps (2 updates) on the CPU: finite losses in
    metrics.jsonl, a validation, two sampled wavs and a checkpoint that
    reloads strictly; a second run with --ckpt resumes at step 4."""
    shard = make_shard(tmp_path, n_tracks=3, seconds=0.02)
    ta.reset_counts()
    state = train_diffusion.main(_cli_args(tmp_path, shard, "--max_steps", "4",
                                           "--device", "cpu"))
    assert state.step == 4 and state.optimizer.mini_step == 0
    # 3 attention calls per tiny forward: 4 train, 1 val, 2 sampler steps
    assert ta.flash_attention.plain_calls == 3 * (4 + 1 + 2)
    assert ta.flash_attention.plain_bwd_calls == 2 * 3 * 4
    (run,) = (tmp_path / "logs" / "runs").iterdir()
    recs = _records(run)
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert [r["step"] for r in recs if "train_loss" in r] == [1, 2, 3, 4]
    assert np.isfinite(losses).all()
    assert np.isfinite([r["valid_loss"] for r in recs if "valid_loss" in r]).all()
    assert sorted(p.name for p in (run / "media").iterdir()) == [
        "mel_spectrogram_0_2steps_step00000004.png",
        "mel_spectrogram_1_2steps_step00000004.png",
        "sample_0_step4.wav", "sample_1_step4.wav"]
    saved = Checkpointer(CheckpointConfig(run / "ckpts")).restore()
    assert saved["step"] == 4
    model = SyncFusionDiffusion.from_config(
        {"model": TRAIN_UNET, "onsets_encoder": TRAIN_ENC}, device="cpu")
    model.load_state_dict(saved["model"], strict=True)

    state = train_diffusion.main(_cli_args(tmp_path, shard, "--max_steps", "6",
                                           "--ckpt", str(run / "ckpts"),
                                           "--device", "cpu"))
    assert state.step == 6
    (second,) = {p for p in (tmp_path / "logs" / "runs").iterdir()} - {run}
    assert [r["step"] for r in _records(second) if "train_loss" in r] == [5, 6]


def test_sampling_failure_does_not_end_training(tmp_path, monkeypatch, caplog):
    """Fault 5: an exception in the sample logger's sampling is logged as a
    warning, as script/train_diffusion_model.py's ``_log_samples`` does; the
    run goes on past the validation and that step's checkpoint is saved."""
    shard = make_shard(tmp_path, n_tracks=3, seconds=0.02)

    def broken(*args, **kwargs):
        raise RuntimeError("the sampler broke")

    monkeypatch.setattr(SyncFusionDiffusion, "sample", broken)
    with caplog.at_level(logging.WARNING, logger=train_diffusion.log.name):
        state = train_diffusion.main(_cli_args(tmp_path, shard, "--max_steps", "5",
                                               "--device", "cpu"))
    assert state.step == 5
    (run,) = (tmp_path / "logs" / "runs").iterdir()
    assert Checkpointer(CheckpointConfig(run / "ckpts")).all_steps() == [4]
    assert [r.levelno for r in caplog.records
            if "sample logging failed at step 4" in r.getMessage()] == [logging.WARNING]
    assert "the sampler broke" in caplog.text


def test_generate_from_a_training_checkpoint(tmp_path):
    """4 tiny micro-steps through the training command line, then
    generate.py --ckpt with DPM++(2M) and DeepCache: the wav is, bitwise on
    the CPU, ``model.sample`` of the trained model held in memory."""
    shard = make_shard(tmp_path, n_tracks=3, seconds=0.02)
    state = train_diffusion.main(_cli_args(tmp_path, shard, "--max_steps", "4",
                                           "--device", "cpu"))
    (run,) = (tmp_path / "logs" / "runs").iterdir()
    times = tmp_path / "times.txt"
    times.write_text("0.001\n0.003\n")
    out = tmp_path / "foley.wav"
    generate.main(["--onset_times", str(times), "--model_config",
                   str(tmp_path / "tiny.json"), "--length", str(TRAIN_L),
                   "--ckpt", str(run / "ckpts"), "--sampler", "dpm",
                   "--deep_cache_interval", "2", "--deep_split", "2",
                   "--num_steps", "4", "--device", "cpu", "--output", str(out)])
    got, sr = read_wav(out)

    model = SyncFusionDiffusion.from_config(
        {"model": TRAIN_UNET, "onsets_encoder": TRAIN_ENC}, dtype=torch.bfloat16,
        device="cpu", seed=9)
    model.load_state_dict(state.model.state_dict(), strict=True)
    noise = torch.randn((1, TRAIN_L, 1), generator=torch.Generator().manual_seed(0))
    onsets = torch.from_numpy(generate.onset_track(np.loadtxt(times), TRAIN_L))
    want = model.sample(noise, onsets, torch.zeros((1, 1, 8)), num_steps=4,
                        embedding_scale=2.0, guidance_interval=(0.2, 0.8),
                        sampler="dpm", deep_cache_interval=2, deep_split=2)
    assert sr == generate.SR and got.shape == (1, TRAIN_L)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_array_equal(got[0], n(want)[0, :, 0])
    with pytest.raises(SystemExit):  # one source of parameters
        generate.main(["--onset_times", str(times), "--ckpt", str(run / "ckpts"),
                       "--params_npz", "params.npz"])


def test_train_cli_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_diffusion.main(_cli_args(tmp_path, "unused.tar"))


def test_train_cli_clap_is_not_substituted(tmp_path, monkeypatch):
    """``--embedder HTSAT-tiny`` (the default) builds CLAP with
    ``--clap_ckpt``, never zeros; ``none`` builds the zero embedder."""
    built = []

    class Stop(Exception):
        pass

    def recorder(amodel, features, device, checkpoint_path=None):
        built.append((amodel, features, str(device), checkpoint_path))
        raise Stop

    monkeypatch.setattr(train_diffusion, "build_embedder", recorder)
    args = _cli_args(tmp_path, "unused.tar", "--device", "cpu", "--clap_ckpt", "c.pt")
    for amodel in ("HTSAT-tiny", "none"):
        args[args.index("--embedder") + 1] = amodel
        with pytest.raises(Stop):
            train_diffusion.main(args)
    without = [a for a in args if a != "--embedder"]
    without.remove("none")
    with pytest.raises(Stop):
        train_diffusion.main(without)
    assert built == [("HTSAT-tiny", 8, "cpu", "c.pt"), ("none", 8, "cpu", "c.pt"),
                     ("HTSAT-tiny", 8, "cpu", "c.pt")]
    with pytest.raises(ValueError, match="HTSAT-tiny"):
        build_embedder("HTSAT-base", 8, "cpu")
    zero = build_embedder("none", 8, "cpu")
    assert torch.equal(zero.embed_audio(np.ones((3, 5, 1))), torch.zeros((3, 1, 8)))
    assert torch.equal(zero.embed_text(["a", "b"]), torch.zeros((2, 1, 8)))


class _ZeroEmbedder:
    def embed_audio(self, cond):
        return np.zeros((len(cond), 1, 16), np.float32)


def test_validate_reads_the_jax_val_stream(tmp_path, monkeypatch):
    """``validate`` reads the val dataset as script/train_diffusion_model.py
    does (no shift augmentation, no shard shuffle): the batches it hands
    ``eval_step`` are bit-equal to the JAX ``make_batches(val_fn, seed=0)``
    stream on one shard."""
    monkeypatch.setattr("syncfusion_tpu.core.cache.enable_compile_cache",
                        lambda *a, **k: None)  # leave this process's cache be
    monkeypatch.syspath_prepend(str(ROOT / "script"))
    jscript = importlib.import_module("train_diffusion_model")
    shard = make_shard(tmp_path, n_tracks=4, seconds=0.05, seed=3)
    cfg = load_config(ROOT / "config.yaml", [
        "exp=train_diffusion_gh", f"datamodule.val_dataset.path={shard}",
        "datamodule.batch_size=2", f"length={TRAIN_L}"])
    val_batches = 4
    want = list(itertools.islice(jscript.make_batches(
        instantiate(cfg.datamodule.val_dataset), cfg, seed=0,
        embedder=_ZeroEmbedder(), length=TRAIN_L), val_batches))

    seen = []

    class Recorder:
        def eval_step(self, state, batch, gen):
            seen.append({k: v.numpy() for k, v in batch.items()})
            return {"valid_loss": torch.tensor(0.0)}

    tcfg = TrainConfig(length=TRAIN_L, batch_size=2, val_batches=val_batches)
    train_diffusion.validate(Recorder(), None, tcfg, shard, _ZeroEmbedder(),
                             torch.device("cpu"))
    assert len(seen) == len(want) == val_batches
    for got, w in zip(seen, want):
        assert got.keys() == w.keys()
        for key in w:
            assert got[key].dtype == w[key].dtype
            np.testing.assert_array_equal(got[key], w[key])
