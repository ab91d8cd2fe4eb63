"""Progressive distillation (``train/distill.py``, ``distill_diffusion``)
against the JAX package's ``syncfusion_tpu/train/distill.py``.

* The one-step target: one rotation by v* equals the two teacher rotations.
* ``loss``, unguided and guided (cfg_scale 2), on the tiny models of
  tests/test_diffusion_stack.py with a student and a teacher of different
  parameters, fed the JAX side's own draws (``split(key, 3)``: the grid
  index and the noise): the loss within 1e-5 relative, the student's
  gradients (unguided) within 1e-4 of the largest.
* One clip + AdamW student step in f64, the port's ``optimizer`` against
  the JAX distiller's own optax chain on the same distillation gradients
  (PERF §6: Adam steps in f32 are ill-conditioned).
* The halving schedule: the returned ``n`` against the JAX ``distill`` for
  several (start, final) pairs, and the rounds the port logs.
* ``distill_diffusion`` end to end on a tiny shard, on the CPU, and
  ``generate.py --ckpt`` on its output.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from syncfusion_tpu.train.distill import DistillConfig as JaxDistillConfig
from syncfusion_tpu.train.distill import ProgressiveDistiller as JaxDistiller
from syncfusion_tpu_torch import distill_diffusion, generate
from syncfusion_tpu_torch.convert import to_state_dict
from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops.wav import read_wav
from syncfusion_tpu_torch.train.distill import (
    DistillConfig,
    ProgressiveDistiller,
    _rotate,
)
from test_trainer import ENC as TRAIN_ENC
from test_trainer import UNET as TRAIN_UNET
from torch_port_helpers import L, make_shard, n, t, tiny_pair, to_numpy

TRAIN_L = 256


def test_one_step_target_reproduces_two_teacher_rotations():
    rng = np.random.default_rng(0)
    x, v1, v2 = (t(rng.standard_normal((2, 64, 1)).astype(np.float32)) for _ in range(3))
    phi, phi_h, phi_n = (torch.tensor(a) for a in (0.9, 0.7, 0.5))
    x_next = _rotate(_rotate(x, v1, phi_h - phi), v2, phi_n - phi_h)
    delta = phi_n - phi
    v_star = (x_next - torch.cos(delta) * x) / torch.sin(delta)
    np.testing.assert_allclose(n(_rotate(x, v_star, delta)), n(x_next), atol=1e-5)


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    onsets = np.zeros((b, L, 1), np.float32)
    onsets[:, rng.integers(0, L, size=8), 0] = 1.0
    return (0.5 * rng.standard_normal((b, L, 1)).astype(np.float32), onsets,
            rng.standard_normal((b, 1, 16)).astype(np.float32))


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_loss_and_student_gradients_match_jax(cfg_scale):
    """The loss within 1e-5 relative; unguided, every student gradient
    within 1e-4 of the largest (tests/test_torch_adp_compat.py's rule: the
    encoder's are ~1e-7, f32 noise of their sums).  The guided case holds
    the loss alone (its backward is the same student forward's)."""
    jm, teacher_params, teacher = tiny_pair(seed=0)
    _, student_params, student = tiny_pair(seed=1)
    wav, onsets, emb = _batch()
    key, steps = jax.random.key(4), 4
    jd = JaxDistiller(jm, JaxDistillConfig(cfg_scale=cfg_scale))

    def loss_fn(p):
        return jd.loss(p, teacher_params, key, jnp.asarray(wav), jnp.asarray(onsets),
                       jnp.asarray(emb), steps)

    guided = cfg_scale != 1.0
    if guided:
        want_loss = jax.jit(loss_fn)(student_params)
    else:
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(student_params)
    k_i, k_noise, _ = jax.random.split(key, 3)
    i = jax.random.randint(k_i, (wav.shape[0],), 0, steps)
    noise = jax.random.normal(k_noise, wav.shape, jnp.float32)
    td = ProgressiveDistiller(student, DistillConfig(cfg_scale=cfg_scale))
    got = td.loss(student, teacher.requires_grad_(False), t(wav), t(onsets), t(emb),
                  steps, i=t(n(i)), noise=t(n(noise)))
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=1e-5)
    if guided:  # the guided teacher is another target
        plain = ProgressiveDistiller(student).loss(
            student, teacher, t(wav), t(onsets), t(emb), steps, i=t(n(i)),
            noise=t(n(noise)))
        assert abs(plain.item() - got.item()) > 1e-6
        return
    got.backward()
    assert all(p.grad is None for p in teacher.parameters())
    want = to_state_dict(to_numpy(want_grads))
    params = dict(student.named_parameters())
    assert want.keys() == params.keys()
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        g = params[name].grad
        g = torch.zeros_like(w) if g is None else g
        assert (g - w).abs().max().item() <= 1e-4 * top, name


def test_one_student_step_matches_optax_in_f64():
    """The distillation gradients of the f64 port student, clipped and
    applied by the port's ``ProgressiveDistiller.optimizer`` and by the JAX
    distiller's ``tx`` (clip_by_global_norm, adamw b1 0.9, no decay) on the
    same f64 parameters: equal to 1e-12 after one step.  The gradient's
    norm is far above the clip (0.5), so the clip acts."""
    jm, _, teacher = tiny_pair(seed=0)
    _, _, student = tiny_pair(seed=1)
    teacher, student = teacher.double(), student.double()
    wav, onsets, emb = (a.astype(np.float64) for a in _batch(seed=3))
    td = ProgressiveDistiller(student, DistillConfig(lr=1e-3))
    gen = torch.Generator().manual_seed(5)
    i, noise = td.draws(t(wav), 4, gen)
    td.loss(student, teacher, t(wav), t(onsets), t(emb), 4, i=i, noise=noise).backward()
    before = {k: n(p).copy() for k, p in student.named_parameters()}
    grads = {k: n(p.grad).copy() for k, p in student.named_parameters()
             if p.grad is not None}
    assert np.sqrt(sum((g ** 2).sum() for g in grads.values())) > 1.0
    td.optimizer(student).step()
    tx = JaxDistiller(jm, JaxDistillConfig(lr=1e-3)).tx
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v) for k, v in before.items()}
        jg = {k: jnp.asarray(grads.get(k, np.zeros_like(v))) for k, v in before.items()}

        @jax.jit
        def step(g, p):
            updates, _ = tx.update(g, tx.init(p), p)
            return optax.apply_updates(p, updates)

        want = {k: np.asarray(v) for k, v in step(jg, jp).items()}
    for k, p in student.named_parameters():
        assert want[k].dtype == np.float64
        np.testing.assert_allclose(n(p), want[k], rtol=0, atol=1e-12, err_msg=k)
        if k in grads and np.abs(grads[k]).max() > 0:
            assert not np.allclose(n(p), before[k])


@pytest.mark.parametrize("start,final", [(64, 8), (9, 2), (8, 8), (3, 2)])
def test_halving_schedule_returns_the_jax_step_count(start, final):
    """With no optimizer steps a round is the halving alone: the returned
    step counts are the JAX distiller's."""
    jm, params, tm = tiny_pair(seed=0)
    _, want = JaxDistiller(jm, JaxDistillConfig(start, final, 0)).distill(
        params, batch_fn=None, key=jax.random.key(0))
    out, got = ProgressiveDistiller(tm, DistillConfig(start, final, 0)).distill(
        batch_fn=None)
    assert got == want and out is not tm


def test_rounds_train_a_copy_and_log_each_step():
    _, _, tm = tiny_pair(seed=0)
    wav, onsets, emb = _batch(seed=6)
    batch = {"wav": t(wav), "onsets": t(onsets), "embedding": t(emb)}
    logs = []
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    out, steps = ProgressiveDistiller(tm, DistillConfig(8, 2, 2, lr=1e-3)).distill(
        lambda step: batch, torch.Generator().manual_seed(0), logs.append, log_every=1)
    assert steps == 2
    assert [(m["round_steps"], m["step"]) for m in logs] == [(4, 0), (4, 1), (2, 0), (2, 1)]
    assert np.isfinite([m["distill_loss"] for m in logs]).all()
    assert all(v.equal(tm.state_dict()[k]) for k, v in before.items())
    assert any(not v.equal(out.state_dict()[k]) for k, v in before.items())


def test_distill_cli_end_to_end_and_generate_loads_its_output(tmp_path):
    """A teacher checkpoint in train_diffusion's layout, 2 rounds of 2 steps
    through the entry point on a tiny shard, then ``generate.py --ckpt`` on
    the written directory: its wav is, bitwise, ``sample`` of the distilled
    model at 2 steps."""
    shard = make_shard(tmp_path, n_tracks=3, seconds=0.02)
    cfg_path = tmp_path / "tiny.json"
    node = {"model": TRAIN_UNET, "onsets_encoder": TRAIN_ENC}
    cfg_path.write_text(json.dumps(node))
    teacher = SyncFusionDiffusion.from_config(node, device="cpu", seed=3)
    ckpts = tmp_path / "run" / "ckpts"
    Checkpointer(CheckpointConfig(ckpts)).save(7, {"step": 7, "model": teacher.state_dict()},
                                               {"valid_loss": 0.5})
    result = distill_diffusion.main([
        "--ckpt", str(ckpts), "--train_path", shard, "--model_config", str(cfg_path),
        "--length", str(TRAIN_L), "--batch_size", "2", "--embedder", "none",
        "--device", "cpu", "--log_every_n_steps", "1", "--distill.start_steps", "8",
        "--distill.final_steps", "2", "--distill.steps_per_round", "2",
        "--distill.lr", "1e-3"])
    assert result["num_steps"] == 2
    assert result["out"] == tmp_path / "run" / "distilled_2step"
    assert [(m["round_steps"], m["step"]) for m in result["log"]] == [
        (4, 0), (4, 1), (2, 0), (2, 1)]
    assert np.isfinite([m["distill_loss"] for m in result["log"]]).all()
    saved = Checkpointer(CheckpointConfig(result["out"])).restore()
    assert saved["num_steps"] == 2 and Checkpointer(
        CheckpointConfig(result["out"])).all_steps() == [7]

    times = tmp_path / "times.txt"
    times.write_text("0.001\n0.003\n")
    out = tmp_path / "foley.wav"
    generate.main(["--onset_times", str(times), "--model_config", str(cfg_path),
                   "--length", str(TRAIN_L), "--ckpt", str(result["out"]),
                   "--num_steps", "2", "--embedding_scale", "1.0", "--device", "cpu",
                   "--output", str(out)])
    got, _ = read_wav(out)
    model = SyncFusionDiffusion.from_config(node, dtype=torch.bfloat16, device="cpu",
                                            seed=9)
    model.load_state_dict(result["model"].state_dict(), strict=True)
    noise = torch.randn((1, TRAIN_L, 1), generator=torch.Generator().manual_seed(0))
    onsets = torch.from_numpy(generate.onset_track(np.loadtxt(times), TRAIN_L))
    want = model.sample(noise, onsets, torch.zeros((1, 1, 8)), num_steps=2,
                        embedding_scale=1.0, guidance_interval=(0.2, 0.8))
    np.testing.assert_array_equal(got[0], n(want)[0, :, 0])
