"""The port's multi-device layer against one process and the JAX package.

Ranks run as separate processes on the CPU, joined by gloo through a file
store (tests/torch_dist_workers.py, which imports no JAX): two ranks, and
four on a 2x2 (data, model) mesh, started once for the module and run side
by side with the single-process and JAX references computed here.  Each
join has its own timeout, so a hung rank fails the tests instead of the
suite's time limit.

Tolerances:
* the sampler's rows against the JAX sampler on the same noise: 2e-5 (the
  JAX package's multi-process test's), against one process 1e-5 (the CPU's
  f32 products sum in other orders at 2 rows than at 4: 2.1e-6 seen);
* training in f64 (a gradient that is 0 in exact arithmetic rounds far
  below Adam's eps there, where f32 can flip its update to ±lr): losses
  1e-10 relative, parameters within 1e-6 of the largest update, Adam's
  moments 1e-9 of the largest of their kind; the f32 loss against the JAX
  loss on the same draws 1e-5 relative (tests/test_torch_train.py's);
* synchronised BatchNorm in f32, as tests/test_parallel.py's
  ``test_onset_syncbn_mesh_equivalence``: loss 1e-5, logits 1e-4, running
  statistics 1e-5.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.core.mesh import MeshSpec as JaxMeshSpec
from syncfusion_tpu.core.mesh import mesh_for_batch as jax_mesh_for_batch
from syncfusion_tpu.data.shards import shard_for_process as jax_shard_for_process
from syncfusion_tpu.models.onset_net import VideoOnsetNet as JaxOnsetNet
from syncfusion_tpu.train.onset_trainer import OnsetTrainer as JaxOnsetTrainer
from syncfusion_tpu_torch.convert import onset_state_dict
from syncfusion_tpu_torch.core import mesh as tmesh
from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.data.shards import shard_for_process
import torch_dist_workers as w
from test_torch_deepcache_samplers import _jax_sample
from torch_port_helpers import ENC, UNET, L, make_shard, n, t, tiny_pair

TESTS = Path(__file__).resolve().parent
JOIN_TIMEOUT = 120
SAMPLER_CASES = {
    "ddim_band": dict(num_steps=2, embedding_scale=2.0, guidance_interval=(0.2, 0.8)),
    "dpm": dict(num_steps=2, embedding_scale=2.0, guidance_interval=(0.2, 0.8),
                sampler="dpm"),
    "deep_cache": dict(num_steps=3, embedding_scale=2.0, guidance_interval=(0.2, 0.8),
                       deep_cache_interval=2, deep_split=1),
}
SAMPLER_SEED = 3
ONSET_SHAPE = (8, 4, 32, 32, 3)  # tests/test_parallel.py's sync-BN batch


def _inputs(d: Path) -> tuple[dict, dict]:
    """(what the ranks read, the JAX side's pieces)."""
    rng = np.random.default_rng(0)
    jm, params, tm = tiny_pair(seed=3)
    on = np.zeros((4, L, 1), np.float32)
    on[:, [40, 333], 0] = 1.0
    on[1, 100, 0] = on[3, 7, 0] = 1.0
    emb = rng.standard_normal((4, 1, 16)).astype(np.float32)

    def train_batch(seed):
        r = np.random.default_rng(seed)
        onsets = np.zeros((4, L, 1), np.uint8)
        onsets[:, r.integers(0, L, size=8), 0] = 1
        return {"wav": r.uniform(-0.5, 0.5, (4, L, 1)),
                "onsets": onsets, "embedding": r.standard_normal((4, 1, 16))}

    onset_net = JaxOnsetNet(layers=(1, 1, 1, 1))
    onset_tr = JaxOnsetTrainer(onset_net)
    onset_state = onset_tr.init(jax.random.key(0), frames_shape=(1, *ONSET_SHAPE[1:]))
    frames = rng.normal(size=ONSET_SHAPE).astype(np.float32)
    labels = (rng.uniform(size=ONSET_SHAPE[:2]) > 0.7).astype(np.float32)
    items = [{"frames": f, "label": lab, "video_name": f"v{i}"} for i, (f, lab) in
             enumerate(zip(rng.normal(size=(7, 4, 32, 32, 3)).astype(np.float32),
                           (rng.uniform(size=(7, 4)) > 0.6).astype(np.float32)))]

    shard = make_shard(d / "shard")
    cfg = d / "tiny.json"
    cfg.write_text(json.dumps({"model": UNET, "onsets_encoder": ENC}))
    key = jax.random.key(5)
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    loss_batch = {"wav": rng.standard_normal((4, L, 1)).astype(np.float32),
                  "onsets": on, "embedding": emb,
                  "sigma": np.asarray(jax.random.uniform(k_sigma, (4,))),
                  "noise": np.asarray(jax.random.normal(k_noise, (4, L, 1)))}
    inputs = {
        "model_cfg": {"model": UNET, "onsets_encoder": ENC},
        "sampler_state": tm.state_dict(), "sampler_onsets": on,
        "sampler_embedding": emb, "sampler_seed": SAMPLER_SEED,
        "sampler_cases": SAMPLER_CASES,
        "train_batches": [train_batch(10 + i) for i in range(w.TRAIN_STEPS)],
        "loss_batch": loss_batch,
        "onset_state": onset_state_dict({"params": onset_state.params,
                                         "batch_stats": onset_state.batch_stats}),
        "onset_batch": {"frames": frames, "label": labels},
        "onset_items": items,
        "cli_args": ["--train_path", shard, "--val_path", shard, "--logs_dir",
                     str(d / "logs"), "--model_config", str(cfg), "--length", str(L),
                     "--batch_size", "2", "--max_steps", "2", "--val_check_interval",
                     "2", "--val_batches", "1", "--log_every_n_steps", "1",
                     "--sampling_steps", "2", "--embedder", "none", "--device", "cpu"],
    }
    jax_side = {"model": jm, "params": params, "key": key,
                "onset": (onset_tr, onset_state)}
    return inputs, jax_side


def _launch(d: Path) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(TESTS.parent), os.environ.get("PYTHONPATH", "")]))
    return [(f"{suite} rank {rank}", subprocess.Popen(
        [sys.executable, str(TESTS / "torch_dist_workers.py"), suite, str(rank),
         str(world), str(d)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)) for suite, world in (("w2", 2), ("w4", 4))
        for rank in range(world)]


def _join(procs) -> None:
    failed = []
    for name, p in procs:
        try:
            out, _ = p.communicate(timeout=JOIN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed.append(f"{name} timed out after {JOIN_TIMEOUT} s:\n{out[-3000:]}")
            continue
        if p.returncode:
            failed.append(f"{name} exited {p.returncode}:\n{out[-3000:]}")
    assert not failed, "\n\n".join(failed)


def _jax_references(inputs, jax_side) -> dict:
    jm, params = jax_side["model"], jax_side["params"]
    noise = torch.randn((4, L, 1), generator=torch.Generator().manual_seed(SAMPLER_SEED))
    on, emb = inputs["sampler_onsets"], inputs["sampler_embedding"]
    samples = {name: np.asarray(_jax_sample(jm, params, n(noise), on, emb, 0, **kw))[:, :, 0]
               for name, kw in SAMPLER_CASES.items()}
    b = inputs["loss_batch"]
    loss = float(jax.jit(lambda p: jm.loss(
        p, jax_side["key"], jnp.asarray(b["wav"]), jnp.asarray(b["onsets"]),
        jnp.asarray(b["embedding"])))(params))
    onset_tr, onset_state = jax_side["onset"]
    ob = inputs["onset_batch"]
    state, metrics, logits = onset_tr.train_step(onset_state, ob, np.uint32(0))
    stats = onset_state_dict({"params": state.params, "batch_stats": state.batch_stats})
    return {"noise": noise, "samples": samples, "loss": loss,
            "onset": {"loss": float(metrics["loss/train"]), "logits": np.asarray(logits),
                      "buffers": {k: v for k, v in stats.items()
                                  if k.endswith(("running_mean", "running_var"))}}}


def _world_one(inputs, noise, dp) -> dict:
    single = tmesh.Mesh.single()
    model = w.SyncFusionDiffusion.from_config(inputs["model_cfg"], device="cpu")
    model.load_state_dict(inputs["sampler_state"], strict=True)
    samples = {name: n(model.eval().sample(noise, t(inputs["sampler_onsets"]),
                                           t(inputs["sampler_embedding"]), **kw))[:, :, 0]
               for name, kw in SAMPLER_CASES.items()}
    return {"samples": samples, "dp": dp,
            "init": w.tiny_model(inputs["model_cfg"]).state_dict(),
            "onset": w.onset_step(inputs, single),
            "onset_eval": w.onset_evaluate(inputs, single)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, the single-process runs and the JAX side."""
    d = tmp_path_factory.mktemp("dist")
    inputs, jax_side = _inputs(d)
    dp = w.train_run(inputs, tmesh.Mesh.single(), save_dir=d / "ckpt_w1")
    inputs["ckpt_w1"] = str(d / "ckpt_w1")
    torch.save(inputs, d / "inputs.pt")
    procs = _launch(d)
    try:
        jax_ref = _jax_references(inputs, jax_side)
        one = _world_one(inputs, jax_ref["noise"], dp)
    finally:
        _join(procs)
    ranks = {suite: [torch.load(d / f"{suite}_{r}.pt", weights_only=False)
                     for r in range(world)] for suite, world in (("w2", 2), ("w4", 4))}
    resumed = {suite: w.train_run(inputs, tmesh.Mesh.single(), restore=d / f"ckpt_{suite}")
               for suite in ("w2", "w4")}
    return {"dir": d, "inputs": inputs, "jax": jax_ref, "one": one, "ranks": ranks,
            "resumed": resumed}


# -- the mesh rules, against the JAX functions ------------------------------

@pytest.mark.parametrize("world,batch", [(8, 16), (8, 6), (8, 1), (4, 6), (3, 9),
                                         (2, 5), (5, 10), (1, 4)])
def test_mesh_for_batch_matches_jax(world, batch):
    want = jax_mesh_for_batch(batch, devices=jax.devices()[:world]).shape["data"]
    assert tmesh.data_axis_for_batch(batch, world) == want


@pytest.mark.parametrize("spec", [(-1, 1), (-1, 2), (2, 4), (4, 2), (3, 1), (-1, 3)])
def test_meshspec_resolve_matches_jax(spec):
    try:
        want = JaxMeshSpec(*spec).resolve(8)
    except ValueError:
        with pytest.raises(ValueError, match="does not tile 8 devices"):
            tmesh.MeshSpec(*spec).resolve(8)
        return
    assert tmesh.MeshSpec(*spec).resolve(8) == want


@pytest.mark.parametrize("n_shards,count", [(5, 2), (4, 2), (7, 3), (2, 4)])
def test_shard_for_process_matches_jax(n_shards, count):
    shards = [f"shard_{i}.tar" for i in range(n_shards)]
    got = [shard_for_process(shards, p, count) for p in range(count)]
    assert got == [jax_shard_for_process(shards, p, count) for p in range(count)]
    flat = [s for part in got for s in part]
    assert sorted(flat) == sorted(shards) and len(set(flat)) == len(flat)


def test_single_process_mesh_needs_no_process_group():
    mesh = tmesh.create_mesh()
    assert (mesh.data, mesh.model, mesh.distributed) == (1, 1, False)
    assert mesh.rows(4) == slice(0, 4) and tmesh.local_batch_size(4, mesh) == 4
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.create_mesh(tmesh.MeshSpec(data=-1, model=2), world_size=2)


# -- the data-parallel sampler ---------------------------------------------

@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_rows_match_jax_and_one_process(runs, case):
    ranks = runs["ranks"]["w2"]
    indices = [r["sampler"][case][1] for r in ranks]
    assert sorted(np.concatenate(indices).tolist()) == [0, 1, 2, 3]
    assert not set(indices[0]) & set(indices[1])
    for r in ranks:
        rows, idx = r["sampler"][case]
        assert rows.shape == (2, L) and np.isfinite(rows).all()
        np.testing.assert_allclose(rows, runs["jax"]["samples"][case][idx], rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(rows, runs["one"]["samples"][case][idx], rtol=0,
                                   atol=1e-5)


# -- training ---------------------------------------------------------------

def _assert_states_agree(got: dict, want: dict, init: dict) -> None:
    """Parameters within 1e-6 of the largest update, Adam's moments within
    1e-9 of the largest of their kind (a bias ahead of a GroupNorm has a
    gradient of 0 in exact arithmetic: its moments, ~1e-19, are rounding
    alone), the same micro-step."""
    assert got["step"] == want["step"]
    gm, wm = got["model"], want["model"]
    assert gm.keys() == wm.keys() == init.keys()
    largest = max((wm[k] - init[k]).abs().max().item() for k in wm)
    assert largest > 0
    for k in wm:
        assert (gm[k] - wm[k]).abs().max().item() <= 1e-6 * largest, k
    gs, ws = got["optimizer"]["adamw"]["state"], want["optimizer"]["adamw"]["state"]
    assert gs.keys() == ws.keys() and ws
    for m in ("exp_avg", "exp_avg_sq"):
        scale = max(ws[k][m].abs().max().item() for k in ws)
        for k in ws:
            assert (gs[k][m] - ws[k][m]).abs().max().item() <= 1e-9 * scale, (k, m)


def _assert_run_agrees(got: dict, want: dict, init: dict) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-10, atol=0)
    _assert_states_agree(got["state"], want["state"], init)


@pytest.mark.parametrize("run", ["dp", "fsdp", "model_parallel"])
def test_training_matches_one_process(runs, run):
    """f64, accumulation 2, three optimizer updates: data parallelism at 2
    ranks, FSDP and model_parallel on the 2x2 mesh, against one process on
    the whole batch."""
    suite = "w2" if run == "dp" else "w4"
    ranks = runs["ranks"][suite]
    one = runs["one"]
    for r in ranks:  # every rank reports the global loss
        np.testing.assert_allclose(r[run]["losses"], one["dp"]["losses"], rtol=1e-10,
                                   atol=0)
    _assert_run_agrees(ranks[0][run], one["dp"], one["init"])


def test_fsdp_stores_large_parameters_sharded(runs):
    """Each rank stores half of every parameter of at least FSDP_MIN_SIZE
    elements that has a dimension divisible by 2, the whole of the others;
    without FSDP every rank stores everything."""
    sharded = 0
    for r in runs["ranks"]["w4"]:
        for name, (local, full) in r["fsdp"]["numel"].items():
            if full >= w.FSDP_MIN_SIZE:
                assert local == full // 2, name
                sharded += 1
            else:
                assert local == full, name
        assert all(a == b for a, b in r["model_parallel"]["numel"].values())
    assert sharded > 4 * 10


def test_data_parallel_loss_matches_jax(runs):
    """The f32 loss through the DDP-wrapped model at 2 ranks, each on its
    rows of the batch with the JAX key's sigma and noise, against the JAX
    ``loss`` on the whole batch."""
    got = [r["loss"] for r in runs["ranks"]["w2"]]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], runs["jax"]["loss"], rtol=1e-5)


@pytest.mark.parametrize("suite", ["w2", "w4"])
def test_checkpoint_restores_at_world_one(runs, suite):
    """A checkpoint saved mid-accumulation at 2 ranks (DDP) and at 4 (FSDP)
    restores into one process with strict=True; the resumed micro-steps
    agree with the ranks' own."""
    ckpt = Checkpointer(CheckpointConfig(runs["dir"] / f"ckpt_{suite}"))
    saved = ckpt.restore()
    assert saved["step"] == w.SAVE_AT and saved["optimizer"]["mini_step"] == 1
    # the gradients summed so far (None where the loss reaches no parameter)
    assert sum(g is not None for g in saved["optimizer"]["grads"]) > 10
    ranks_run = runs["ranks"][suite][0]["dp" if suite == "w2" else "fsdp"]
    resumed = runs["resumed"][suite]
    np.testing.assert_allclose(resumed["losses"], ranks_run["losses"][w.SAVE_AT:],
                               rtol=1e-10, atol=0)
    _assert_states_agree(resumed["state"], ranks_run["state"], runs["one"]["init"])


@pytest.mark.parametrize("suite", ["w2", "w4"])
def test_world_one_checkpoint_restores_on_ranks(runs, suite):
    """The reverse: a checkpoint saved mid-accumulation by one process
    resumes at 2 ranks and under FSDP at 4 as the process itself goes on."""
    run = runs["ranks"][suite][0]["dp_restored" if suite == "w2" else "fsdp_restored"]
    one = runs["one"]["dp"]
    np.testing.assert_allclose(run["losses"], one["losses"][w.SAVE_AT:], rtol=1e-10,
                               atol=0)
    _assert_states_agree(run["state"], one["state"], runs["one"]["init"])


def test_replicate_check_raises_on_divergent_ranks(runs):
    for r in runs["ranks"]["w2"]:
        assert r["divergent"]["raised"] and "differ across ranks" in r["divergent"]["raised"]


@pytest.mark.parametrize("suite,logs", [("w2", "logs"), ("w4", "logs_fsdp")])
def test_rank_one_writes_no_metrics(runs, suite, logs):
    """``train_diffusion.main`` at 2 ranks (DDP) and at 4 (``--model_parallel
    2 --fsdp true``): one run directory, whose metrics.jsonl rank 0 alone
    wrote (2 train lines and 1 validation), with the sample logger's clips
    and the checkpoint; the ranks end on equal parameters; a MetricLogger
    on a rank other than 0 writes no file."""
    d = runs["dir"]
    ranks = runs["ranks"][suite]
    assert [r["cli"]["step"] for r in ranks] == [2] * len(ranks)
    assert len({r["cli"]["digest"] for r in ranks}) == 1
    (run_dir,) = (d / logs / "runs").iterdir()
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(k for k in x if k not in ("_time", "step")) for x in lines] == [
        ["sec_per_step", "train_loss"], ["sec_per_step", "train_loss"], ["valid_loss"]]
    assert sorted(p.name for p in (run_dir / "media").glob("*.wav")) == [
        "sample_0_step2.wav", "sample_1_step2.wav"]
    assert Checkpointer(CheckpointConfig(run_dir / "ckpts")).all_steps() == [2]
    loggers = d / f"logger_{suite}"
    assert sorted(p.name for p in loggers.iterdir()) == ["rank0"]
    assert (loggers / "rank0" / "metrics.jsonl").exists()


# -- the onset trainer --------------------------------------------------------

def test_sync_batchnorm_matches_one_process_and_jax(runs):
    """One f32 step at 2 ranks against one process and the JAX trainer on
    the whole batch: the global loss, the gathered train-mode logits and
    every BatchNorm buffer after the step."""
    one, jax_ref = runs["one"]["onset"], runs["jax"]["onset"]
    for r in runs["ranks"]["w2"]:
        got = r["onset"]
        for want, loss_tol in ((one, 1e-5), (jax_ref, 1e-5)):
            assert abs(got["loss"] - want["loss"]) <= loss_tol
            np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=1e-4)
            assert got["buffers"].keys() == want["buffers"].keys()
            for k, v in want["buffers"].items():
                np.testing.assert_allclose(n(got["buffers"][k]), n(v), rtol=0, atol=1e-5,
                                           err_msg=k)


def test_onset_pos_weight_is_global(runs):
    """The same constant logits on every frame: the loss depends on the
    batch only through pos_weight, so the ranks' mean equals one process's
    only with the global count of positives."""
    got = np.mean([r["onset"]["pos_weight_loss"] for r in runs["ranks"]["w2"]])
    np.testing.assert_allclose(got, runs["one"]["onset"]["pos_weight_loss"], rtol=1e-6)


def test_onset_evaluate_pads_and_gathers(runs):
    """``train_onset.evaluate`` over 7 chunks in batches of 4 at 2 ranks (the
    last batch padded to 4 and the padding dropped) equals one process's."""
    want = runs["one"]["onset_eval"]
    for r in runs["ranks"]["w2"]:
        assert r["onset_eval"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r["onset_eval"][k], v, rtol=1e-6, err_msg=k)
