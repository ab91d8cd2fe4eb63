"""The CondFoleyGen baseline's training entry points on the CPU:
``train_codebook`` and ``train_transformer`` for an epoch on a tiny
processed root, their files under the JAX scripts' names, their resume,
``generate_audio`` from their checkpoints; and ``TransformerTrainer`` at two
ranks over gloo (DDP, and FSDP on a 1 x 2 mesh) against one process
(tests/torch_dist_workers.py's ``gpt`` suite, the file-store pattern of
tests/test_torch_parallel.py).

The config is tests/test_torch_condfoleygen_cli.py's ``TINY`` (an 80 x 160
mel to a 5 x 10 grid, a 1-layer GPT of width 16, 20 frames of 16 x 16) with
the training keys of tests/test_scripts_cli.py:273-302 (one epoch, batch 2)
and the discriminator joining at step 2; the perceptual term is off (LPAPS
is held against JAX in tests/test_torch_condfoleygen_train.py, and runs at
full width in chip_smoke.py's phase 18).  The multi-rank runs are in f64:
losses 1e-10 relative, parameters 1e-9 of the largest update.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from syncfusion_tpu.ops.wav import write_wav as jax_write_wav
from syncfusion_tpu_torch import generate_audio, train_codebook, train_transformer
from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.core.config import BaselineConfig
from syncfusion_tpu_torch.core.mesh import Mesh
from syncfusion_tpu_torch.data.baseline_dataset import (
    CondGreatestHitsWaveCondOnImage,
    GreatestHitsWaveDataset,
    baseline_loader,
)
from syncfusion_tpu_torch.models.vqgan.model import VQModel, wav_to_spec
from syncfusion_tpu_torch.ops.mel import mel01_to_waveform_gl
from syncfusion_tpu_torch.ops.wav import read_wav
from syncfusion_tpu_torch.train.vqgan_trainer import VQGANTrainer
import torch_dist_workers as w
from test_torch_condfoleygen_cli import TINY
from torch_port_helpers import n

TESTS = Path(__file__).resolve().parent
JOIN_TIMEOUT = 120
SR, FPS = 8000, 5  # tests/test_baseline_stack.py's fixture
RANK_LOSS_TOL = 1e-10
RANK_PARAM_TOL = 1e-9


def write_root(root: Path) -> Path:
    """tests/test_baseline_stack.py's ``gh_root``: 3 videos of 3 s at 8 kHz
    and 5 fps, onsets at 0.4, 1.2 and 2.1 s, random 20 x 20 frames; the
    split file lists all three."""
    rng = np.random.default_rng(0)
    names = ["vid_a", "vid_b", "vid_c"]
    for name in names:
        d = root / name
        (d / "audio").mkdir(parents=True)
        (d / "frames").mkdir()
        meta = {"processed": {"video_frame_rate": FPS, "video_duration": 3.0}}
        (d / f"{name}.metadata.json").write_text(json.dumps(meta))
        (d / f"{name}.times.csv").write_text("0.4,hit\n1.2,hit\n2.1,hit\n")
        wav = rng.normal(size=(1, 3 * SR)).astype(np.float32) * 0.1
        jax_write_wav(d / "audio" / f"{name}.resampled.wav", wav, SR)
        for i in range(1, 3 * FPS + 2):
            Image.fromarray(rng.integers(0, 255, (20, 20, 3), np.uint8)).save(
                d / "frames" / f"{name}.frame_{i:06d}.jpg")
    (root / "train.txt").write_text("\n".join(names) + "\n")
    return root / "train.txt"


def write_config(path: Path, root: Path, split: Path, logs: Path) -> Path:
    cfg = json.loads(json.dumps(TINY))
    cfg["model"]["lossconfig"] = {"disc_start": 2, "perceptual_weight": 0.0}
    cfg["data"].update(root_dir=str(root), train_split_file_path=str(split),
                       val_split_file_path=str(split), test_split_file_path=str(split))
    cfg.update(seed=3, logs_dir=str(logs), trainer={"max_epochs": 1})
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A codebook run and a transformer run on it, one epoch each (4 steps of
    batch 2 over the 9 onsets)."""
    d = tmp_path_factory.mktemp("baseline_train")
    split = write_root(d / "gh")
    cb_cfg = write_config(d / "codebook.json", d / "gh", split, d / "logs_cb")
    tr_cfg = write_config(d / "transformer.json", d / "gh", split, d / "logs_tr")
    cb = train_codebook.main(["-c", str(cb_cfg), "--device", "cpu"])
    tr = train_transformer.main(["-c", str(tr_cfg), "--vq_ckpt", str(cb["run_dir"] / "ckpts"),
                                 "--device", "cpu"])
    return {"dir": d, "cb_cfg": cb_cfg, "tr_cfg": tr_cfg, "cb": cb, "tr": tr}


def media_names(run_dir: Path) -> set:
    return {p.name for p in (run_dir / "media").iterdir()}


def metrics_of(run_dir: Path) -> list:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_train_codebook_cli_writes_the_jax_scripts_files(runs):
    run_dir, state = runs["cb"]["run_dir"], runs["cb"]["state"]
    assert state.step == 4
    step = f"step{4:08d}"
    assert media_names(run_dir) == {f"reconstructions_{step}.png"} | {
        f"val_{k}_{i}_{step}.wav" for k in ("inputs", "reconstructions") for i in (0, 1)}
    for p in (run_dir / "media").glob("*.wav"):
        wav, sr = read_wav(p)
        assert sr == 22050 and wav.shape == (1, 512 + 256 * 159) and np.isfinite(wav).all()
    (val,) = metrics_of(run_dir)  # no step reached 50: validation only
    assert val["step"] == 4 and set(val) == {"_time", "step", "val/rec_loss",
                                             "val/codebook_usage"}
    assert np.isfinite(val["val/rec_loss"]) and 0 < val["val/codebook_usage"] <= 1
    ckpt = Checkpointer(CheckpointConfig(run_dir / "ckpts", monitor="val/rec_loss"))
    assert ckpt.all_steps() == [4] and ckpt.best_step() == 4
    saved = ckpt.restore()
    assert set(saved) == {"step", "vq", "disc", "opt_g", "opt_d"}
    assert torch.equal(saved["vq"]["quantize.embedding"], state.model.quantize.embedding)
    assert saved["disc"]["bn1.running_var"].ne(1.0).any()  # D ran in train mode
    assert int(saved["opt_d"]["state"][0]["step"]) == 4  # stepped on zero gradients too
    assert json.loads((run_dir / "config.json").read_text())["lossconfig"]["disc_start"] == 2


def test_train_codebook_resume_continues_the_saved_state(runs, tmp_path):
    """``--ckpt_path`` restores the run's state and takes epoch 0's batches
    again: the same as that state stepped through them by hand."""
    ckpts = runs["cb"]["run_dir"] / "ckpts"
    cfg_path = write_config(tmp_path / "resume.json", runs["dir"] / "gh",
                            runs["dir"] / "gh" / "train.txt", tmp_path / "logs")
    out = train_codebook.main(["-c", str(cfg_path), "--ckpt_path", str(ckpts),
                               "--device", "cpu"])
    assert out["state"].step == 8
    assert Checkpointer(CheckpointConfig(out["run_dir"] / "ckpts")).all_steps() == [8]

    cfg = BaselineConfig.from_files([cfg_path])
    trainer = VQGANTrainer(VQModel(**dataclasses.asdict(cfg.model)), cfg.lossconfig,
                           learning_rate=cfg.vq_learning_rate)
    state = trainer.init(0)
    state.load_state_dict(Checkpointer(CheckpointConfig(ckpts)).restore())
    d = cfg.data
    ds = GreatestHitsWaveDataset(d.root_dir, d.train_split_file_path,
                                 sample_rate=d.sample_rate, rand_shift=True)
    for batch in baseline_loader(ds, 2, shuffle=True, drop_last=True, seed=0):
        trainer.train_step(state, wav_to_spec(torch.from_numpy(batch["image"]))[:, None])
    got = out["state"].state_dict()
    for part in ("vq", "disc"):
        want = state.state_dict()[part]
        assert got[part].keys() == want.keys()
        for k in want:
            assert torch.equal(got[part][k], want[k]), (part, k)


def test_train_transformer_cli_loads_the_codebook_and_writes_the_jax_scripts_files(runs):
    run_dir, state = runs["tr"]["run_dir"], runs["tr"]["state"]
    assert state.step == 4
    step = f"step{4:08d}"
    assert media_names(run_dir) == {f"val_{step}.png"} | {
        f"val_att_{k}_{step}.png" for k in ("half", "nopix", "det")} | {
        f"val_samples_nopix_{i}_{step}.wav" for i in (0, 1)}
    (val,) = metrics_of(run_dir)
    assert val["step"] == 4 and np.isfinite(val["val/loss"])
    saved = Checkpointer(CheckpointConfig(run_dir / "ckpts")).restore()
    assert set(saved) == {"step", "model", "optimizer"}
    assert not any(k.startswith(("vq.", "video.")) for k in saved["model"])  # frozen: out
    assert set(saved["model"]) == set(state.model.state_dict())
    codebook = Checkpointer(CheckpointConfig(runs["cb"]["run_dir"] / "ckpts")).restore()
    model = generate_audio.build_model(BaselineConfig.from_files([runs["tr_cfg"]]), "cpu",
                                       seed=3)
    generate_audio.load_runs(model, vq_ckpt=runs["cb"]["run_dir"] / "ckpts")
    for k, v in codebook["vq"].items():
        assert torch.equal(model.vq.state_dict()[k], v), k
    groups = saved["optimizer"]["adamw"]["param_groups"]
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
    assert all(int(s["step"]) == 4 for s in saved["optimizer"]["adamw"]["state"].values())


def test_train_transformer_resume_and_generate_audio_from_the_runs(runs, tmp_path):
    tr_ckpts = runs["tr"]["run_dir"] / "ckpts"
    vq_ckpts = runs["cb"]["run_dir"] / "ckpts"
    cfg_path = write_config(tmp_path / "resume.json", runs["dir"] / "gh",
                            runs["dir"] / "gh" / "train.txt", tmp_path / "logs")
    out = train_transformer.main(["-c", str(cfg_path), "--vq_ckpt", str(vq_ckpts),
                                  "--ckpt_path", str(tr_ckpts), "--device", "cpu"])
    assert out["state"].step == 8
    saved = Checkpointer(CheckpointConfig(tr_ckpts)).restore()
    moved = out["state"].model.state_dict()
    assert any(not torch.equal(moved[k], v) for k, v in saved["model"].items())

    gen = tmp_path / "gen"
    summary = generate_audio.main(["--gh_testset", "-c", str(runs["tr_cfg"]),
                                   "--vq_ckpt", str(vq_ckpts),
                                   "--transformer_ckpt_path", str(tr_ckpts), "--top_k", "16",
                                   "--batch_size", "2", "--data_to_use", "0.7",
                                   "--audio_only", "--output_dir", str(gen),
                                   "--device", "cpu"])
    assert summary["clips"] == 6
    cfg = BaselineConfig.from_files([runs["tr_cfg"]])
    model = generate_audio.build_model(cfg, "cpu", seed=cfg.seed)
    generate_audio.load_runs(model, vq_ckpts, tr_ckpts)
    for k, v in saved["model"].items():
        assert torch.equal(model.gpt.state_dict()[k], v), k
    d = cfg.data
    ds = CondGreatestHitsWaveCondOnImage(
        d.root_dir, d.test_split_file_path, data_to_use=0.7, sample_rate=d.sample_rate,
        rand_shift=False, p_outside_cond=1.0, frame_size=d.frame_size)
    batch = next(baseline_loader(ds, 2))
    with torch.no_grad():
        grid = model.sample(wav_to_spec(torch.from_numpy(batch["cond_image"]))[:, None],
                            torch.from_numpy(batch["feature"]),
                            torch.Generator().manual_seed(0), top_k=16)
        want = n(mel01_to_waveform_gl(generate_audio.spec01(model, grid), 22050))
    for i in range(2):
        wav, sr = read_wav(next((gen / "generated_audio").glob(f"*_{i}.wav")))
        assert sr == 22050
        np.testing.assert_array_equal(wav[0], want[i])

    with pytest.raises(SystemExit):
        generate_audio.main(["-c", str(runs["tr_cfg"]), "--params_npz", "x.npz",
                             "--vq_ckpt", str(vq_ckpts), "--device", "cpu"])


def test_trainers_refuse_to_run_without_a_card(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_codebook.main(["-c", str(runs["cb_cfg"])])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_transformer.main(["-c", str(runs["tr_cfg"])])


def test_transformer_trainer_ddp_and_fsdp_match_one_process(tmp_path):
    """Two ranks over gloo: DDP (2 rows each of a batch of 4) and FSDP on a
    1 x 2 mesh (the GPT, its AdamW state and the frozen stages sharded), two
    steps and the val loss each, against one process, f64."""
    rng = np.random.default_rng(40)

    def batch():
        return {"spec": torch.from_numpy(np.clip(0.5 * rng.standard_normal((4, 1, 20, 40)),
                                                 -1, 1)),
                "cond_spec": torch.from_numpy(np.clip(
                    0.5 * rng.standard_normal((4, 1, 20, 40)), -1, 1)),
                "frames": torch.from_numpy(rng.standard_normal((4, 4, 16, 16, 3)))}

    inputs = {"gpt_batches": [batch(), batch()]}
    torch.save(inputs, tmp_path / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(TESTS.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(TESTS / "torch_dist_workers.py"), "gpt",
                               str(rank), "2", str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for rank in range(2)]
    try:
        one = w.gpt_run(inputs, Mesh.single())
    finally:
        failed = []
        for rank, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=JOIN_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failed.append(f"rank {rank} timed out:\n{out[-3000:]}")
                continue
            if p.returncode:
                failed.append(f"rank {rank} exited {p.returncode}:\n{out[-3000:]}")
        assert not failed, "\n\n".join(failed)
    ranks = [torch.load(tmp_path / f"gpt_{r}.pt", weights_only=False) for r in range(2)]
    start = w.gpt_model().gpt.state_dict()
    scale = max(float((one["state"]["model"][k] - v).abs().max()) for k, v in start.items())
    assert scale > 0
    for mode in ("ddp", "fsdp"):
        assert ranks[0][mode]["fsdp"] == (mode == "fsdp")
        for r in ranks:
            for got, want in zip(r[mode]["losses"] + [r[mode]["val"]],
                                 one["losses"] + [one["val"]]):
                assert abs(got - want) <= RANK_LOSS_TOL * abs(want), mode
        sd = ranks[0][mode]["state"]
        assert sd["step"] == one["state"]["step"] == 2
        assert sd["model"].keys() == one["state"]["model"].keys()
        for k, v in one["state"]["model"].items():
            assert float((sd["model"][k] - v).abs().max()) <= RANK_PARAM_TOL * scale, (mode, k)
        assert ranks[1][mode]["state"] is None
