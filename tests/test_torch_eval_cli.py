"""The port's evaluation command lines end to end on the CPU, against the JAX
package: ``evaluate_diffusion`` (GT preparation, then generation and FAD,
against the JAX functions instantiated from the same exp/*.yaml with the
same overrides, on shared noise), ``evaluate_onset`` and
``evaluate_onset_baseline`` (both protocols) against the JAX scripts'
JSON lines, and ``video_to_foley --mux_video`` onto a video's own frames.

Tiny config of tests/test_diffusion_stack.py; tolerances as
tests/test_torch_eval.py states them.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from syncfusion_tpu.core.config import instantiate, load_config
from syncfusion_tpu.eval import fad as jfad
from syncfusion_tpu.eval import mux as jmux
from syncfusion_tpu.models.embedder import build_embedder as jax_build_embedder
from syncfusion_tpu.models.syncfusion import SyncFusionDiffusion as JaxSyncFusion
from syncfusion_tpu.ops.wav import read_wav
from syncfusion_tpu_torch import evaluate_diffusion, evaluate_onset, evaluate_onset_baseline
from syncfusion_tpu_torch import video_to_foley
from syncfusion_tpu_torch.convert import flatten
from syncfusion_tpu_torch.eval import mux as tmux
from syncfusion_tpu_torch.ops.wav import write_wav
from test_torch_eval import clicks, shared_noise, wav_dir
from torch_port_helpers import ENC, L, UNET, make_shard, to_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "script"))


def _flag(v) -> str:
    return json.dumps(list(v) if isinstance(v, tuple) else v).replace(" ", "")


# the tiny model as overrides of exp/model/diffusion.yaml, which become the
# port's model config (the yaml's other keys, e.g. fold_cap 256, kept); the
# JAX from_config reads no modulation_features or resnet_groups (1024 and 8)
TINY = ([f"+model.model.{k}={_flag(v)}" for k, v in UNET.items()
         if k not in ("modulation_features", "resnet_groups")]
        + [f"+model.onsets_encoder.{k}={_flag(v)}" for k, v in ENC.items()]
        + ["model.embedder=null"])


def jax_experiment(overrides: list, **kw):
    """The JAX evaluation script's experiment step: its config with
    ``overrides``, the dataset and experiment function instantiated from
    it; generation with the script's random init (key 0) and embedder."""
    cfg = load_config(ROOT / "config.yaml", overrides)
    exp_node = dict(cfg.experiment)
    dataset = instantiate(exp_node.pop("dataset"))()
    fn = instantiate(exp_node)
    if "generate_dataset" not in exp_node["_target_"]:
        return fn(dataset=dataset)
    model = JaxSyncFusion.from_config(cfg.model)
    params = model.init(jax.random.key(0), cfg.gen_length, batch=1)
    embedder = jax_build_embedder(cfg.model)
    fn(model=model, params=params, dataset=dataset, embed_audio=embedder.embed_audio,
       embed_text=embedder.embed_text)
    return cfg, params


def test_evaluate_diffusion_cli_end_to_end(tmp_path, monkeypatch, capsys):
    """prepare_gh_gt, then evaluate_gh_gen with --params_npz (the JAX
    script's own random init), --device cpu: the GT chunks bitwise, the
    clips within 2e-4 of the JAX package's (CFG 2.0 at every step, the
    prefix cut, 22.05 kHz; 3 clips at batch size 2), metrics.csv and the
    printed table with the FAD of the mel statistics."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shard = make_shard(tmp_path / "data", n_tracks=3)
    gt = tmp_path / "port-gt"
    evaluate_diffusion.main(["--exp", "prepare_gh_gt", "--dataset_path", shard,
                             "--experiment_path", str(gt), "--cut_length", "400"])
    jax_experiment(["exp=prepare_gh_gt", f"dataset_path={shard}",
                    f"experiment_path={tmp_path / 'jax-gt'}", "length=400"])
    names = sorted(p.name for p in gt.iterdir())
    assert len(names) == 3 and names == sorted(p.name for p in (tmp_path / "jax-gt").iterdir())
    for name in names:
        assert (gt / name).read_bytes() == (tmp_path / "jax-gt" / name).read_bytes()

    shared_noise(monkeypatch, 2, 2)
    size = [f"gen_length={L}", "cut_length=400", "experiment.num_steps=2",
            "experiment.batch_size=2"]
    cfg, params = jax_experiment(["exp=evaluate_gh_gen", f"dataset_path={shard}",
                                  f"experiment_path={tmp_path / 'jax-gen'}", *size, *TINY])
    npz = tmp_path / "params.npz"
    np.savez(npz, **{"/".join(k): v for k, v in flatten(to_numpy(params)).items()})
    model_cfg = tmp_path / "tiny.json"
    model_cfg.write_text(json.dumps(cfg.model))
    gen = tmp_path / "port-gen"
    capsys.readouterr()
    out = evaluate_diffusion.main([
        "--exp", "evaluate_gh_gen", "--dataset_path", shard, "--experiment_path", str(gen),
        "--gt_dir", str(gt), "--gen_length", str(L), "--cut_length", "400",
        "--num_steps", "2", "--batch_size", "2", "--params_npz", str(npz),
        "--model_config", str(model_cfg), "--device", "cpu"])
    clips = sorted(p.name for p in gen.glob("*.wav"))
    assert clips == names and out["generation"]["clips"] == 3
    for name in clips:
        got, sr = read_wav(gen / name)
        want, _ = read_wav(tmp_path / "jax-gen" / name)
        assert sr == 22050 and got.shape == want.shape == (1, 184)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    want = jfad.evaluate_fad(gen, gt)
    assert out["metrics"] == pytest.approx(want, rel=1e-6)
    csv = (gen / "metrics.csv").read_text().splitlines()
    assert csv[0] == "fad_melstats" and float(csv[1]) == pytest.approx(
        want["fad_melstats"], rel=1e-6)
    printed = capsys.readouterr().out.splitlines()[-2:]
    assert printed[0].split() == ["fad_melstats"] and float(printed[1]) == pytest.approx(
        want["fad_melstats"], rel=1e-5)


def test_evaluate_diffusion_refuses_what_it_cannot_run(tmp_path):
    """A torch checkpoint that is not a reference diffusion module's (no
    ``model.net.*`` keys) is refused by the compat loader; a run without a
    dataset by the presets."""
    ckpt = tmp_path / "epoch=784-valid_loss=0.008.ckpt"
    torch.save({"state_dict": {"onsets_encoder.x": torch.zeros(1)}}, ckpt)
    args = ["--exp", "evaluate_gh_gen", "--dataset_path", "x.tar", "--experiment_path",
            str(tmp_path / "gen"), "--device", "cpu"]
    with pytest.raises(ValueError, match="not a diffusion checkpoint"):
        evaluate_diffusion.load_model(evaluate_diffusion.parse_args(
            [*args, "--ckpt", str(ckpt)]), None, "cpu")
    with pytest.raises(SystemExit, match="needs --dataset_path"):
        evaluate_diffusion.main(["--exp", "evaluate_gh_gen", "--experiment_path", "x"])


def _jax_json(main, argv, capsys) -> dict:
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out.splitlines()[-1])


def test_evaluate_onset_cli_equals_jax(tmp_path, capsys):
    import evaluate_onset as jax_script

    gen = wav_dir(tmp_path / "gen", [0, 1, 2], sr=48000)
    tar = wav_dir(tmp_path / "tar", [0, 5, 2])
    for extra in ([], ["--delta", "0.2", "--multi_delta"]):
        argv = ["--gen_dir", str(gen), "--tar_dir", str(tar), *extra]
        want = _jax_json(jax_script.main, argv, capsys)
        got = _jax_json(evaluate_onset.main, argv, capsys)
        assert got == want and want["num_files"] == 2


def _mp4(path: Path, y: np.ndarray, frames: Path) -> None:
    wav = path.with_suffix(".wav")
    write_wav(wav, y, 22050)
    tmux.attach_audio_to_frames(frames, "f%d.jpg", wav, path, fps=15, n_frames=2)
    wav.unlink()


def test_evaluate_onset_baseline_cli_equals_jax(tmp_path, capsys):
    """The mp4 protocol (``{A}_to_{B}.mp4`` against ``{A}.mp4``) and the wav
    protocol (``{A}_to_{B}.wav`` against the processed root's audio)."""
    from PIL import Image

    import evaluate_onset_baseline as jax_script

    frames = tmp_path / "frames"
    frames.mkdir()
    for i in (1, 2):
        Image.fromarray(np.full((16, 16, 3), 40 * i, np.uint8)).save(frames / f"f{i}.jpg")
    gen, tar, root = (tmp_path / d for d in ("gen", "tar", "root"))
    gen.mkdir()
    tar.mkdir()
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for a, b, s in (("vidA", "vidB", 0), ("vidB", "vidC", 1), ("vidC", "vidA", 2)):
        _mp4(gen / f"{a}_to_{b}.mp4", 0.3 * clicks(s, 2.2), frames)
        _mp4(tar / f"{a}.mp4", 0.3 * clicks(s + 10, 2.2), frames)
        write_wav(wavs / f"{a}_to_{b}.wav", 0.3 * clicks(s, 2.2, 48000), 48000)
        (root / a / "audio").mkdir(parents=True)
        write_wav(root / a / "audio" / f"{a}.resampled.wav", 0.3 * clicks(s + 20, 2.5, 48000),
                  48000)
    _mp4(gen / "stray.mp4", clicks(3, 1.0), frames)  # no _to_: skipped
    for argv in (["--gen_dir", str(gen), "--tar_dir", str(tar)],
                 ["--gen_dir", str(gen), "--tar_dir", str(tar), "--multi_delta",
                  "--delta", "0.2", "--remove_head", "0.3"],
                 ["--gen_dir", str(wavs), "--gt_root", str(root)]):
        want = _jax_json(jax_script.main, argv, capsys)
        got = _jax_json(evaluate_onset_baseline.main, argv, capsys)
        assert got == want and want["num_files"] == 3
    with pytest.raises(SystemExit):
        evaluate_onset_baseline.main(["--gen_dir", str(gen)])


def test_video_to_foley_muxes_onto_the_video_frames(tmp_path, monkeypatch):
    """``--mux_video`` without ``--source_video``: the clip on the video
    directory's own frames, the bytes of the JAX muxer on the same frames
    and wav; the audio reads back as 16-bit PCM holds the wav."""
    from PIL import Image

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    video = tmp_path / "vid"
    (video / "frames").mkdir(parents=True)
    (video / "vid.metadata.json").write_text(json.dumps(
        {"processed": {"video_frame_rate": 5, "video_duration": 2.2}}))
    (video / "vid.times.csv").write_text("0.5,hit\n")
    rng = np.random.default_rng(1)
    for i in range(1, 13):
        Image.fromarray(rng.integers(0, 255, (120, 128, 3), np.uint8)).save(
            video / "frames" / f"vid.frame_{i:06d}.jpg")
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": UNET, "onsets_encoder": ENC}))
    out, mp4 = tmp_path / "foley.wav", tmp_path / "foley.mp4"
    video_to_foley.main([
        "--video_dir", str(video), "--onset_layers", "1", "1", "1", "1",
        "--model_config", str(cfg), "--length", str(L), "--num_steps", "2",
        "--output", str(out), "--mux_video", str(mp4), "--mux_fps", "5", "--device", "cpu"])
    want = jmux.attach_audio_to_frames(video / "frames", "vid.frame_%06d.jpg", out,
                                       tmp_path / "jax.mp4", fps=5, n_frames=1)
    assert mp4.read_bytes() == want.read_bytes()
    wav, _ = read_wav(out)
    audio = tmux.extract_video_audio(mp4, 48000)
    pcm = (np.clip(wav[0], -1.0, 1.0 - 1 / 32768.0) * 32768.0).astype(np.int16) / 32768.0
    assert audio.shape == (L,) and np.abs(audio - pcm).max() <= 1e-6
