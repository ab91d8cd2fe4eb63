"""The CondFoleyGen baseline's data, AV transformer, exporter and entry
point on the CPU: the port's datasets against the JAX package's on the
``gh_root`` fixture; ``AVCondTransformer`` (video features, cond codes,
``sample`` and ``sample_long`` at top-k 1, the decoded grid) against the
JAX one on a batch of it; ``script/export_params_npz.py`` from JAX checkpoints (the baseline's
codebook and transformer runs; a diffusion run) into the port, which loads
the result strictly and generates what the JAX package generates;
``generate_audio.main`` writing the reference's artifact set, scored by
``evaluate_onset_baseline.main``.

The baseline config is the tiny one of tests/test_scripts_cli.py (an 80 x
160 mel to a 5 x 10 grid, a 1-layer GPT of width 16, 20 frames of 16 x 16),
as JSON, which both packages read.  Tolerances as in
tests/test_torch_condfoleygen.py (TOL, GAP_TOL); the diffusion sample as
tests/test_torch_sampler.py (2e-4 absolute after the sampler's steps).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.core.checkpoint import CheckpointConfig as JaxCkptConfig
from syncfusion_tpu.core.checkpoint import Checkpointer as JaxCheckpointer
from syncfusion_tpu.core.config import Config
from syncfusion_tpu.data import baseline_dataset as jds
from syncfusion_tpu.models.transformer_av import AVCondTransformer as JaxAVCondTransformer
from syncfusion_tpu.models.vqgan.model import wav_to_spec as jax_wav_to_spec
from syncfusion_tpu.train.diffusion_trainer import DiffusionTrainer
from syncfusion_tpu.train.transformer_trainer import TransformerTrainer
from syncfusion_tpu.train.vqgan_trainer import VQGANTrainer
from syncfusion_tpu_torch import evaluate_onset_baseline, generate, generate_audio
from syncfusion_tpu_torch.convert import av_transformer_state_dict, flatten
from syncfusion_tpu_torch.core.config import BaselineConfig
from syncfusion_tpu_torch.data import baseline_dataset as tds
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.models.transformer_av import column_major, column_major_inverse
from syncfusion_tpu_torch.models.vqgan.model import wav_to_spec
from syncfusion_tpu_torch.ops.mel import mel01_to_waveform_gl
from syncfusion_tpu_torch.ops.wav import read_wav
from test_baseline_stack import SR as FIXTURE_SR
from test_baseline_stack import gh_root  # noqa: F401  (fixture)
from test_torch_condfoleygen import (
    TOL,
    assert_same_codes,
    assert_same_tokens,
    jax_distances,
    rel,
)
from torch_port_helpers import ENC, L, UNET, n, t, tiny_pair, to_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "script"))
import export_params_npz  # noqa: E402  (the exporter: a JAX script)
from train_codebook import build_vq_model  # noqa: E402
from train_transformer import build_model  # noqa: E402

TINY = {
    "model": {"embed_dim": 16, "n_embed": 32,
              "ddconfig": {"ch": 8, "ch_mult": [1, 1, 2, 2, 4], "num_res_blocks": 1,
                           "attn_resolutions": [10], "resolution": 160,
                           "z_channels": 16}},
    "transformer": {"vocab_size": 32, "block_size": 128, "n_layer": 1, "n_head": 2,
                    "n_embd": 16},
    "n_frames": 20,
    "data": {"batch_size": 2, "sample_rate": 22050, "chunk_length_in_seconds": 2.0,
             "frame_size": 16},
}


def tiny_config(tmp_path, root) -> Path:
    cfg = json.loads(json.dumps(TINY))
    cfg["data"].update(root_dir=str(root), test_split_file_path=str(root / "train.txt"))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return path


def _cond_kwargs(**kw):
    return dict(chunk_length_in_seconds=1.0, rand_shift=False, frame_size=16, **kw)


@pytest.mark.parametrize("sample_rate", [FIXTURE_SR, 22050])  # as stored; resampled
def test_datasets_and_loader_match_jax(gh_root, sample_rate):  # noqa: F811
    split = str(gh_root / "train.txt")
    for shift, seed in ((True, 1), (False, 0)):
        kw = dict(sample_rate=sample_rate, chunk_length_in_seconds=1.0,
                  rand_shift=shift, seed=seed)
        a = tds.GreatestHitsWaveDataset(str(gh_root), split, **kw)
        b = jds.GreatestHitsWaveDataset(str(gh_root), split, **kw)
        assert len(a) == len(b) == 9
        for i in range(len(a)):
            ia, ib = a[i], b[i]
            assert ia["file_path_wav_"] == ib["file_path_wav_"]
            np.testing.assert_array_equal(ia["image"], ib["image"])
    for p_out, seed in ((1.0, 3), (0.0, 4)):
        kw = _cond_kwargs(sample_rate=sample_rate, p_outside_cond=p_out, seed=seed)
        a = tds.CondGreatestHitsWaveCondOnImage(str(gh_root), split, **kw)
        b = jds.CondGreatestHitsWaveCondOnImage(str(gh_root), split, **kw)
        batches = zip(tds.baseline_loader(a, 4), jds.baseline_loader(b, 4))
        for ba, bb in batches:
            assert ba.keys() == bb.keys()
            for key in ba:
                if isinstance(ba[key], np.ndarray):
                    np.testing.assert_array_equal(ba[key], bb[key], err_msg=key)
                else:
                    assert ba[key] == bb[key], key
        assert ba["feature"].shape[1:] == (10, 16, 16, 3)


def _save(directory, state):
    ckpt = JaxCheckpointer(JaxCkptConfig(directory=directory))
    ckpt.save(1, state, {"valid_loss": 0.5}, blocking=True)
    ckpt.close()


@pytest.fixture(scope="module", autouse=True)
def jax_init_once():
    """The JAX baseline's ``init`` runs the full-width R(2+1)D-18 (its
    video net has no tiny form): computed once in this module for each
    model, key and ``n_frames``, and handed back (a new top-level dict) to
    a later call with the same three, the exporter's among them."""
    real, done = JaxAVCondTransformer.init, []

    def init(self, key, n_frames=60):
        data = np.asarray(jax.random.key_data(key))
        for model, kd, nf, params in done:
            if model == self and nf == n_frames and np.array_equal(kd, data):
                return dict(params)
        params = real(self, key, n_frames)
        done.append((self, data, n_frames, params))
        return dict(params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxAVCondTransformer, "init", init)
        yield


@pytest.fixture(scope="module")
def baseline():
    """The tiny JAX baseline (its init from key 0), its generation at top-k 1
    as one jitted function (also giving the VQ latent, the cond tokens and
    the video features), and the port with the same parameters."""
    cfg = Config.wrap(TINY)
    model = build_model(cfg)
    params = model.init(jax.random.key(0), n_frames=20)

    @jax.jit
    def pipeline(params, cond_spec, frames, key):
        grid = model.sample(params, cond_spec, frames, key, top_k=1)
        spec01 = (model.decode_grid(params, grid)[..., 0] + 1.0) / 2.0
        latent = model.first_stage.model.apply(
            params["vq"], cond_spec, method=lambda m, x: m.quant_conv(m.encoder(x)))
        return (grid, spec01, latent, model.encode_to_z(params, cond_spec),
                model.encode_to_c(params, frames))

    port = generate_audio.build_model(BaselineConfig.from_dict(TINY), "cpu", seed=None)
    port.load_state_dict(av_transformer_state_dict(to_numpy(params)), strict=True)
    return {"cfg": cfg, "model": model, "params": params, "pipeline": pipeline,
            "port": port}


def first_batch(root):
    """The first batch that ``generate_audio`` draws from the fixture (2 of
    its 3 videos)."""
    ds = tds.CondGreatestHitsWaveCondOnImage(
        str(root), str(root / "train.txt"), data_to_use=0.7, sample_rate=22050,
        chunk_length_in_seconds=2.0, rand_shift=False, p_outside_cond=1.0, frame_size=16)
    return next(tds.baseline_loader(ds, 2))


def run_pipeline(baseline, params, batch):
    cond_spec = jax_wav_to_spec(jnp.asarray(batch["cond_image"]))[..., None]
    out = baseline["pipeline"](params, cond_spec, jnp.asarray(batch["feature"]),
                               jax.random.key(0))
    return (np.asarray(cond_spec), *(np.asarray(a) for a in out))


def gpt_logits(baseline, params, feats):
    """The JAX GPT's next-token logits over the sampled half, teacher-forced."""
    def logits_of(buf):
        out = baseline["model"].gpt.apply(params["gpt"], jnp.asarray(buf[:, :-1]),
                                          jnp.asarray(feats))
        return np.asarray(out)[:, feats.shape[1] + 50 - 1:]
    return logits_of


def test_av_transformer_sample_and_sample_long_match_jax(baseline, gh_root):  # noqa: F811
    params, port = baseline["params"], baseline["port"]
    batch = first_batch(gh_root)
    cond_spec, grid_j, spec01_j, latent_j, zp_j, feats_j = run_pipeline(baseline, params,
                                                                        batch)
    with torch.no_grad():
        feats = port.encode_to_c(t(batch["feature"]))
        codes = port.vq.encode_indices(t(cond_spec).permute(0, 3, 1, 2))
        grid = port.sample(t(cond_spec).permute(0, 3, 1, 2), t(batch["feature"]),
                           torch.Generator().manual_seed(0), top_k=1)
        spec = port.decode_grid(t(grid_j).long())
    assert feats.shape == (2, 20, 512) and rel(feats, feats_j) <= TOL
    assert_same_codes(codes, column_major_inverse(t(zp_j)), jax_distances(
        params["vq"]["params"]["quantize"]["embedding"], latent_j))
    assert grid.shape == (2, 5, 10)
    assert_same_tokens(np.concatenate([zp_j, n(column_major(grid))], 1),
                       np.concatenate([zp_j, n(column_major(t(grid_j)))], 1),
                       gpt_logits(baseline, params, feats_j), 50)
    assert rel(spec[:, 0], 2.0 * spec01_j - 1.0) <= TOL

    # two patches of 10 columns, each on the 10 columns before it and its
    # slice of the features (0.5 frames a column: 10 frames from 5, 10)
    cond_grid = np.asarray(column_major_inverse(t(zp_j)))
    model = baseline["model"]
    long_j = model.sample_long(params, cond_grid, feats_j, 2, jax.random.key(3), top_k=1)
    long_t = port.sample_long(t(cond_grid).long(), t(feats_j), 2,
                              torch.Generator().manual_seed(0), top_k=1)
    assert long_t.shape == (2, 5, 20)

    def long_logits(seq):
        context, out = zp_j, []
        for patch, f_start in ((seq[:, :50], 5), (seq[:, 50:], 10)):
            buf = np.concatenate([context, patch], 1)
            logits = model.gpt.apply(params["gpt"], jnp.asarray(buf[:, :-1]),
                                     jnp.asarray(feats_j[:, f_start:f_start + 10]))
            out.append(np.asarray(logits)[:, 10 + 50 - 1:])
            context = buf[:, -50:]
        return np.concatenate(out, 1)

    assert_same_tokens(column_major(long_t), n(column_major(t(long_j))), long_logits, 0)


@pytest.fixture(scope="module")
def baseline_runs(baseline, tmp_path_factory):
    """A tiny codebook run and a transformer run: the JAX trainers' states,
    the codebook's from another key than the model's init, the GPT's
    parameters moved off the init."""
    tmp = tmp_path_factory.mktemp("runs")
    model, params = baseline["model"], baseline["params"]
    vq_state = VQGANTrainer(model=build_vq_model(baseline["cfg"]), lpaps_params={}).init(
        jax.random.key(5))
    _save(tmp / "vq", vq_state)
    trained = jax.tree_util.tree_map(lambda a: 1.5 * a + 0.01, params["gpt"])
    gpt_state = TransformerTrainer(model).create_state({**params, "gpt": trained})
    _save(tmp / "gpt", gpt_state)
    return {"dir": tmp, "states": (vq_state, gpt_state)}


def test_exporter_gives_the_jax_scripts_tree_and_the_port_its_output(
        baseline, baseline_runs, gh_root, tmp_path):  # noqa: F811
    runs = baseline_runs["dir"]
    cfg_path = tiny_config(tmp_path, gh_root)
    out = export_params_npz.main(["--kind", "condfoleygen", "-c", str(cfg_path),
                                  "--vq_ckpt", str(runs / "vq"),
                                  "--transformer_ckpt_path", str(runs / "gpt"),
                                  "--out", str(tmp_path / "baseline.npz")])

    # the tree as script/generate_audio.py assembles it: restored into
    # templates of the trainers' states (the runs' own, which have their
    # structure)
    vq_template, gpt_template = baseline_runs["states"]
    params = dict(baseline["params"])
    params["vq"] = JaxCheckpointer(JaxCkptConfig(directory=runs / "vq")).restore(
        vq_template).params
    params["gpt"] = JaxCheckpointer(JaxCkptConfig(directory=runs / "gpt")).restore(
        gpt_template).gpt_params
    want = {"/".join(k): v for k, v in flatten(to_numpy(params)).items()}
    with np.load(out) as npz:
        got = dict(npz)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(  # the runs' parameters, not the init's
        got["gpt/params/head/kernel"],
        1.5 * np.asarray(baseline["params"]["gpt"]["params"]["head"]["kernel"]) + 0.01)

    # the port loads it strictly and samples, at top-k 1, the JAX tokens
    port = generate_audio.build_model(BaselineConfig.from_files([cfg_path]), "cpu",
                                      seed=None)
    generate_audio.load_params_npz(port, out)
    batch = first_batch(gh_root)
    cond_spec, grid_j, spec01_j, _, zp, feats = run_pipeline(baseline, params, batch)
    with torch.no_grad():
        grid = port.sample(t(cond_spec).permute(0, 3, 1, 2), t(batch["feature"]),
                           torch.Generator().manual_seed(0), top_k=1)
        spec01 = generate_audio.spec01(port, t(grid_j).long())
    assert_same_tokens(np.concatenate([zp, n(column_major(grid))], 1),
                       np.concatenate([zp, n(column_major(t(grid_j)))], 1),
                       gpt_logits(baseline, params, feats), 50)
    assert rel(spec01, spec01_j) <= TOL

    # the entry point on the exported tree writes what the port generates
    # from the batch, through its own spectrogram
    gen = tmp_path / "gen"
    generate_audio.main(["--gh_testset", "-c", str(cfg_path), "--params_npz", str(out),
                         "--top_k", "1", "--batch_size", "2", "--data_to_use", "0.7",
                         "--audio_only", "--output_dir", str(gen), "--device", "cpu"])
    with torch.no_grad():
        port_grid = port.sample(wav_to_spec(t(batch["cond_image"]))[:, None],
                                t(batch["feature"]), torch.Generator().manual_seed(0),
                                top_k=1)
        want_wav = n(mel01_to_waveform_gl(generate_audio.spec01(port, port_grid), 22050))
    for i in range(2):
        wav, sr = read_wav(next((gen / "generated_audio").glob(f"*_{i}.wav")))
        assert sr == 22050
        np.testing.assert_array_equal(wav[0], want_wav[i])


def test_exporter_feeds_generate_a_jax_diffusion_run(tmp_path):
    """A tiny JAX diffusion training checkpoint -> the exporter -> the port's
    f32 model samples the JAX sample from the same noise, and
    ``generate.py --params_npz`` writes that model's bf16 sample."""
    jm, params, _ = tiny_pair(seed=2)  # shared with other files' tests
    _save(tmp_path / "ckpts", DiffusionTrainer(jm).create_state(params))
    npz = export_params_npz.main(["--kind", "diffusion", "--ckpt", str(tmp_path / "ckpts"),
                                  "--out", str(tmp_path / "unet.npz")])
    cfg = {"model": UNET, "onsets_encoder": ENC}
    port = SyncFusionDiffusion.from_config(cfg, dtype=torch.float32, device="cpu", seed=1)
    with np.load(npz) as f:
        from syncfusion_tpu_torch.convert import to_state_dict, unflatten

        port.load_state_dict(to_state_dict(unflatten(dict(f))), strict=True)
    noise = torch.randn((1, L, 1), generator=torch.Generator().manual_seed(0))
    onsets = torch.from_numpy(generate.onset_track(np.array([0.001, 0.004]), L))
    emb = torch.zeros((1, 1, 16))
    kw = dict(num_steps=2, embedding_scale=2.0, guidance_interval=(0.2, 0.8))
    want = jax.jit(lambda *a: jm.sample(*a, **kw))(
        params, jnp.asarray(n(noise)), jnp.asarray(n(onsets)), jnp.asarray(n(emb)))
    np.testing.assert_allclose(n(port.sample(noise, onsets, emb, **kw)), np.asarray(want),
                               rtol=0, atol=2e-4)

    times = tmp_path / "times.txt"
    times.write_text("0.001\n0.004\n")
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    generate.main(["--onset_times", str(times), "--model_config", str(tmp_path / "tiny.json"),
                   "--length", str(L), "--num_steps", "2", "--params_npz", str(npz),
                   "--device", "cpu", "--output", str(tmp_path / "foley.wav")])
    got, _ = read_wav(tmp_path / "foley.wav")
    bf16 = SyncFusionDiffusion.from_config(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    bf16.load_state_dict(port.state_dict(), strict=True)
    np.testing.assert_array_equal(got[0], n(bf16.sample(noise, onsets, emb, **kw))[0, :, 0])


def test_generate_audio_writes_the_artifact_set_and_is_scored(gh_root, tmp_path,
                                                              monkeypatch):  # noqa: F811
    cfg_path = tiny_config(tmp_path, gh_root)
    out = tmp_path / "gen"
    summary = generate_audio.main(["--gh_testset", "-c", str(cfg_path), "--output_dir",
                                   str(out), "--batch_size", "2", "--top_k", "16",
                                   "--data_to_use", "0.7", "--device", "cpu"])
    wavs = sorted((out / "generated_audio").glob("*_to_*.wav"))
    assert summary["clips"] == len(wavs) == 6  # 2 of 3 videos, 3 onsets each
    for wav_path in wavs:
        w, sr = read_wav(wav_path)
        # 160 frames of Griffin-Lim: 512 + 256·159 samples, under n_samp
        assert sr == 22050 and w.shape == (1, 41216) and np.isfinite(w).all()
        pair = wav_path.stem
        ref, rest = pair.split("_to_")
        cond = rest.rsplit("_", 1)[0]
        assert ref != cond
        for rel_path in (f"generated_video/{pair}.mp4", f"generated_video/{pair}.jpg",
                         f"orig_audio/{ref}.wav", f"orig_video/{ref}.mp4",
                         f"orig_video/{ref}.jpg", f"cond_audio/{cond}.wav",
                         f"cond_video/{cond}.mp4", f"cond_video/{cond}.jpg"):
            assert (out / rel_path).is_file(), rel_path
    metrics = evaluate_onset_baseline.main(["--gen_dir", str(out / "generated_video"),
                                            "--tar_dir", str(out / "orig_video")])
    assert metrics["num_files"] == 6
    assert 0.0 <= metrics["detection_acc"] <= 1.0
    by_wav = evaluate_onset_baseline.main(["--gen_dir", str(out), "--gt_root", str(gh_root)])
    assert by_wav["num_files"] == 6

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_audio.main(["-c", str(cfg_path), "--output_dir", str(tmp_path / "x")])
