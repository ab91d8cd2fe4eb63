"""The port's CLAP-conditioned command lines on the CPU: ``train_diffusion``
with its default embedder (CLAP, HTSAT-tiny and roberta-base at full width
with seeded weights) on a tiny UNet, and ``video_to_foley --text`` and
``--cond_wav``, each clip conditioned on the embedding that the embedder
gives for its prompt or wav, and unlike the zero-embedding clip of the same
seed."""

import json

import numpy as np
import pytest
import torch

from syncfusion_tpu.ops.resample import resample as jresample
from syncfusion_tpu.ops.wav import read_wav, write_wav
from syncfusion_tpu_torch import train_diffusion, video_to_foley
from syncfusion_tpu_torch.models.clap.model import ClapEmbedder
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops import attention as ta
from test_torch_clap import no_transformers_files  # noqa: F401  (fixture)
from test_trainer import ENC as TRAIN_ENC
from test_trainer import UNET as TRAIN_UNET
from torch_port_helpers import ENC, UNET, make_shard, n

# the tiny UNets with CLAP's 512 embedding features
CLAP_FEATURES = 512
TRAIN_L, V2F_L = 256, 512


@pytest.fixture(scope="module")
def clap():
    """The embedder every entry point builds by default on the CPU: seed 0."""
    return ClapEmbedder(device="cpu")


def test_train_cli_default_embedder_is_clap(tmp_path, monkeypatch, clap,
                                            no_transformers_files):  # noqa: F811
    """4 micro-steps with no ``--embedder``: every training, validation and
    sample-logger batch carries the CLAP embedding of its conditioning
    chunk (unit norm, (B, 1, 512)), the losses are finite, and the sample
    logger writes each clip's wav and mel panel."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": {**TRAIN_UNET, "embedding_features": CLAP_FEATURES},
                               "onsets_encoder": TRAIN_ENC}))
    shard = make_shard(tmp_path, n_tracks=3, seconds=0.02)
    seen = []
    embed = ClapEmbedder.embed_audio

    def spy(self, wav):
        out = embed(self, wav)
        seen.append((np.asarray(wav), out))
        return out

    monkeypatch.setattr(ClapEmbedder, "embed_audio", spy)
    ta.reset_counts()
    state = train_diffusion.main([
        "--train_path", shard, "--val_path", shard, "--logs_dir", str(tmp_path / "logs"),
        "--model_config", str(cfg), "--length", str(TRAIN_L), "--batch_size", "2",
        "--log_every_n_steps", "1", "--val_check_interval", "4", "--val_batches", "1",
        "--sampling_steps", "2", "--max_steps", "4", "--device", "cpu"])
    assert state.step == 4
    # 4 training batches (the feeder may run ahead by its buffer), 1
    # validation batch, 1 sample-logger batch
    assert 6 <= len(seen) <= 8
    for wav, emb in seen:
        assert emb.shape == (2, 1, CLAP_FEATURES)
        np.testing.assert_allclose(n(emb.norm(dim=-1)), 1.0, atol=1e-5)
    wav, emb = seen[0]
    np.testing.assert_allclose(n(clap.embed_audio(wav)), n(emb), atol=1e-6, rtol=0)
    (run,) = (tmp_path / "logs" / "runs").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite([r["train_loss"] for r in recs if "train_loss" in r]).all()
    assert sorted(p.name for p in (run / "media").iterdir()) == [
        "mel_spectrogram_0_2steps_step00000004.png",
        "mel_spectrogram_1_2steps_step00000004.png",
        "sample_0_step4.wav", "sample_1_step4.wav"]


def test_video_to_foley_text_and_cond_wav(tmp_path, monkeypatch, clap,
                                          no_transformers_files):  # noqa: F811
    """The same seeded chunks and seed with no condition, ``--text`` and
    ``--cond_wav`` (a stereo 22.05 kHz wav, its channels' mean resampled to
    48 kHz as the JAX script resamples it): the sampler gets zeros, the
    prompt's and the wav's CLAP embeddings, and the three clips differ."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    chunks = [{"frames": rng.integers(0, 256, (10, 112, 112, 3), dtype=np.uint8),
               "start_frame": 10 * i, "frame_rate": 5.0} for i in range(2)]
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": {**UNET, "embedding_features": CLAP_FEATURES},
                               "onsets_encoder": ENC}))
    cond = tmp_path / "cond.wav"
    write_wav(cond, (0.3 * rng.standard_normal((2, 11025))).astype(np.float32), 22050)
    embeddings = []
    sample = SyncFusionDiffusion.sample

    def spy(self, noise, onsets, embedding, **kw):
        embeddings.append(embedding)
        return sample(self, noise, onsets, embedding, **kw)

    monkeypatch.setattr(SyncFusionDiffusion, "sample", spy)
    clips = {}
    for name, flags in (("zero", []), ("text", ["--text", "hit wood"]),
                        ("cond_wav", ["--cond_wav", str(cond)])):
        out = tmp_path / f"{name}.wav"
        got = video_to_foley.main([
            "--video_dir", str(tmp_path / "unused"), "--onset_layers", "1", "1", "1", "1",
            "--model_config", str(cfg), "--length", str(V2F_L), "--num_steps", "2",
            "--sampler", "dpm", "--output", str(out), "--device", "cpu", *flags],
            chunks=chunks)
        assert set(got["seconds"]) == {"onset", "clap", "generation"}
        clips[name], sr = read_wav(out)
        assert sr == 48000 and clips[name].shape == (1, V2F_L)
        assert np.isfinite(clips[name]).all()
    zero, text, wav = embeddings
    assert torch.equal(zero, torch.zeros((1, 1, CLAP_FEATURES)))
    np.testing.assert_allclose(n(text), n(clap.embed_text(["hit wood"])), atol=1e-6, rtol=0)
    stereo, _ = read_wav(cond)
    y = jresample(stereo.mean(axis=0), 22050, 48000)
    np.testing.assert_allclose(n(wav), n(clap.embed_audio(y[None, :, None])),
                               atol=1e-6, rtol=0)
    assert np.abs(n(text) - n(wav)).max() > 1e-2
    for name in ("text", "cond_wav"):
        assert np.abs(clips[name] - clips["zero"]).max() > 1e-4


def test_video_to_foley_builds_the_config_embedder(tmp_path, monkeypatch):
    """The model config's embedder node decides the conditioning, as
    ``script/video_to_foley.py`` builds ``build_embedder(cfg.model)``: under
    ``embedder.amodel: none`` the ``--text`` embedding is the JAX script's
    (zeros) and no CLAP is built; without ``--clap_ckpt`` CLAP reads the
    node's ``embedder_checkpoint``."""
    from pathlib import Path

    from syncfusion_tpu.core.config import load_config
    from syncfusion_tpu.models.embedder import build_embedder as jax_build_embedder

    built = []

    class Recorder:
        def __init__(self, checkpoint_path=None, tokenizer_path=None, device=None):
            built.append(checkpoint_path)

        def embed_text(self, texts):
            return torch.ones((len(texts), 1, CLAP_FEATURES))

    monkeypatch.setattr("syncfusion_tpu_torch.models.clap.ClapEmbedder", Recorder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    chunks = [{"frames": rng.integers(0, 256, (10, 112, 112, 3), dtype=np.uint8),
               "start_frame": 0, "frame_rate": 5.0}]
    model = {**UNET, "embedding_features": CLAP_FEATURES}
    cfg = tmp_path / "none.json"
    cfg.write_text(json.dumps({"model": model, "onsets_encoder": ENC,
                               "embedder": {"amodel": "none"}}))
    embeddings = []
    sample = SyncFusionDiffusion.sample

    def spy(self, noise, onsets, embedding, **kw):
        embeddings.append(embedding)
        return sample(self, noise, onsets, embedding, **kw)

    monkeypatch.setattr(SyncFusionDiffusion, "sample", spy)
    video_to_foley.main([
        "--video_dir", str(tmp_path / "unused"), "--onset_layers", "1", "1", "1", "1",
        "--model_config", str(cfg), "--length", str(V2F_L), "--num_steps", "1",
        "--output", str(tmp_path / "out.wav"), "--device", "cpu",
        "--text", "hit wood"], chunks=chunks)
    jcfg = load_config(Path(__file__).resolve().parents[1] / "config.yaml",
                       ["exp=train_diffusion_gh", "model.embedder.amodel=none"])
    want = np.asarray(jax_build_embedder(jcfg.model).embed_text(["hit wood"]))
    (got,) = embeddings
    assert built == [] and got.shape == want.shape == (1, 1, CLAP_FEATURES)
    np.testing.assert_array_equal(n(got), want)

    node = {"model": model, "onsets_encoder": ENC, "embedder": {"amodel": "HTSAT-tiny"},
            "embedder_checkpoint": "630k-audioset-best.pt"}
    emb = video_to_foley.conditioning("hit wood", None, None, node, "cpu")
    assert built == ["630k-audioset-best.pt"] and torch.equal(emb, torch.ones((1, 1, 512)))
    video_to_foley.conditioning("hit wood", None, "other.pt", node, "cpu")
    assert built[-1] == "other.pt"
