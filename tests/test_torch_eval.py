"""The port's evaluation modules against the JAX package's, on the CPU:
onset detection and metrics, the numpy AP against scikit-learn's, the FAD
front end and statistics, the full-width VGGish (converted JAX weights and a
torchvggish state dict), the on-device resampler, test-set generation on
shared noise (a ragged last batch, resume), GT preparation, the presets
against the YAMLs, and the mp4 container.

Inputs come from numpy seeds; the diffusion model is the tiny config of
tests/test_diffusion_stack.py.  Tolerances: onset positions exact; onset
metrics 1e-12; the log-mel, statistics and Fréchet distance 1e-6 relative;
VGGish 1e-4 of max |embedding| (f32 sums over up to 12288 products in other
orders); the resampler 1e-5; generated wavs 2e-4 absolute
(tests/test_torch_sampler.py's); GT chunks, presets and resume exact.
"""

import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.data import sfx_dataset as jsfx
from syncfusion_tpu.eval import fad as jfad
from syncfusion_tpu.eval import generation as jgen
from syncfusion_tpu.eval import mp4 as jmp4
from syncfusion_tpu.eval import mux as jmux
from syncfusion_tpu.eval import onset_detect as jdet
from syncfusion_tpu.eval import onset_metrics as jmet
from syncfusion_tpu.ops.resample import resample_jax
from syncfusion_tpu.ops.wav import read_wav as jread_wav
from syncfusion_tpu_torch import convert
from syncfusion_tpu_torch.data import sfx_dataset as tsfx
from syncfusion_tpu_torch.eval import fad as tfad
from syncfusion_tpu_torch.eval import generation as tgen
from syncfusion_tpu_torch.eval import mp4 as tmp4
from syncfusion_tpu_torch.eval import mux as tmux
from syncfusion_tpu_torch.eval import onset_detect as tdet
from syncfusion_tpu_torch.eval import onset_metrics as tmet
from syncfusion_tpu_torch.evaluate_diffusion import PRESETS
from syncfusion_tpu_torch.ops import resample as tres
from syncfusion_tpu_torch.ops.wav import write_wav
from torch_port_helpers import L, make_shard, n, t, tiny_pair

ROOT = Path(__file__).resolve().parents[1]
SR = 22050


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def clicks(seed: int, seconds: float = 2.0, sr: int = SR) -> np.ndarray:
    """Noise with decaying clicks at seeded times: a signal with onsets."""
    rng = np.random.default_rng(seed)
    y = 0.01 * rng.standard_normal(int(seconds * sr))
    for at in rng.uniform(0.05, seconds - 0.1, int(rng.integers(3, 9))):
        i = int(at * sr)
        k = np.arange(min(2000, len(y) - i))
        y[i:i + k.size] += rng.uniform(0.3, 1.0) * np.exp(-k / 300.0) * rng.standard_normal(k.size)
    return y.astype(np.float32)


def wav_dir(path: Path, seeds, sr: int = SR) -> Path:
    path.mkdir(parents=True)
    for s in seeds:
        write_wav(path / f"clip{s}.wav", clicks(s, sr=sr), sr)
    return path


# ---------------------------------------------------------------- onsets


@pytest.mark.parametrize("seed", range(4))
def test_onset_detect_equals_jax(seed):
    y = clicks(seed)
    np.testing.assert_allclose(tdet.onset_strength(y), jdet.onset_strength(y), rtol=1e-12)
    for delta in (0.07, 0.3):
        got = tdet.onset_detect(y, delta=delta)
        assert got.dtype.kind == "i" and len(got)
        np.testing.assert_array_equal(got, jdet.onset_detect(y, delta=delta))


def test_evaluate_onset_dirs_equal_jax(tmp_path):
    """Paired by name (2 shared names) and by sorted order (none shared),
    one window and several; the generated directory at 48 kHz goes through
    the resampler."""
    gen = wav_dir(tmp_path / "gen", [0, 1, 2, 3], sr=48000)
    tar = wav_dir(tmp_path / "tar", [0, 11, 2, 13])
    other = wav_dir(tmp_path / "other", [20, 21, 22, 23])
    for g, tdir, files in ((gen, tar, 2), (gen, other, 4)):
        for kw in (dict(delta=0.1), dict(delta=0.2, deltas=[0.1, 0.15, 0.2])):
            got = tmet.evaluate_onset_dirs(g, tdir, **kw)
            want = jmet.evaluate_onset_dirs(g, tdir, **kw)
            assert got.keys() == want.keys() and got["num_files"] == files
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("ties", [False, True])
def test_average_precision_equals_sklearn(ties):
    """On the lists the matching builds (labels of 1 and 0, scores with
    0.0 for unmatched onsets), untied and tied."""
    from sklearn.metrics import average_precision_score

    rng = np.random.default_rng(int(ties))
    for size in (3, 17, 120):
        y_true = [int(v) for v in rng.random(size) < 0.6] + [0, 1]
        y_score = [float(v) for v in rng.random(size + 2)]
        if ties:
            y_score = [round(v * 3) / 3 for v in y_score]
            y_score[:4] = [0.0] * 4
        assert tmet.average_precision(y_true, y_score) == pytest.approx(
            average_precision_score(y_true, y_score), rel=1e-12)


# ---------------------------------------------------------------- FAD


def test_fad_front_end_and_statistics_equal_jax():
    rng = np.random.default_rng(0)
    for y, sr in ((clicks(5), SR), (clicks(6, 0.5, 16000), 16000)):  # 0.5 s: repeat-padded
        got, want = tfad.vggish_log_mel(y, sr), jfad.vggish_log_mel(y, sr)
        assert got.shape == want.shape and got.shape[1:] == (96, 64)
        assert rel(got, want) <= 1e-6
    a = rng.standard_normal((40, 8)).astype(np.float32)
    b = (rng.standard_normal((30, 8)) * 1.5 + 0.2).astype(np.float32)
    for x in (a, b):
        for g, w in zip(tfad.gaussian_stats(x), jfad.gaussian_stats(x)):
            assert rel(g, w) <= 1e-6
    stats = [*tfad.gaussian_stats(a), *tfad.gaussian_stats(b)]
    assert tfad.frechet_distance(*stats) == pytest.approx(jfad.frechet_distance(*stats),
                                                         rel=1e-6)
    few = [*tfad.gaussian_stats(a[:3]), *tfad.gaussian_stats(b[:3])]  # rank-deficient
    assert tfad.frechet_distance(*few) == pytest.approx(jfad.frechet_distance(*few), rel=1e-6)


@pytest.fixture(scope="module")
def jax_vggish():
    """The JAX VGGish's variables at full width (seeded), as numpy."""
    net = jfad.VGGish()
    variables = jax.jit(lambda: net.init(jax.random.key(1), jnp.zeros((1, 96, 64, 1))))()
    return net, jax.tree_util.tree_map(np.asarray, variables)


def test_full_width_vggish_equals_jax(jax_vggish):
    """Two patches through the JAX net and the port's on converted weights
    (``convert.vggish_state_dict``): the (H, W, C) flatten keeps fc1_1's
    columns in their order."""
    net, variables = jax_vggish
    port = tfad.VGGish()
    port.load_state_dict(convert.vggish_state_dict(variables), strict=True)
    assert sum(p.numel() for p in port.parameters()) == 72141184
    patches = np.stack([tfad.vggish_log_mel(clicks(s, 1.0), SR)[0] for s in (7, 8)])
    want = np.asarray(net.apply(variables, jnp.asarray(patches[..., None])))
    with torch.no_grad():
        got = n(port(t(patches)))
    assert got.shape == want.shape == (2, 128)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_torchvggish_checkpoint_loads_on_both_sides(jax_vggish, tmp_path):
    """A state dict in torchvggish's layout (made from the JAX weights,
    with a PCA key the loaders drop) read by both embedders; then
    ``evaluate_fad``'s VGGish backend on both sides."""
    _, variables = jax_vggish
    p = variables["params"]
    sd = {}
    for ours, theirs, _ in [c for block in tfad._CONVS for c in block]:
        sd[f"{theirs}.weight"] = torch.from_numpy(p[ours]["kernel"].transpose(3, 2, 0, 1).copy())
        sd[f"{theirs}.bias"] = torch.from_numpy(p[ours]["bias"].copy())
    for ours, theirs in tfad._FCS:
        sd[f"{theirs}.weight"] = torch.from_numpy(p[ours]["kernel"].T.copy())
        sd[f"{theirs}.bias"] = torch.from_numpy(p[ours]["bias"].copy())
    sd["pca_eigen_vectors"] = torch.zeros(128, 128)
    ckpt = tmp_path / "vggish.pth"
    torch.save(sd, ckpt)
    gen = wav_dir(tmp_path / "gen", [0, 1, 2])
    gt = wav_dir(tmp_path / "gt", [3, 4, 5])
    port = tfad.VGGishEmbedder(str(ckpt), device="cpu")
    want = jfad._embed_dir(jfad.VGGishEmbedder(str(ckpt)), gen)
    got = tfad._embed_dir(port, gen)
    assert got.shape == want.shape == (6, 128)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    fad = tfad.evaluate_fad(gen, gt, str(ckpt), device="cpu")
    assert list(fad) == ["fad_vggish"] and np.isfinite(fad["fad_vggish"])
    # without a checkpoint both take the mel statistics
    got = tfad.evaluate_fad(gen, gt, str(tmp_path / "absent.pth"), device="cpu")
    want = jfad.evaluate_fad(gen, gt, None)
    assert list(got) == list(want) == ["fad_melstats"]
    assert got["fad_melstats"] == pytest.approx(want["fad_melstats"], rel=1e-6)


def test_seeded_vggish_init_follows_flax_distributions():
    """Kernels of std 1/sqrt(fan_in) (lecun-normal), zero biases; finite
    embeddings of (patches, 128)."""
    emb = tfad.VGGishEmbedder(device="cpu")
    for name, m in emb.net.named_children():
        fan_in = m.weight[0].numel()
        assert float(m.weight.std()) == pytest.approx(fan_in ** -0.5, rel=0.05), name
        assert not m.bias.any(), name
    out = emb.embed(clicks(4, 1.5), SR)
    assert out.shape == (1, 128) and np.isfinite(out).all()


# ---------------------------------------------------------------- resampling


@pytest.mark.parametrize("orig,new", [(48000, 22050), (22050, 16000), (16000, 48000),
                                      (44100, 48000)])
def test_resample_torch_equals_resample_jax(orig, new):
    x = np.random.default_rng(orig).standard_normal((2, 3, 1999)).astype(np.float32)
    got = n(tres.resample_torch(t(x), orig, new))
    want = np.asarray(resample_jax(jnp.asarray(x), orig, new))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, tres.resample(x, orig, new), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- generation

GEN = dict(batch_size=2, sample_rate=48000, num_steps=3, length=L, embedding_scale=2.0,
           one_chunk_per_track=True, cut_prefix=True, cut_length=400,
           downsample_rate=22050)
DATA = dict(sample_rate=48000, chunk_size=L, shift_augment=False, cut_prefix=False,
            one_chunk_per_track=True, onset_check_length=400)


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """3 tracks of 0.1 s at 48 kHz: one chunk each, batches of 2 and 1."""
    return make_shard(tmp_path_factory.mktemp("shard"), n_tracks=3)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=2)


def embed_audio(cond):
    """A deterministic (B, 1, 16) embedding of the conditioning chunks."""
    x = np.pad(np.asarray(cond)[:, :16, 0], ((0, 0), (0, max(0, 16 - cond.shape[1]))))
    return np.tanh(4.0 * x)[:, None, :].astype(np.float32)


def embed_text(texts):
    return np.stack([np.full((1, 16), 0.1 * len(s), np.float32) for s in texts])


def shared_noise(monkeypatch, batches: int, batch_size: int):
    """Batch ``i``'s noise from one numpy table in both packages; the JAX
    generation module alone sees the replaced ``normal`` (it draws batch
    after batch, none skipped)."""
    table = np.random.default_rng(9).standard_normal(
        (batches, batch_size, L, 1)).astype(np.float32)
    calls = iter(range(batches))
    monkeypatch.setattr(jgen, "jax", SimpleNamespace(jit=jax.jit, random=SimpleNamespace(
        key=jax.random.key, fold_in=jax.random.fold_in,
        normal=lambda key, shape: table[next(calls)])))
    monkeypatch.setattr(tgen, "batch_noise",
                        lambda seed, i, shape, device: torch.from_numpy(table[i]))


@pytest.mark.parametrize("cond", ["audio", "text"])
def test_generate_dataset_equals_jax(tmp_path, monkeypatch, shard, pair, cond):
    """3 clips at batch size 2 on shared noise: the port samples the last
    batch's one valid row, the JAX package a padded batch of 2; with
    ``save_cond`` the conditioning chunk (audio) or the label (text) is
    written beside each clip."""
    jm, params, tm = pair
    shared_noise(monkeypatch, 2, 2)
    kw = dict(GEN, cond_text=cond == "text", save_cond=True)
    jgen.generate_dataset(tmp_path / "jax", jm, params,
                          jsfx.create_sfx_dataset(shard, **DATA),
                          embed_audio=embed_audio, embed_text=embed_text, **kw)
    stats = tgen.generate_dataset(tmp_path / "port", tm, tsfx.create_sfx_dataset(shard, **DATA),
                                  embed_audio=lambda c: torch.from_numpy(embed_audio(c)),
                                  embed_text=lambda s: torch.from_numpy(embed_text(s)), **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == (3 if cond == "text" else 6) and stats["clips"] == 3
    for name in names:
        want, sr = jread_wav(tmp_path / "jax" / name)
        got, sr_got = jread_wav(tmp_path / "port" / name)
        assert sr == sr_got == 22050 and got.shape == want.shape
        if name.endswith("_cond.wav"):
            np.testing.assert_array_equal(got, want)
        else:
            assert got.shape[1] == int(np.ceil(400 * 22050 / 48000))
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
            assert np.abs(want).max() > 1e-3


def test_resume_is_bitwise(tmp_path, shard, pair):
    """Delete two outputs (the second batch's), run again: batch 0 is
    skipped, batch 1 draws the noise of an uninterrupted run, and every
    file is bitwise the first run's.  Chunk-numbered outputs."""
    _, _, tm = pair
    kw = dict(GEN, one_chunk_per_track=False, batch_size=1, seed=4)
    ds = lambda: tsfx.create_sfx_dataset(shard, **DATA)  # noqa: E731
    first = tgen.generate_dataset(tmp_path / "a", tm, ds(), **kw)
    assert first["clips"] == 3
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for name in ("1.wav", "2.wav"):
        (tmp_path / "b" / name).unlink()
    again = tgen.generate_dataset(tmp_path / "b", tm, ds(), **kw)
    assert again["clips"] == 2
    for name in ("0.wav", "1.wav", "2.wav"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    # each batch's noise is its own: batch 1's differs from batch 0's
    a, b = (tgen.batch_noise(4, i, (1, 8, 1), "cpu") for i in (0, 1))
    assert not torch.equal(a, b) and torch.equal(a, tgen.batch_noise(4, 0, (1, 8, 1), "cpu"))


def test_prepare_gt_for_fad_is_bitwise(tmp_path, shard):
    kw = dict(batch_size=2, sample_rate=48000, one_chunk_per_track=True,
              downsample_rate=22050)
    data = dict(DATA, cut_prefix=True)
    jgen.prepare_gt_for_fad(tmp_path / "jax", jsfx.create_sfx_dataset(shard, **data), **kw)
    tgen.prepare_gt_for_fad(tmp_path / "port", tsfx.create_sfx_dataset(shard, **data), **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 3 and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


# ---------------------------------------------------------------- presets


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_equals_its_yaml(name):
    """Each preset holds its exp/*.yaml as the JAX ``load_config`` reads it
    (interpolations resolved at work_dir '.'), key for key."""
    from syncfusion_tpu.core.config import load_config

    def plain(node):
        return {k: v for k, v in dict(node).items() if k not in ("_target_", "_partial_")}

    cfg = load_config(ROOT / "config.yaml", [f"exp={name}"])
    preset = PRESETS[name]
    exp = plain(cfg.experiment)
    dataset = plain(exp.pop("dataset"))
    assert exp.pop("experiment_path") == cfg.experiment_path
    assert dataset.pop("path") == cfg.dataset_path
    assert preset["experiment"] == {"run": cfg.experiment._target_.rsplit(".", 1)[1], **exp}
    assert preset["dataset"] == dataset
    top = {k: cfg[k] for k in preset if k not in ("experiment", "dataset", "evaluation")}
    assert {k: preset[k] for k in top} == top
    if preset["evaluation"] is None:
        assert cfg.get("evaluation") is None
    else:
        ev = plain(cfg.evaluation)
        assert ev.pop("gen_dir") == cfg.experiment_path
        assert preset["evaluation"] == {"run": cfg.evaluation._target_.rsplit(".", 1)[1], **ev}


# ---------------------------------------------------------------- mp4


def test_mp4_round_trip_equals_jax(tmp_path):
    """The same bytes as the JAX muxer; the audio back as 16-bit PCM holds
    it, at its own rate and resampled."""
    from PIL import Image

    rng = np.random.default_rng(0)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(1, 8):
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), np.uint8)).save(
            frames / f"vid.frame_{i:06d}.jpg")
    y = 0.3 * clicks(3, 0.4)
    wav = tmp_path / "a.wav"
    write_wav(wav, y, SR)
    got = tmux.attach_audio_to_frames(frames, "vid.frame_%06d.jpg", wav, tmp_path / "t.mp4",
                                      fps=15, n_frames=6)
    want = jmux.attach_audio_to_frames(frames, "vid.frame_%06d.jpg", wav, tmp_path / "j.mp4",
                                       fps=15, n_frames=6)
    assert got.read_bytes() == want.read_bytes()
    audio, sr = tmp4.read_mp4_audio(got)
    pcm = (np.clip(y, -1.0, 1.0 - 1 / 32768.0) * 32768.0).astype(np.int16) / 32768.0
    assert sr == SR and np.abs(audio - pcm).max() <= 1e-6
    assert np.abs(audio - y).max() <= 2.0 ** -15
    assert jmp4.jpeg_size((frames / "vid.frame_000001.jpg").read_bytes()) == (32, 24)
    for rate in (SR, 16000):
        np.testing.assert_array_equal(tmux.extract_video_audio(got, rate),
                                      jmux.extract_video_audio(got, rate))
    with pytest.raises(ValueError, match="no sound track"):
        tmp4.read_mp4_audio(_video_only(tmp_path / "v.mp4", frames))


def _video_only(dest: Path, frames: Path) -> Path:
    """An mp4 whose audio track is not a sound track (its handler renamed)."""
    data = bytearray(tmp4.write_mp4(dest, [frames.joinpath("vid.frame_000001.jpg")
                                           .read_bytes()], 15, np.zeros(10), SR)
                     .read_bytes())
    i = data.index(b"soun")
    data[i:i + 4] = b"meta"
    dest.write_bytes(bytes(data))
    return dest
