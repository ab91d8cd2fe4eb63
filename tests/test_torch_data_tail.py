"""The port's raw-data tail against the JAX package's: the spectral-gate
denoiser, the shard writer, the native tar reader, the video utilities,
the three ``gh_*`` entry points and ``train_diffusion --save``.

* ``spectral_gate``: its binary gate ``sig_dB > thresh_dB`` compares two
  float computations, so a cell within rounding of the threshold can flip;
  the share of flipped cells is held to ``FLIP_SHARE`` (1e-3), and the
  output to ``GATE_TOL`` (1e-5 of max |out|) where the two gates agree,
  that is with the JAX gate fed to the port's second half (``apply_gate``),
  with and without ``noise_clip``.
* ``write_shards``: byte-identical tars, with and without ``pred_csv_dir``.
* The native reader (built with g++; skipped only where g++ is absent):
  members, WAV decode and resampling against the Python reader and against
  ``syncfusion_tpu.data.native``; ``iter_tar_samples(native=True)`` against
  ``native=False``.
* ``eval/video_utils`` and ``gh_preprocess_videos`` through stub
  ffmpeg/ffprobe binaries (tests/test_video_utils.py's and
  tests/test_scripts_cli.py's), their files equal to the JAX ones'; the
  denoised wav is the port's ``spectral_gate`` of the extracted audio.
* ``gh_make_synthetic``: every file equal to the JAX script's for one seed.
* ``train_diffusion --save``: each exported subtree's tensors equal the
  JAX export's leaves (the JAX script's walk over the parameter tree,
  converted), and an unknown root or name raises naming what is there.
"""

import importlib
import json
import os
import shutil
import stat
import sys
import tarfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from syncfusion_tpu.data import native as jnative
from syncfusion_tpu.data.shard_writer import write_shards as jax_write_shards
from syncfusion_tpu.eval import video_utils as jvu
from syncfusion_tpu_torch import gh_make_shards, gh_make_synthetic, gh_preprocess_videos
from syncfusion_tpu_torch import train_diffusion
from syncfusion_tpu_torch.convert import convert_leaf, flatten
from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.data import native as tnative
from syncfusion_tpu_torch.data import shards as tshards
from syncfusion_tpu_torch.data.shard_writer import write_shards
from syncfusion_tpu_torch.eval import video_utils as tvu
from syncfusion_tpu_torch.ops import denoise as tdenoise
from syncfusion_tpu_torch.ops.wav import read_wav, write_wav
from syncfusion_tpu_torch.train.diffusion_trainer import DiffusionTrainer
from torch_port_helpers import make_shard, n, t, tiny_pair, to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "script"))
# the module (syncfusion_tpu.ops re-exports a function of the same name)
jstft = importlib.import_module("syncfusion_tpu.ops.stft")
jdenoise = importlib.import_module("syncfusion_tpu.ops.denoise")
jresample = importlib.import_module("syncfusion_tpu.ops.resample")

FLIP_SHARE, GATE_TOL = 1e-3, 1e-5
SR = 8000


def _noisy(seed, seconds=2.0, channels=1):
    """A 660 Hz burst over white noise, as tests/test_scripts_cli.py's."""
    rng = np.random.default_rng(seed)
    wav = 0.02 * rng.standard_normal((channels, int(SR * seconds))).astype(np.float32)
    wav[:, SR // 2:SR // 2 + 400] += np.sin(2 * np.pi * 660 * np.arange(400) / SR)
    return wav.astype(np.float32)


def _jax_mask(wav, noise_clip=None):
    def db(x):
        return 20.0 * jnp.log10(jnp.maximum(jnp.abs(jstft.stft(x, 1024, 256)), 1e-12))

    sig = db(jnp.asarray(wav))
    ref = sig if noise_clip is None else db(jnp.asarray(noise_clip))
    thresh = jnp.mean(ref, axis=-1, keepdims=True) + 1.5 * jnp.std(ref, axis=-1,
                                                                  keepdims=True)
    return np.asarray(sig > thresh, np.float32)


@pytest.mark.parametrize("with_noise_clip", [False, True])
def test_spectral_gate_matches_jax(with_noise_clip):
    wav = _noisy(0, channels=2)
    clip = 0.02 * np.random.default_rng(1).standard_normal((2, SR)).astype(np.float32)
    noise_clip = clip if with_noise_clip else None
    want = np.asarray(jdenoise.spectral_gate(
        jnp.asarray(wav), noise_clip=None if noise_clip is None else jnp.asarray(clip)))
    spec, mask = tdenoise.gate_mask(t(wav), noise_clip=None if noise_clip is None
                                    else t(clip))
    jmask = _jax_mask(wav, noise_clip)
    assert 0 < jmask.mean() < 1
    assert (n(mask) != jmask).mean() <= FLIP_SHARE
    got = tdenoise.apply_gate(spec, t(jmask), wav.shape[-1])
    assert got.shape == wav.shape
    assert np.abs(n(got) - want).max() <= GATE_TOL * np.abs(want).max()
    whole = tdenoise.spectral_gate(t(wav), noise_clip=None if noise_clip is None
                                   else t(clip))
    if (n(mask) == jmask).all():
        np.testing.assert_array_equal(n(whole), n(got))


def _make_processed(root: Path, names, seed=0):
    rng = np.random.default_rng(seed)
    for name in names:
        d = root / name
        (d / "audio").mkdir(parents=True)
        write_wav(d / "audio" / f"{name}.resampled.wav",
                  0.1 * rng.standard_normal((1, SR // 4)).astype(np.float32), SR)
        (d / f"{name}.times.csv").write_text("0.05,hit\n0.15,scratch\n")
    (root / "split.txt").write_text("\n".join(names) + "\n")


@pytest.mark.parametrize("with_preds", [False, True])
def test_write_shards_is_byte_identical_to_jax(tmp_path, with_preds):
    names = [f"vid_{i}" for i in range(5)]
    _make_processed(tmp_path, names)
    preds = None
    if with_preds:
        preds = tmp_path / "preds"
        preds.mkdir()
        for name in names[::2]:
            (preds / f"{name}.times.csv").write_text("0.05\n\n0.12\n")
    want = jax_write_shards(tmp_path, tmp_path / "split.txt",
                            str(tmp_path / "jax" / "s_%d.tar"), 3, preds)
    got = gh_make_shards.main(["--root", str(tmp_path), "--split",
                               str(tmp_path / "split.txt"), "--output",
                               str(tmp_path / "port" / "s_%d.tar"), "--shard_size", "3"]
                              + (["--pred_csv_dir", str(preds)] if with_preds else []))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert Path(g).read_bytes() == Path(w).read_bytes()
    assert write_shards(tmp_path, tmp_path / "split.txt",
                        str(tmp_path / "lib" / "s_%d.tar"), 3, preds)[0].endswith("s_1.tar")


def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native reader cannot be built here")


def test_native_reader_matches_python_and_jax(tmp_path):
    _needs_gxx()
    assert tnative.available()
    assert tnative.library_path().parent == Path(tshards.__file__).parents[1] / "_build"
    shard = make_shard(tmp_path, n_tracks=3, seconds=0.05)
    with tarfile.open(shard, "a") as tf:  # a directory member: skipped by both
        info = tarfile.TarInfo("adir")
        info.type = tarfile.DIRTYPE
        tf.addfile(info)
    py = list(tshards._iter_members_python(shard))
    assert list(tnative.iter_tar_members(shard)) == py == list(
        jnative.iter_tar_members(shard))
    assert list(tshards.iter_tar_samples(shard, native=True)) == list(
        tshards.iter_tar_samples(shard, native=False))
    rng = np.random.default_rng(2)
    for fmt in ("f32", "pcm16"):
        path = tmp_path / f"{fmt}.wav"
        write_wav(path, (0.3 * rng.standard_normal((2, 999))).astype(np.float32), 48000,
                  fmt=fmt)
        w, sr = tnative.decode_wav(path.read_bytes())
        np.testing.assert_array_equal(w, read_wav(path)[0])
        assert sr == 48000
        np.testing.assert_array_equal(w, jnative.decode_wav(path.read_bytes())[0])
    x = rng.standard_normal(8000).astype(np.float32)
    for orig, new in ((48000, 22050), (16000, 48000)):
        got = tnative.resample_native(x, orig, new)
        # tests/test_native_io.py's tolerance: the JAX library is built with
        # -march=native, whose fused multiply-adds round otherwise
        np.testing.assert_allclose(got, jnative.resample_native(x, orig, new), atol=1e-5)
        np.testing.assert_allclose(got, jresample.resample(x, orig, new), atol=1e-5)


def test_native_true_raises_when_the_build_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", "g++: not found")
    shard = make_shard(tmp_path, n_tracks=1, seconds=0.01)
    with pytest.raises(RuntimeError, match="unavailable"):
        list(tshards.iter_tar_samples(shard, native=True))
    assert [s["__key__"] for s in tshards.iter_tar_samples(shard)] == ["track0"]


@pytest.fixture()
def stub_bin(tmp_path, monkeypatch):
    """A PATH directory of scriptable ffmpeg/ffprobe stubs."""
    bindir = tmp_path / "bin"
    bindir.mkdir()

    def install(name: str, script: str):
        p = bindir / name
        p.write_text("#!/bin/sh\n" + script)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)

    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return install


def test_video_utils_match_jax(stub_bin, tmp_path):
    stub_bin("ffprobe", 'case "$*" in *width*) echo 4,2 ;; *) echo 3.5 ;; esac\n')
    frames = np.arange(2 * 2 * 4 * 3, dtype=np.uint8)
    raw = tmp_path / "raw.bin"
    raw.write_bytes(frames.tobytes())
    stub_bin("ffmpeg", f'for a in "$@"; do last="$a"; done\n'
                       f'if [ "$last" = "-" ]; then cat {raw}; else : > "$last"; fi\n')
    video = tmp_path / "v.mp4"
    video.write_bytes(b"fake")
    assert tvu.get_duration(video) == jvu.get_duration(video) == 3.5
    for cond in (False, True):
        got = tvu.trim_video(video, 1.25, 2, tmp_path / "p", cond=cond)
        want = jvu.trim_video(video, 1.25, 2, tmp_path / "j", cond=cond)
        assert Path(got).name == Path(want).name and Path(got).exists()
    with pytest.raises(AssertionError, match="Trim Start"):
        tvu.trim_video(video, 9.0, 2, tmp_path / "p")
    assert Path(tvu.reencode_video_with_diff_fps(video, tmp_path / "p", 5)).name == \
        Path(jvu.reencode_video_with_diff_fps(video, tmp_path / "j", 5)).name
    got, want = tvu.load_frames(video), jvu.load_frames(video)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    stub_bin("ffprobe", "echo boom >&2; exit 3\n")
    with pytest.raises(RuntimeError, match="rc=3"):
        tvu.get_duration(video)


def test_gh_preprocess_videos_matches_the_jax_script(stub_bin, tmp_path):
    """The port's entry point (a spawn worker for ffmpeg, the gate in this
    process on the CPU) against the JAX script's per-video pipeline on the
    same stubs: the metadata, the extracted and onset wavs and the frames
    are the same files; the denoised wav is ``spectral_gate`` of the
    extracted one, in f32."""
    src = tmp_path / "source.wav"
    write_wav(src, _noisy(3), SR)
    probe = json.dumps({"streams": [
        {"codec_type": "video", "width": 320, "height": 240, "avg_frame_rate": "15/1",
         "duration": "2.0", "nb_frames": "30"},
        {"codec_type": "audio", "sample_rate": "44100", "channels": "2",
         "duration": "2.0"}]})
    stub_bin("ffprobe", f"cat <<'EOF'\n{probe}\nEOF\n")
    stub_bin("ffmpeg", 'out=""\nfor a in "$@"; do out="$a"; done\ncase "$out" in\n'
                       f'  *.wav) cp {src} "$out" ;;\n'
                       '  *.jpg) i=1; while [ $i -le 30 ]; do\n'
                       '    : > "$(printf "$out" $i)"; i=$((i+1)); done ;;\nesac\n')
    videos = tmp_path / "videos"
    videos.mkdir()
    (videos / "vid1.mp4").write_bytes(b"fake")
    for side in ("jax", "port"):
        (tmp_path / side / "vid1").mkdir(parents=True)
        (tmp_path / side / "vid1" / "hit_record.csv").write_text("0.5,hit\n1.0,hit\n")
    import gh_preprocess_videos as jgpv

    jgpv.pipeline(str(videos / "vid1.mp4"), ".mp4", SR, 32, False, True, 15, 320, 240,
                  str(tmp_path / "jax"))
    gh_preprocess_videos.main(["--input_dir", str(videos), "--output_dir",
                               str(tmp_path / "port"), "--audio_sample_rate", str(SR),
                               "--audio_denoise", "--audio_onsets", "--num_workers", "1",
                               "--device", "cpu"])
    jroot, proot = tmp_path / "jax" / "vid1", tmp_path / "port" / "vid1"
    files = sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_file())
    assert len(files) == 2 + 2 + 30
    for rel in files:
        assert (proot / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    denoised, sr = read_wav(proot / "audio" / "vid1.resampled_denoised.wav")
    wav, _ = read_wav(proot / "audio" / "vid1.resampled.wav")
    assert sr == SR
    np.testing.assert_array_equal(denoised, n(tdenoise.spectral_gate(t(wav))))


def test_gh_make_synthetic_matches_the_jax_script(tmp_path, monkeypatch):
    """Two videos of 2-3 s, seed 5: every file (wav, csv, json, JPEG frames,
    splits) the same bytes.  The JAX script's pool is replaced by an
    in-process one (a fork of this process, which runs JAX's threads, is
    not safe); the port's runs its spawn pool."""
    import gh_make_synthetic as jgms

    class InProcess:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def map(self, fn, jobs, chunksize=1):
            return map(fn, jobs)

    monkeypatch.setattr(jgms, "ProcessPoolExecutor", InProcess)
    args = ["--n_videos", "2", "--min_dur", "2", "--max_dur", "3", "--seed", "5",
            "--num_workers", "1"]
    jgms.main(["--output_dir", str(tmp_path / "jax"), *args])
    gh_make_synthetic.main(["--output_dir", str(tmp_path / "port"), *args])
    want = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                  if p.is_file())
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                 if p.is_file())
    assert got == want and len(want) > 3 + 2 * 30
    for rel in want:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def _jax_export(params, attr):
    """The JAX script's walk (script/train_diffusion_model.py:140-157) over
    the JAX parameter tree, its leaves converted to the port's layout and
    keyed below ``attr`` (the leaf itself where ``attr`` names one)."""
    key_map = {"model": "unet", "unet": "unet", "onsets_encoder": "encoder",
               "encoder": "encoder"}
    root, *segs = attr.split(".")
    sub = params[key_map[root]]
    for seg in segs:
        if isinstance(sub, dict) and seg not in sub and "params" in sub:
            sub = sub["params"]
        sub = sub[seg]
    if not isinstance(sub, dict):
        return convert_leaf(tuple(segs), np.asarray(sub))[1]
    prefix = ".".join(segs)
    out = {}
    for path, leaf in flatten(sub.get("params", sub)).items():
        key, a = convert_leaf(tuple(segs) + path, leaf)
        out[key[len(prefix) + 1:] if prefix else key] = a
    return out


@pytest.mark.parametrize("attr", ["model", "onsets_encoder", "unet.down_1",
                                  "model.mid_attn.qkv", "model.fixed_embedding"])
def test_save_exports_the_jax_subtree(tmp_path, attr):
    _, params, tm = tiny_pair(seed=0)
    ckpts = tmp_path / "teacher"
    Checkpointer(CheckpointConfig(ckpts)).save(
        0, DiffusionTrainer(tm).create_state().state_dict())
    state = train_diffusion.export_subtree(tm.state_dict(), attr)
    want = _jax_export(to_numpy(params), attr)
    if not isinstance(want, dict):  # one leaf
        np.testing.assert_array_equal(n(state), want)
        return
    assert sorted(state) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(n(state[k]), v, err_msg=k)
    if attr == "unet.down_1":  # through the entry point
        shard = make_shard(tmp_path, n_tracks=2, seconds=0.02)
        cfg = tmp_path / "tiny.json"
        from torch_port_helpers import ENC, UNET

        cfg.write_text(json.dumps({"model": UNET, "onsets_encoder": ENC}))
        train_diffusion.main(["--train_path", shard, "--val_path", shard, "--logs_dir",
                              str(tmp_path / "logs"), "--model_config", str(cfg),
                              "--embedder", "none", "--device", "cpu", "--ckpt",
                              str(ckpts), "--save", attr])
        (run,) = (tmp_path / "logs" / "runs").iterdir()
        saved = Checkpointer(CheckpointConfig(run / "export_unet_down_1")).restore()
        assert list(saved) == ["unet_down_1"]
        assert sorted(saved["unet_down_1"]) == sorted(state)
        for k, v in state.items():
            assert saved["unet_down_1"][k].equal(v)


def test_save_names_what_is_there():
    _, _, tm = tiny_pair(seed=0)
    with pytest.raises(ValueError, match="unknown root 'decoder'.*'encoder'"):
        train_diffusion.export_subtree(tm.state_dict(), "decoder.x")
    with pytest.raises(ValueError, match="no subtree 'down_9'.*'down_0'"):
        train_diffusion.export_subtree(tm.state_dict(), "model.down_9")
