"""The port's onset data path and command lines on the CPU: the Greatest
Hits dataset, its loader and the frame transform against the JAX package on
a JPEG fixture (frames and labels equal, every augment mode and wire
format); the annotation writer against the JAX one; ``train_onset`` fit,
resume and test on a tiny fixture; ``video_to_foley``'s onset times against
the JAX ``predict_onset_times`` on the same (converted) weights, and its wav.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from syncfusion_tpu.data import onset_dataset as jds
from syncfusion_tpu.data import transforms as jtf
from syncfusion_tpu.eval import onset_annotations as jann
from syncfusion_tpu.ops.wav import read_wav
from syncfusion_tpu_torch import train_onset, video_to_foley
from syncfusion_tpu_torch.convert import onset_state_dict
from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.data import onset_dataset as tds
from syncfusion_tpu_torch.data import transforms as ttf
from syncfusion_tpu_torch.eval import onset_annotations as tann
from syncfusion_tpu_torch.models.onset_net import VideoOnsetNet
from torch_port_helpers import ENC, L, UNET

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "script"))

FPS = 15


def make_video(root: Path, name: str, duration: float, fps: int, size=(24, 32),
               times="0.5,hit\n1.9,hit\n2.5,scratch\n4.4,hit\n", seed: int = 0):
    """A preprocessed Greatest Hits video directory of random JPEG frames."""
    rng = np.random.default_rng(seed)
    d = root / name
    (d / "frames").mkdir(parents=True)
    meta = {"processed": {"video_frame_rate": fps, "video_duration": duration}}
    (d / f"{name}.metadata.json").write_text(json.dumps(meta))
    (d / f"{name}.times.csv").write_text(times)
    for i in range(1, int(duration * fps) + 2):
        Image.fromarray(rng.integers(0, 255, (*size, 3), np.uint8)).save(
            d / "frames" / f"frame_{i:06d}.jpg")
    return d


@pytest.fixture(scope="module")
def gh_root(tmp_path_factory):
    """tests/test_onset_dataset.py's fixture: 2 videos of 4.5 s at 15 fps,
    2 chunks each."""
    root = tmp_path_factory.mktemp("gh")
    names = [f"2015-02-16-{v}" for v in range(2)]
    for v, name in enumerate(names):
        make_video(root, name, 4.5, FPS, seed=v)
    (root / "train.txt").write_text("\n".join(names) + "\n")
    return root


TRANSFORMS = [
    dict(augment=False, size=16),
    dict(augment=False, size=16, wire_uint8=True),
    dict(augment=False, size=16, wire_yuv420=True),
    dict(augment=True, size=16, resize_to=20),
    dict(augment=True, size=16, resize_to=20, wire_uint8=True, device_jitter=True),
    dict(augment=True, size=16, resize_to=20, wire_yuv420=True, device_jitter=True),
]


@pytest.mark.parametrize("kw", TRANSFORMS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items() if k != "size"))
def test_dataset_and_loader_match_jax(gh_root, kw):
    """Every item and every shuffled batch equal to the JAX package's:
    frames, labels, chunk bounds; the augmenting modes draw from the same
    numpy seeds, so they are equal too."""
    args = (str(gh_root), str(gh_root / "train.txt"))
    ours = tds.GreatestHitsDataset(*args, frames_transforms=ttf.FrameTransform(**kw),
                                   cache_decoded=True)
    ref = jds.GreatestHitsDataset(*args, frames_transforms=jtf.FrameTransform(**kw),
                                  cache_decoded=True)
    assert len(ours) == len(ref) == 4
    for epoch in range(2):  # the second reads the decoded cache
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a.keys() == b.keys()
            for k in b:
                if isinstance(b[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
                else:
                    assert a[k] == b[k], k
    ours_b = list(tds.loader(ours, 3, shuffle=True, num_workers=1, seed=4))
    ref_b = list(jds.loader(ref, 3, shuffle=True, num_workers=1, seed=4))
    assert [len(b["label"]) for b in ours_b] == [3, 1]
    for a, b in zip(ours_b, ref_b, strict=True):
        assert np.array_equal(a["label"], b["label"])
        assert a["video_name"] == b["video_name"]
        assert np.array_equal(a["start_frame"], b["start_frame"])


def test_dataset_labels_are_the_reference_frames(gh_root):
    ds = tds.GreatestHitsDataset(str(gh_root), str(gh_root / "train.txt"),
                                 frames_transforms=ttf.FrameTransform(size=16))
    assert np.nonzero(ds[0]["label"])[0].tolist() == [7, 28]  # 0.5 s, 1.9 s
    assert np.nonzero(ds[1]["label"])[0].tolist() == [7]  # 2.5 s in chunk 1


@pytest.mark.parametrize("name,args", [
    ("resize", ((2, 8, 10, 3), 4)), ("resize", ((2, 8, 10, 3), (6, 6))),
    ("normalize", ((2, 4, 4, 3),)), ("rgb_to_yuv420", ((2, 4, 6, 3),))])
def test_transform_functions_match_jax(name, args):
    x = np.random.default_rng(1).random(args[0]).astype(np.float32)
    np.testing.assert_array_equal(getattr(ttf, name)(x, *args[1:]),
                                  getattr(jtf, name)(x, *args[1:]))


def test_host_color_jitter_matches_jax():
    x = np.random.default_rng(2).random((3, 6, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttf.color_jitter(x, np.random.default_rng(9), 0.4, 0.2, 0.4, 0.1),
        jtf.color_jitter(x, np.random.default_rng(9), 0.4, 0.2, 0.4, 0.1))


def test_natsorted_matches_jax():
    items = ["f_10", "f_2", "f_1", "a10b2", "a10b10", "a9"]
    assert tds.natsorted(items) == jds.natsorted(items)


def test_annotations_match_jax(tmp_path):
    """The per-chunk CSVs and their per-video merge, on the same batch and
    logits, byte for byte (runs of predicted frames deduplicated)."""
    rng = np.random.default_rng(3)
    batch = {"video_name": ["va", "va", "vb"], "label": (rng.random((3, 30)) < 0.1),
             "frame_rate": np.array([15.0, 15.0, 15.0]),
             "start_frame": np.array([0, 30, 0]), "end_frame": np.array([30, 60, 30])}
    logits = rng.normal(size=(3, 30)).astype(np.float32) + 0.5
    for mod, out in ((tann, tmp_path / "port"), (jann, tmp_path / "jax")):
        mod.write_chunk_annotations(out, batch, logits)
        mod.concat_annotations(out)
    for sub in ("target", "pred"):
        names = sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        assert names == ["va.times.csv", "vb.times.csv"]
        for name in names:
            assert ((tmp_path / "port" / sub / name).read_bytes()
                    == (tmp_path / "jax" / sub / name).read_bytes())
    assert tann.dedup_consecutive([3, 4, 5, 6, 9, 10]) == [3, 5, 9]


@pytest.fixture(scope="module")
def onset_fixture(tmp_path_factory):
    """tests/test_scripts_cli.py's fit/test fixture: 2 videos of 2.2 s at
    5 fps (one 10-frame chunk each), a tiny config as JSON."""
    tmp = tmp_path_factory.mktemp("onset_cli")
    root = tmp / "gh"
    names = ["vid_a", "vid_b"]
    for v, name in enumerate(names):
        make_video(root, name, 2.2, 5, size=(24, 24), times="0.5,hit\n1.5,hit\n", seed=v)
    for split in ("train", "val", "test"):
        (root / f"{split}.txt").write_text("\n".join(names) + "\n")
    cfg = {
        "data": {"root_dir": str(root), "train_split_file_path": str(root / "train.txt"),
                 "val_split_file_path": str(root / "val.txt"),
                 "test_split_file_path": str(root / "test.txt"),
                 "batch_size": 2, "num_workers": 2, "frame_size": 16, "fps": 5},
        "model": {"lr": 1e-3, "layers": [1, 1, 1, 1]},
        "trainer": {"max_epochs": 2, "check_val_every_n_epoch": 1,
                    "log_every_n_steps": 1, "seed": 0, "logs_dir": str(tmp / "logs")},
    }
    (tmp / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "f32.json").write_text(json.dumps({"model": {"precision": 32}}))
    return tmp


def _records(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_train_onset_fit_resume_and_test(onset_fixture):
    tmp = onset_fixture
    cfgs = ["-c", str(tmp / "tiny.json"), "-c", str(tmp / "f32.json")]
    state = train_onset.main(["fit", *cfgs, "--device", "cpu"])
    assert state.step == 2  # 1 full batch of 2 chunks an epoch, 2 epochs
    (run,) = (tmp / "logs").iterdir()
    assert json.loads((run / "config.json").read_text())["model"]["precision"] == "32"
    recs = _records(run)
    train = [r for r in recs if "loss/train" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss/train"]) and r["sec_per_step"] > 0 for r in train)
    assert all({"AP", "Acc", "OnsNumAcc"} <= r.keys() for r in train)
    val = [r for r in recs if "loss/val" in r]
    assert [r["step"] for r in val] == [1, 2] and np.isfinite(val[-1]["loss/val"])
    ckpt = Checkpointer(CheckpointConfig(run / "ckpts", monitor="loss/val"))
    assert ckpt.latest_step() == 2 and ckpt.best_step() in (1, 2)
    saved = ckpt.restore()
    net = VideoOnsetNet((1, 1, 1, 1))
    net.load_state_dict(saved["model"], strict=True)
    assert saved["optimizer"]["adamw"]["state"]

    resumed = train_onset.main(["fit", *cfgs, "--ckpt_path", str(run / "ckpts"),
                                "--device", "cpu"])
    assert resumed.step == 4
    (second,) = set((tmp / "logs").iterdir()) - {run}
    assert [r["step"] for r in _records(second) if "loss/train" in r] == [3, 4]

    train_onset.main(["test", *cfgs, "--ckpt_path", str(second / "ckpts"),
                      "--device", "cpu"])
    (third,) = set((tmp / "logs").iterdir()) - {run, second}
    (rec,) = _records(third)
    assert {"loss/test", "AP/test", "Acc/test", "OnsNumAcc/test"} == rec.keys() - {"_time"}
    ann = third / "media" / "annotations"
    for sub in ("target", "pred"):
        assert sorted(p.name for p in (ann / sub).iterdir()) == [
            "vid_a.times.csv", "vid_b.times.csv"]
    # the targets merged back to each video's times (0.5 s and 1.5 s)
    np.testing.assert_allclose(np.loadtxt(ann / "target" / "vid_a.times.csv"), [0.4, 1.4])
    plots = sorted(p.name for p in (third / "media" / "labels").iterdir())
    assert plots == ["labels_b0-0_vid_a_step00000000.png",
                     "labels_b0-1_vid_b_step00000000.png"]


def test_video_to_foley_onset_times_match_jax(tmp_path, monkeypatch):
    """The JAX predict_onset_times against the port's command line on the
    same weights, converted into a train_onset checkpoint; then the tiny
    UNet samples a finite wav of --length samples.  The weights are the
    ones predict_onset_times draws without a checkpoint (key 0), with
    fc2's bias moved so that the median logit of the video is the 0.5
    threshold (that init alone predicts no onset here)."""
    import dataclasses

    import video_to_foley as jvf

    from syncfusion_tpu.models.onset_net import VideoOnsetNet as JaxOnsetNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    video = make_video(tmp_path / "videos", "vid", 4.4, 5, size=(120, 128),
                       times="", seed=7)
    chunks = video_to_foley.read_chunks(video)
    assert len(chunks) == 2 and chunks[0]["frames"].shape == (10, 112, 112, 3)
    frames = np.stack([c["frames"] for c in chunks])
    jt = jvf.OnsetTrainer(model=JaxOnsetNet(layers=(1, 1, 1, 1)))
    state = jt.init(jax.random.key(0), frames_shape=(1, 10, 112, 112, 3))
    shift = 0.5 - float(np.median(np.asarray(jt.forward(state, frames))))
    init = jvf.OnsetTrainer.init

    def shifted_init(self, key, frames_shape):
        st = init(self, key, frames_shape=frames_shape)
        params = {**st.params, "fc2": {**st.params["fc2"],
                                       "bias": st.params["fc2"]["bias"] + shift}}
        return dataclasses.replace(st, params=params)

    monkeypatch.setattr(jvf.OnsetTrainer, "init", shifted_init)
    want = jvf.predict_onset_times(video, None, layers=(1, 1, 1, 1))
    state = jt.init(jax.random.key(0), frames_shape=(1, 10, 112, 112, 3))
    sd = onset_state_dict({"params": jax.tree_util.tree_map(np.asarray, state.params),
                           "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                 state.batch_stats)})
    Checkpointer(CheckpointConfig(tmp_path / "onset", monitor="loss/val")).save(
        0, {"model": sd}, {"loss/val": 1.0})

    # every logit's margin from the threshold, so that f32 rounding cannot
    # move an onset
    net = video_to_foley.load_onset_net(tmp_path / "onset", (1, 1, 1, 1), "cpu")
    with torch.no_grad():
        logits = net(torch.from_numpy(frames))
    assert (logits - 0.5).abs().min() > 1e-4

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": UNET, "onsets_encoder": ENC}))
    out = tmp_path / "foley.wav"
    got = video_to_foley.main([
        "--video_dir", str(video), "--onset_ckpt", str(tmp_path / "onset"),
        "--onset_layers", "1", "1", "1", "1", "--model_config", str(cfg),
        "--length", str(L), "--num_steps", "2", "--sampler", "dpm",
        "--output", str(out), "--device", "cpu"])
    assert len(want) > 0
    np.testing.assert_array_equal(got["times"], want)
    assert set(got["seconds"]) == {"onset", "clap", "generation"}
    wav, sr = read_wav(out)
    assert sr == 48000 and wav.shape == (1, L) and np.isfinite(wav).all()
