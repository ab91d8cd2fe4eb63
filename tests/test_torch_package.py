"""Guards of the port package: what it imports, where it runs, and its
command line end to end on the CPU at the tiny config."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import syncfusion_tpu_torch
from syncfusion_tpu.ops.wav import read_wav
from syncfusion_tpu_torch import device as port_device
from syncfusion_tpu_torch import generate
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops import attention as ta
from syncfusion_tpu_torch.convert import flatten
from torch_port_helpers import ENC, UNET, L, tiny_pair, to_numpy

ROOT = Path(__file__).resolve().parents[1]
# pandas: the JAX evaluation script writes metrics.csv with it; the card's
# machine does not promise it, the port writes the CSV with ``csv``
# matplotlib: the JAX generation script draws its spectrograms with it; the
# card's machine has none, the port draws them with PIL
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "syncfusion_tpu", "pandas",
             "matplotlib"}
# and the ranks of the multi-process tests, which run the port alone
PORT_FILES = sorted(Path(syncfusion_tpu_torch.__file__).parent.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_workers.py"]


def _imports(tree):
    """(top-level module, enclosing function or None) for every import."""
    out = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Import):
            out.extend((a.name.split(".")[0], func) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.module.split(".")[0], func))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, None)
    return out


def test_guards_cover_the_evaluation_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"syncfusion_tpu_torch/{m}.py" for m in (
        "eval/onset_detect", "eval/onset_metrics", "eval/fad", "eval/generation",
        "eval/mp4", "eval/mux", "evaluate_diffusion", "evaluate_onset",
        "evaluate_onset_baseline")} <= names


def test_guards_cover_the_multi_device_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"syncfusion_tpu_torch/core/mesh.py", "syncfusion_tpu_torch/train/sharding.py",
            "syncfusion_tpu_torch/parallel/sampling.py",
            "syncfusion_tpu_torch/data/shards.py", "tests/torch_dist_workers.py"} <= names


def test_guards_cover_the_baseline_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"syncfusion_tpu_torch/{m}.py" for m in (
        "models/vqgan/autoencoder", "models/vqgan/quantize", "models/vqgan/model",
        "models/mingpt", "models/mingpt_decode", "models/transformer_av",
        "models/melgan", "models/init", "data/baseline_dataset", "generate_audio")} <= names


def test_guards_cover_the_checkpoint_modules():
    """The published-checkpoint paths: the a-unet twins and their loader,
    the SpecVQGAN/minGPT converters, the style transfer and its L-BFGS."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"syncfusion_tpu_torch/{m}.py" for m in (
        "models/adp_torch_recon", "models/adp_compat", "models/adp_convert",
        "models/vqgan/convert", "eval/style_transfer", "train/lbfgs")} <= names


def test_guards_cover_the_tail_modules():
    """Distillation, the raw-data tail, the video ResNet family and the
    run utilities; the native reader's C++ source is the port's own copy."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"syncfusion_tpu_torch/{m}.py" for m in (
        "train/distill", "distill_diffusion", "ops/denoise", "data/shard_writer",
        "data/native", "eval/video_utils", "gh_make_synthetic", "gh_make_shards",
        "gh_preprocess_videos", "models/video_resnet", "core/profiler",
        "utils/misc")} <= names
    assert (ROOT / "syncfusion_tpu_torch" / "csrc" / "sfx_io.cpp").is_file()


def test_guards_cover_the_overfit_quality_modules():
    """The two overfit-to-quality entry points, counterparts of the JAX
    scripts that import the JAX package (and scikit-learn, optax)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"syncfusion_tpu_torch/overfit_quality.py",
            "syncfusion_tpu_torch/overfit_quality_stage2.py"} <= names


def test_nothing_of_the_port_imports_the_exporter():
    """script/export_params_npz.py imports the JAX package; the port and
    chip_smoke.py reach it by no import, and it lies outside the package."""
    exporter = ROOT / "script" / "export_params_npz.py"
    assert exporter.is_file() and exporter not in PORT_FILES
    for path in PORT_FILES:
        mods = {mod for mod, _ in _imports(ast.parse(path.read_text()))}
        assert "export_params_npz" not in mods and "script" not in mods, path.name
    assert "syncfusion_tpu" in {mod for mod, _ in _imports(ast.parse(exporter.read_text()))}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    for mod, func in _imports(ast.parse(path.read_text())):
        if mod == "yaml" and func == "from_yaml":
            continue  # the optional reader, for callers that have PyYAML
        assert mod not in FORBIDDEN, f"{path.name} imports {mod} (in {func})"


# modules the card's machine does not promise: imported only inside the
# functions that use them (PIL decodes and draws; regex and transformers
# tokenize)
FUNCTION_ONLY = {"PIL", "regex", "transformers"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_pil_only_in_functions_and_never_sklearn(path):
    """PIL, regex, transformers and scikit-learn are not among the packages
    the card's machine promises (scikit-learn is absent there): the port
    and chip_smoke.py import the first three only inside the functions that
    use them, and scikit-learn nowhere."""
    for mod, func in _imports(ast.parse(path.read_text())):
        assert mod != "sklearn", f"{path.name} imports sklearn (in {func})"
        assert mod not in FUNCTION_ONLY or func is not None, (
            f"{path.name} imports {mod} at module level")


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyncFusionDiffusion.from_config(None)
    assert port_device.default_device("cpu") == torch.device("cpu")


def test_default_device_is_the_local_rank_card_under_torchrun(monkeypatch):
    """One process per card: torchrun's LOCAL_RANK names the card; without
    a card the rule is unchanged (it raises unless a device is named)."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_device.default_device() == torch.device("cuda", 3)
    assert port_device.default_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.default_device()
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_device.default_device() == torch.device("cuda")


def test_config_defaults_are_the_yaml():
    from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig, from_yaml

    assert from_yaml(ROOT / "exp/model/diffusion.yaml") == (UNetConfig(), EncoderConfig())


def test_onset_config_defaults_are_the_yaml():
    """OnsetConfig's defaults hold every key of the onset YAMLs, and the
    f32 overlay merged after them gives precision 32."""
    from syncfusion_tpu_torch.core.config import OnsetConfig, from_yaml

    cfg = OnsetConfig()
    files = {"data": "cfg/data/data-onset-greatesthit.yaml",
             "model": "cfg/model/model-onset.yaml",
             "trainer": "cfg/trainer/trainer-onset.yaml"}
    for node, path in files.items():
        got = getattr(cfg, node)
        for key, val in from_yaml(ROOT / path, raw=True)[node].items():
            if isinstance(getattr(got, key), float):
                val = float(val)  # YAML 1.1 reads 1e-4 as a string
            assert getattr(got, key) == val, (node, key)
    merged = OnsetConfig.from_files([ROOT / p for p in files.values()])
    assert merged == cfg
    f32 = OnsetConfig.from_files([ROOT / p for p in files.values()]
                                 + [ROOT / "cfg/model/model-onset-f32.yaml"])
    assert f32.model.precision == "32" and f32.model.lr == 1e-4
    assert f32.data == cfg.data and f32.trainer == cfg.trainer


def test_baseline_config_defaults_are_the_yaml():
    """BaselineConfig's defaults hold the transformer YAML's ``transformer``,
    top-level and ``data`` keys and the codebook YAML's model geometry,
    ``learning_rate`` and ``lossconfig``; a key the YAMLs leave out holds the
    JAX scripts' default (``frame_size`` 112, ``p_audio_aug`` 0.5,
    ``rand_shift`` true, the data shares 1.0), and the keys where the two
    scripts' defaults differ or where they have none (``logs_dir``,
    ``trainer.max_epochs``, ``data.batch_size``) are None, for each entry
    point to fill.  Reading either YAML gives the defaults back with those
    keys set; ``n_frames`` and ``lossconfig.disc_factor``, which the JAX
    scripts do not read from the config, are ignored."""
    import dataclasses

    from syncfusion_tpu_torch.core.config import BaselineConfig, from_yaml

    cfg = BaselineConfig()
    tr = from_yaml(ROOT / "cfg/condfoleygen/greatesthit_transformer.yaml", raw=True)
    cb = from_yaml(ROOT / "cfg/condfoleygen/greatesthit_codebook.yaml", raw=True)
    assert dataclasses.asdict(cfg.transformer) == tr["transformer"]
    absent = {"frame_size": 112, "train_data_to_use": 1.0, "val_data_to_use": 1.0,
              "rand_shift": True, "p_audio_aug": 0.5, "batch_size": None}
    for key, val in dataclasses.asdict(cfg.data).items():
        assert (absent[key] if key in absent else tr["data"][key]) == val, key
    model = {**cb["model"]["ddconfig"], "embed_dim": cb["model"]["embed_dim"],
             "n_embed": cb["model"]["n_embed"]}
    for key, val in dataclasses.asdict(cfg.model).items():
        want = model[key]
        assert val == (tuple(want) if isinstance(want, list) else want), key
    assert cfg.vq_learning_rate == float(cb["model"]["learning_rate"])
    loss = dataclasses.asdict(cfg.lossconfig)
    assert {k: loss[k] for k in cb["model"]["lossconfig"]} == cb["model"]["lossconfig"]
    assert cfg.logs_dir is None and cfg.trainer.max_epochs is None
    # keys the JAX scripts do not read from the config are ignored
    assert BaselineConfig.from_dict(
        {"n_frames": 30, "model": {"lossconfig": {"disc_factor": 0.0}}}) == cfg
    path = ROOT / "cfg/condfoleygen/greatesthit_transformer.yaml"
    assert BaselineConfig.from_files([path]) == dataclasses.replace(
        cfg, logs_dir="logs/transformer", data=dataclasses.replace(cfg.data, batch_size=4),
        trainer=dataclasses.replace(cfg.trainer, max_epochs=100))
    path = ROOT / "cfg/condfoleygen/greatesthit_codebook.yaml"
    assert BaselineConfig.from_files([path]) == dataclasses.replace(
        cfg, logs_dir="logs/specvqgan", data=dataclasses.replace(cfg.data, batch_size=40),
        trainer=dataclasses.replace(cfg.trainer, max_epochs=1000))


def test_generate_end_to_end_on_cpu(tmp_path, monkeypatch):
    """The command line with converted JAX parameters (.npz) and an
    embedding (.npy), on the CPU at the tiny config."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, params, _ = tiny_pair(seed=5)
    npz = tmp_path / "params.npz"
    np.savez(npz, **{"/".join(k): v for k, v in flatten(to_numpy(params)).items()})
    emb = tmp_path / "emb.npy"
    np.save(emb, np.random.default_rng(0).standard_normal(16).astype(np.float32))
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": UNET, "onsets_encoder": ENC}))
    times = tmp_path / "times.txt"
    times.write_text("0.001\n0.004\n")
    out = tmp_path / "foley.wav"
    before = ta.flash_attention.plain_calls
    generate.main(["--onset_times", str(times), "--model_config", str(cfg),
                   "--length", str(L), "--num_steps", "3", "--device", "cpu",
                   "--params_npz", str(npz), "--embedding", str(emb),
                   "--output", str(out)])
    wav, sr = read_wav(out)
    assert sr == generate.SR and wav.shape == (1, L)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0
    # 2 attention levels per UNet forward in the tiny config, 3 forwards
    assert ta.flash_attention.plain_calls - before == 3 * (2 + 1 + 2)
    assert ta.flash_attention.kernel_launches == 0


def test_onset_track():
    track = generate.onset_track(np.array([0.0, 0.5, 100.0]), length=48000)
    assert track.shape == (1, 48000, 1)
    assert np.flatnonzero(track[0, :, 0]).tolist() == [0, 24000]


def test_seeded_init_is_deterministic():
    cfg = {"model": UNET, "onsets_encoder": ENC}
    a, b, c = (SyncFusionDiffusion.from_config(cfg, device="cpu", seed=s).state_dict()
               for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["unet.head.weight"], c["unet.head.weight"])
    assert all(torch.isfinite(v).all() for v in a.values())
