"""The rest of the port's tail against the JAX package: the video ResNet
family (``models/video_resnet.py``), ``utils/misc.py``,
``core/profiler.py`` and ``models/clap/convert.convert_hf_clap_audio``.

* ``r3d_18``, ``mc3_18`` and ``r2plus1d_18`` with BasicBlocks, and a
  Bottleneck net of each builder family (layers (1, 1, 1, 1)), on the JAX
  family's parameters (drawn with numpy into its init's tree, as
  tests/test_torch_condfoleygen_train.py's ``random_tree`` does, to skip
  XLA's init compiles) through ``from_jax``: (1, 3, 4, 32, 32) frames, eval
  mode, within 1e-5 of the largest output; the state dict carries
  torchvision's names.  (Train mode's batch statistics at this size reduce
  over 4 elements a channel at the last stage, where the two packages'
  roundings of mean(x²) - mean² part by ~1e-3: not compared here.)
* ``count_params``, ``log_hyperparameters``, ``load_dotenv`` and
  ``retry_if_error`` against the JAX functions.
* ``StepTimer`` and ``trace`` on the CPU (the card's side: chip_smoke.py
  phase 20d).
* ``convert_hf_clap_audio`` against the JAX converter on a seeded
  transformers-named state dict of the HTSAT-tiny tower.
"""

import json
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import video_resnet as jvr
from syncfusion_tpu.models.clap import convert as jclap_convert
from syncfusion_tpu.utils import misc as jmisc
from syncfusion_tpu_torch.convert import clap_state_dict
from syncfusion_tpu_torch.core import profiler
from syncfusion_tpu_torch.models import video_resnet as tvr
from syncfusion_tpu_torch.models.clap import convert as tclap_convert
from syncfusion_tpu_torch.utils import misc as tmisc
from test_torch_clap import laion_state_dict
from torch_port_helpers import n, t

FRAMES = (1, 4, 32, 32, 3)  # (B, T, H, W, C) as the JAX family takes them
VR_TOL = 1e-5


def random_tree(init, seed):
    """Variables of the shapes ``init()`` would give, drawn with numpy:
    kernels normal of variance 1/fan-in, BatchNorm scales 1 + 0.1·normal,
    variances U(0.5, 1.5), the rest 0.1·normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(leaf(path, s), np.float32), jax.eval_shape(init))


NETS = {
    "r3d_18": (jvr.r3d_18, tvr.r3d_18, {}),
    "mc3_18": (jvr.mc3_18, tvr.mc3_18, {}),
    "r2plus1d_18": (jvr.r2plus1d_18, tvr.r2plus1d_18, {}),
    "r3d_bottleneck": (jvr.r3d_18, tvr.r3d_18, {"block": "bottleneck",
                                                "layers": (1, 1, 1, 1)}),
    "mc3_bottleneck": (jvr.mc3_18, tvr.mc3_18, {"block": "bottleneck",
                                                "layers": (1, 1, 1, 1),
                                                "num_classes": 5}),
    "r2plus1d_bottleneck": (jvr.r2plus1d_18, tvr.r2plus1d_18,
                            {"block": "bottleneck", "layers": (1, 1, 1, 1)}),
}


@pytest.mark.parametrize("name", list(NETS))
def test_video_resnet_matches_jax(name):
    jfn, tfn, kw = NETS[name]
    jnet = jfn(**kw)
    x = np.random.default_rng(1).standard_normal(FRAMES).astype(np.float32)
    variables = random_tree(lambda: jnet.init(jax.random.key(0), jnp.asarray(x)), 2)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    net = tfn(**kw).eval()
    net.load_state_dict(tvr.from_jax(variables), strict=True)
    got = n(net(t(x).permute(0, 4, 1, 2, 3)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= VR_TOL * np.abs(want).max()
    names = set(net.state_dict())
    assert "stem.0.weight" in names and "stem.1.num_batches_tracked" in names
    if name.startswith("r2plus1d"):
        assert {"stem.3.weight", "stem.4.running_var"} <= names
    if name == "r2plus1d_18":  # the factored conv, torchvision's Conv2Plus1D
        assert {"layer1.0.conv1.0.0.weight", "layer1.0.conv1.0.1.running_mean",
                "layer1.0.conv1.0.3.weight", "layer2.0.downsample.1.weight"} <= names


def test_count_params_and_log_hyperparameters_match_jax(tmp_path):
    tree = {"a": np.zeros((3, 4)), "b": {"c": np.zeros(5), "d": None}, "e": [np.zeros(2)]}
    assert tmisc.count_params(tree) == jmisc.count_params(tree) == 19
    module = torch.nn.Linear(3, 4)
    assert tmisc.count_params(module) == 16
    cfg = {"lr": 1e-4, "path": tmp_path}
    tmisc.log_hyperparameters(tmp_path / "port", cfg, tree)
    jmisc.log_hyperparameters(tmp_path / "jax", cfg, tree)
    got = json.loads((tmp_path / "port" / "hparams.json").read_text())
    want = json.loads((tmp_path / "jax" / "hparams.json").read_text())
    assert {k: got[k] for k in ("config", "param_count", "packages")} == {
        k: want[k] for k in ("config", "param_count", "packages")}
    assert got["devices"][0] == "cpu"


def test_load_dotenv_matches_jax(tmp_path, monkeypatch):
    env = tmp_path / ".env"
    env.write_text("# creds\n\nexport SFX_A=1\nSFX_B='two words'\nSFX_C=\"q\"\n"
                   "novalue\nSFX_D = spaced \n")
    monkeypatch.setenv("SFX_D", "kept")
    for name in ("SFX_A", "SFX_B", "SFX_C"):
        monkeypatch.delenv(name, raising=False)
    want = jmisc.load_dotenv(env, override=False)
    assert os.environ["SFX_D"] == "kept"
    got = tmisc.load_dotenv(env, override=False)
    assert got == want == {"SFX_A": "1", "SFX_B": "two words", "SFX_C": "q",
                           "SFX_D": "spaced"}
    assert tmisc.load_dotenv(env)["SFX_D"] == os.environ["SFX_D"] == "spaced"
    assert tmisc.load_dotenv(tmp_path / "absent") == jmisc.load_dotenv(tmp_path / "absent") == {}


def test_retry_if_error_matches_jax(caplog):
    def flaky(fails):
        calls = []

        def f(x):
            calls.append(x)
            if len(calls) <= fails:
                raise OSError(f"boom {len(calls)}")
            return x * 2

        return f, calls

    for mod in (tmisc, jmisc):
        f, calls = flaky(2)
        with caplog.at_level(logging.WARNING):
            assert mod.retry_if_error(f, retries=3, delay=0.0)(4) == 8
        assert len(calls) == 3
        g, calls = flaky(5)
        with pytest.raises(OSError, match="boom 3"):
            mod.retry_if_error(retries=3, delay=0.0)(g)(1)
    assert "attempt 2/3 failed: boom 2" in caplog.text


def test_seed_everything_seeds_every_generator():
    gen = tmisc.seed_everything(7)
    a = (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=gen).item())
    tmisc.seed_everything(7)
    assert (np.random.rand(), torch.rand(1).item()) == a[:2]
    assert torch.rand(1, generator=torch.Generator().manual_seed(7)).item() == a[2]


def test_step_timer_and_trace_on_the_cpu(tmp_path):
    timer = profiler.StepTimer(warmup=1)
    timer.start()
    for _ in range(3):
        time.sleep(0.01)
        timer.tick()
    assert len(timer.times) == 2 and timer.best >= 0.009 and timer.mean >= timer.best
    assert np.isnan(profiler.StepTimer().best)
    with profiler.trace(tmp_path / "tr") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    assert prof.key_averages()


def _hf_names(laion: dict) -> dict:
    """laion_clap's audio keys -> transformers' (the inverse of the
    rename): HF splits the fused qkv and renames the Swin block's parts."""
    out = {}
    for k, v in laion.items():
        k = k[len("module."):]
        if not k.startswith(("audio_branch.", "audio_projection.")):
            continue
        v = np.asarray(v)
        k = k.replace("audio_branch.", "audio_model.audio_encoder.")
        k = k.replace("audio_projection.0.", "audio_projection.linear1.")
        k = k.replace("audio_projection.2.", "audio_projection.linear2.")
        for a, b in ((".norm1.", ".layernorm_before."), (".norm2.", ".layernorm_after."),
                     (".attn.proj.", ".attention.output.dense."),
                     (".attn.relative_position_bias_table",
                      ".attention.self.relative_position_bias_table"),
                     (".mlp.fc1.", ".intermediate.dense."), (".mlp.fc2.", ".output.dense."),
                     ("audio_encoder.bn0.", "audio_encoder.batch_norm.")):
            k = k.replace(a, b)
        if ".attn.qkv." in k:
            base, kind = k.split(".attn.qkv.")
            for part, chunk in zip(("query", "key", "value"), np.split(v, 3)):
                out[f"{base}.attention.self.{part}.{kind}"] = chunk
            continue
        out[k] = v
    return out


def test_convert_hf_clap_audio_matches_jax():
    hf = _hf_names(laion_state_dict(3))
    got = tclap_convert.convert_hf_clap_audio(hf)
    want = clap_state_dict({"params": jclap_convert.convert_hf_clap_audio(hf)})
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(n(got[key]), n(w), err_msg=key)
    assert got["mel_bn_var"].min() > 0
