"""The port's spectrogram style transfer against the JAX package's
(``eval/style_transfer.py``) and its L-BFGS against optax's.

* ``Vgg19Prefix`` on a seeded torchvision-layout state dict, through both
  converters: activations to 1e-4; the gram matrix to 1e-5; the uint8
  image round trip bitwise.
* ``train/lbfgs.py`` against ``optax.lbfgs()`` with the JAX function's
  clamp, in f64 on a small image and an objective of the same form (gram
  matrices and a content term of two feature maps): the first 5 steps'
  images and values to 1e-8 relative.
* ``run_style_transfer``: its first value against the JAX function's to
  1e-5, 40 steps that move the image toward the style (on the weights of
  tests/test_style_transfer.py).
* ``generate_audio --style_transfer`` on the CPU at the tiny baseline
  config: its wavs equal the port's own pipeline on the same items.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from syncfusion_tpu.eval import style_transfer as jst
from syncfusion_tpu_torch import generate_audio
from syncfusion_tpu_torch.convert import clap_state_dict
from syncfusion_tpu_torch.core.config import BaselineConfig
from syncfusion_tpu_torch.data.baseline_dataset import (
    CondGreatestHitsWaveCondOnImage,
    baseline_loader,
)
from syncfusion_tpu_torch.eval import style_transfer as st
from syncfusion_tpu_torch.models.vqgan.model import wav_to_spec
from syncfusion_tpu_torch.ops import attention as ta
from syncfusion_tpu_torch.ops.mel import mel01_to_waveform_gl
from syncfusion_tpu_torch.ops.wav import read_wav
from syncfusion_tpu_torch.train.lbfgs import LBFGS
from test_baseline_stack import gh_root  # noqa: F401  (fixture)
from test_style_transfer import _synth_vgg_state_dict
from test_torch_condfoleygen_cli import tiny_config
from torch_port_helpers import n


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _vgg_pair(seed=0):
    sd = _synth_vgg_state_dict(np.random.default_rng(seed))
    variables = jst.convert_torch_vgg19(sd)
    vgg = st.Vgg19Prefix()
    vgg.load_state_dict(st.convert_torch_vgg19({k: torch.from_numpy(v)
                                                 for k, v in sd.items()}), strict=True)
    return variables, vgg.eval()


def test_vgg19_prefix_matches_jax():
    variables, vgg = _vgg_pair()
    # the generic Flax rule maps the JAX tree onto the same state dict
    from_jax = clap_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    for k, v in vgg.state_dict().items():
        np.testing.assert_array_equal(n(from_jax[k]), n(v), err_msg=k)
    img = np.random.default_rng(1).uniform(size=(1, 32, 48, 3)).astype(np.float32)
    want = jst.Vgg19Prefix().apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = vgg(torch.from_numpy(img))
    assert got.keys() == want.keys() == set(st.STYLE_LAYERS)
    for layer in st.STYLE_LAYERS:
        assert got[layer].shape == want[layer].shape
        assert _rel(n(got[layer]), np.asarray(want[layer])) < 1e-4, layer


def test_gram_matrix_and_the_image_round_trip_match_jax():
    feat = np.random.default_rng(2).standard_normal((2, 6, 5, 4)).astype(np.float32)
    got = st.gram_matrix(torch.from_numpy(feat))
    want = np.asarray(jst.gram_matrix(jnp.asarray(feat)))
    assert got.shape == want.shape == (8, 8)
    assert _rel(n(got), want) < 1e-5
    spec = np.random.default_rng(3).uniform(size=(80, 200)).astype(np.float32)
    for take in (192, 160):
        img = st.load_specs_as_img(spec, take)
        assert img.shape == (1, 80, take, 3) and img.dtype == torch.float32
        np.testing.assert_array_equal(n(img), np.asarray(jst.load_specs_as_img(spec, take)))
        np.testing.assert_array_equal(n(st.load_specs_as_img(torch.from_numpy(spec), take)),
                                      n(img))


# an objective of the style loss's form, small enough for f64 on both sides:
# two feature maps of the image, their gram matrices against a style's and
# the second against a content target
def _features(img, w1, w2, tanh):
    a = img @ w1
    return a, tanh(a) @ w2


def _objective(xp_gram, tanh, w1, w2, style_grams, content):
    def loss(img):
        a, b = _features(img, w1, w2, tanh)
        style = sum(((xp_gram(f) - g) ** 2).mean() for f, g in zip((a, b), style_grams))
        return 100.0 * style + ((b - content) ** 2).mean()
    return loss


def test_lbfgs_trajectory_matches_optax_in_f64():
    rng = np.random.default_rng(4)
    h, w = 6, 8
    content_img = np.tile(np.linspace(0.2, 0.8, w), (h, 1))[None, :, :, None].repeat(3, -1)
    style_img = (((np.mgrid[:h, :w].sum(0)) % 2).astype(np.float64))[None, :, :, None]
    style_img = style_img.repeat(3, -1)
    w1, w2 = rng.standard_normal((3, 5)), rng.standard_normal((5, 4)) / 2
    steps = 5

    with jax.enable_x64(True):
        jw1, jw2 = jnp.asarray(w1), jnp.asarray(w2)
        s_a, s_b = _features(jnp.asarray(style_img), jw1, jw2, jnp.tanh)
        _, c_b = _features(jnp.asarray(content_img), jw1, jw2, jnp.tanh)
        loss_fn = _objective(jst.gram_matrix, jnp.tanh, jw1, jw2,
                             (jst.gram_matrix(s_a), jst.gram_matrix(s_b)), c_b)
        opt = optax.lbfgs()
        value_and_grad = optax.value_and_grad_from_state(loss_fn)

        @jax.jit
        def step(img, state):
            value, grad = value_and_grad(img, state=state)
            updates, state = opt.update(grad, state, img, value=value, grad=grad,
                                        value_fn=loss_fn)
            return jnp.clip(optax.apply_updates(img, updates), 0.0, 1.0), state, value

        img, state = jnp.asarray(content_img), opt.init(jnp.asarray(content_img))
        want_imgs, want_values = [], []
        for _ in range(steps):
            img, state, value = step(img, state)
            want_imgs.append(np.asarray(img))
            want_values.append(float(value))
        assert img.dtype == jnp.float64

    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)
    s_a, s_b = _features(torch.from_numpy(style_img), tw1, tw2, torch.tanh)
    _, c_b = _features(torch.from_numpy(content_img), tw1, tw2, torch.tanh)
    loss = _objective(st.gram_matrix, torch.tanh, tw1, tw2,
                      (st.gram_matrix(s_a), st.gram_matrix(s_b)), c_b)

    def torch_value_and_grad(x):
        x = x.detach().requires_grad_(True)
        value = loss(x)
        return value.detach(), torch.autograd.grad(value, x)[0]

    got_imgs, got_values = [], []
    x = torch.from_numpy(content_img)
    opt_t = LBFGS()
    for _ in range(steps):
        x, value = opt_t.step(x, torch_value_and_grad)
        x = x.clamp(0.0, 1.0)
        got_imgs.append(n(x))
        got_values.append(float(value))
    assert x.dtype == torch.float64
    moved = [_rel(a, content_img) for a in want_imgs]
    assert min(moved) > 1e-3  # every step moved the image
    for i in range(steps):
        assert _rel(got_imgs[i], want_imgs[i]) < 1e-8, i
        assert abs(got_values[i] - want_values[i]) <= 1e-8 * abs(want_values[i]), i
    assert want_values[-1] < want_values[0]


def test_run_style_transfer_moves_toward_the_style():
    """The JAX test's weights and images.  Past ~10 steps the clamped
    L-BFGS path is chaotic under f32 rounding (line searches that fail and
    fall back; the f64 test above follows optax step for step), so the 40
    steps are held to moving toward the style, not to the JAX run's
    endpoint: on these weights the JAX run ends at 0.49 of the content
    image's style distance and the port at 0.85."""
    variables, vgg = _vgg_pair(seed=0)
    h, w = 16, 24
    content = np.tile(np.linspace(0.2, 0.8, w, dtype=np.float32), (h, 1))
    style = (np.mgrid[:h, :w].sum(0) % 2).astype(np.float32)
    c_img, s_img = st.load_specs_as_img(content, w), st.load_specs_as_img(style, w)

    # the first step starts from the content image's loss: the JAX value
    _, want_first = jst.run_style_transfer(variables, jnp.asarray(n(c_img)),
                                           jnp.asarray(n(s_img)), num_steps=1,
                                           style_weight=1e4)
    _, got_first = st.run_style_transfer(vgg, c_img, s_img, num_steps=1, style_weight=1e4)
    assert abs(got_first - float(want_first)) <= 1e-5 * abs(float(want_first))

    ta.reset_counts()
    out, final = st.run_style_transfer(vgg, c_img, s_img, num_steps=40, style_weight=1e4)
    assert out.shape == c_img.shape and torch.all((out >= 0.0) & (out <= 1.0))
    assert np.isfinite(final) and final < got_first
    assert all(getattr(ta.flash_attention, c) == 0 for c in ta.COUNTS)
    assert all(not p.requires_grad or p.grad is None for p in vgg.parameters())

    def style_dist(img):
        with torch.no_grad():
            a, s = vgg(img), vgg(s_img)
        return sum(float(torch.mean((st.gram_matrix(a[layer]) - st.gram_matrix(s[layer]))
                                    ** 2)) for layer in st.STYLE_LAYERS)

    assert style_dist(out) < 0.9 * style_dist(c_img)
    assert final < 0.9 * got_first
    mel = st.style_transfer_mel(vgg, content, style, spec_take_first=w, num_steps=2,
                                style_weight=1e4)
    assert mel.shape == (h, w) and 0.0 <= float(mel.min()) <= float(mel.max()) <= 1.0


def test_generate_audio_style_transfer_on_the_cpu(gh_root, tmp_path):  # noqa: F811
    cfg_path = tiny_config(tmp_path, gh_root)
    out = tmp_path / "gen"
    argv = ["--gh_testset", "-c", str(cfg_path), "--output_dir", str(out), "--batch_size",
            "2", "--data_to_use", "0.7", "--style_transfer", "--style_steps", "2",
            "--device", "cpu"]
    summary = generate_audio.main(argv)
    wavs = sorted((out / "generated_audio").glob("*_to_*.wav"))
    assert summary["clips"] == len(wavs) >= 2
    for sub in ("orig_audio", "cond_audio", "generated_video", "orig_video", "cond_video"):
        assert any((out / sub).iterdir()), sub

    # the same items through the port's pieces: the VQ reconstructions, the
    # style transfer on the seeded VGG, Griffin-Lim
    cfg = BaselineConfig.from_files([str(cfg_path)])
    model = generate_audio.build_model(cfg, "cpu", seed=0)
    vgg = generate_audio.load_vgg19(None, "cpu", seed=0)
    d = cfg.data
    ds = CondGreatestHitsWaveCondOnImage(
        d.root_dir, d.test_split_file_path, data_to_use=0.7,
        chunk_length_in_seconds=d.chunk_length_in_seconds, sample_rate=d.sample_rate,
        rand_shift=False, p_outside_cond=1.0, frame_size=d.frame_size)
    batch = next(iter(baseline_loader(ds, 2)))
    with torch.no_grad():
        ref = generate_audio.reconstruction01(
            model, wav_to_spec(torch.from_numpy(batch["image"]))[:, None])
        cond = generate_audio.reconstruction01(
            model, wav_to_spec(torch.from_numpy(batch["cond_image"]))[:, None])
    styled = torch.stack([st.style_transfer_mel(vgg, ref[i], cond[i],
                                                spec_take_first=ref.shape[-1], num_steps=2)
                          for i in range(2)])
    want = n(mel01_to_waveform_gl(styled, 22050))  # Griffin-Lim of the batch, as main
    n_samp = int(22050 * d.chunk_length_in_seconds)
    for i in range(2):
        got, sr = read_wav(next((out / "generated_audio").glob(f"*_{i}.wav")))
        assert sr == 22050
        np.testing.assert_array_equal(got[0], want[i][:n_samp])
