"""The port's CondFoleyGen training modules against the JAX package, on
the CPU: the quantizer's training side, LPAPS and its reference-weight
loader, the PatchGAN discriminator (BatchNorm and ActNorm), the VQGAN
trainer's steps across ``disc_start`` and with the adaptive weight, its
eval step; the audio augments; the attention panel and the media wavs;
``AVCondTransformer.loss`` with the token corruption, two
``TransformerTrainer`` steps against optax and the decay groups against
``decay_mask``; ``log_images``.

Tiny configs: the VQGAN of tests/test_vqgan.py (``_tiny_model``: a 20 x 40
spectrogram to a 5 x 10 grid) with an ``ndf=8, n_layers=2`` discriminator,
the GPT of tests/test_baseline_stack.py:107-112.  LPAPS's VGG16 trunk has
no tiny width: it runs whole at 20 x 40.  The JAX ``AVCondTransformer`` is
built once for the module.  Parameters have the trees the JAX ``init``s
give, their values drawn with numpy (``random_tree``: XLA's compile of the
R(2+1)D-18's or the VQGAN trainer's init costs seconds).  Weights go from JAX to the port
through ``convert``; inputs come from numpy seeds.

Tolerances: f32 TOL = 1e-5 of the largest magnitude (the two sides sum in
other orders); the training steps in f64 (Adam moves a parameter by ~lr
whatever its gradient's size, so a gradient within f32 rounding of 0 can
move either way): losses 1e-9 relative, parameter updates 1e-6 of the
largest update (the converters round each update to f32); tokens under the
tie rule of tests/test_torch_condfoleygen.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.eval import panels as jpanels
from syncfusion_tpu.models.mingpt import GPTConfig as JaxGPTConfig
from syncfusion_tpu.models.mingpt import GPTFeats as JaxGPTFeats
from syncfusion_tpu.models.onset_net import R2Plus1D18KeepTemp as JaxVideoNet
from syncfusion_tpu.models.transformer_av import AVCondTransformer as JaxAVCondTransformer
from syncfusion_tpu.models.vqgan.discriminator import NLayerDiscriminator as JaxDisc
from syncfusion_tpu.models.vqgan.lpaps import LPAPS as JaxLPAPS
from syncfusion_tpu.models.vqgan.lpaps import convert_lpaps
from syncfusion_tpu.models.vqgan.model import SpecVQGAN as JaxSpecVQGAN
from syncfusion_tpu.models.vqgan.quantize import VectorQuantizer as JaxVQ
from syncfusion_tpu.ops import augment as jaug
from syncfusion_tpu.train import transformer_trainer as jtt
from syncfusion_tpu.train import vqgan_trainer as jvt
from syncfusion_tpu_torch import convert
from syncfusion_tpu_torch.core.config import GPTConfig
from syncfusion_tpu_torch.eval import panels as tpanels
from syncfusion_tpu_torch.models import transformer_av as tav
from syncfusion_tpu_torch.models.mingpt import GPTFeats
from syncfusion_tpu_torch.models.vqgan.discriminator import NLayerDiscriminator
from syncfusion_tpu_torch.models.vqgan.lpaps import LPAPS, reference_state_dict
from syncfusion_tpu_torch.models.vqgan.model import VQModel
from syncfusion_tpu_torch.models.vqgan.quantize import VectorQuantizer
from syncfusion_tpu_torch.ops import augment as taug
from syncfusion_tpu_torch.ops.mel import mel01_to_waveform_gl
from syncfusion_tpu_torch.ops.wav import read_wav
from syncfusion_tpu_torch.train import transformer_trainer as ttt
from syncfusion_tpu_torch.train import vqgan_trainer as tvt
from test_torch_condfoleygen import TINY_VQ, TOL, assert_same_tokens, nchw, nhwc, rel
from test_vqgan import _tiny_model
from torch_port_helpers import n, t, to_numpy

STEP_TOL = 1e-9
UPDATE_TOL = 1e-6
SPEC = (2, 20, 40, 1)
FRAMES = (2, 4, 16, 16, 3)
BASE_GPT = dict(vocab_size=32, block_size=128, n_layer=2, n_head=2, n_embd=16)
# the VGG16 trunk's convs in torchvision's ``features`` numbering
VGG_FEATURES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def random_tree(init, seed):
    """Parameters of the shapes ``init`` (a function of no argument that
    returns a Flax variable tree) would give, drawn with numpy instead of
    run (XLA's compile of a conv net's init costs seconds): kernels normal
    of variance 1/fan-in, norm scales 1 + 0.1·normal, BatchNorm variances
    U(0.5, 1.5), a codebook U(-1/n_e, 1/n_e), the rest 0.1·normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name == "embedding" and s.shape[1] != BASE_GPT["n_embd"]:
            return rng.uniform(-1.0 / s.shape[0], 1.0 / s.shape[0], s.shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    shapes = jax.eval_shape(init)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(leaf(path, s), np.float32), shapes)


def specs(seed, shape=SPEC):
    return np.clip(0.5 * np.random.default_rng(seed).standard_normal(shape), -1, 1)


def assert_updates(got_after, got_before, want_delta, what):
    """Every parameter's update (after − before) of the port within
    UPDATE_TOL of the largest update of the JAX run's ``want_delta``."""
    assert got_after.keys() == want_delta.keys(), what
    scale = max(float(np.abs(n(v)).max()) for v in want_delta.values())
    assert scale > 0, what
    for k, w in want_delta.items():
        d = n(got_after[k]) - n(got_before[k])
        assert np.abs(d - n(w)).max() <= UPDATE_TOL * scale, (what, k)


# ------------------------------------------------------------- quantizer
def test_quantizer_training_side_matches_jax():
    """Loss, perplexity, indices, the straight-through output and the
    gradients with respect to z and the codebook (of Σ w·z_q + 3·loss)."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    w = rng.standard_normal(z.shape).astype(np.float32)
    q = JaxVQ(n_e=16, e_dim=4)
    params = q.init(jax.random.key(1), jnp.asarray(z))

    def f(params, z):
        zq, loss, info = q.apply(params, z)
        return jnp.sum(zq * w) + 3.0 * loss, (zq, loss, info)

    (_, (zq, loss, info)), (gp, gz) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(z))
    tq = VectorQuantizer(16, 4)
    tq.load_state_dict({"embedding": t(params["params"]["embedding"])})
    zt = nchw(z).requires_grad_()
    zq_t, loss_t, info_t = tq.train_forward(zt)
    ((zq_t * nchw(w)).sum() + 3.0 * loss_t).backward()
    np.testing.assert_array_equal(n(info_t["indices"]), np.asarray(info["indices"]))
    assert rel(nhwc(zq_t), zq) <= TOL
    assert abs(loss_t.item() - float(loss)) <= TOL * abs(float(loss))
    assert abs(float(info_t["perplexity"]) - float(info["perplexity"])) <= TOL * 16
    assert rel(nhwc(zt.grad), gz) <= TOL
    assert rel(tq.embedding.grad, gp["params"]["embedding"]) <= TOL


# ----------------------------------------------------------------- LPAPS
@pytest.fixture(scope="module")
def lpaps():
    jl = JaxLPAPS()
    params = to_numpy(jax.jit(lambda: jl.init(jax.random.key(3), jnp.zeros(SPEC),
                                              jnp.zeros(SPEC)))())
    tl = LPAPS()
    tl.load_state_dict(convert.lpaps_state_dict(params), strict=True)
    return jl, params, tl.eval()


def test_lpaps_value_and_input_gradient_match_jax(lpaps):
    jl, params, tl = lpaps
    x, y = specs(1).astype(np.float32), specs(2).astype(np.float32)
    wts = np.array([1.0, 2.0], np.float32)
    val, g = jax.jit(jax.value_and_grad(
        lambda x: jnp.sum(jl.apply(params, x, jnp.asarray(y)) * wts)))(jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    out = tl(xt, nchw(y))
    (out * t(wts)).sum().backward()
    assert out.shape == (2,)
    assert abs((out * t(wts)).sum().item() - float(val)) <= TOL * abs(float(val))
    assert rel(nhwc(xt.grad), g) <= TOL


def test_lpaps_reference_loader_matches_convert_lpaps(lpaps):
    """A reference-layout ``vggishish16.pt`` (``features.{k}``, OIHW) and
    LPAPS lin file made from the JAX weights: ``reference_state_dict``
    gives what the JAX ``convert_lpaps`` gives."""
    jl, params, _ = lpaps
    rng = np.random.default_rng(4)
    net = params["params"]["net"]
    vgg = {}
    for i, k in enumerate(VGG_FEATURES):
        vgg[f"features.{k}.weight"] = net[f"conv_{i}"]["kernel"].transpose(3, 2, 0, 1)
        vgg[f"features.{k}.bias"] = net[f"conv_{i}"]["bias"]
    vgg["classifier.0.weight"] = rng.standard_normal((8, 4)).astype(np.float32)  # ignored
    lin = {f"lin{i}.model.1.weight": rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
           for i, c in enumerate((64, 128, 256, 512, 512))}
    lin["scaling_layer.shift"] = np.array([-0.03], np.float32)
    lin["scaling_layer.scale"] = np.array([0.4], np.float32)
    want_params = convert_lpaps(vgg, lin)
    tl = LPAPS()
    tl.load_state_dict(reference_state_dict({k: t(v) for k, v in vgg.items()},
                                            {k: t(v) for k, v in lin.items()}), strict=True)
    x, y = specs(5).astype(np.float32), specs(6).astype(np.float32)
    want = jax.jit(jl.apply)(want_params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = tl(nchw(x), nchw(y))
    assert rel(got, want) <= TOL


# ------------------------------------------------------- discriminator
@pytest.mark.parametrize("use_actnorm", [False, True])
def test_discriminator_train_and_eval_match_jax(use_actnorm):
    """Two train-mode calls (real, then fake on the moved statistics), as
    the D update makes them, then an eval call: logits, BatchNorm's
    running statistics or ActNorm's first-call init and its flag."""
    jd = JaxDisc(ndf=8, n_layers=2, use_actnorm=use_actnorm)
    variables = to_numpy(jax.jit(lambda: jd.init(jax.random.key(2), jnp.zeros(SPEC)))())
    td = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=use_actnorm)
    td.load_state_dict(convert.discriminator_state_dict(variables), strict=True)
    stats = variables.get("batch_stats", {})
    td.train()
    for seed in (7, 8):
        x = specs(seed).astype(np.float32)
        want, mut = jd.apply({"params": variables["params"], "batch_stats": stats},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = to_numpy(mut["batch_stats"])
        with torch.no_grad():
            got = td(nchw(x))
        assert got.shape == (2, 1, 3, 8) and rel(nhwc(got), want) <= TOL
    sd = td.state_dict()
    want_sd = convert.discriminator_state_dict(
        {"params": variables["params"], "batch_stats": stats})
    for key in [k for k in want_sd if k.endswith(("running_mean", "running_var"))]:
        assert rel(sd[key], want_sd[key]) <= TOL, key
    for key in [k for k in want_sd if k.endswith("initialized")]:
        assert bool(sd[key]) and bool(want_sd[key]), key
    x = specs(9).astype(np.float32)
    want = jd.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = td.eval()(nchw(x))
    assert rel(nhwc(got), want) <= TOL
    if use_actnorm:
        assert bool(td.an1.initialized) and bool(td.an2.initialized)


def test_hinge_d_loss_matches_jax():
    rng = np.random.default_rng(3)
    real, fake = rng.standard_normal((2, 2, 2, 3, 8)).astype(np.float32)
    want = float(jvt.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake)))
    assert abs(float(tvt.hinge_d_loss(t(real), t(fake))) - want) <= TOL * want


# ------------------------------------------------------ the VQGAN step
def _vqgan_pair(loss_kw, lr=1e-3):
    """The JAX trainer's state (``init``'s tree, its values from
    ``random_tree``) and the port's trainer on the same weights, both in
    f64 (call under ``enable_x64``)."""
    jt = jvt.VQGANTrainer(model=_tiny_model(), loss_cfg=jvt.VQGANLossConfig(**loss_kw),
                          learning_rate=lr, discriminator=JaxDisc(ndf=8, n_layers=2))
    zeros = np.zeros(SPEC, np.float32)
    params = random_tree(lambda: jt.model.init(jax.random.key(0), zeros), 30)
    dvars = random_tree(lambda: jt.disc.init(jax.random.key(1), zeros), 31)
    lp_params = random_tree(lambda: jt.lpaps.init(jax.random.key(2), zeros, zeros), 32)
    model = VQModel(**TINY_VQ)
    model.load_state_dict(convert.vqgan_state_dict(params), strict=True)
    disc = NLayerDiscriminator(ndf=8, n_layers=2)
    disc.load_state_dict(convert.discriminator_state_dict(dvars), strict=True)
    lp = LPAPS()
    lp.load_state_dict(convert.lpaps_state_dict(lp_params), strict=True)
    tr = tvt.VQGANTrainer(model.double(), tvt.VQGANLossConfig(**loss_kw), lr, lp.double(),
                          disc.double())
    tstate = tr.create_state((1, 1, 20, 40))
    jt.lpaps_params = f64(lp_params)
    p64, d64 = f64(params), f64(dvars["params"])
    jstate = jvt.VQGANTrainState(step=jnp.zeros((), jnp.int32), params=p64, disc_params=d64,
                                 disc_stats=f64(dvars["batch_stats"]),
                                 opt_state_g=jt.tx_g.init(p64), opt_state_d=jt.tx_d.init(d64))
    return jt, jstate, tr, tstate


def _port_params(tstate):
    return ({k: v.detach().clone() for k, v in tstate.model.state_dict().items()},
            {k: v.detach().clone() for k, v in tstate.disc.state_dict().items()})


def _check_vqgan_run(jt, jstate, tr, tstate, steps):
    """``steps`` train steps on both sides: metrics each step, then every
    parameter's update and the discriminator's statistics."""
    vq0, d0 = _port_params(tstate)
    j0 = jstate
    step = jax.jit(jt._train_step)
    for i in range(steps):
        x = specs(20 + i)
        jstate, jm = step(jstate, jnp.asarray(x))
        tm = tr.train_step(tstate, nchw(x))
        assert tm.keys() == jm.keys()
        for k in jm:
            w = float(jm[k])
            tol = TOL if k == "perplexity" else STEP_TOL  # f32 in both packages
            assert abs(float(tm[k]) - w) <= tol * max(abs(w), 1e-3), (i, k, float(tm[k]), w)
    delta = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), jstate.params, j0.params)
    assert_updates(tstate.model.state_dict(), vq0, convert.vqgan_state_dict(delta), "VQ")
    ddelta = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), jstate.disc_params,
                                    j0.disc_params)
    want = convert.discriminator_state_dict({"params": ddelta})
    sd = tstate.disc.state_dict()
    assert_updates({k: sd[k] for k in want}, d0, want, "D")
    stats = convert.discriminator_state_dict({"params": {}, "batch_stats": to_numpy(
        jstate.disc_stats)})
    for k, w in stats.items():
        assert rel(sd[k], w) <= UPDATE_TOL, k
    return jstate


def test_four_vqgan_steps_across_disc_start_match_jax_f64():
    """disc_start 2: two steps with the discriminator's factor at 0 (it
    runs, its statistics move, its Adam steps on zero gradients), two with
    it on; the GH config's constant adaptive weight and LPAPS on."""
    with jax.enable_x64(True):
        jt, jstate, tr, tstate = _vqgan_pair(dict(disc_start=2))
        jstate = _check_vqgan_run(jt, jstate, tr, tstate, 4)
        assert tstate.step == 4
        assert tstate.opt_d.state[next(tstate.disc.parameters())]["step"] == 4
        x = specs(30)
        want = jax.jit(jt._eval_step)(jstate, jnp.asarray(x))
        got = tr.eval_step(tstate, nchw(x))
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(n(got["val/code_counts"]), np.asarray(want["val/code_counts"]))
    for k in ("val/rec_loss", "val/quant_loss", "val/perplexity", "val/codebook_usage"):
        assert abs(float(got[k]) - float(want[k])) <= TOL * max(abs(float(want[k])), 1), k


def test_vqgan_step_with_the_adaptive_weight_matches_jax_f64():
    """min 0, max 1e4: ‖∇nll‖ / (‖∇g‖ + 1e-4) at the decoder's last conv,
    the discriminator on from step 0, the perceptual term off."""
    with jax.enable_x64(True):
        jt, jstate, tr, tstate = _vqgan_pair(dict(disc_start=0, min_adapt_weight=0.0,
                                                  max_adapt_weight=1e4,
                                                  perceptual_weight=0.0))
        assert tr.lpaps is not None  # made, frozen, unused
        _check_vqgan_run(jt, jstate, tr, tstate, 1)


# ------------------------------------------------------------- augments
def test_audio_augments_match_jax():
    rng = np.random.default_rng(11)
    y = (0.2 * rng.standard_normal(22050)).astype(np.float32)
    np.testing.assert_array_equal(taug.normalize_audio(y), jaug.normalize_audio(y))
    for rate in (0.8, 1.3):
        np.testing.assert_array_equal(taug.time_stretch(y, rate), jaug.time_stretch(y, rate))
    np.testing.assert_array_equal(taug.pitch_shift(y, 22050, 3.7),
                                  jaug.pitch_shift(y, 22050, 3.7))
    for p in (1.0, 0.5):
        a, b = np.random.default_rng(12), np.random.default_rng(12)
        for _ in range(4):
            np.testing.assert_array_equal(taug.random_audio_augment(y, 22050, a, p=p),
                                          jaug.random_audio_augment(y, 22050, b, p=p))
        assert a.random() == b.random()  # the generators drew alike


# ---------------------------------------------------------------- media
def test_attention_panel_and_media_wavs_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(13)
    att = rng.random((3, 2, 12, 12)).astype(np.float32)
    att /= att.sum(-1, keepdims=True)
    for prior in (True, False):
        np.testing.assert_allclose(tpanels.visualize_attention(att, prior),
                                   jpanels.visualize_attention(att, prior), rtol=0, atol=1e-6)
    got = tpanels.write_attention_panel(tmp_path / "t", "val_att_det", att, step=7)
    want = jpanels.write_attention_panel(tmp_path / "j", "val_att_det", att, step=7)
    assert got.name == want.name == "val_att_det_step00000007.png"
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))

    spec01 = rng.random((3, 80, 12)).astype(np.float32)
    paths = tpanels.write_media_wavs(tmp_path / "tw", "val", {"samples_nopix": spec01}, step=3)
    jpaths = jpanels.write_media_wavs(tmp_path / "jw", "val", {"samples_nopix": spec01}, step=3)
    assert [p.name for p in paths] == [p.name for p in jpaths] == [
        "val_samples_nopix_0_step00000003.wav", "val_samples_nopix_1_step00000003.wav"]
    want = n(mel01_to_waveform_gl(t(spec01[:2]), 22050, n_iter=16))
    for i, (p, jp) in enumerate(zip(paths, jpaths)):
        w, sr = read_wav(p)
        assert sr == 22050 and w.shape == read_wav(jp)[0].shape
        np.testing.assert_array_equal(w[0], want[i])


# ------------------------------------------------- the AV transformer
@pytest.fixture(scope="module")
def baseline():
    """The tiny JAX ``AVCondTransformer`` (pkeep 0.5), parameters of its
    init's tree (``random_tree``), and the port with the same parameters."""
    jvq = _tiny_model()
    model = JaxAVCondTransformer(first_stage=JaxSpecVQGAN(jvq),
                                 gpt=JaxGPTFeats(JaxGPTConfig(**BASE_GPT)), pkeep=0.5)

    def init():
        k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
        return {"vq": jvq.init(k1, jnp.zeros(SPEC)),
                "video": JaxVideoNet().init(k2, jnp.zeros((1, 2, 16, 16, 3)), train=False),
                "gpt": model.gpt.init(k3, jnp.zeros((1, 99), jnp.int32),
                                      jnp.zeros((1, 4, 512)))}

    params = random_tree(init, 33)
    port = tav.AVCondTransformer(VQModel(**TINY_VQ), GPTFeats(GPTConfig(**BASE_GPT)),
                                 pkeep=0.5)
    port.load_state_dict(convert.av_transformer_state_dict(params), strict=True)
    rng = np.random.default_rng(14)
    batch = {"spec": specs(15).astype(np.float32), "cond_spec": specs(16).astype(np.float32),
             "frames": rng.standard_normal(FRAMES).astype(np.float32)}
    return {"model": model, "params": params, "port": port.eval(), "batch": batch}


def jax_draws(key, shape, pkeep, vocab, dtype=jnp.int32):
    """The JAX loss's corruption draws for ``key`` (``dtype``: the tokens',
    int64 under ``enable_x64``; call in the same x64 mode as the loss)."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.bernoulli(k1, pkeep, shape)),
            np.asarray(jax.random.randint(k2, shape, 0, vocab, dtype)))


def test_av_loss_with_corruption_matches_jax(baseline):
    model, params, port, b = (baseline[k] for k in ("model", "params", "port", "batch"))
    key = jax.random.key(21)
    args = (jnp.asarray(b["spec"]), jnp.asarray(b["cond_spec"]), jnp.asarray(b["frames"]))
    want, want_eval = jax.jit(lambda p, k, *a: (model.loss(p, *a, k), model.loss(p, *a)))(
        params, key, *args)
    mask, rand = jax_draws(key, (2, 100), 0.5, 32)
    assert 0 < mask.sum() < mask.size
    targs = (nchw(b["spec"]), nchw(b["cond_spec"]), t(b["frames"]))
    with torch.no_grad():
        got = port.loss(*targs, draws=(t(mask), t(rand).long()))
        got_eval = port.loss(*targs)
        drawn = port.loss(*targs, generator=torch.Generator().manual_seed(0))
    assert abs(float(got) - float(want)) <= TOL * float(want)
    assert abs(float(got_eval) - float(want_eval)) <= TOL * float(want_eval)
    assert float(drawn) != float(got_eval)  # a generator corrupts too


def test_two_trainer_steps_and_decay_groups_match_optax_f64(baseline, monkeypatch):
    """Two ``TransformerTrainer`` steps (clip 1.0, AdamW with the kernel-only
    decay) against the JAX ``_train_step`` in f64, pkeep 0.5 on the JAX
    key's draws; the video features shared (the JAX video net computes in
    f32 whatever its parameters)."""
    model, params, b = baseline["model"], baseline["params"], baseline["batch"]
    with jax.enable_x64(False):
        feats = np.asarray(jax.jit(model.encode_to_c)(params, jnp.asarray(b["frames"])))
    port = tav.AVCondTransformer(VQModel(**TINY_VQ), GPTFeats(GPTConfig(**BASE_GPT)),
                                 pkeep=0.5)
    port.load_state_dict(convert.av_transformer_state_dict(params), strict=True)
    port.double()
    keys = [np.uint32(5), np.uint32(6)]
    with jax.enable_x64(True):
        drawn = iter([jax_draws(jax.random.key(k), (2, 100), 0.5, 32, jnp.int64)
                      for k in keys])
    monkeypatch.setattr(port, "encode_to_c", lambda frames: t(feats).double())
    monkeypatch.setattr(port, "draw_pkeep",
                        lambda shape, gen, device=None: tuple(t(a) for a in next(drawn)))
    monkeypatch.setattr(JaxAVCondTransformer, "encode_to_c",
                        lambda self, p, frames: jnp.asarray(feats, jnp.float64))
    tr = ttt.TransformerTrainer(port)
    tstate = tr.create_state()
    names = {id(p): k for k, p in port.gpt.named_parameters()}
    decayed = {names[id(p)] for p in ttt.decay_params(port.gpt)}
    mask = {convert.convert_leaf(path, np.zeros((1, 1)))[0]: bool(v) for path, v in
            convert.flatten(jtt.decay_mask(params["gpt"]["params"])).items()}
    assert mask.keys() == set(names.values())
    assert decayed == {k for k, v in mask.items() if v}
    assert "tok_emb.weight" not in decayed and "h_0.ln1.weight" not in decayed
    groups = tstate.optimizer.adamw.param_groups
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
    assert {names[id(p)] for p in groups[0]["params"]} == decayed

    g0 = {k: v.detach().clone() for k, v in port.gpt.state_dict().items()}
    with jax.enable_x64(True):
        p64 = f64(params)
        jt = jtt.TransformerTrainer(model)
        jstate = jt.create_state(p64)
        step = jax.jit(jt._train_step)
        batch64 = {k: jnp.asarray(v, jnp.float64) for k, v in b.items()}
        for key in keys:
            jstate, jm = step(jstate, {"vq": p64["vq"], "video": p64["video"]}, batch64, key)
            tm = tr.train_step(tstate, {k: nchw(v).double() if k != "frames" else
                                        t(v).double() for k, v in b.items()})
            w = float(jm["train/loss"])
            assert abs(float(tm["train/loss"]) - w) <= STEP_TOL * w
        delta = jax.tree_util.tree_map(lambda a, c: np.asarray(a - c), jstate.gpt_params,
                                       p64["gpt"])
    assert_updates(port.gpt.state_dict(), g0, convert.gpt_state_dict(delta), "GPT")
    assert tstate.step == 2


def test_log_images_matches_jax_greedy_and_top_k_1(baseline, monkeypatch):
    """``log_images`` at top-k 1 (every variant deterministic): the three
    samples' tokens under the tie rule, and where they agree the decoded
    spectrograms and the attention maps; inputs and reconstructions."""
    import syncfusion_tpu.models.transformer_av as jav

    model, params, port, b = (baseline[k] for k in ("model", "params", "port", "batch"))
    bufs = {"jax": [], "port": []}
    real_j, real_t = jav.sample_tokens_cached, tav.sample_tokens_cached

    def record_jax(*a, **kw):  # traced under jit: the buffers become outputs
        bufs["jax"].append(real_j(*a, **kw))
        return bufs["jax"][-1]

    def record_port(*a, **kw):
        bufs["port"].append(real_t(*a, **kw))
        return bufs["port"][-1]

    monkeypatch.setattr(jav, "sample_tokens_cached", record_jax)
    monkeypatch.setattr(tav, "sample_tokens_cached", record_port)

    @jax.jit
    def jax_media(params, spec, cond_spec, frames, key):
        bufs["jax"].clear()
        media = model.log_images(params, spec, cond_spec, frames, key, top_k=1)
        return media, list(bufs["jax"])

    want, jbufs = jax_media(params, jnp.asarray(b["spec"]), jnp.asarray(b["cond_spec"]),
                            jnp.asarray(b["frames"]), jax.random.key(0))
    got = port.log_images(nchw(b["spec"]), nchw(b["cond_spec"]), t(b["frames"]),
                          torch.Generator().manual_seed(0), top_k=1)
    assert got.keys() == want.keys()
    bufs = {"jax": [np.asarray(x) for x in jbufs], "port": [n(x) for x in bufs["port"]]}
    feats = np.asarray(jax.jit(model.encode_to_c)(params, jnp.asarray(b["frames"])))

    def logits_of(pre):
        def f(buf):
            out = model.gpt.apply(params["gpt"], jnp.asarray(buf[:, :-1]), jnp.asarray(feats))
            return np.asarray(out)[:, feats.shape[1] + pre - 1:]
        return f

    for name, jbuf, tbuf, pre in zip(("half", "nopix", "det"), bufs["jax"], bufs["port"],
                                     (75, 50, 50)):
        assert tbuf.shape == jbuf.shape == (2, 100)
        assert_same_tokens(tbuf, jbuf, logits_of(pre), pre)
        if np.array_equal(tbuf, jbuf):
            assert rel(nhwc(got[f"samples_{name}"]), want[f"samples_{name}"]) <= TOL, name
            assert rel(got[f"att_{name}"], want[f"att_{name}"]) <= TOL, name
    for k in ("inputs", "reconstructions"):
        assert got[k].shape == (2, 1, 20, 40) and rel(nhwc(got[k]), want[k]) <= TOL, k
    assert got["att_det"].shape == (2, 2, 104, 104)
