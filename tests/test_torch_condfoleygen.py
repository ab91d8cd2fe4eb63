"""The port's CondFoleyGen baseline modules against the JAX package, on the
CPU: the SpecVQGAN spectrogram and scaling chain, the quantizer, the
encoder, decoder and ``VQModel``; ``GPTFeats``, ``top_k_filter``, the
uncached and KV-cached samplers; the column-major token order; MelGAN and
its weight-norm loader; ``istft``, Griffin-Lim and
``mel01_to_waveform_gl``.  ``AVCondTransformer`` is held in
tests/test_torch_condfoleygen_cli.py, beside the exporter, on one JAX
model (its R(2+1)D-18 has no tiny width).

Tiny configs: the VQGAN of tests/test_baseline_stack.py:107-112, the GPTs
of tests/test_transformer_stack.py:18 and tests/test_mingpt_decode.py:9,
MelGAN at ngf 4.  Weights go from the JAX init to the port through
``convert``; inputs come from numpy seeds.

Tolerances (f32; the two sides sum in other orders): TOL = 1e-5 of the
largest magnitude of each tensor.  A token or code index may differ only
where the JAX run's logits (GAP_TOL) or distances (DIST_TOL) of the two
choices at that step lie within the rounding that separates the two sides.
Griffin-Lim from the JAX initial phase: 1e-5 of the largest sample after 2
iterations, 1e-3 after 32 (momentum 0.99 amplifies each iteration's
rounding), over the signal's length.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models import melgan as jmel
from syncfusion_tpu.models import mingpt as jgpt
from syncfusion_tpu.models.mingpt_decode import sample_tokens_cached as jax_cached
from syncfusion_tpu.models.transformer_av import column_major as jax_column_major
from syncfusion_tpu.models.vqgan.model import SpecVQGAN as JaxSpecVQGAN
from syncfusion_tpu.models.vqgan.model import VQModel as JaxVQModel
from syncfusion_tpu.models.vqgan.model import wav_to_spec as jax_wav_to_spec
from syncfusion_tpu.models.vqgan.quantize import VectorQuantizer as JaxVQ
from syncfusion_tpu_torch import convert
from syncfusion_tpu_torch.models import melgan as tmel
from syncfusion_tpu_torch.models import mingpt as tgpt
from syncfusion_tpu_torch.models.mingpt_decode import sample_tokens_cached
from syncfusion_tpu_torch.models.transformer_av import column_major, column_major_inverse
from syncfusion_tpu_torch.models.vqgan.model import VQModel, wav_to_spec
from syncfusion_tpu_torch.models.vqgan.quantize import VectorQuantizer
from syncfusion_tpu_torch.ops import mel as tm
from syncfusion_tpu_torch.ops import stft as ts
from torch_port_helpers import n, t, to_numpy

jst = importlib.import_module("syncfusion_tpu.ops.stft")  # the package exports a function
jm = importlib.import_module("syncfusion_tpu.ops.mel")

TOL = 1e-5
GAP_TOL = 1e-4   # logits of the tiny GPTs are O(1); the sides agree to ~1e-6
DIST_TOL = 1e-4  # distances O(1); the sides agree to ~1e-6
GL_TOL = {2: 1e-5, 32: 1e-3}

TINY_VQ = dict(embed_dim=16, n_embed=32, ch=8, ch_mult=(1, 2, 2), num_res_blocks=1,
               attn_resolutions=(10,), resolution=40, z_channels=16)
STACK_GPT = dict(vocab_size=32, block_size=64, n_layer=2, n_head=2, n_embd=32)
DECODE_GPT = dict(vocab_size=32, block_size=64, n_layer=2, n_head=2, n_embd=16)


def rel(a, b):
    a, b = n(a), n(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def nhwc(x):
    """(B, C, H, W) torch -> (B, H, W, C) numpy."""
    return n(x.permute(0, 2, 3, 1))


def nchw(a):
    return t(np.asarray(a)).permute(0, 3, 1, 2)


def assert_same_tokens(got, want, jax_logits, pre: int):
    """Tokens after position ``pre`` agree, or first differ in a row at a
    step where the JAX run's logits of the two tokens lie within GAP_TOL;
    ``jax_logits(buf)`` gives the JAX next-token logits (B, steps, V)
    teacher-forced on the JAX run's buffer."""
    got, want = n(got), n(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :pre], want[:, :pre])
    rows = np.flatnonzero((got != want).any(axis=1))
    if rows.size:
        logits = n(jax_logits(want))
        for b in rows:
            i = int(np.flatnonzero(got[b] != want[b])[0])
            row = logits[b, i - pre]
            assert row[want[b, i]] - row[got[b, i]] <= GAP_TOL, (b, i, row[want[b, i]])


def assert_same_codes(got, want, d_jax):
    """Code indices agree, or differ only where the JAX distances to the
    two codes lie within DIST_TOL; d_jax (N, n_e)."""
    got, want = n(got).reshape(-1), n(want).reshape(-1)
    for i in np.flatnonzero(got != want):
        assert d_jax[i, got[i]] - d_jax[i, want[i]] <= DIST_TOL, i


def jax_distances(codebook, z_nhwc):
    """The JAX quantizer's distances, its expression on its arrays."""
    flat = jnp.asarray(z_nhwc).reshape(-1, codebook.shape[1])
    cb = jnp.asarray(codebook)
    return np.asarray(jnp.sum(flat ** 2, axis=1, keepdims=True) - 2.0 * flat @ cb.T
                      + jnp.sum(cb ** 2, axis=1)[None, :])


@pytest.fixture(scope="module")
def vq():
    jmodel = JaxVQModel(**TINY_VQ)
    params = to_numpy(jax.jit(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 20, 40, 1))))())
    tmodel = VQModel(**TINY_VQ)
    tmodel.load_state_dict(convert.vqgan_state_dict(params), strict=True)
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module")
def gpt():
    jnet = jgpt.GPTFeats(jgpt.GPTConfig(**STACK_GPT))
    params = to_numpy(jax.jit(lambda: jnet.init(
        jax.random.key(0), jnp.zeros((1, 10), jnp.int32), jnp.zeros((1, 6, 8))))())
    tnet = tgpt.GPTFeats(tgpt.GPTConfig(**STACK_GPT), feat_dim=8)
    tnet.load_state_dict(convert.gpt_state_dict(params), strict=True)
    return jnet, params, tnet


@pytest.fixture(scope="module")
def decode_gpt():
    jnet = jgpt.GPTFeats(jgpt.GPTConfig(**DECODE_GPT))
    params = to_numpy(jax.jit(lambda: jnet.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 5, 4))))())
    tnet = tgpt.GPTFeats(tgpt.GPTConfig(**DECODE_GPT), feat_dim=4)
    tnet.load_state_dict(convert.gpt_state_dict(params), strict=True)
    return jnet, params, tnet


# ----------------------------------------------------------- spectrogram
def test_specvqgan_scale_pair_matches_jax():
    mel = np.abs(np.random.default_rng(0).standard_normal((2, 80, 37))).astype(np.float32)
    mel[0, :5] = 1e-7  # below the floor
    mel[1, :3] = 50.0  # above the clip
    got = tm.specvqgan_scale(t(mel))
    want = np.asarray(jm.specvqgan_scale(jnp.asarray(mel)))
    np.testing.assert_allclose(n(got), want, rtol=0, atol=TOL)
    x = np.random.default_rng(1).random((2, 80, 37)).astype(np.float32)
    assert rel(tm.specvqgan_unscale(t(x)), jm.specvqgan_unscale(jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("samples", [44100, 22050])  # cropped; padded
def test_wav_to_spec_matches_jax(samples):
    wav = (0.3 * np.random.default_rng(samples).standard_normal((2, samples))
           ).astype(np.float32)
    got = wav_to_spec(t(wav))
    want = np.asarray(jax_wav_to_spec(jnp.asarray(wav)))
    assert got.shape == want.shape == (2, 80, 160)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=TOL)


# ----------------------------------------------------------------- VQGAN
def test_quantizer_matches_jax():
    rng = np.random.default_rng(0)
    codebook = rng.uniform(-1, 1, (32, 16)).astype(np.float32)
    # latents near codes, so that nearest and second-nearest lie close
    z = (codebook[rng.integers(0, 32, (2, 5, 10))]
         + 0.3 * rng.standard_normal((2, 5, 10, 16))).astype(np.float32)
    zq_j, _, info = JaxVQ(32, 16).apply({"params": {"embedding": codebook}},
                                        jnp.asarray(z))
    q = VectorQuantizer(32, 16)
    q.load_state_dict({"embedding": t(codebook)})
    d_port = q.distances(t(z.reshape(-1, 16)))
    d_jax = jax_distances(codebook, z)
    np.testing.assert_allclose(n(d_port), d_jax, rtol=0, atol=TOL * np.abs(d_jax).max())
    with torch.no_grad():
        zq, idx = q(nchw(z))
    assert_same_codes(idx, info["indices"], d_jax)
    same = n(idx) == np.asarray(info["indices"])
    # the JAX z_q is the straight-through z + (e - z): e within rounding
    np.testing.assert_array_equal(nhwc(zq)[same], codebook[np.asarray(info["indices"])][same])
    assert rel(nhwc(zq)[same], np.asarray(zq_j)[same]) <= TOL


def test_vq_encoder_decoder_and_model_match_jax(vq):
    jmodel, params, tmodel = vq
    x = (0.5 * np.random.default_rng(2).standard_normal((2, 20, 40, 1))).astype(np.float32)
    with torch.no_grad():
        h = tmodel.quant_conv(tmodel.encoder(nchw(x)))
        _, idx = tmodel.encode(nchw(x))
        rec = tmodel.reconstruct(nchw(x))

    @jax.jit
    def jax_side(params, x):
        h = jmodel.apply(params, x, method=lambda m, x: m.quant_conv(m.encoder(x)))
        _, _, info = jmodel.apply(params, x, method=JaxVQModel.encode)
        # the decoder and the code path on the JAX run's indices
        dec = JaxSpecVQGAN(jmodel).decode_indices(params, info["indices"])
        return h, info["indices"], dec, jmodel.apply(params, x)[0]

    h_j, j_idx, dec_j, rec_j = (np.asarray(a) for a in jax_side(params, jnp.asarray(x)))
    assert rel(nhwc(h), h_j) <= TOL
    codebook = params["params"]["quantize"]["embedding"]
    assert_same_codes(idx, j_idx, jax_distances(codebook, h_j))
    with torch.no_grad():
        dec = tmodel.decode_indices(t(j_idx).long())
    assert dec.shape == (2, 1, 20, 40)
    assert rel(nhwc(dec), dec_j) <= TOL
    if (n(idx) == j_idx).all():
        assert rel(nhwc(rec), rec_j) <= TOL


# ------------------------------------------------------------------- GPT
@pytest.mark.parametrize("with_feats", [True, False])
def test_gpt_feats_matches_jax(gpt, with_feats):
    jnet, params, tnet = gpt
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 32, (2, 10)).astype(np.int32)
    feats = rng.standard_normal((2, 6, 8)).astype(np.float32) if with_feats else None
    want, att_j = jnet.apply(params, jnp.asarray(toks),
                             None if feats is None else jnp.asarray(feats), return_att=True)
    with torch.no_grad():
        got, att = tnet(t(toks).long(), None if feats is None else t(feats), return_att=True)
        plain = tnet(t(toks).long(), None if feats is None else t(feats))
    assert got.shape == (2, 16 if with_feats else 10, 32)
    assert rel(got, want) <= TOL
    assert rel(att, att_j) <= TOL
    assert torch.equal(got, plain)


def test_top_k_filter_keeps_ties_as_jax():
    rng = np.random.default_rng(4)
    logits = np.round(rng.standard_normal((6, 32)), 1).astype(np.float32)  # many ties
    for k in (1, 3, 8, 32):
        got = n(tgpt.top_k_filter(t(logits), k))
        want = np.asarray(jgpt.top_k_filter(jnp.asarray(logits), k))
        np.testing.assert_array_equal(got, want)
        assert ((got > -np.inf).sum(axis=1) >= k).all()


def test_gumbel_draws_match_numpy():
    """The port's draw on fixed uniforms is numpy's Gumbel-max; draws from
    a generator stay in the top-k set."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((64, 32)).astype(np.float32)
    u = rng.random((64, 32)).astype(np.float32)
    want = np.argmax(logits - np.log(-np.log(u)), axis=-1)
    np.testing.assert_array_equal(n(tgpt.gumbel_argmax(t(logits), t(u))), want)
    gen = torch.Generator().manual_seed(0)
    top = np.argsort(logits, axis=-1)[:, -4:]
    draws = n(tgpt.sample_from(t(logits), gen, temperature=0.7, top_k=4))
    assert all(d in row for d, row in zip(draws, top))


def _jax_step_logits(jnet, params, feats, pre):
    """JAX next-token logits at every sampled step, teacher-forced."""
    def logits_of(buf):
        out = jnet.apply(params, jnp.asarray(buf[:, :-1]),
                         None if feats is None else jnp.asarray(feats))
        cond = 0 if feats is None else feats.shape[1]
        return np.asarray(out)[:, cond + pre - 1:]
    return logits_of


@pytest.mark.parametrize("with_feats", [True, False])
@pytest.mark.parametrize("mode", ["greedy", "top_k_1"])
def test_cached_sampler_matches_jax(decode_gpt, with_feats, mode):
    jnet, params, tnet = decode_gpt
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 5, 4)).astype(np.float32) if with_feats else None
    prefix = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    kw = dict(greedy=True) if mode == "greedy" else dict(top_k=1)
    want = jax_cached(params, None if feats is None else jnp.asarray(feats),
                      jnp.asarray(prefix), 9, jax.random.key(1),
                      config=jgpt.GPTConfig(**DECODE_GPT), **kw)
    f = None if feats is None else t(feats)
    got = sample_tokens_cached(tnet, f, t(prefix).long(),
                               9, torch.Generator().manual_seed(0), **kw)
    uncached = tgpt.sample_tokens(tnet, f, t(prefix).long(), 9,
                                  torch.Generator().manual_seed(0), **kw)
    logits_of = _jax_step_logits(jnet, params, feats, 3)
    assert got.shape == (2, 12)
    assert_same_tokens(got, want, logits_of, 3)
    assert_same_tokens(uncached, want, logits_of, 3)
    # the JAX package's uncached sampler, for the reference's loop
    ref = jgpt.sample_tokens(lambda p, x, fe: jnet.apply(p, x, fe), params,
                             None if feats is None else jnp.asarray(feats),
                             jnp.asarray(prefix), 9, jax.random.key(2), **kw)
    assert_same_tokens(uncached, ref, logits_of, 3)
    # the teacher-forced logits of the port on the JAX buffer
    buf = np.asarray(want)
    with torch.no_grad():
        port = n(tnet(t(buf[:, :-1]).long(), f))[:, (0 if f is None else 5) + 2:]
    assert rel(port, logits_of(buf)) <= TOL


def test_cached_sampler_refuses_more_than_the_block(decode_gpt):
    with pytest.raises(ValueError, match="block"):
        sample_tokens_cached(decode_gpt[2], torch.zeros(1, 5, 4),
                             torch.zeros(1, 10, dtype=torch.long), 50, greedy=True)


# ------------------------------------------------------- AV transformer
def test_column_major_matches_jax():
    grid = np.arange(2 * 5 * 20).reshape(2, 5, 20)
    seq = column_major(t(grid))
    np.testing.assert_array_equal(n(seq), np.asarray(jax_column_major(jnp.asarray(grid))))
    np.testing.assert_array_equal(n(column_major_inverse(seq, 20)), grid)


# ---------------------------------------------------------------- MelGAN
def reference_melgan_state_dict(ngf, n_res, seed, ratios=(8, 8, 2, 2), n_mels=80):
    """A seeded state dict in the reference generator's format (its
    weight-normed ``model.{i}`` Sequential)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def wn(key, shape):
        v = 0.3 * torch.randn(shape, generator=g)
        sd[f"{key}.weight_v"] = v
        sd[f"{key}.weight_g"] = (0.5 + torch.rand((shape[0],) + (1,) * (len(shape) - 1),
                                                 generator=g))
        sd[f"{key}.bias"] = 0.1 * torch.randn(shape[0], generator=g)

    mult = 2 ** len(ratios)
    wn("model.1", (mult * ngf, n_mels, 7))
    idx = 3
    for r in ratios:
        c = mult * ngf // 2
        v = 0.3 * torch.randn((mult * ngf, c, 2 * r), generator=g)
        sd[f"model.{idx}.weight_v"] = v
        sd[f"model.{idx}.weight_g"] = 0.5 + torch.rand((mult * ngf, 1, 1), generator=g)
        sd[f"model.{idx}.bias"] = 0.1 * torch.randn(c, generator=g)
        for j in range(n_res):
            wn(f"model.{idx + 1 + j}.block.2", (c, c, 3))
            wn(f"model.{idx + 1 + j}.block.4", (c, c, 1))
            wn(f"model.{idx + 1 + j}.shortcut", (c, c, 1))
        idx += n_res + 2
        mult //= 2
    wn(f"model.{idx + 1}", (1, ngf, 7))
    return sd


def test_melgan_loader_matches_convert_melgan():
    """One seeded reference-format state dict: the JAX package through
    ``convert_melgan``, the port through ``melgan_state_dict``."""
    sd = reference_melgan_state_dict(ngf=4, n_res=3, seed=0)
    jnet = jmel.MelGANGenerator(ngf=4, n_residual_layers=3)
    variables = jmel.convert_melgan({k: v.numpy() for k, v in sd.items()})
    tnet = tmel.MelGANGenerator(ngf=4, n_residual_layers=3)
    tnet.load_state_dict(tmel.melgan_state_dict(sd), strict=True)
    mel = np.random.default_rng(8).random((2, 80, 12)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(mel.transpose(0, 2, 1))))
    with torch.no_grad():
        got = tnet(t(mel))
    assert got.shape == want.shape == (2, 12 * 256)
    assert rel(got, want) <= TOL
    v, g = sd["model.3.weight_v"], sd["model.3.weight_g"]
    np.testing.assert_allclose(n(tmel.fold_weight_norm(v, g)),
                               jmel.fold_weight_norm(v.numpy(), g.numpy()), rtol=1e-6)


def test_melgan_one_residual_layer_matches_jax():
    """ngf 4 with one residual layer a stage, from the JAX init: its
    parameters written in the reference format (weight_v the folded
    kernel, weight_g its norm) and read by the port's loader."""
    jnet = jmel.MelGANGenerator(ngf=4, n_residual_layers=1)
    mel = np.random.default_rng(9).random((1, 80, 10)).astype(np.float32)
    variables = to_numpy(jax.jit(lambda: jnet.init(jax.random.key(0),
                                                   jnp.zeros((1, 10, 80))))())
    p = variables["params"]
    sd = {}

    def put(key, w, b):  # w in torch's layout
        sd[f"{key}.weight_v"] = torch.from_numpy(w.copy())
        norm = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
        sd[f"{key}.weight_g"] = torch.from_numpy(norm)
        sd[f"{key}.bias"] = torch.from_numpy(np.array(b))

    def conv(key, node):
        put(key, np.transpose(node["kernel"], (2, 1, 0)), node["bias"])

    conv("model.1", p["conv_in"])
    idx = 3
    for i in range(4):
        put(f"model.{idx}", np.transpose(p[f"up_{i}_kernel"], (1, 2, 0)), p[f"up_{i}_bias"])
        res = p[f"res_{i}_0"]
        conv(f"model.{idx + 1}.block.2", res["conv_dilated"])
        conv(f"model.{idx + 1}.block.4", res["conv_1x1"])
        conv(f"model.{idx + 1}.shortcut", res["shortcut"])
        idx += 3
    conv(f"model.{idx + 1}", p["conv_out"])
    tnet = tmel.MelGANGenerator(ngf=4, n_residual_layers=1)
    tnet.load_state_dict(tmel.melgan_state_dict(sd, n_residual_layers=1), strict=True)
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(mel.transpose(0, 2, 1))))
    with torch.no_grad():
        got = tnet(t(mel))
    assert rel(got, want) <= TOL
    assert float(got.abs().max()) <= 1.0


def test_vocoder_reads_a_reference_checkpoint(tmp_path):
    sd = reference_melgan_state_dict(ngf=32, n_res=3, seed=1)
    path = tmp_path / "best_netG.pt"
    torch.save(sd, path)
    mel = torch.rand(1, 80, 6, generator=torch.Generator().manual_seed(0))
    voc = tmel.Vocoder(path)
    wav = voc(mel)
    ref = tmel.MelGANGenerator()
    ref.load_state_dict(tmel.melgan_state_dict(sd))
    with torch.no_grad():
        assert torch.equal(wav, ref(mel))
    assert wav.shape == (1, 6 * 256)
    seeded = tmel.Vocoder()(mel)
    assert torch.isfinite(seeded).all() and torch.equal(seeded, tmel.Vocoder()(mel))


# ----------------------------------------------- inverse STFT, Griffin-Lim
def test_istft_matches_jax():
    """Beyond the signal's length the overlap-added window sum falls towards
    0 and the division amplifies each side's rounding by its inverse (the
    last sample's error is ~1e4 times the rest), so the comparison takes
    the signal's length; the full output has the JAX shape."""
    x = np.random.default_rng(10).standard_normal((2, 5000)).astype(np.float32)
    spec = np.asarray(jst.stft(jnp.asarray(x)))
    want = np.asarray(jst.istft(jnp.asarray(spec), length=5000))
    got = ts.istft(t(spec), length=5000)
    assert got.shape == want.shape and rel(got, want) <= TOL
    np.testing.assert_allclose(n(got), x, atol=1e-5)
    full = ts.istft(t(spec))
    assert full.shape == np.asarray(jst.istft(jnp.asarray(spec))).shape
    assert torch.equal(full[:, :5000], got)


@pytest.mark.parametrize("n_iter", [2, 32])
def test_griffin_lim_matches_jax_from_its_initial_phase(n_iter):
    """Over the signal's length (see test_istft_matches_jax)."""
    x = np.random.default_rng(11).standard_normal((2, 4000)).astype(np.float32)
    mag = np.abs(np.asarray(jst.stft(jnp.asarray(x)))).astype(np.float32)
    key = jax.random.key(3)
    theta = np.asarray(2.0 * jnp.pi * jax.random.uniform(key, mag.shape))
    want = np.asarray(jst.griffin_lim(jnp.asarray(mag), n_iter=n_iter, length=4000,
                                      key=key))
    got = ts.griffin_lim(t(mag), n_iter=n_iter, length=4000, theta=t(theta))
    assert got.shape == want.shape
    assert rel(got, want) <= GL_TOL[n_iter]


def test_mel01_to_waveform_gl_matches_jax():
    spec01 = np.random.default_rng(12).random((2, 80, 24)).astype(np.float32)
    want = np.asarray(jm.mel01_to_waveform_gl(jnp.asarray(spec01), n_iter=2))
    theta = np.asarray(2.0 * jnp.pi * jax.random.uniform(jax.random.key(0), (2, 513, 24)))
    got = tm.mel01_to_waveform_gl(t(spec01), n_iter=2, theta=t(theta))
    assert got.shape == want.shape
    assert rel(got, want) <= GL_TOL[2]
    # without a phase: the same seeded phase on every call, as the JAX key(0)
    a, b = (tm.mel01_to_waveform_gl(t(spec01), n_iter=2) for _ in range(2))
    assert torch.equal(a, b)
