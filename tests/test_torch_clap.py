"""The port's CLAP against the JAX package's on the CPU, in f32, on seeded
inputs: the STFT and mel front end, the Swin helpers and blocks, a tiny
HTSAT, RoBERTa with padding, the tokenizers, the whole ``ClapModel`` and its
embedder through ``convert.clap_state_dict``, the laion checkpoint loader
on a synthetic checkpoint, and the sample logger's mel panels.

Tolerances, each against the JAX output on the same inputs:
  * spectrograms and mels: max |diff| <= 1e-5 of max |JAX| (two FFT
    libraries and matmuls summing in other orders, f32);
  * dB values: 1e-4 dB where the power is at least 1e-6 of its largest
    value (below that a rounding error of 1e-7 of the largest bin is a
    sizeable share of the value, and the dB difference measures it);
  * network outputs (Swin, HTSAT, RoBERTa, projections): 1e-5 absolute on
    unit-scale outputs (LayerNorm in and out; Flax's LayerNorm takes its
    variance as E[x^2] - E[x]^2, torch's in two passes);
  * L2-normalised embeddings: 1e-5 absolute;
  * numpy code copied as it is (filterbank, bicubic matrix, repeat-pad,
    masks, index, tokenizers): equal.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from syncfusion_tpu.eval import panels as jpanels
from syncfusion_tpu.models.clap import bpe as jbpe
from syncfusion_tpu.models.clap import convert as jconvert
from syncfusion_tpu.models.clap import htsat as jhtsat
from syncfusion_tpu.models.clap import model as jmodel
from syncfusion_tpu.models.clap import roberta as jroberta
from syncfusion_tpu.models.clap import swin as jswin
from syncfusion_tpu_torch.convert import clap_state_dict
from syncfusion_tpu_torch.eval import panels as tpanels
from syncfusion_tpu_torch.models.clap import bpe as tbpe
from syncfusion_tpu_torch.models.clap import convert as tconvert
from syncfusion_tpu_torch.models.clap import htsat as thtsat
from syncfusion_tpu_torch.models.clap import model as tmodel
from syncfusion_tpu_torch.models.clap import roberta as troberta
from syncfusion_tpu_torch.models.clap import swin as tswin
from syncfusion_tpu_torch.ops import mel as tmel
from syncfusion_tpu_torch.ops import stft as tstft
from torch_port_helpers import n, t, to_numpy

# the modules themselves: syncfusion_tpu.ops re-exports functions of these names
jmel = importlib.import_module("syncfusion_tpu.ops.mel")
jstft = importlib.import_module("syncfusion_tpu.ops.stft")

SPEC_TOL = 1e-5
DB_TOL = 1e-4
DB_FLOOR = 1e-6
NET_TOL = 1e-5
EMB_TOL = 1e-5

TINY_AUDIO = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(1, 1, 2, 2))
TINY_TEXT = dict(num_layers=2, hidden=32, heads=2, intermediate=64)


def rel(a, b):
    a, b = n(a).astype(np.float64), n(b).astype(np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def perturb(variables, seed):
    """Every leaf of a Flax tree moved by seeded noise, so that LayerNorm
    scales, biases and the mel BatchNorm are not at their init (a swapped
    scale and bias would pass there); variances kept positive."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(to_numpy(variables))
    leaves = []
    for path, leaf in flat[0]:
        if "mel_bn_var" in jax.tree_util.keystr(path):
            leaves.append(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        else:
            leaves.append((leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32))
    return jax.tree_util.tree_unflatten(flat[1], leaves)


def port(module, variables):
    """A port module loaded with a JAX tree through ``clap_state_dict``."""
    module.load_state_dict(clap_state_dict(variables), strict=True)
    return module.eval()


def noise(shape, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# --------------------------------------------------------------- front end

@pytest.mark.parametrize("n_fft,hop,length,power", [
    (256, 64, 3000, 1.0), (256, 64, 100, 2.0), (1024, 480, 48000, 2.0)])
def test_stft_and_spectrogram_match_jax(n_fft, hop, length, power):
    """Complex STFT and spectrogram; length 100 < n_fft / 2 takes the
    reflect padding past the signal's ends (numpy's repeated reflection)."""
    x = noise((2, length), length)
    want = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop))
    got = n(tstft.stft(t(x), n_fft, hop))
    assert got.shape == want.shape
    assert rel(got.real, want.real) <= SPEC_TOL and rel(got.imag, want.imag) <= SPEC_TOL
    want = jstft.spectrogram(jnp.asarray(x), n_fft, hop, power=power)
    assert rel(tstft.spectrogram(t(x), n_fft, hop, power=power), want) <= SPEC_TOL
    np.testing.assert_allclose(n(tstft.hann_window(n_fft)),
                               np.asarray(jstft.hann_window(n_fft)), atol=1e-7)


@pytest.mark.parametrize("args", [
    (48000, 1024, 64, 50.0, 14000.0, "slaney", "slaney"),
    (22050, 1024, 80, 125.0, 7600.0, "htk", "slaney"),
    (48000, 1024, 80, 0.0, None, "slaney", "slaney"),
    (16000, 512, 40, 0.0, None, "htk", None)])
def test_mel_filterbank_is_the_jax_one(args):
    np.testing.assert_array_equal(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(tmel._hz_to_mel(np.arange(0, 9000, 250.0), args[5]),
                                  jmel._hz_to_mel(np.arange(0, 9000, 250.0), args[5]))
    np.testing.assert_array_equal(tmel._mel_to_hz(np.arange(0, 60, 2.5), args[5]),
                                  jmel._mel_to_hz(np.arange(0, 60, 2.5), args[5]))


def test_mel_spectrogram_and_power_to_db_match_jax():
    """The sample logger's chain (n_fft 1024, hop 512, 80 slaney mels of
    the power) and ``power_to_db`` on the same mel (batch-wide top_db)."""
    x = noise((2, 8192), 3)
    kw = dict(sample_rate=48000, n_fft=1024, hop_length=512, n_mels=80, power=2.0,
              norm="slaney")
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(x), **kw))
    got = n(tmel.mel_spectrogram(t(x), **kw))
    assert rel(got, want) <= SPEC_TOL
    for top_db in (80.0, None, 20.0):
        np.testing.assert_allclose(n(tmel.power_to_db(t(want), top_db=top_db)),
                                   np.asarray(jmel.power_to_db(jnp.asarray(want),
                                                               top_db=top_db)),
                                   atol=DB_TOL, rtol=0)


def test_clap_mel_image_and_prepare_audio_match_jax():
    """``prepare_audio`` (repeat-pad, then zero-pad; truncate) equal; the dB
    mel of a repeat-padded clip within DB_TOL where its power is above
    DB_FLOOR of the largest (the zero-padded tail sits at the 1e-10 clamp on
    both sides); the 1001 -> 1024 frame image within 1e-5 of max."""
    short = noise((1, 150_000), 4)
    for wav, length in ((short, thtsat.CLAP_SAMPLES), (noise((2, 3000), 5), 2500),
                        (noise((1, 1000), 6)[..., None].transpose(0, 2, 1), 2500)):
        np.testing.assert_array_equal(thtsat.prepare_audio(wav, length),
                                      jhtsat.prepare_audio(wav, length))
    wav = thtsat.prepare_audio(short)
    want_db = np.asarray(jhtsat.clap_mel(jnp.asarray(wav)))
    got_db = n(thtsat.clap_mel(t(wav)))
    assert got_db.shape == want_db.shape == (1, 1001, 64)
    power = 10.0 ** (want_db.astype(np.float64) / 10.0)
    live = power >= DB_FLOOR * power.max()
    assert live.mean() > 0.5 and (~live).any()
    assert np.abs(got_db - want_db)[live].max() <= DB_TOL
    np.testing.assert_array_equal(thtsat._torch_bicubic_matrix(1001, 1024),
                                  jhtsat._torch_bicubic_matrix(1001, 1024))
    want = np.asarray(jhtsat.reshape_mel_to_image(jnp.asarray(want_db)))
    got = n(thtsat.reshape_mel_to_image(t(want_db)))
    assert got.shape == (1, 256, 256, 1) and rel(got, want) <= SPEC_TOL


# --------------------------------------------------------------------- Swin

def test_swin_helpers_are_the_jax_ones():
    x = noise((2, 16, 16, 3), 7)
    w = tswin.window_partition(t(x), 8)
    np.testing.assert_array_equal(n(w), np.asarray(jswin.window_partition(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(n(tswin.window_reverse(w, 8, 16, 16)), x)
    for ws in (4, 8):
        np.testing.assert_array_equal(tswin.relative_position_index(ws),
                                      jswin.relative_position_index(ws))
    for args in ((16, 16, 8, 4), (64, 64, 8, 4), (8, 8, 4, 2)):
        np.testing.assert_array_equal(tswin.shifted_window_mask(*args),
                                      jswin.shifted_window_mask(*args))


@pytest.mark.parametrize("res,shift", [(16, 0), (16, 4), (8, 4)],
                         ids=["plain", "shifted", "window-covers-resolution"])
def test_swin_block_matches_jax(res, shift):
    """One block, dim 16, 2 heads, window 8: at resolution 8 the window
    covers it and the shift is dropped (stage 4 of HTSAT)."""
    jblock = jswin.SwinBlock(dim=16, input_resolution=res, num_heads=2, window_size=8,
                             shift_size=shift)
    x = noise((2, res * res, 16), res + shift, scale=1.0)
    v = perturb(jblock.init(jax.random.key(0), jnp.asarray(x)), 1)
    want = np.asarray(jblock.apply(v, jnp.asarray(x)))
    tblock = port(tswin.SwinBlock(16, res, 2, 8, shift), v)
    assert tblock.shift == (shift if res > 8 else 0)
    np.testing.assert_allclose(n(tblock(t(x))), want, atol=NET_TOL, rtol=0)


def test_patch_merging_and_stage_match_jax():
    x = noise((2, 16 * 16, 8), 9, scale=1.0)
    jpm = jswin.PatchMerging(input_resolution=16, dim=8)
    v = perturb(jpm.init(jax.random.key(1), jnp.asarray(x)), 2)
    got = n(port(tswin.PatchMerging(16, 8), v)(t(x)))
    np.testing.assert_allclose(got, np.asarray(jpm.apply(v, jnp.asarray(x))),
                               atol=NET_TOL, rtol=0)
    jst = jswin.SwinStage(dim=8, input_resolution=16, depth=2, num_heads=2,
                          window_size=8, downsample=True)
    v = perturb(jst.init(jax.random.key(2), jnp.asarray(x)), 3)
    got = n(port(tswin.SwinStage(8, 16, 2, 2, 8, downsample=True), v)(t(x)))
    assert got.shape == (2, 64, 16)
    np.testing.assert_allclose(got, np.asarray(jst.apply(v, jnp.asarray(x))),
                               atol=NET_TOL, rtol=0)


def test_tiny_htsat_matches_jax():
    """Embed 8, depths (2, 2, 2, 2), heads (1, 1, 2, 2), window 8, on the
    fixed 256x256 image: the NHWC patch conv against the port's NCHW one,
    every merge's concatenation order, the token mean."""
    img = noise((2, 256, 256, 1), 10, scale=1.0)
    jnet = jhtsat.HTSAT(**TINY_AUDIO)
    v = perturb(jax.jit(lambda: jnet.init(jax.random.key(3), jnp.asarray(img)))(), 4)
    want = np.asarray(jax.jit(jnet.apply)(v, jnp.asarray(img)))
    with torch.no_grad():
        got = n(port(thtsat.HTSAT(**TINY_AUDIO), v)(t(img)))
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_allclose(got, want, atol=NET_TOL, rtol=0)


# ------------------------------------------------------------------ RoBERTa

def test_roberta_matches_jax_with_padding():
    """2 layers, hidden 32, vocab 50265: rows padded differently, so the
    positions (cumsum of the mask) and the key bias both matter."""
    ids = np.array([[0, 713, 4, 98, 2, 1, 1, 1], [0, 31, 50264, 7, 11, 9, 5, 2]], np.int32)
    mask = (ids != 1).astype(np.int32)
    jnet = jroberta.RobertaModel(**TINY_TEXT)
    v = perturb(jnet.init(jax.random.key(5), jnp.asarray(ids), jnp.asarray(mask)), 5)
    want = np.asarray(jnet.apply(v, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = n(port(troberta.RobertaModel(**TINY_TEXT), v)(
            torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)))
    live = mask.astype(bool)
    np.testing.assert_allclose(got[live], want[live], atol=NET_TOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=NET_TOL, rtol=0)


# --------------------------------------------------------------- tokenizers

def _tiny_roberta_files(tmp_path):
    """tests/test_bpe_tokenizer.py's tiny vocab and merges."""
    table = jbpe.bytes_to_unicode()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    for ch in sorted(set(table.values())):
        vocab[ch] = len(vocab)
    merges = ["h i", "hi t", "Ġ w", "Ġw o", "Ġwo o", "Ġwoo d", "Ġ m", "Ġm e",
              "Ġme t", "Ġmet a", "Ġmeta l", "s c", "sc r", "scr a", "scra t",
              "scrat c", "scratc h", "t a"]
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return tmp_path / "vocab.json", tmp_path / "merges.txt"


TEXTS = ["hit wood", "scratch metal", "hit  metal!", "", "tap tap tap wood"]


def test_bpe_and_hashed_tokenizers_are_the_jax_ones(tmp_path):
    files = _tiny_roberta_files(tmp_path)
    for tok, jtok in ((tbpe.ByteLevelBPE(*files), jbpe.ByteLevelBPE(*files)),
                      (tbpe.HashedFallback(), jbpe.HashedFallback())):
        for max_length in (16, 4):
            got = tbpe.encode_batch(tok, TEXTS, max_length)
            want = jbpe.encode_batch(jtok, TEXTS, max_length)
            for key in ("input_ids", "attention_mask"):
                np.testing.assert_array_equal(got[key], want[key])
    assert tbpe.find_bpe_files(str(files[0])) == files
    assert tbpe.find_bpe_files(str(tmp_path / "nowhere" / "x")) is None


@pytest.fixture
def no_transformers_files(monkeypatch):
    """Both packages' tokenizer caches reset, and transformers' loader made
    to fail as it does with no local files: the first ``tokenize`` of the
    test picks the BPE files or the hashed fallback."""
    import transformers

    def boom(*a, **k):
        raise OSError("no local files")

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", boom)
    monkeypatch.setattr(jroberta, "_TOKENIZER", None)
    monkeypatch.setattr(troberta, "_TOKENIZER", None)
    yield
    monkeypatch.setattr(jroberta, "_TOKENIZER", None)
    monkeypatch.setattr(troberta, "_TOKENIZER", None)


@pytest.mark.parametrize("with_files", [True, False], ids=["bpe-files", "hashed"])
def test_tokenize_chain_matches_jax(tmp_path, no_transformers_files, with_files):
    path = str(_tiny_roberta_files(tmp_path)[0].parent) if with_files else None
    got = troberta.tokenize(TEXTS, max_length=12, tokenizer_path=path)
    want = jroberta.tokenize(TEXTS, max_length=12, tokenizer_path=path)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    # the first choice is kept for the process, as the JAX package keeps it
    again = troberta.tokenize(["hit wood"], max_length=12, tokenizer_path=None)
    np.testing.assert_array_equal(again["input_ids"], got["input_ids"][:1])


# --------------------------------------------------------- the whole model

class TinyJaxClap(jmodel.ClapModel):
    """The JAX ``ClapModel`` with the tiny towers."""

    def setup(self):
        self.audio_branch = jhtsat.HTSAT(**TINY_AUDIO, name="audio_branch")
        self.text_branch = jroberta.RobertaModel(**TINY_TEXT, name="text_branch")
        self.audio_projection = jmodel.Projection(self.embed_dim, name="audio_projection")
        self.text_projection = jmodel.Projection(self.embed_dim, name="text_projection")
        self.mel_scale = self.param("mel_bn_scale", fnn.initializers.ones, (64,))
        self.mel_bias = self.param("mel_bn_bias", fnn.initializers.zeros, (64,))
        self.mel_mean = self.param("mel_bn_mean", fnn.initializers.zeros, (64,))
        self.mel_var = self.param("mel_bn_var", fnn.initializers.ones, (64,))


def tiny_port_model(**audio):
    return tmodel.ClapModel(audio={**TINY_AUDIO, **audio}, text=TINY_TEXT)


def test_clap_embedder_matches_jax(monkeypatch, no_transformers_files):
    """The JAX embedder on the tiny model (its random init, perturbed) and
    the port's on the same weights through ``clap_state_dict``:
    ``embed_audio`` on a (B, L, 1) clip shorter than 10 s (int16 round
    trip, repeat-pad, mel BatchNorm, towers, projection, L2 norm) and on a
    (B, L) one longer; ``embed_text`` through the hashed tokenizer."""
    monkeypatch.setattr(jmodel, "ClapModel", TinyJaxClap)
    jemb = jmodel.ClapEmbedder()
    jemb.variables = perturb(jemb.variables, 6)
    temb = tmodel.ClapEmbedder(device="cpu", model=port(tiny_port_model(), jemb.variables))
    for wav in (noise((2, 100_000, 1), 11, scale=0.3), noise((1, 500_000), 12, scale=0.3)):
        got, want = n(temb.embed_audio(wav)), np.asarray(jemb.embed_audio(wav))
        assert got.shape == want.shape == (len(wav), 1, 512)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
        np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=0)
    prompts = ["hit wood", "scratch metal with a stick"]
    got, want = n(temb.embed_text(prompts)), np.asarray(jemb.embed_text(prompts))
    assert got.shape == want.shape == (2, 1, 512)
    np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=0)
    assert np.abs(got[0] - got[1]).max() > 1e-2


def test_seeded_embedder_init():
    """Random weights from the seed, on the embedder's device: the same
    seed gives the same weights, another seed others; unit-norm output."""
    a, b, c = (tiny_port_model() for _ in range(3))
    for m, seed in ((a, 0), (b, 0), (c, 1)):
        tmodel.clap_init(m, seed)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["text_branch.layer_0.attention_q.weight"],
                           sc["text_branch.layer_0.attention_q.weight"])
    assert torch.equal(sa["mel_bn_var"], torch.ones(64))
    table = sa["audio_branch.layers_0.blocks_0.attn.relative_position_bias_table"]
    assert 0 < table.abs().max() <= 0.04
    emb = tmodel.ClapEmbedder(device="cpu", model=a).embed_audio(noise((1, 4800), 13))
    assert emb.shape == (1, 1, 512) and abs(float(emb.norm()) - 1.0) < 1e-6


# ---------------------------------------------------- the laion checkpoint

def laion_state_dict(seed, embed=8, depths=(2, 2, 6, 2), heads=(1, 1, 2, 2), window=8,
                     layers=2, hidden=32, inter=64, vocab=50265):
    """A synthetic laion_clap ``630k-audioset-best.pt`` state dict: every key
    the loaders read, named and shaped as laion's HTSAT (timm Swin), HF
    RoBERTa and the projection heads, behind ``module.``, with keys that
    neither loader reads beside them."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, *shape, positive=False):
        v = rng.uniform(0.5, 1.5, shape) if positive else 0.2 * rng.standard_normal(shape)
        sd["module." + key] = torch.from_numpy(v.astype(np.float32))

    def lin(key, o, i, bias=True):
        put(f"{key}.weight", o, i)
        if bias:
            put(f"{key}.bias", o)

    def ln(key, d):
        put(f"{key}.weight", d)
        put(f"{key}.bias", d)

    ab = "audio_branch"
    put(f"{ab}.patch_embed.proj.weight", embed, 1, 4, 4)
    put(f"{ab}.patch_embed.proj.bias", embed)
    ln(f"{ab}.patch_embed.norm", embed)
    dim = embed
    for li, (depth, nh) in enumerate(zip(depths, heads)):
        for bi in range(depth):
            src = f"{ab}.layers.{li}.blocks.{bi}"
            ln(f"{src}.norm1", dim)
            lin(f"{src}.attn.qkv", 3 * dim, dim)
            lin(f"{src}.attn.proj", dim, dim)
            put(f"{src}.attn.relative_position_bias_table", (2 * window - 1) ** 2, nh)
            sd[f"module.{src}.attn.relative_position_index"] = torch.zeros(64, 64, dtype=torch.long)
            ln(f"{src}.norm2", dim)
            lin(f"{src}.mlp.fc1", 4 * dim, dim)
            lin(f"{src}.mlp.fc2", dim, 4 * dim)
        if li < len(depths) - 1:
            ln(f"{ab}.layers.{li}.downsample.norm", 4 * dim)
            lin(f"{ab}.layers.{li}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
            dim *= 2
    ln(f"{ab}.norm", dim)
    for key in ("weight", "bias", "running_mean"):
        put(f"{ab}.bn0.{key}", 64)
    put(f"{ab}.bn0.running_var", 64, positive=True)
    sd[f"module.{ab}.bn0.num_batches_tracked"] = torch.tensor(7)
    put(f"{ab}.head.weight", 527, dim)
    put(f"{ab}.spectrogram_extractor.stft.conv_real.weight", 513, 1, 1024)
    lin("audio_projection.0", 512, dim)
    lin("audio_projection.2", 512, 512)

    tb = "text_branch"
    put(f"{tb}.embeddings.word_embeddings.weight", vocab, hidden)
    put(f"{tb}.embeddings.position_embeddings.weight", 514, hidden)
    put(f"{tb}.embeddings.token_type_embeddings.weight", 1, hidden)
    ln(f"{tb}.embeddings.LayerNorm", hidden)
    sd[f"module.{tb}.embeddings.position_ids"] = torch.arange(514)[None]
    for li in range(layers):
        src = f"{tb}.encoder.layer.{li}"
        for part in ("query", "key", "value"):
            lin(f"{src}.attention.self.{part}", hidden, hidden)
        lin(f"{src}.attention.output.dense", hidden, hidden)
        ln(f"{src}.attention.output.LayerNorm", hidden)
        lin(f"{src}.intermediate.dense", inter, hidden)
        lin(f"{src}.output.dense", hidden, inter)
        ln(f"{src}.output.LayerNorm", hidden)
    lin(f"{tb}.pooler.dense", hidden, hidden)
    lin("text_projection.0", 512, hidden)
    lin("text_projection.2", 512, 512)
    sd["module.logit_scale_a"] = torch.tensor(2.0)
    return sd


def test_laion_loader_matches_jax_converter(tmp_path, no_transformers_files):
    """A synthetic checkpoint saved as laion saves it ({"epoch", "state_dict"}
    with ``module.`` keys) through the JAX ``convert_laion_clap`` and through
    the port's ``ClapEmbedder(checkpoint_path=...)``: the same audio and
    text embeddings.  The JAX converter reads HTSAT-tiny's depths (2, 2, 6,
    2), so the towers are narrow at those depths."""
    depths = (2, 2, 6, 2)
    sd = laion_state_dict(0, depths=depths)
    path = tmp_path / "630k-synthetic.pt"
    torch.save({"epoch": 3, "state_dict": sd}, path)

    from syncfusion_tpu.core.checkpoint import load_torch_state_dict

    jvars = jconvert.convert_laion_clap(load_torch_state_dict(path))
    jnet = TinyJaxClap()
    jnet_audio = jhtsat.HTSAT(**{**TINY_AUDIO, "depths": depths})
    temb = tmodel.ClapEmbedder(str(path), device="cpu", model=tiny_port_model(depths=depths))

    wav = thtsat.prepare_audio(noise((1, 200_000), 14, scale=0.3))
    mel = jhtsat.clap_mel(jnp.asarray(wav))
    p = jvars["params"]
    mel = (mel - p["mel_bn_mean"]) / jnp.sqrt(p["mel_bn_var"] + 1e-5)
    mel = mel * p["mel_bn_scale"] + p["mel_bn_bias"]
    latent = jnet_audio.apply({"params": p["audio_branch"]},
                              jhtsat.reshape_mel_to_image(mel))
    emb = jmodel.Projection().apply({"params": p["audio_projection"]}, latent)
    want = np.asarray(emb / jnp.linalg.norm(emb, axis=-1, keepdims=True))
    got = n(temb.model.encode_audio(t(wav)))
    np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=0)

    toks = jroberta.tokenize(["hit wood", "metal"])
    want = np.asarray(jnet.apply(jvars, jnp.asarray(toks["input_ids"]),
                                 jnp.asarray(toks["attention_mask"]),
                                 method=jmodel.ClapModel.encode_text))
    got = n(temb.embed_text(["hit wood", "metal"]))[:, 0]
    np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=0)

    # every loaded tensor is the checkpoint's, renamed only
    loaded = tconvert.load_laion_clap(sd)
    assert loaded["mel_bn_var"].equal(sd["module.audio_branch.bn0.running_var"])
    assert loaded["text_branch.layer_1.output.weight"].equal(
        sd["module.text_branch.encoder.layer.1.output.dense.weight"])
    assert "audio_branch.head.weight" not in loaded and "logit_scale_a" not in loaded


def test_hf_clap_audio_rename_is_the_jax_one():
    """transformers' CLAP audio names -> laion's (qkv fused), on a synthetic
    state dict of one block."""
    rng = np.random.default_rng(15)
    base = "audio_model.audio_encoder.layers.0.blocks.0"
    sd = {f"{base}.{k}": rng.standard_normal(s).astype(np.float32) for k, s in {
        "layernorm_before.weight": (8,), "layernorm_after.bias": (8,),
        "attention.self.query.weight": (8, 8), "attention.self.key.weight": (8, 8),
        "attention.self.value.weight": (8, 8), "attention.self.query.bias": (8,),
        "attention.self.key.bias": (8,), "attention.self.value.bias": (8,),
        "attention.self.relative_position_bias_table": (225, 1),
        "attention.self.relative_position_index": (64, 64),
        "attention.output.dense.weight": (8, 8), "intermediate.dense.weight": (32, 8),
        "output.dense.weight": (8, 32)}.items()}
    sd["audio_model.audio_encoder.batch_norm.running_mean"] = np.zeros(64, np.float32)
    sd["audio_model.audio_encoder.batch_norm.num_batches_tracked"] = np.zeros((), np.int64)
    sd["audio_projection.linear1.weight"] = rng.standard_normal((512, 8)).astype(np.float32)
    got, want = tconvert.hf_clap_audio_to_laion(sd), jconvert.hf_clap_audio_to_laion(sd)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# --------------------------------------------------- the sample logger's panel

def test_spec_panel_matches_jax(tmp_path):
    """The panel's mel (the sample logger's chain) within SPEC_TOL after the
    dB step, and the PNG the same pixels as the JAX one's for one mel."""
    wavs = noise((2, 6000), 16)
    kw = dict(sample_rate=48000, n_fft=1024, hop_length=512, n_mels=80, power=2.0,
              norm="slaney")
    want = np.asarray(jmel.power_to_db(jmel.mel_spectrogram(jnp.asarray(wavs), **kw)))
    got = n(tmel.power_to_db(tmel.mel_spectrogram(t(wavs), **kw)))
    np.testing.assert_allclose(got, want, atol=DB_TOL, rtol=0)
    np.testing.assert_array_equal(tpanels._colormap(np.linspace(-0.5, 1.5, 41)),
                                  jpanels._colormap(np.linspace(-0.5, 1.5, 41)))
    a = tpanels.write_spec_panel(tmp_path / "port", "mel", {"sample": want[0],
                                                            "other": want[1]}, 3)
    b = jpanels.write_spec_panel(tmp_path / "jax", "mel", {"sample": want[0],
                                                           "other": want[1]}, 3)
    assert a.name == b.name == "mel_step00000003.png"
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
