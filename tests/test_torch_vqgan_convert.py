"""The port's SpecVQGAN and minGPT checkpoint converters against the JAX
package's (``models/vqgan/convert.py``), on the reference-layout state
dicts that tests/test_converters.py builds from the JAX models' inits:
the trees equal bitwise, and the port's models load them (through
``convert.vqgan_state_dict`` and ``gpt_state_dict``, strictly) and compute
what the JAX models compute on them, to 1e-4 of max |JAX|."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from syncfusion_tpu.models.mingpt import GPTConfig as JaxGPTConfig
from syncfusion_tpu.models.mingpt import GPTFeats as JaxGPTFeats
from syncfusion_tpu.models.vqgan import convert as jconvert
from syncfusion_tpu.models.vqgan.model import VQModel as JaxVQModel
from syncfusion_tpu_torch.convert import flatten, gpt_state_dict, vqgan_state_dict
from syncfusion_tpu_torch.core.config import GPTConfig
from syncfusion_tpu_torch.models.mingpt import GPTFeats
from syncfusion_tpu_torch.models.vqgan import convert
from syncfusion_tpu_torch.models.vqgan.model import VQModel
from torch_port_helpers import n

VQ = dict(embed_dim=16, n_embed=32, ch=8, ch_mult=(1, 2), num_res_blocks=1,
          attn_resolutions=(10,), resolution=20, z_channels=16)


def _same_tree(got, want):
    fg, fw = flatten(got), flatten(want)
    assert fg.keys() == fw.keys()
    for k, v in fw.items():
        assert fg[k].dtype == v.dtype and fg[k].shape == v.shape, k
        np.testing.assert_array_equal(fg[k], v, err_msg=str(k))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _vqgan_state_dict(p) -> dict:
    """The taming-transformers state dict of a JAX VQModel tree (the
    layout tests/test_converters.py writes)."""
    sd = {}

    def conv(dst, node):
        sd[f"{dst}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
        sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def gn(dst, node):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = (np.asarray(node["scale"]),
                                                  np.asarray(node["bias"]))

    def res(dst, node):
        gn(f"{dst}.norm1", node["GroupNorm_0"])
        conv(f"{dst}.conv1", node["conv1"])
        gn(f"{dst}.norm2", node["GroupNorm_1"])
        conv(f"{dst}.conv2", node["conv2"])
        if "nin_shortcut" in node:
            conv(f"{dst}.nin_shortcut", node["nin_shortcut"])

    def attn(dst, node):
        gn(f"{dst}.norm", node["GroupNorm_0"])
        for name in ("q", "k", "v", "proj_out"):
            conv(f"{dst}.{name}", node[name])

    enc, dec = p["encoder"], p["decoder"]
    levels = len(VQ["ch_mult"])
    conv("encoder.conv_in", enc["conv_in"])
    for i in range(levels):
        for j in range(VQ["num_res_blocks"]):
            res(f"encoder.down.{i}.block.{j}", enc[f"down_{i}_block_{j}"])
            if f"down_{i}_attn_{j}" in enc:
                attn(f"encoder.down.{i}.attn.{j}", enc[f"down_{i}_attn_{j}"])
        if f"down_{i}_downsample" in enc:
            conv(f"encoder.down.{i}.downsample.conv", enc[f"down_{i}_downsample"]["Conv_0"])
    for tower, node in (("encoder", enc), ("decoder", dec)):
        res(f"{tower}.mid.block_1", node["mid_block_1"])
        attn(f"{tower}.mid.attn_1", node["mid_attn_1"])
        res(f"{tower}.mid.block_2", node["mid_block_2"])
        gn(f"{tower}.norm_out", node["norm_out"])
        conv(f"{tower}.conv_out", node["conv_out"])
    conv("decoder.conv_in", dec["conv_in"])
    for i in range(levels):
        for j in range(VQ["num_res_blocks"] + 1):
            res(f"decoder.up.{i}.block.{j}", dec[f"up_{i}_block_{j}"])
            if f"up_{i}_attn_{j}" in dec:
                attn(f"decoder.up.{i}.attn.{j}", dec[f"up_{i}_attn_{j}"])
        if f"up_{i}_upsample" in dec:
            conv(f"decoder.up.{i}.upsample.conv", dec[f"up_{i}_upsample"]["Conv_0"])
    sd["quantize.embedding.weight"] = np.asarray(p["quantize"]["embedding"])
    conv("quant_conv", p["quant_conv"])
    conv("post_quant_conv", p["post_quant_conv"])
    sd["loss.discriminator.dummy"] = np.zeros(1, np.float32)  # dropped by both
    return sd


def test_vqgan_converter_equals_jax_and_loads_into_the_port():
    model = JaxVQModel(**VQ)
    x = np.random.default_rng(0).normal(size=(1, 10, 20, 1)).astype(np.float32)
    variables = jax.jit(lambda: model.init(jax.random.key(0), jnp.asarray(x)))()
    sd = _vqgan_state_dict(variables["params"])
    want = jconvert.convert_torch_vqgan(sd, ch_mult=(1, 2), num_res_blocks=1)
    got = convert.convert_torch_vqgan(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, ch_mult=(1, 2),
        num_res_blocks=1)
    _same_tree(got, want)
    _same_tree(convert.convert_torch_vqgan(sd, ch_mult=(1, 2), num_res_blocks=1), want)

    port = VQModel(**VQ)
    port.load_state_dict(vqgan_state_dict(got), strict=True)
    jax_out = np.asarray(model.apply(want, jnp.asarray(x))[0])
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel(n(out.permute(0, 2, 3, 1)), jax_out) < 1e-4


def test_mingpt_converter_equals_jax_and_loads_into_the_port():
    cfg = dict(vocab_size=16, block_size=24, n_layer=2, n_head=2, n_embd=8)
    net = JaxGPTFeats(JaxGPTConfig(**cfg))
    variables = jax.jit(lambda: net.init(jax.random.key(0), jnp.zeros((1, 6), jnp.int32),
                                         jnp.zeros((1, 4, 8))))()
    p = variables["params"]
    sd = {"transformer.tok_emb.weight": np.asarray(p["tok_emb"]["embedding"]),
          "transformer.pos_emb": np.asarray(p["pos_emb"])[None],
          "transformer.ln_f.weight": np.asarray(p["ln_f"]["scale"]),
          "transformer.ln_f.bias": np.asarray(p["ln_f"]["bias"]),
          "transformer.head.weight": np.asarray(p["head"]["kernel"]).T,
          "transformer.embedder.weight": np.asarray(p["feat_proj"]["kernel"]).T[:, :, None],
          "transformer.embedder.bias": np.asarray(p["feat_proj"]["bias"])}
    for i in range(cfg["n_layer"]):
        blk, src = p[f"h_{i}"], f"transformer.blocks.{i}"
        for name in ("ln1", "ln2"):
            sd[f"{src}.{name}.weight"] = np.asarray(blk[name]["scale"])
            sd[f"{src}.{name}.bias"] = np.asarray(blk[name]["bias"])
        qkv_k, qkv_b = np.asarray(blk["attn"]["qkv"]["kernel"]), np.asarray(
            blk["attn"]["qkv"]["bias"])
        c = qkv_k.shape[0]
        for slot, name in enumerate(("query", "key", "value")):
            sd[f"{src}.attn.{name}.weight"] = qkv_k[:, slot * c:(slot + 1) * c].T
            sd[f"{src}.attn.{name}.bias"] = qkv_b[slot * c:(slot + 1) * c]
        for dst, node in (("attn.proj", blk["attn"]["proj"]), ("mlp.0", blk["mlp_fc"]),
                          ("mlp.2", blk["mlp_proj"])):
            sd[f"{src}.{dst}.weight"] = np.asarray(node["kernel"]).T
            sd[f"{src}.{dst}.bias"] = np.asarray(node["bias"])
    want = jconvert.convert_torch_mingpt(sd)
    got = convert.convert_torch_mingpt({k: torch.from_numpy(np.array(v))
                                        for k, v in sd.items()})
    _same_tree(got, want)
    bare = {k[len("transformer."):]: v for k, v in sd.items()}
    _same_tree(convert.convert_torch_mingpt(bare, prefix=""),
               jconvert.convert_torch_mingpt(bare, prefix=""))

    port = GPTFeats(GPTConfig(**cfg), feat_dim=8)
    port.load_state_dict(gpt_state_dict(got), strict=True)
    toks = np.array([[1, 2, 3, 4, 5, 6]], np.int32)
    feats = np.random.default_rng(1).normal(size=(1, 4, 8)).astype(np.float32)
    jax_out = np.asarray(net.apply(want, jnp.asarray(toks), jnp.asarray(feats)))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(toks).long(), torch.from_numpy(feats))
    assert out.shape == jax_out.shape
    assert _rel(n(out), jax_out) < 1e-4
