"""Configurations and state-dict manifests of the reference's diffusion nets
(the port's copy of the configs and manifests of
``syncfusion_tpu/models/adp_torch_recon.py``).

The reference builds its diffusion model from two pip packages:
``audio-diffusion-pytorch==0.1.3`` (``UNetV0``: an a-unet ``XUNet`` inside
``TimeConditioningPlugin(ClassifierFreeGuidancePlugin(...))``) and
``audio-encoders-pytorch==0.0.22`` (``Encoder1d``, the onset-track
encoder), configured by ``exp/model/diffusion.yaml``.  The JAX package
reconstructs both as torch modules; the port keeps only what its loader
needs of that reconstruction: the two configurations and the manifests,
the ordered ``(key, shape)`` listing of each net's ``state_dict``, which
``models/adp_convert.py`` matches a checkpoint against (by name, or by
registration order and shape for upstream's anonymous ``blocks.N`` keys).

The structural decisions behind the manifests (D1-D11: plugin nesting,
NumberEmbedder, per-item skips, injection, attention, modulation, the
encoder's ``xs``) are listed in the JAX module and docs/AUNET_MANIFEST.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class UNetV0Config:
    """UNetV0 as ``exp/model/diffusion.yaml`` configures it."""

    in_channels: int = 1
    channels: Sequence[int] = (8, 32, 64, 128, 256, 512, 1024, 1024)
    factors: Sequence[int] = (1, 4, 4, 4, 2, 2, 2, 2)
    items: Sequence[int] = (1, 2, 2, 2, 2, 2, 2, 4)
    attentions: Sequence[int] = (0, 0, 0, 0, 1, 1, 1, 1)
    cross_attentions: Sequence[int] = (1, 1, 1, 1, 1, 1, 1, 1)
    context_channels: Sequence[int] = (2, 8, 16, 32, 64, 128, 256, 256)
    attention_heads: int = 8
    attention_features: int = 64
    embedding_features: int = 512
    embedding_max_length: int = 1
    use_embedding_cfg: bool = True
    use_modulation: bool = True
    modulation_features: int = 1024
    resnet_groups: int = 8
    out_channels: Optional[int] = None
    # the skip merge's scale and concat order (decision D4) cannot be read
    # off a checkpoint; both are switches, as in the JAX package
    skip_scale: float = 2.0 ** -0.5
    cat_order: str = "skip_first"  # or "x_first"
    fourier_dim: int = 256

    def item_kinds(self, level: int) -> List[str]:
        """The expanded item kinds of one level (decision D5)."""
        base: List[str] = ["res"]
        if self.use_modulation:
            base.append("mod")
        if self.context_channels[level] > 0:
            base.append("inj")
        if self.attentions[level]:
            base.append("attn")
        if self.cross_attentions[level]:
            base.append("xattn")
        return base * self.items[level]

    @classmethod
    def from_node(cls, m: dict) -> "UNetV0Config":
        """From a diffusion config's ``model`` node."""
        return cls(
            in_channels=m.get("in_channels", 1),
            channels=tuple(m["channels"]),
            factors=tuple(m["factors"]),
            items=tuple(m["items"]),
            attentions=tuple(m["attentions"]),
            cross_attentions=tuple(m["cross_attentions"]),
            context_channels=tuple(m["context_channels"]),
            attention_heads=m.get("attention_heads", 8),
            attention_features=m.get("attention_features", 64),
            embedding_features=m.get("embedding_features", 512),
            embedding_max_length=m.get("embedding_max_length", 1),
            use_embedding_cfg=m.get("use_embedding_cfg", True),
        )


@dataclass(frozen=True)
class Encoder1dConfig:
    """aep ``Encoder1d`` as ``exp/model/diffusion.yaml`` configures it."""

    in_channels: int = 1
    channels: int = 2
    multipliers: Sequence[int] = (1, 1, 4, 8, 16, 32, 64, 128, 128)
    factors: Sequence[int] = (1, 4, 4, 4, 2, 2, 2, 2)
    num_blocks: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2)
    resnet_groups: int = 2
    patch_size: int = 1

    @classmethod
    def from_node(cls, e: dict) -> "Encoder1dConfig":
        """From a diffusion config's ``onsets_encoder`` node."""
        return cls(
            in_channels=e.get("in_channels", 1),
            channels=e["channels"],
            multipliers=tuple(e["multipliers"]),
            factors=tuple(e["factors"]),
            num_blocks=tuple(e["num_blocks"]),
            resnet_groups=e.get("resnet_groups", 2),
            patch_size=e.get("patch_size", 1),
        )


def unet_manifest(cfg: UNetV0Config) -> List[tuple]:
    """Ordered ``[(key, shape)]`` of the reference UNetV0's state dict."""
    out: List[tuple] = []
    mf, ef = cfg.modulation_features, cfg.embedding_features
    heads_mid = cfg.attention_heads * cfg.attention_features
    out += [("embedder.weights", (cfg.fourier_dim // 2,)),
            ("embedder.to_out.weight", (mf, cfg.fourier_dim + 1)),
            ("embedder.to_out.bias", (mf,))]
    for i in (0, 1):
        out += [(f"mlp.{i}.0.weight", (mf, mf)), (f"mlp.{i}.0.bias", (mf,))]
    if cfg.use_embedding_cfg:
        out.append(("fixed_embedding.weight", (cfg.embedding_max_length, ef)))

    def item_entries(prefix: str, kind: str, level: int) -> List[tuple]:
        ch = cfg.channels[level]
        if kind == "res":
            return [(f"{prefix}.gn1.weight", (ch,)), (f"{prefix}.gn1.bias", (ch,)),
                    (f"{prefix}.conv1.weight", (ch, ch, 3)), (f"{prefix}.conv1.bias", (ch,)),
                    (f"{prefix}.gn2.weight", (ch,)), (f"{prefix}.gn2.bias", (ch,)),
                    (f"{prefix}.conv2.weight", (ch, ch, 3)), (f"{prefix}.conv2.bias", (ch,))]
        if kind == "mod":
            return [(f"{prefix}.to_scale_shift.weight", (ch * 2, mf)),
                    (f"{prefix}.to_scale_shift.bias", (ch * 2,)),
                    (f"{prefix}.norm.weight", (ch,)), (f"{prefix}.norm.bias", (ch,))]
        if kind == "inj":
            ctx = cfg.context_channels[level]
            return [(f"{prefix}.conv.weight", (ch, ch + ctx, 1)),
                    (f"{prefix}.conv.bias", (ch,))]
        ctx_f = ef if kind == "xattn" else ch
        return [(f"{prefix}.norm.weight", (ch,)), (f"{prefix}.norm.bias", (ch,)),
                (f"{prefix}.norm_context.weight", (ctx_f,)),
                (f"{prefix}.norm_context.bias", (ctx_f,)),
                (f"{prefix}.to_q.weight", (heads_mid, ch)),
                (f"{prefix}.to_kv.weight", (heads_mid * 2, ctx_f)),
                (f"{prefix}.to_out.weight", (ch, heads_mid)),
                (f"{prefix}.to_out.bias", (ch,))]

    def block_entries(prefix: str, level: int) -> List[tuple]:
        n = len(cfg.channels)
        in_ch = cfg.in_channels if level == 0 else cfg.channels[level - 1]
        out_ch = (cfg.out_channels or cfg.in_channels) if level == 0 else in_ch
        ch, f = cfg.channels[level], cfg.factors[level]
        kinds = cfg.item_kinds(level)
        e: List[tuple] = [(f"{prefix}.downsample.weight", (ch, in_ch, f)),
                          (f"{prefix}.downsample.bias", (ch,))]
        for j, k in enumerate(kinds):
            e += item_entries(f"{prefix}.items_down.{j}", k, level)
        if level + 1 < n:
            e += block_entries(f"{prefix}.inner", level + 1)
            for j in range(len(kinds)):
                e += [(f"{prefix}.skip_adapters.{j}.conv.weight", (ch, ch * 2, 1)),
                      (f"{prefix}.skip_adapters.{j}.conv.bias", (ch,))]
        for j, k in enumerate(kinds):
            e += item_entries(f"{prefix}.items_up.{j}", k, level)
        e += [(f"{prefix}.upsample.weight", (ch, out_ch, f)),
              (f"{prefix}.upsample.bias", (out_ch,))]
        return e

    return out + block_entries("net", 0)


def encoder_manifest(cfg: Encoder1dConfig) -> List[tuple]:
    """Ordered ``[(key, shape)]`` of the reference Encoder1d's state dict."""
    chs = [cfg.channels * m for m in cfg.multipliers]
    out: List[tuple] = [
        ("to_in.groupnorm.weight", (cfg.in_channels,)),
        ("to_in.groupnorm.bias", (cfg.in_channels,)),
        ("to_in.project.weight", (chs[0] // cfg.patch_size, cfg.in_channels, 3)),
        ("to_in.project.bias", (chs[0] // cfg.patch_size,)),
    ]
    for i, f in enumerate(cfg.factors):
        ic, oc = chs[i], chs[i + 1]
        p = f"downsamples.{i}"
        out += [(f"{p}.downsample.weight", (oc, ic, f * 2 + 1)),
                (f"{p}.downsample.bias", (oc,))]
        for j in range(cfg.num_blocks[i]):
            for b in ("block1", "block2"):
                out += [(f"{p}.blocks.{j}.{b}.groupnorm.weight", (oc,)),
                        (f"{p}.blocks.{j}.{b}.groupnorm.bias", (oc,)),
                        (f"{p}.blocks.{j}.{b}.project.weight", (oc, oc, 3)),
                        (f"{p}.blocks.{j}.{b}.project.bias", (oc,))]
    return out
