"""Model configuration of the diffusion system, without a YAML dependency.

The defaults are the values of ``exp/model/diffusion.yaml`` (the
reference's hyperparameters).  ``from_dict`` reads an already-loaded config
node; ``from_yaml`` reads the file itself and needs PyYAML, which only the
callers that use it must have.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 1
    channels: tuple[int, ...] = (8, 32, 64, 128, 256, 512, 1024, 1024)
    factors: tuple[int, ...] = (1, 4, 4, 4, 2, 2, 2, 2)
    items: tuple[int, ...] = (1, 2, 2, 2, 2, 2, 2, 4)
    attentions: tuple[int, ...] = (0, 0, 0, 0, 1, 1, 1, 1)
    cross_attentions: tuple[int, ...] = (1, 1, 1, 1, 1, 1, 1, 1)
    context_channels: tuple[int, ...] = (2, 8, 16, 32, 64, 128, 256, 256)
    attention_heads: int = 8
    attention_features: int = 64
    embedding_features: int = 512
    embedding_max_length: int = 1
    use_embedding_cfg: bool = True
    modulation_features: int = 1024
    resnet_groups: int = 8
    out_channels: Optional[int] = None

    @classmethod
    def from_dict(cls, node: Mapping[str, Any]) -> "UNetConfig":
        return _from_dict(cls, node)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    in_channels: int = 1
    channels: int = 2
    multipliers: tuple[int, ...] = (1, 1, 4, 8, 16, 32, 64, 128, 128)
    factors: tuple[int, ...] = (1, 4, 4, 4, 2, 2, 2, 2)
    num_blocks: tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2)
    resnet_groups: int = 2
    patch_size: int = 1

    @classmethod
    def from_dict(cls, node: Mapping[str, Any]) -> "EncoderConfig":
        return _from_dict(cls, node)


def _from_dict(cls, node: Mapping[str, Any]):
    """Build ``cls`` from the keys of ``node`` it knows; lists become tuples.

    Keys the port has no use for (e.g. ``flash_attention``, a TPU execution
    switch: the port always runs its kernel on the card) are ignored.
    """
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in node.items() if k in names}
    return cls(**kw)


def model_configs(model_cfg: Optional[Mapping[str, Any]]
                  ) -> tuple[UNetConfig, EncoderConfig]:
    """The ``model`` node of a diffusion config (``{"model": ...,
    "onsets_encoder": ...}``) as config objects; the defaults when None."""
    if model_cfg is None:
        return UNetConfig(), EncoderConfig()
    return (UNetConfig.from_dict(model_cfg["model"]),
            EncoderConfig.from_dict(model_cfg["onsets_encoder"]))


def from_yaml(path) -> tuple[UNetConfig, EncoderConfig]:
    """Read an ``exp/model/diffusion.yaml``-style file (needs PyYAML)."""
    import yaml

    with open(path) as f:
        node = yaml.safe_load(f)
    return model_configs(node["model"])
