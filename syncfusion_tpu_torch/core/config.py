"""Configuration of the diffusion system, without a YAML dependency.

The model defaults are the values of ``exp/model/diffusion.yaml`` (the
reference's hyperparameters); ``TrainConfig``'s are those of
``exp/train_diffusion_gh.yaml``.  ``from_dict`` reads an already-loaded config
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Diffusion training: the values of ``exp/train_diffusion_gh.yaml``
    (with ``config.yaml``'s seed and ``exp/model/diffusion.yaml``'s
    optimizer and embedder), named after the YAML keys that hold them."""

    seed: int = 12345
    sampling_rate: int = 48000
    length: int = 262144
    max_steps: int = 1000000
    embedding_mask_proba: float = 0.0
    # datamodule
    batch_size: int = 4
    shuffle_size: int = 200
    wire_int16: bool = False
    # trainer
    precision: str = "32"  # "32": f32 compute, no TF32; "bf16": bf16 compute
    gradient_clip_val: float = 0.5
    accumulate_grad_batches: int = 2
    log_every_n_steps: int = 10
    val_check_interval: int = 1000
    val_batches: int = 16
    model_parallel: int = 1
    fsdp: bool = False
    # callbacks: model_checkpoint
    monitor: str = "valid_loss"
    mode: str = "min"
    save_top_k: int = 1
    save_last: bool = True
    # callbacks: audio_samples_logger
    num_items: int = 2
    sampling_steps: tuple[int, ...] = (100,)
    embedding_scale: float = 7.0
    # model: optimizer and embedder
    lr: float = 1e-4
    lr_beta1: float = 0.95
    lr_beta2: float = 0.999
    lr_eps: float = 1e-6
    lr_weight_decay: float = 1e-3
    amodel: str = "HTSAT-tiny"
