"""Configuration of the diffusion system and the onset model, without a
YAML dependency.

The model defaults are the values of ``exp/model/diffusion.yaml`` (the
reference's hyperparameters); ``TrainConfig``'s are those of
``exp/train_diffusion_gh.yaml``; ``OnsetConfig``'s those of
``cfg/data/data-onset-greatesthit.yaml``, ``cfg/model/model-onset.yaml`` and
``cfg/trainer/trainer-onset.yaml``; ``BaselineConfig``'s those of
``cfg/condfoleygen/greatesthit_transformer.yaml`` and, for the VQGAN, the
``model`` node of ``cfg/condfoleygen/greatesthit_codebook.yaml``.
``from_dict`` reads an already-loaded
config node; ``from_yaml`` reads the file itself and needs PyYAML, which only
the callers that use it must have.
"""

from __future__ import annotations

import dataclasses
import json
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
    # execution switches of the JAX UNet1d, off by default as there:
    # fused_resnet runs the resnet chains that pass its gate through K3;
    # fused_stats runs the levels that the folded apply folds (compute_folds
    # at fold_cap, the diffusion config's top-level key, 256 in the yaml)
    # through K4.  fold_cap alone changes nothing: the port keeps the plain
    # layout, which the folded one equals.
    fused_resnet: bool = False
    fused_stats: bool = False
    fused_block_l: int = 4096
    fold_cap: int = 256
    # recompute each resnet block of the levels in the backward instead of
    # keeping its activations (the JAX UNet1d's nn.remat): memory down,
    # work up, the same numbers
    remat: bool = False

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
    """Build ``cls`` from the keys of ``node`` it knows; lists become tuples,
    and a string given for a float field (YAML 1.1 reads ``1e-4`` as one)
    becomes a float.

    Keys the port has no use for (e.g. ``flash_attention``, a TPU execution
    switch: the port always runs its kernel on the card) are ignored.
    """
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in node.items():
        if k not in fields:
            continue
        if isinstance(v, list):
            v = tuple(v)
        elif isinstance(v, str) and isinstance(fields[k].default, float):
            v = float(v)
        kw[k] = v
    return cls(**kw)


def model_configs(model_cfg: Optional[Mapping[str, Any]]
                  ) -> tuple[UNetConfig, EncoderConfig]:
    """The ``model`` node of a diffusion config (``{"model": ...,
    "onsets_encoder": ..., "fold_cap": ...}``) as config objects; the
    defaults when None.  ``fold_cap`` (0 when absent) joins the UNet's
    config, as the JAX ``from_config`` reads it beside ``model``."""
    if model_cfg is None:
        return UNetConfig(), EncoderConfig()
    unet = UNetConfig.from_dict({**model_cfg["model"],
                                 "fold_cap": int(model_cfg.get("fold_cap", 0))})
    return unet, EncoderConfig.from_dict(model_cfg["onsets_encoder"])


def from_yaml(path, raw: bool = False):
    """Read an ``exp/model/diffusion.yaml``-style file as its
    ``(UNetConfig, EncoderConfig)``, or with ``raw`` any YAML file as the
    dict it holds (needs PyYAML).  Numbers like ``1e-4``, which YAML 1.1
    reads as strings, are left to the config classes to convert."""
    import yaml

    with open(path) as f:
        node = yaml.safe_load(f)
    return node if raw else model_configs(node["model"])


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


@dataclasses.dataclass(frozen=True)
class OnsetDataConfig:
    """``cfg/data/data-onset-greatesthit.yaml``, with the keys that
    ``script/train_onset_model.py`` reads with a default."""

    root_dir: str = "data/greatest-hits/mic-mp4-processed"
    train_split_file_path: str = "data/greatest-hits/mic-mp4-processed/train.txt"
    val_split_file_path: str = "data/greatest-hits/mic-mp4-processed/val.txt"
    test_split_file_path: str = "data/greatest-hits/mic-mp4-processed/test.txt"
    train_data_to_use: float = 1.0
    val_data_to_use: float = 1.0
    test_data_to_use: float = 1.0
    chunk_length_in_seconds: float = 2.0
    augment: bool = False
    batch_size: int = 16
    num_workers: int = 8
    frame_size: int = 112
    fps: int = 15
    wire: str = "uint8"  # "uint8", "yuv420" or "float"
    device_jitter: bool = True
    cache_decoded: bool = True
    cache_decoded_mb: int = 8192


@dataclasses.dataclass(frozen=True)
class OnsetModelConfig:
    """``cfg/model/model-onset.yaml``; ``precision`` is ``"bf16"`` (bf16
    convolutions over f32 parameters) or ``"32"`` (f32, no TF32)."""

    precision: str = "bf16"
    lr: float = 1e-4
    lr_beta1: float = 0.9
    lr_beta2: float = 0.999
    lr_eps: float = 1e-8
    lr_weight_decay: float = 1e-3
    pretrained: bool = False
    pretrained_path: Optional[str] = None
    layers: tuple[int, ...] = (2, 2, 2, 2)


@dataclasses.dataclass(frozen=True)
class OnsetTrainerConfig:
    """``cfg/trainer/trainer-onset.yaml``."""

    max_epochs: int = 100
    check_val_every_n_epoch: int = 5
    log_every_n_steps: int = 10
    seed: int = 12345
    logs_dir: str = "logs/onset"


@dataclasses.dataclass(frozen=True)
class OnsetConfig:
    """The onset model's ``data``, ``model`` and ``trainer`` nodes."""

    data: OnsetDataConfig = OnsetDataConfig()
    model: OnsetModelConfig = OnsetModelConfig()
    trainer: OnsetTrainerConfig = OnsetTrainerConfig()

    @classmethod
    def from_dict(cls, node: Mapping[str, Any]) -> "OnsetConfig":
        """From a ``{"data": ..., "model": ..., "trainer": ...}`` node; a
        missing key keeps its default.  ``precision`` becomes a string (the
        YAML holds ``bf16`` or ``32``)."""
        model = dict(node.get("model", {}))
        if "precision" in model:
            model["precision"] = str(model["precision"])
        return cls(data=_from_dict(OnsetDataConfig, node.get("data", {})),
                   model=_from_dict(OnsetModelConfig, model),
                   trainer=_from_dict(OnsetTrainerConfig, node.get("trainer", {})))

    @classmethod
    def from_files(cls, paths) -> "OnsetConfig":
        """``-c`` files merged in order, a later key over an earlier one (as
        ``script/train_onset_model.py`` merges them): JSON, or YAML through
        ``from_yaml`` where PyYAML is installed."""
        return cls.from_dict(read_files(paths))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def read_files(paths) -> dict:
    """Config files merged in order, a later key over an earlier one: JSON,
    or YAML through ``from_yaml`` where PyYAML is installed."""
    node: dict = {}
    for path in paths:
        if str(path).endswith((".yaml", ".yml")):
            overlay = from_yaml(path, raw=True) or {}
        else:
            with open(path) as f:
                overlay = json.load(f)
        node = merge(node, overlay)
    return node


def merge(base: Mapping, overlay: Mapping) -> dict:
    """Deep merge: ``overlay``'s keys win, nested dicts merge."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(out.get(k), Mapping) and isinstance(v, Mapping):
            v = merge(out[k], v)
        out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """SpecVQGAN's geometry: ``embed_dim`` and ``n_embed`` with the
    ``ddconfig`` keys that ``VQModel`` takes, the values of
    ``cfg/condfoleygen/greatesthit_codebook.yaml``'s ``model`` node."""

    embed_dim: int = 256
    n_embed: int = 1024
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple[int, ...] = (10,)
    resolution: int = 160
    z_channels: int = 256


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The CondFoleyGen GPT's geometry, the ``transformer`` node of
    ``cfg/condfoleygen/greatesthit_transformer.yaml``."""

    vocab_size: int = 1024
    block_size: int = 160
    n_layer: int = 24
    n_head: int = 16
    n_embd: int = 1024


@dataclasses.dataclass(frozen=True)
class BaselineDataConfig:
    """The ``data`` node: the test split and ``frame_size``, which
    ``generate_audio`` reads, and the train and val splits with the keys
    that ``script/train_codebook.py`` and ``script/train_transformer.py``
    read with a default (``batch_size`` has none there: None here, and the
    trainers raise without it).  ``p_audio_aug`` is the transformer
    trainer's share of augmented wavs, 0.5 by default (the GH YAML does not
    set it); ``rand_shift`` is the codebook trainer's (the transformer's
    train split always shifts, as the JAX script's does)."""

    root_dir: str = "data/greatest-hits/mic-mp4-processed"
    test_split_file_path: str = "data/greatest-hits/mic-mp4-processed/test.txt"
    chunk_length_in_seconds: float = 2.0
    sample_rate: int = 22050
    frame_size: int = 112
    train_split_file_path: str = "data/greatest-hits/mic-mp4-processed/train.txt"
    val_split_file_path: str = "data/greatest-hits/mic-mp4-processed/val.txt"
    train_data_to_use: float = 1.0
    val_data_to_use: float = 1.0
    batch_size: Optional[int] = None
    rand_shift: bool = True
    p_outside_cond: float = 0.0
    p_audio_aug: float = 0.5


@dataclasses.dataclass(frozen=True)
class VQGANLossConfig:
    """The VQGAN's ``model.lossconfig`` (the values of
    ``cfg/condfoleygen/greatesthit_codebook.yaml``): the discriminator
    joins at step ``disc_start`` with weight ``disc_weight`` times the
    adaptive weight, clipped to [``min_adapt_weight``,
    ``max_adapt_weight``] (a constant when the two are equal, as there).
    The discriminator's factor once it has joined is not a config value:
    ``train.vqgan_trainer.DISC_FACTOR``, as the JAX script fixes it."""

    disc_start: int = 30001
    disc_weight: float = 0.8
    codebook_weight: float = 1.0
    perceptual_weight: float = 1.0
    min_adapt_weight: float = 1.0
    max_adapt_weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class BaselineTrainerConfig:
    """The ``trainer`` node: ``max_epochs`` (None: the entry point's
    default, 1000 epochs of the codebook, 100 of the transformer, as the JAX
    scripts read it), the transformer's ``model_parallel`` and ``fsdp``."""

    max_epochs: Optional[int] = None
    model_parallel: int = 1
    fsdp: bool = False


# BaselineConfig's fields read from the config's top level
_BASELINE_TOP = ("seed", "logs_dir", "learning_rate", "weight_decay", "pkeep", "log_media")


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    """The CondFoleyGen baseline's config as ``generate_audio``,
    ``train_codebook`` and ``train_transformer`` read it: ``model`` (the
    VQGAN's geometry with its ``ddconfig``; its ``learning_rate`` and
    ``lossconfig`` go to ``vq_learning_rate`` and ``lossconfig``),
    ``transformer``, ``data``, ``trainer`` and the top-level keys.  A
    missing key keeps its default, the one the JAX scripts read with
    ``.get``; a key nothing reads is ignored.  ``logs_dir`` None is the
    entry point's own default (``logs/specvqgan`` or ``logs/transformer``);
    ``learning_rate`` is the GPT's.  The JAX script's ``n_frames`` sizes its
    init only: the port's parameters do not depend on it, so it is not read."""

    model: VQConfig = VQConfig()
    transformer: GPTConfig = GPTConfig()
    data: BaselineDataConfig = BaselineDataConfig()
    trainer: BaselineTrainerConfig = BaselineTrainerConfig()
    lossconfig: VQGANLossConfig = VQGANLossConfig()
    vq_learning_rate: float = 4.5e-6
    seed: int = 0
    logs_dir: Optional[str] = None
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    pkeep: float = 1.0
    log_media: bool = True

    @classmethod
    def from_dict(cls, node: Mapping[str, Any]) -> "BaselineConfig":
        model = dict(node.get("model", {}))
        lossconfig = model.pop("lossconfig", {}) or {}
        vq_lr = model.pop("learning_rate", cls.vq_learning_rate)
        model = {**model.pop("ddconfig", {}), **model}
        top = _from_dict(cls, {k: v for k, v in node.items() if k in _BASELINE_TOP})
        return dataclasses.replace(
            top, model=_from_dict(VQConfig, model),
            transformer=_from_dict(GPTConfig, node.get("transformer", {})),
            data=_from_dict(BaselineDataConfig, node.get("data", {})),
            trainer=_from_dict(BaselineTrainerConfig, node.get("trainer", {}) or {}),
            lossconfig=_from_dict(VQGANLossConfig, lossconfig),
            vq_learning_rate=float(vq_lr))

    @classmethod
    def from_files(cls, paths) -> "BaselineConfig":
        """Files merged in order, as ``OnsetConfig.from_files`` reads them."""
        return cls.from_dict(read_files(paths))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

