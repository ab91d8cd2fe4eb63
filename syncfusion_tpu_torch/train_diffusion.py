"""Diffusion training (the counterpart of ``script/train_diffusion_model.py``).

    python -m syncfusion_tpu_torch.train_diffusion \\
        --train_path "data/.../train_shard_{1..3}.tar" \\
        --val_path data/.../val_shard_1.tar --logs_dir logs \\
        [--clap_ckpt 630k-audioset-best.pt | --embedder none] \\
        [--ckpt logs/runs/<run>/ckpts] [--model_config model.json] \\
        [--<key> <value> for any key of TrainConfig, e.g. --batch_size 2]

The defaults are ``exp/train_diffusion_gh.yaml``'s (``core.config.TrainConfig``):
batch 4 chunks of 2^18 samples, gradient accumulation 2, clip 0.5, AdamW,
f32 compute (``--precision 32``: no TF32, the JAX package's parity policy)
or ``--precision bf16`` (bf16 compute over f32 parameters).  Every
``val_check_interval`` micro-steps it computes the validation loss, writes
``--num_items`` sampled clips and their mel panels to ``media/`` and saves
a checkpoint (best ``save_top_k`` by valid_loss and the latest); ``--ckpt
DIR`` resumes from the latest checkpoint in DIR.  Metrics go to
``<logs_dir>/runs/<run>/metrics.jsonl``.  ``--save ATTR`` (the JAX
script's ``+save=``) writes the model's dotted subtree ATTR (``model``,
``onsets_encoder``, ``model.down_1``, ...) as a checkpoint ``{ATTR with _
for .: {key: tensor}}`` under ``<run>/export_<ATTR>`` and stops.
``--model_config``: JSON of the diffusion config's model node, as in
``generate.py``.  Each batch is conditioned on the CLAP
embedding of its conditioning chunk (the default embedder, ``HTSAT-tiny``,
with the laion checkpoint ``--clap_ckpt``, else random weights and a
warning), computed on the device in the feeder thread; ``--embedder none``
conditions on zero embeddings.  Runs on the card; ``--device cpu`` runs on
the CPU.

On several cards, one process each:

    python -m torch.distributed.run --nproc_per_node N \
        -m syncfusion_tpu_torch.train_diffusion ...

trains over a ``(data, model)`` mesh as the JAX script does: ``--model_parallel
M`` makes a model axis of M ranks (``--fsdp true`` shards the parameters
over it), else the data axis is the largest divisor of ``--batch_size``
that fits the world, and the launch must give the mesh all its ranks.  Each
rank reads the same stream and trains on its rows of each global batch;
rank 0 writes the metrics, samples and checkpoints, whose format is the
same at every world size.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import logging
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.core.config import TrainConfig, model_configs
from syncfusion_tpu_torch.core.logging import MetricLogger, configure_logging
from syncfusion_tpu_torch.core.mesh import (
    Mesh,
    MeshSpec,
    create_mesh,
    init_distributed,
    launched,
    mesh_for_batch,
    rank_zero,
)
from syncfusion_tpu_torch.data.prefetch import device_prefetch, to_device
from syncfusion_tpu_torch.data.sfx_dataset import batched, collate, create_sfx_dataset
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.eval.panels import write_spec_panel
from syncfusion_tpu_torch.models.embedder import build_embedder
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops.mel import mel_spectrogram, power_to_db
from syncfusion_tpu_torch.ops.quantize import float32_to_int16
from syncfusion_tpu_torch.train.diffusion_trainer import (
    DiffusionTrainer,
    OptimizerConfig,
    TrainState,
)

log = logging.getLogger("syncfusion_tpu_torch.train_diffusion")

PRECISIONS = {"32": torch.float32, "bf16": torch.bfloat16}


def dataset(path, cfg: TrainConfig, seed: int, train: bool):
    """The items of ``exp/train_diffusion_gh.yaml``'s train or val dataset."""
    return create_sfx_dataset(
        path, sample_rate=cfg.sampling_rate, chunk_size=cfg.length,
        shardshuffle=train, shift_augment=train, cut_prefix=True,
        one_chunk_per_track=False, seed=seed)


def make_batches(path, cfg: TrainConfig, seed: int, embedder, train: bool = True):
    """Dataset stream -> model batches in their wire formats: uint8 onsets,
    f32 or (``wire_int16``) int16 wav, and the embedding of each item's
    conditioning chunk (a tensor on the embedder's device)."""
    stream = batched(dataset(path, cfg, seed, train), batch_size=cfg.batch_size,
                     drop_last=True, shuffle_size=cfg.shuffle_size, seed=seed)
    for b in stream:
        yield {
            "wav": float32_to_int16(b["wav"]) if cfg.wire_int16 else b["wav"],
            "onsets": b["onsets"].astype(np.uint8),
            "embedding": embedder.embed_audio(b["cond"]),
        }


def validate(trainer: DiffusionTrainer, state: TrainState, cfg: TrainConfig,
             val_path, embedder, device, mesh: Optional[Mesh] = None) -> float:
    """Mean loss over ``val_batches`` batches of the val dataset (no shift
    augmentation, no shard shuffle), each with sigma and noise from seed 0
    (the JAX script's key 0); over a ``mesh``, each rank takes its rows and
    each batch's loss is its global mean."""
    losses = []
    for vb in itertools.islice(make_batches(val_path, cfg, 0, embedder,
                                            train=False), cfg.val_batches):
        gen = torch.Generator(device=device).manual_seed(0)
        m = trainer.eval_step(state, to_device(vb, device, mesh), gen)
        losses.append(float(m["valid_loss"]))
    return float(np.mean(losses)) if losses else float("nan")


class SampleLogger:
    """Samples ``num_items`` clips of the validation set at each validation
    and writes each to ``media/`` with the panel of its mel spectrogram
    (the reference's SampleLogger: n_fft 1024, hop 512, 80 slaney-normed
    mels of the power, ``power_to_db`` over the batch)."""

    def __init__(self, cfg: TrainConfig, val_path, embedder, device):
        self.cfg, self.val_path = cfg, val_path
        self.embedder, self.device = embedder, device

    def __call__(self, model, metrics_logger: MetricLogger, step: int) -> None:
        """Samples and writes them; a failure is logged as a warning, as the
        reference's ``_log_samples`` does."""
        try:
            self._log(model, metrics_logger, step)
        except Exception as e:  # sampling must never end training
            log.warning("sample logging failed at step %d: %r", step, e)

    def _log(self, model, metrics_logger: MetricLogger, step: int) -> None:
        cfg = self.cfg
        items = list(itertools.islice(dataset(self.val_path, cfg, 0, False),
                                      cfg.num_items))
        if not items or not cfg.sampling_steps:
            return
        b = collate(items)
        emb = self.embedder.embed_audio(b["cond"])
        onsets = torch.from_numpy(b["onsets"]).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(step)
        noise = torch.randn((len(items), cfg.length, 1), generator=gen,
                            device=self.device)
        for steps in cfg.sampling_steps:
            wavs = model.sample(noise, onsets, emb, num_steps=steps,
                                embedding_scale=cfg.embedding_scale)[:, :, 0].float()
            mels = power_to_db(mel_spectrogram(
                wavs, sample_rate=cfg.sampling_rate, n_fft=1024, hop_length=512,
                n_mels=80, power=2.0, norm="slaney")).cpu().numpy()
            for i, w in enumerate(wavs.cpu().numpy()):
                metrics_logger.log_audio(f"sample_{i}", w, cfg.sampling_rate, step)
            for i, mel in enumerate(mels):
                write_spec_panel(metrics_logger.run_dir / "media",
                                 f"mel_spectrogram_{i}_{steps}steps", {"sample": mel}, step)


def _flag_type(default):
    if isinstance(default, bool):
        return lambda s: {"true": True, "false": False}[s.lower()]
    return type(default)


def add_config_args(ap: argparse.ArgumentParser) -> None:
    """The flags that build the model and the data stream, shared with
    ``distill_diffusion``: ``--model_config``, the embedder, ``--device``
    and one flag for each key of ``TrainConfig``."""
    ap.add_argument("--model_config", default=None,
                    help="JSON of the diffusion config's model node "
                         "(default: exp/model/diffusion.yaml's values)")
    ap.add_argument("--embedder", dest="amodel", default=TrainConfig.amodel,
                    help="'HTSAT-tiny' (CLAP) or 'none' for zero embeddings")
    ap.add_argument("--clap_ckpt", default=None,
                    help="laion_clap checkpoint (630k-audioset-best.pt), the "
                         "config's embedder_checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    for f in dataclasses.fields(TrainConfig):
        if f.name == "amodel":
            continue
        if isinstance(f.default, tuple):
            ap.add_argument(f"--{f.name}", type=int, nargs="+", default=f.default)
        elif f.name == "precision":
            ap.add_argument("--precision", choices=sorted(PRECISIONS),
                            default=f.default)
        else:
            ap.add_argument(f"--{f.name}", type=_flag_type(f.default),
                            default=f.default)


def config_of(args) -> TrainConfig:
    """The ``TrainConfig`` of parsed ``add_config_args`` flags."""
    return TrainConfig(**{f.name: (tuple(v) if isinstance(f.default, tuple) else v)
                          for f in dataclasses.fields(TrainConfig)
                          for v in [getattr(args, f.name)]})


def read_model_config(path: Optional[str]) -> Optional[dict]:
    """The ``--model_config`` JSON, or None."""
    if not path:
        return None
    with open(path) as f:
        return json.load(f)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train_path", required=True,
                    help="training shards: path, glob or shard_{1..3}.tar")
    ap.add_argument("--val_path", required=True, help="validation shards")
    ap.add_argument("--logs_dir", default="logs")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory to resume from (its latest)")
    ap.add_argument("--save", default=None, metavar="ATTR",
                    help="export the model's (dotted) subtree ATTR as a "
                         "checkpoint under <run>/export_<ATTR>, then stop: "
                         "model, onsets_encoder, model.down_1, ...")
    add_config_args(ap)
    args = ap.parse_args(argv)
    return args, config_of(args)


# the roots of --save, as the JAX script maps them onto its parameter tree
SAVE_ROOTS = {"model": "unet", "unet": "unet",
              "onsets_encoder": "onsets_encoder", "encoder": "onsets_encoder"}


def export_subtree(model_state: dict, attr: str) -> dict:
    """The entries of a model state dict under the dotted ``attr``
    (``train_diffusion_model.py``'s ``+save=``): its root one of
    ``SAVE_ROOTS``, then module names, as ``{key below attr: tensor}``, or
    the tensor ``attr`` names.  An unknown root or name raises
    ``ValueError`` naming what is there."""
    root, *parts = attr.split(".")
    if root not in SAVE_ROOTS:
        raise ValueError(f"--save {attr}: unknown root {root!r}; use one of "
                         f"{sorted(SAVE_ROOTS)}")
    prefix = SAVE_ROOTS[root]
    for seg in parts:
        below = {k[len(prefix) + 1:].split(".", 1)[0] for k in model_state
                 if k.startswith(prefix + ".")}
        if seg not in below:
            raise ValueError(f"--save {attr}: no subtree {seg!r} in {prefix!r}; "
                             f"available: {sorted(below)[:10]}")
        prefix = f"{prefix}.{seg}"
    if prefix in model_state:
        return model_state[prefix]
    return {k[len(prefix) + 1:]: v for k, v in model_state.items()
            if k.startswith(prefix + ".")}


def make_mesh(cfg: TrainConfig) -> Mesh:
    """The JAX script's mesh: ``model_parallel`` ranks on the model axis
    and the rest on data, else the data axis ``mesh_for_batch`` gives;
    every launched rank must be on it."""
    if cfg.model_parallel > 1:
        mesh = create_mesh(MeshSpec(data=-1, model=cfg.model_parallel))
    else:
        mesh = mesh_for_batch(cfg.batch_size)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh.size != world:
        raise ValueError(f"batch {cfg.batch_size} splits over at most {mesh.size} "
                         f"ranks; launch {mesh.size} processes, not {world}")
    return mesh


def main(argv=None) -> TrainState:
    """Train until ``max_steps`` micro-steps; returns the final state."""
    args, cfg = parse_args(argv)
    device = default_device(args.device)
    if launched():
        init_distributed(device)
    configure_logging()
    mesh = make_mesh(cfg)
    dtype = PRECISIONS[cfg.precision]
    if cfg.precision == "32":
        set_exact_f32()
    model_cfg = read_model_config(args.model_config)
    embedder = build_embedder(cfg.amodel,
                              model_configs(model_cfg)[0].embedding_features,
                              device, checkpoint_path=args.clap_ckpt)
    if not args.clap_ckpt:
        log.warning("no CLAP checkpoint: the embedder is zero or random-weight")
    model = SyncFusionDiffusion.from_config(model_cfg, dtype=dtype,
                                            device=device, seed=cfg.seed)
    trainer = DiffusionTrainer(
        model, OptimizerConfig(
            lr=cfg.lr, lr_beta1=cfg.lr_beta1, lr_beta2=cfg.lr_beta2,
            lr_eps=cfg.lr_eps, lr_weight_decay=cfg.lr_weight_decay,
            gradient_clip_val=cfg.gradient_clip_val,
            accumulate_grad_batches=cfg.accumulate_grad_batches),
        embedding_mask_proba=cfg.embedding_mask_proba, mesh=mesh, fsdp=cfg.fsdp)
    # the sample logger's model: under FSDP a whole copy on rank 0, loaded
    # from the gathered state at each validation
    sampling_model = model
    if trainer.fsdp and rank_zero():
        sampling_model = SyncFusionDiffusion.from_config(model_cfg, dtype=dtype,
                                                         device=device, seed=cfg.seed)
    state = trainer.create_state()
    if args.ckpt:
        state.load_state_dict(Checkpointer(CheckpointConfig(args.ckpt), mesh).restore())
        log.info("resumed from %s at step %d", args.ckpt, state.step)
    log.info("params: %.1fM on %s, %s compute, mesh (data %d, model %d)%s",
             model.param_count() / 1e6, device, cfg.precision, mesh.data,
             mesh.model, ", FSDP" if trainer.fsdp else "")

    runs = Path(args.logs_dir) / "runs"
    run_dir = [None]
    if rank_zero():
        runs.mkdir(parents=True, exist_ok=True)
        run_dir = [Path(tempfile.mkdtemp(prefix=time.strftime("%Y-%m-%d-%H-%M-%S-"),
                                         dir=runs))]
    if mesh.distributed:
        dist.broadcast_object_list(run_dir, src=0)
    run_dir = run_dir[0]
    log.info("run dir: %s", run_dir)
    if args.save:
        full = state.state_dict()  # collective: every rank calls it
        tag = args.save.replace(".", "_")
        sub = export_subtree(full["model"], args.save) if rank_zero() else {}
        Checkpointer(CheckpointConfig(run_dir / f"export_{tag}"), mesh).save(
            state.step, {tag: sub})
        log.info("exported %s to %s and stopping", args.save, run_dir / f"export_{tag}")
        return state
    ckpt = Checkpointer(CheckpointConfig(
        directory=run_dir / "ckpts", monitor=cfg.monitor, mode=cfg.mode,
        save_top_k=cfg.save_top_k, save_last=cfg.save_last), mesh)
    samples = SampleLogger(cfg, args.val_path, embedder, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    metrics_logger = MetricLogger(run_dir)
    try:
        t0 = time.perf_counter()
        for epoch in itertools.count():
            batches = make_batches(args.train_path, cfg, cfg.seed + epoch, embedder)
            seen = 0
            with contextlib.closing(device_prefetch(batches, device,
                                                    mesh=mesh)) as stream:
                for batch in stream:
                    seen += 1
                    metrics = trainer.train_step(state, batch, gen)
                    step = state.step
                    if step % cfg.log_every_n_steps == 0:
                        loss = float(metrics["train_loss"])  # syncs the device
                        dt = (time.perf_counter() - t0) / cfg.log_every_n_steps
                        metrics_logger.log({"train_loss": loss, "sec_per_step": dt},
                                           step=step)
                        t0 = time.perf_counter()
                    if step % cfg.val_check_interval == 0:
                        valid_loss = validate(trainer, state, cfg, args.val_path,
                                              embedder, device, mesh)
                        metrics_logger.log({"valid_loss": valid_loss}, step=step)
                        log.info("step %d valid_loss %.4f", step, valid_loss)
                        full = state.state_dict()
                        if rank_zero():
                            if sampling_model is not model:
                                sampling_model.load_state_dict(full["model"])
                            samples(sampling_model, metrics_logger, step)
                        ckpt.save(step, full, {"valid_loss": valid_loss})
                        t0 = time.perf_counter()
                    if step >= cfg.max_steps:
                        return state
            if not seen:
                raise ValueError(f"{args.train_path} yields no batch of "
                                 f"{cfg.batch_size} chunks of {cfg.length} samples")
            log.info("epoch %d done at step %d", epoch, state.step)
    finally:
        metrics_logger.close()


if __name__ == "__main__":
    main()
