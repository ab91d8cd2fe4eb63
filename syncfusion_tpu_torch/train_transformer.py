"""The CondFoleyGen baseline's stage 2: the AV-conditional GPT's training
(the counterpart of ``script/train_transformer.py``).

    python -m syncfusion_tpu_torch.train_transformer \\
        -c cfg/condfoleygen/greatesthit_transformer.yaml [-c more.json] \\
        [--vq_ckpt CODEBOOK_RUN/ckpts] [--ckpt_path RUN/ckpts] [--device cpu]

The config is read as ``core.config.BaselineConfig`` (``-c`` files merged
in order): the GPT under ``transformer``, the VQ's geometry under
``model``, ``learning_rate``, ``weight_decay``, ``pkeep``, ``seed``,
``logs_dir`` (default ``logs/transformer``), the ``data`` splits,
``batch_size``, ``p_outside_cond`` and ``p_audio_aug`` (default 0.5),
``trainer.max_epochs`` (default 100), ``model_parallel`` and ``fsdp``.

The model's weights are seeded from ``seed`` (the GPT and the frozen video
net; the VQ too unless ``--vq_ckpt`` loads it from a ``train_codebook`` run:
its best step by ``val/rec_loss``, else its latest).  Each epoch takes
shuffled full batches of the train split (random shifts; with probability
``p_audio_aug`` a wav is RMS-normalised and pitch-shifted on the host,
``np.random.default_rng(epoch)``), makes their spectrograms on the device
and takes ``TransformerTrainer.train_step``, the token corruption drawn
from a generator seeded from the chain ``np.random.default_rng(seed)``; the
step's loss is logged every 50 steps.  Then ``val/loss`` over the val
split, and with ``log_media`` (default true) ``log_images`` on the last val
batch into ``media/``: ``val_step*.png`` (inputs, reconstructions and the
three samples), ``val_att_{half,nopix,det}_step*.png`` and
``val_samples_nopix_*_step*.wav`` (16 Griffin-Lim iterations); a media
failure is logged and training goes on.  A checkpoint (the best by
``val/loss`` and the latest) holds the GPT and its optimizer; ``--ckpt_path
DIR`` resumes from DIR's latest.

On several cards, one process each under torchrun, the mesh is the JAX
script's: ``trainer.model_parallel`` M > 1 gives a (world/M, M) mesh,
else the data axis is the largest divisor of ``batch_size`` that fits the
world; ``trainer.fsdp`` shards the GPT, its optimizer state and the frozen
stages over the model axis.  Runs on the card in f32 without TF32;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.core.config import BaselineConfig
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
from syncfusion_tpu_torch.data.baseline_dataset import (
    CondGreatestHitsWaveCondOnImage,
    baseline_loader,
)
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.generate_audio import build_model, load_runs
from syncfusion_tpu_torch.models.vqgan.model import wav_to_spec
from syncfusion_tpu_torch.ops.augment import random_audio_augment
from syncfusion_tpu_torch.train.transformer_trainer import TransformerTrainer
from syncfusion_tpu_torch.train_codebook import LOG_EVERY, batch_size, new_run_dir

log = logging.getLogger("syncfusion_tpu_torch.train_transformer")

MAX_EPOCHS = 100
SPEC_KEYS = ("inputs", "reconstructions", "samples_half", "samples_nopix", "samples_det")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--config", action="append", required=True)
    ap.add_argument("--vq_ckpt", default=None,
                    help="a train_codebook run's ckpts directory: the frozen VQ")
    ap.add_argument("--ckpt_path", default=None,
                    help="a train_transformer run's ckpts directory to resume from")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    return ap.parse_args(argv)


def make_mesh(cfg: BaselineConfig) -> Mesh:
    """The JAX script's choice: a model axis of ``model_parallel`` when it
    is above 1, else the data axis that fits the batch; one process
    without a process group."""
    if not dist.is_initialized():
        return Mesh.single()
    tp = cfg.trainer.model_parallel
    mesh = (create_mesh(MeshSpec(data=-1, model=tp)) if tp > 1
            else mesh_for_batch(batch_size(cfg)))
    if mesh.size != dist.get_world_size():
        raise ValueError(f"batch {batch_size(cfg)} splits over at most {mesh.size} "
                         f"ranks; launch {mesh.size} processes, not {dist.get_world_size()}")
    return mesh


def make_datasets(cfg: BaselineConfig) -> tuple:
    d = cfg.data

    def make(split, shift):
        return CondGreatestHitsWaveCondOnImage(
            d.root_dir, getattr(d, f"{split}_split_file_path"),
            data_to_use=getattr(d, f"{split}_data_to_use"),
            chunk_length_in_seconds=d.chunk_length_in_seconds, sample_rate=d.sample_rate,
            rand_shift=shift, p_outside_cond=d.p_outside_cond, frame_size=d.frame_size)

    return make("train", True), make("val", False)


def device_batch(batch: dict, device, rows: slice) -> dict:
    """A host batch's rows -> ``spec``, ``cond_spec`` (made on the device)
    and ``frames``."""
    def spec(key):
        return wav_to_spec(torch.from_numpy(batch[key][rows]).to(device))[:, None]

    return {"spec": spec("image"), "cond_spec": spec("cond_image"),
            "frames": torch.from_numpy(batch["feature"][rows]).to(device)}


def write_media(run_dir: Path, model, batch: dict, seed: int, step: int,
                cfg: BaselineConfig) -> None:
    """``log_images`` of ``batch`` into ``run_dir/media`` under the JAX
    script's names."""
    from syncfusion_tpu_torch.eval.panels import (
        write_attention_panel,
        write_media_wavs,
        write_spec_panel,
    )

    gen = torch.Generator(device=batch["spec"].device).manual_seed(seed)
    media = model.log_images(batch["spec"], batch["cond_spec"], batch["frames"], gen)
    out = run_dir / "media"
    write_spec_panel(out, "val", {k: media[k][0, 0].cpu().numpy() for k in SPEC_KEYS},
                     step=step)
    for k in ("att_half", "att_nopix", "att_det"):
        write_attention_panel(out, f"val_{k}", media[k].cpu().numpy(), step=step)
    write_media_wavs(out, "val", {"samples_nopix": (media["samples_nopix"][:, 0] + 1) / 2},
                     step=step, sample_rate=cfg.data.sample_rate)


def main(argv=None) -> dict:
    """Returns ``{"run_dir", "state"}``."""
    args = parse_args(argv)
    cfg = BaselineConfig.from_files(args.config)
    device = default_device(args.device)
    if launched():
        init_distributed(device)
    configure_logging()
    set_exact_f32()
    mesh = make_mesh(cfg)

    model = build_model(cfg, device, seed=cfg.seed)
    if args.vq_ckpt:
        load_runs(model, vq_ckpt=args.vq_ckpt)
        log.info("loaded the frozen VQ of %s", args.vq_ckpt)
    trainer = TransformerTrainer(model, learning_rate=cfg.learning_rate,
                                 weight_decay=cfg.weight_decay, mesh=mesh,
                                 fsdp=cfg.trainer.fsdp)
    state = trainer.create_state()
    if args.ckpt_path:
        state.load_state_dict(Checkpointer(CheckpointConfig(args.ckpt_path), mesh).restore())
        log.info("restored step %d of %s", state.step, args.ckpt_path)

    run_dir = [None]
    if rank_zero():
        run_dir = [new_run_dir(cfg.logs_dir or "logs/transformer")]
        (run_dir[0] / "config.json").write_text(json.dumps(cfg.to_dict(), indent=1))
    if mesh.distributed:
        dist.broadcast_object_list(run_dir, src=0)
    run_dir = run_dir[0]
    log.info("run dir: %s", run_dir)

    d, bs = cfg.data, batch_size(cfg)
    rows = mesh.rows(bs)
    train_ds, val_ds = make_datasets(cfg)
    if rank_zero():
        train_ds.print()
    metrics_logger = MetricLogger(run_dir)
    ckpt = Checkpointer(CheckpointConfig(run_dir / "ckpts", monitor="val/loss",
                                         save_top_k=1, save_last=True), mesh)
    seed_rng = np.random.default_rng(cfg.seed)
    try:
        for epoch in range(MAX_EPOCHS if cfg.trainer.max_epochs is None
                           else cfg.trainer.max_epochs):
            aug_rng = np.random.default_rng(epoch)
            for batch in baseline_loader(train_ds, bs, shuffle=True, drop_last=True,
                                         seed=epoch):
                gen = torch.Generator(device=device).manual_seed(
                    int(seed_rng.integers(2**32)))
                if d.p_audio_aug > 0:  # every row of the global batch, in order
                    batch["image"] = np.stack([
                        random_audio_augment(w, d.sample_rate, aug_rng, p=d.p_audio_aug)
                        for w in batch["image"]])
                metrics = trainer.train_step(state, device_batch(batch, device, rows), gen)
                if state.step % LOG_EVERY == 0:
                    metrics_logger.log({k: float(v) for k, v in metrics.items()},
                                       step=state.step)
            vals, last = [], None
            for last in baseline_loader(val_ds, bs, drop_last=True):
                vals.append(float(trainer.eval_step(
                    state, device_batch(last, device, rows))["val/loss"]))
            if not vals:
                continue
            v = float(np.mean(vals))
            metrics_logger.log({"val/loss": v}, step=state.step)
            log.info("epoch %d val/loss %.4f", epoch, v)
            if cfg.log_media:
                media_seed = int(seed_rng.integers(2**32))
                media_model = trainer.model
                if trainer.fsdp:  # log_images needs whole parameters
                    sd = trainer.full_state_dict()
                    media_model = build_model(cfg, device, seed=None) if rank_zero() else None
                    if media_model is not None:
                        media_model.load_state_dict(sd, strict=True)
                if rank_zero():
                    try:
                        write_media(run_dir, media_model,
                                    device_batch(last, device, slice(None)), media_seed,
                                    state.step, cfg)
                    except Exception as e:  # media never stops training
                        log.warning("media logging failed: %s", e, exc_info=True)
            ckpt.save(state.step, state.state_dict(), {"val/loss": v})
    finally:
        metrics_logger.close()
    return {"run_dir": run_dir, "state": state}


if __name__ == "__main__":
    main()
