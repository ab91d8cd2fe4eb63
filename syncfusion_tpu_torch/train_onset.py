"""Onset model training and evaluation (the counterpart of
``script/train_onset_model.py``).

    python -m syncfusion_tpu_torch.train_onset fit -c data.json -c model.json \\
        -c trainer.json [--ckpt_path DIR] [--device cpu]
    python -m syncfusion_tpu_torch.train_onset test -c CONFIG --ckpt_path DIR

``-c`` files merge in order, a later key over an earlier one; their nodes
are ``data``, ``model`` and ``trainer`` with the keys of
``cfg/data/data-onset-greatesthit.yaml``, ``cfg/model/model-onset.yaml`` and
``cfg/trainer/trainer-onset.yaml`` (``core.config.OnsetConfig`` holds their
values as defaults).  JSON is read everywhere, YAML where PyYAML is
installed.  ``model.precision`` is ``bf16`` (bf16 convolutions over f32
parameters, the default) or ``32`` (f32 without TF32).

``fit`` trains ``max_epochs`` epochs of shuffled full batches; every
``check_val_every_n_epoch`` epochs it evaluates the val split and saves a
checkpoint (the best by ``loss/val`` and the latest).  ``test`` and
``validate`` evaluate one split; ``test`` also writes the per-video onset
annotation CSVs and the label plots to ``media/``.  ``--ckpt_path DIR``
restores the latest checkpoint of DIR.  Metrics go to
``<logs_dir>/<run>/metrics.jsonl``.  Runs on the card; ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import tempfile
import time
from pathlib import Path
from typing import Iterable, Mapping, Optional

import numpy as np
import torch

from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.core.config import OnsetConfig
from syncfusion_tpu_torch.core.logging import MetricLogger
from syncfusion_tpu_torch.data.onset_dataset import GreatestHitsDataset, loader
from syncfusion_tpu_torch.data.prefetch import device_prefetch
from syncfusion_tpu_torch.data.transforms import FrameTransform
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.eval.onset_annotations import (
    concat_annotations,
    write_chunk_annotations,
)
from syncfusion_tpu_torch.models.onset_net import VideoOnsetNet, convert_torch_r2plus1d
from syncfusion_tpu_torch.train.diffusion_trainer import OptimizerConfig, TrainState
from syncfusion_tpu_torch.train.onset_trainer import OnsetTrainer, bc_loss, onset_metrics

log = logging.getLogger("syncfusion_tpu_torch.train_onset")

PRECISIONS = {"32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("subcommand", choices=["fit", "test", "validate"])
    ap.add_argument("-c", "--config", action="append", default=[])
    ap.add_argument("--ckpt_path", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    return ap.parse_args(argv)


def make_transform(cfg: OnsetConfig, augment: bool) -> FrameTransform:
    """The frame transform of the dataset (the trainer reads the jitter
    strengths from the same instance).  ``data.wire``: "uint8" ships uint8
    RGB, "yuv420" packed 4:2:0 (half that), "float" frames normalised on
    the host; the trainer decodes and normalises on the device.  With
    ``device_jitter`` the ColorJitter runs in the train step on the
    device; RandomCrop stays on the host."""
    d = cfg.data
    if d.wire not in ("uint8", "yuv420", "float"):
        raise ValueError(f"data.wire {d.wire!r}")
    return FrameTransform(
        augment=augment, size=d.frame_size, resize_to=round(d.frame_size * 128 / 112),
        wire_uint8=d.wire != "float", wire_yuv420=d.wire == "yuv420",
        device_jitter=d.device_jitter)


def make_dataset(cfg: OnsetConfig, split: str,
                 augment_override: Optional[bool] = None) -> GreatestHitsDataset:
    d = cfg.data
    augment = d.augment if augment_override is None else augment_override
    return GreatestHitsDataset(
        root_dir=d.root_dir,
        split_file_path=getattr(d, f"{split}_split_file_path"),
        chunk_length_in_seconds=d.chunk_length_in_seconds,
        frames_transforms=make_transform(cfg, augment),
        data_to_use=getattr(d, f"{split}_data_to_use"),
        cache_decoded=d.cache_decoded,
        cache_max_bytes=int(d.cache_decoded_mb) << 20,
    )


def build_trainer(cfg: OnsetConfig, device, jitter: Optional[tuple] = None) -> OnsetTrainer:
    """The onset net of ``cfg.model`` on ``device`` with parameters from
    ``cfg.trainer.seed`` (or the Kinetics backbone of ``pretrained_path``),
    under its trainer.  ``precision: 32`` turns TF32 off for matmuls and
    cuDNN (the JAX package computes exact f32)."""
    m = cfg.model
    if m.precision not in PRECISIONS:
        raise ValueError(f"model.precision {m.precision!r}: one of {sorted(PRECISIONS)}")
    if m.precision == "32":
        set_exact_f32()
    with torch.device(device):
        net = VideoOnsetNet(m.layers, dtype=PRECISIONS[m.precision])
    net.init(cfg.trainer.seed)
    if m.pretrained and m.pretrained_path:
        saved = torch.load(m.pretrained_path, map_location="cpu", weights_only=True)
        missing, unexpected = net.load_state_dict(
            convert_torch_r2plus1d(saved.get("state_dict", saved)), strict=False)
        if unexpected or any(not k.startswith(("fc1.", "fc2.")) for k in missing):
            raise ValueError(f"{m.pretrained_path}: missing {missing}, unexpected "
                             f"{unexpected}")
        log.info("loaded the Kinetics backbone of %s", m.pretrained_path)
    return OnsetTrainer(net, OptimizerConfig(
        lr=m.lr, lr_beta1=m.lr_beta1, lr_beta2=m.lr_beta2, lr_eps=m.lr_eps,
        lr_weight_decay=m.lr_weight_decay, gradient_clip_val=1e9,
        accumulate_grad_batches=1), jitter=jitter)


def evaluate(trainer: OnsetTrainer, state: TrainState, dataset, cfg: OnsetConfig,
             device, annotations_dir=None, label_plots_dir=None,
             label_plot_batches: int = 4) -> dict:
    """Means over the batches of ``dataset`` of the loss, AP, Acc and
    OnsNumAcc (``nan`` AP of a batch without positives skipped), eval-mode
    forward; the final batch may be short.  Writes the annotation CSVs and
    the first ``label_plot_batches`` batches' label plots where asked."""
    losses, all_metrics = [], []
    for batch_idx, batch in enumerate(loader(dataset, cfg.data.batch_size,
                                             num_workers=cfg.data.num_workers)):
        frames = torch.from_numpy(batch["frames"]).to(device)
        logits = trainer.forward(state, frames).float().cpu().numpy()
        losses.append(float(bc_loss(torch.from_numpy(logits),
                                    torch.from_numpy(batch["label"]))))
        all_metrics.append(onset_metrics(logits, batch["label"]))
        if annotations_dir is not None:
            write_chunk_annotations(annotations_dir, batch, logits)
        if label_plots_dir is not None and batch_idx < label_plot_batches:
            from syncfusion_tpu_torch.eval.panels import write_label_plot

            probs = 1.0 / (1.0 + np.exp(-logits))
            for i in range(len(probs)):
                write_label_plot(label_plots_dir,
                                 f"labels_b{batch_idx}-{i}_{batch['video_name'][i]}",
                                 batch["label"][i], probs[i])
    agg = {k: float(np.nanmean([m[k] for m in all_metrics])) for k in all_metrics[0]}
    agg["loss"] = float(np.mean(losses))
    return agg


def fit_epoch(trainer: OnsetTrainer, state: TrainState, batches: Iterable[Mapping],
              device, metrics_logger: MetricLogger, log_every_n_steps: int,
              generator: Optional[torch.Generator] = None) -> int:
    """One epoch over ``batches`` (host batches with ``frames`` in a wire
    format and ``label``), copied to ``device`` by ``device_prefetch`` and
    taken by ``trainer.train_step``.  Every ``log_every_n_steps``-th step
    logs that step's loss, AP, Acc and OnsNumAcc and ``sec_per_step``, the
    host time per step since the last log, each ended by reading the loss
    (which syncs the card).  Returns the steps taken."""
    steps, since, t0 = 0, 0, time.perf_counter()
    metrics = None
    host = ({"frames": b["frames"], "label": b["label"]} for b in batches)
    with contextlib.closing(device_prefetch(host, torch.device(device))) as stream:
        for batch in stream:
            metrics, logits = trainer.train_step(state, batch, generator)
            steps += 1
            since += 1
            if state.step % log_every_n_steps == 0:
                loss = float(metrics["loss/train"])
                record = onset_metrics(logits.float().cpu().numpy(),
                                       batch["label"].cpu().numpy())
                record["loss/train"] = loss
                record["sec_per_step"] = (time.perf_counter() - t0) / since
                metrics_logger.log(record, step=state.step)
                since, t0 = 0, time.perf_counter()
    if metrics is not None:
        float(metrics["loss/train"])  # the epoch ends when the card does
    return steps


def main(argv=None) -> TrainState:
    """Returns the state after ``fit`` (or the evaluated one)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = OnsetConfig.from_files(args.config)
    device = default_device(args.device)
    logs = Path(cfg.trainer.logs_dir)
    logs.mkdir(parents=True, exist_ok=True)
    run_dir = Path(tempfile.mkdtemp(prefix=time.strftime("%Y-%m-%d-%H-%M-%S-"), dir=logs))
    (run_dir / "config.json").write_text(json.dumps(cfg.to_dict(), indent=1))
    log.info("run dir: %s", run_dir)

    train_tf = make_transform(cfg, augment=cfg.data.augment)
    jitter = (train_tf.jitter_params if train_tf.augment and train_tf.device_jitter
              and args.subcommand == "fit" else None)
    trainer = build_trainer(cfg, device, jitter)
    state = trainer.create_state()
    if args.ckpt_path:
        state.load_state_dict(Checkpointer(CheckpointConfig(args.ckpt_path)).restore())
        log.info("restored step %d of %s", state.step, args.ckpt_path)
    log.info("params: %.1fM on %s, precision %s", trainer.model.param_count() / 1e6,
             device, cfg.model.precision)

    metrics_logger = MetricLogger(run_dir)
    try:
        if args.subcommand in ("test", "validate"):
            split = "test" if args.subcommand == "test" else "val"
            dataset = make_dataset(cfg, split, augment_override=False)
            ann_dir = run_dir / "media/annotations" if split == "test" else None
            plots_dir = run_dir / "media/labels" if split == "test" else None
            agg = evaluate(trainer, state, dataset, cfg, device,
                           annotations_dir=ann_dir, label_plots_dir=plots_dir)
            if ann_dir is not None:
                concat_annotations(ann_dir)
            metrics_logger.log({f"{k}/{split}": v for k, v in agg.items()})
            print({f"{k}/{split}": round(v, 4) for k, v in agg.items()})
            return state

        train_ds = make_dataset(cfg, "train")
        val_ds = make_dataset(cfg, "val", augment_override=False)
        train_ds.print()
        ckpt = Checkpointer(CheckpointConfig(run_dir / "ckpts", monitor="loss/val",
                                             save_top_k=1, save_last=True))
        gen = torch.Generator(device=device).manual_seed(cfg.trainer.seed + 1)
        for epoch in range(cfg.trainer.max_epochs):
            t0 = time.perf_counter()
            batches = loader(train_ds, cfg.data.batch_size, shuffle=True, drop_last=True,
                             num_workers=cfg.data.num_workers, seed=epoch)
            steps = fit_epoch(trainer, state, batches, device, metrics_logger,
                              cfg.trainer.log_every_n_steps, gen)
            if steps:
                dt = time.perf_counter() - t0
                log.info("epoch %d: %d steps in %.1f s (%.3f s/step)", epoch, steps,
                         dt, dt / steps)
            if (epoch + 1) % cfg.trainer.check_val_every_n_epoch == 0:
                agg = evaluate(trainer, state, val_ds, cfg, device)
                metrics_logger.log({f"{k}/val": v for k, v in agg.items()},
                                   step=state.step)
                ckpt.save(state.step, state.state_dict(), {"loss/val": agg["loss"]})
                log.info("epoch %d val %s", epoch, agg)
        return state
    finally:
        metrics_logger.close()


if __name__ == "__main__":
    main()
