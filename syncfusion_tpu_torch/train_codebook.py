"""SpecVQGAN codebook training, the CondFoleyGen baseline's stage 1 (the
counterpart of ``script/train_codebook.py``).

    python -m syncfusion_tpu_torch.train_codebook \\
        -c cfg/condfoleygen/greatesthit_codebook.yaml [-c more.json] \\
        [--ckpt_path RUN/ckpts] [--device cpu]

``-c`` files merge in order, a later key over an earlier one (JSON, or YAML
where PyYAML is installed), and are read as ``core.config.BaselineConfig``:
the VQGAN's geometry under ``model`` (its ``ddconfig``), ``model.
learning_rate`` and ``model.lossconfig``, the ``data`` splits and
``batch_size``, ``trainer.max_epochs`` (default 1000), ``seed`` and
``logs_dir`` (default ``logs/specvqgan``).

Each epoch takes shuffled full batches of the train split (the 2-s wavs
of ``GreatestHitsWaveDataset``, random shifts per ``data.rand_shift``),
their spectrograms made on the device (``wav_to_spec``), through
``VQGANTrainer.train_step``, logging the step's metrics every 50 steps;
then validates on the val split (``val/rec_loss``, ``val/codebook_usage``),
writes the last val batch's reconstruction panel and, with ``log_media``
(default true), its inputs and reconstructions vocoded by 16 Griffin-Lim
iterations (``media/val_{inputs,reconstructions}_*.wav``), and saves a
checkpoint (the best by ``val/rec_loss`` and the latest).  A media failure
is logged and training goes on.  ``--ckpt_path DIR`` resumes from DIR's
latest checkpoint (its step counts on; epochs start again at 0, as in the
JAX script).  Runs on the card in f32 without TF32; ``--device cpu`` runs
on the CPU.  Metrics go to ``<logs_dir>/<run>/metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
from syncfusion_tpu_torch.core.config import BaselineConfig
from syncfusion_tpu_torch.core.logging import MetricLogger, configure_logging
from syncfusion_tpu_torch.data.baseline_dataset import GreatestHitsWaveDataset, baseline_loader
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.models.vqgan.model import VQModel, wav_to_spec
from syncfusion_tpu_torch.train.vqgan_trainer import VQGANTrainer

log = logging.getLogger("syncfusion_tpu_torch.train_codebook")

LOG_EVERY = 50
MAX_EPOCHS = 1000


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--config", action="append", required=True)
    ap.add_argument("--ckpt_path", default=None,
                    help="a codebook run's ckpts directory to resume from")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    return ap.parse_args(argv)


def batch_size(cfg: BaselineConfig) -> int:
    if cfg.data.batch_size is None:
        raise ValueError("the config sets no data.batch_size")
    return cfg.data.batch_size


def new_run_dir(logs_dir) -> Path:
    """A new run directory under ``logs_dir``, named by the time."""
    logs = Path(logs_dir)
    logs.mkdir(parents=True, exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=time.strftime("%Y-%m-%d-%H-%M-%S-"), dir=logs))


def to_spec(batch: dict, key: str, device) -> torch.Tensor:
    """A batch's wavs -> spectrograms (B, 1, 80, 160) on ``device``."""
    return wav_to_spec(torch.from_numpy(batch[key]).to(device))[:, None]


def write_media(run_dir: Path, model: VQModel, spec: torch.Tensor, step: int,
                cfg: BaselineConfig) -> None:
    """The reconstruction panel of the batch's first item and, with
    ``log_media``, its vocoded inputs and reconstructions."""
    from syncfusion_tpu_torch.eval.panels import write_media_wavs, write_spec_panel

    with torch.no_grad():
        xrec = model.reconstruct(spec)
    write_spec_panel(run_dir / "media", "reconstructions",
                     {"inputs": spec[0, 0].cpu().numpy(),
                      "reconstructions": xrec[0, 0].cpu().numpy()}, step=step)
    if cfg.log_media:
        write_media_wavs(run_dir / "media", "val",
                         {"inputs": (spec[:, 0] + 1) / 2,
                          "reconstructions": (xrec[:, 0].clamp(-1, 1) + 1) / 2},
                         step=step, sample_rate=cfg.data.sample_rate)


def main(argv=None) -> dict:
    """Returns ``{"run_dir", "state"}``."""
    args = parse_args(argv)
    cfg = BaselineConfig.from_files(args.config)
    device = default_device(args.device)
    set_exact_f32()
    configure_logging()

    model = VQModel(**dataclasses.asdict(cfg.model)).to(device)
    trainer = VQGANTrainer(model, cfg.lossconfig, learning_rate=cfg.vq_learning_rate)
    trainer.disc.to(device)
    state = trainer.init(cfg.seed)
    run_dir = new_run_dir(cfg.logs_dir or "logs/specvqgan")
    (run_dir / "config.json").write_text(json.dumps(cfg.to_dict(), indent=1))
    log.info("run dir: %s", run_dir)
    if args.ckpt_path:
        state.load_state_dict(Checkpointer(CheckpointConfig(args.ckpt_path)).restore())
        log.info("restored step %d of %s", state.step, args.ckpt_path)

    d, bs = cfg.data, batch_size(cfg)
    train_ds = GreatestHitsWaveDataset(
        d.root_dir, d.train_split_file_path, data_to_use=d.train_data_to_use,
        chunk_length_in_seconds=d.chunk_length_in_seconds, sample_rate=d.sample_rate,
        rand_shift=d.rand_shift)
    val_ds = GreatestHitsWaveDataset(
        d.root_dir, d.val_split_file_path, data_to_use=d.val_data_to_use,
        chunk_length_in_seconds=d.chunk_length_in_seconds, sample_rate=d.sample_rate,
        rand_shift=False)
    train_ds.print()
    metrics_logger = MetricLogger(run_dir)
    ckpt = Checkpointer(CheckpointConfig(run_dir / "ckpts", monitor="val/rec_loss",
                                         save_top_k=1, save_last=True))
    try:
        for epoch in range(MAX_EPOCHS if cfg.trainer.max_epochs is None
                           else cfg.trainer.max_epochs):
            for batch in baseline_loader(train_ds, bs, shuffle=True, drop_last=True,
                                         seed=epoch):
                metrics = trainer.train_step(state, to_spec(batch, "image", device))
                if state.step % LOG_EVERY == 0:
                    metrics_logger.log({k: float(v) for k, v in metrics.items()},
                                       step=state.step)
            vals, spec = [], None
            for batch in baseline_loader(val_ds, bs, drop_last=True):
                spec = to_spec(batch, "image", device)
                vals.append(trainer.eval_step(state, spec))
            if not vals:
                continue
            rec = float(np.mean([float(v["val/rec_loss"]) for v in vals]))
            usage = float(np.mean([float(v["val/codebook_usage"]) for v in vals]))
            metrics_logger.log({"val/rec_loss": rec, "val/codebook_usage": usage},
                               step=state.step)
            log.info("epoch %d val/rec_loss %.4f", epoch, rec)
            try:
                write_media(run_dir, state.model, spec, state.step, cfg)
            except Exception as e:  # media never stops training
                log.warning("media logging failed: %s", e, exc_info=True)
            ckpt.save(state.step, state.state_dict(), {"val/rec_loss": rec})
    finally:
        metrics_logger.close()
    return {"run_dir": run_dir, "state": state}


if __name__ == "__main__":
    main()
