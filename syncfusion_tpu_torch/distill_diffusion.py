"""Distil a trained diffusion model to a few-step sampler (the counterpart of
``script/distill_diffusion.py``).

    python -m syncfusion_tpu_torch.distill_diffusion \\
        --ckpt logs/runs/<run>/ckpts \\
        --train_path "data/.../train_shard_{1..3}.tar" \\
        [--distill.start_steps 64 --distill.final_steps 8 \\
         --distill.steps_per_round 400 --distill.lr 1e-4 \\
         --distill.cfg_scale 1.0] [--out DIR] \\
        [--model_config model.json] [--embedder none | --clap_ckpt X.pt] \\
        [--<key> <value> for any key of TrainConfig, e.g. --batch_size 2]

Progressive distillation (``train/distill.py``) halves the sampler's grid
round by round, 64 -> 32 -> 16 -> 8 by default.  The teacher is restored
from a ``train_diffusion`` checkpoint directory (its best step by
valid_loss, else its latest, as ``generate.restore_model`` reads it); the
batches stream from the shards as ``train_diffusion``'s do, with the same
flags, config route and embedder.  ``--distill.cfg_scale 2.0`` bakes the
evaluation's guidance scale into a one-forward student (guided
distillation).  The result, ``{"model": state dict, "num_steps": n}``, is
written to ``--out`` (default ``<ckpt>/../distilled_<n>step``), a directory
that ``generate.py --ckpt`` loads: sample it with ``--num_steps n``.  Runs
on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import logging
import time
from pathlib import Path

import torch

from syncfusion_tpu_torch import train_diffusion
from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer, restore_best
from syncfusion_tpu_torch.core.config import model_configs
from syncfusion_tpu_torch.core.logging import configure_logging
from syncfusion_tpu_torch.data.prefetch import to_device
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.models.embedder import build_embedder
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.train.distill import DistillConfig, ProgressiveDistiller

log = logging.getLogger("syncfusion_tpu_torch.distill_diffusion")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="train_diffusion checkpoint directory of the teacher")
    ap.add_argument("--train_path", required=True,
                    help="training shards: path, glob or shard_{1..3}.tar")
    ap.add_argument("--out", default=None,
                    help="output directory (default <ckpt>/../distilled_<n>step)")
    for f in dataclasses.fields(DistillConfig):
        ap.add_argument(f"--distill.{f.name}", type=type(f.default), default=f.default)
    train_diffusion.add_config_args(ap)
    args = ap.parse_args(argv)
    dcfg = DistillConfig(**{f.name: getattr(args, f"distill.{f.name}")
                            for f in dataclasses.fields(DistillConfig)})
    return args, train_diffusion.config_of(args), dcfg


def batches(train_path, cfg, embedder, device):
    """Endless model batches of the shards, epoch after epoch (each with its
    own seed, as the JAX script's stream), on ``device``: f32 wav and onsets
    and the embedding of each item's conditioning chunk."""
    for epoch in itertools.count():
        seen = 0
        for b in train_diffusion.make_batches(train_path, cfg, cfg.seed + epoch,
                                              embedder):
            seen += 1
            b = to_device(b, device)
            wav = b["wav"]
            yield {"wav": wav.float() / 32767.0 if wav.dtype == torch.int16 else wav,
                   "onsets": b["onsets"].float(), "embedding": b["embedding"]}
        if not seen:
            raise ValueError(f"{train_path} yields no batch of {cfg.batch_size} "
                             f"chunks of {cfg.length} samples")


def main(argv=None) -> dict:
    """Distil; returns ``{"model", "num_steps", "out", "log"}``: the
    distilled model, its step count, the directory written and the logged
    ``{"round_steps", "step", "distill_loss", "seconds"}`` records (one
    every ``--log_every_n_steps`` steps of a round and at its last)."""
    args, cfg, dcfg = parse_args(argv)
    device = default_device(args.device)
    configure_logging()
    dtype = train_diffusion.PRECISIONS[cfg.precision]
    if cfg.precision == "32":
        set_exact_f32()
    model_cfg = train_diffusion.read_model_config(args.model_config)
    embedder = build_embedder(cfg.amodel, model_configs(model_cfg)[0].embedding_features,
                              device, checkpoint_path=args.clap_ckpt)
    model = SyncFusionDiffusion.from_config(model_cfg, dtype=dtype, device=device,
                                            seed=cfg.seed)
    state = restore_best(args.ckpt, cfg.monitor, cfg.mode)
    model.load_state_dict(state["model"], strict=True)
    step = int(state.get("step", 0))
    log.info("teacher restored from %s at step %d", args.ckpt, step)
    del state

    stream = batches(args.train_path, cfg, embedder, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 7)
    records = []
    t0 = time.perf_counter()

    def log_fn(m):
        records.append({**m, "seconds": time.perf_counter() - t0})
        log.info("distill %d-step round: step %d loss %.5f [%.1fs]", m["round_steps"],
                 m["step"], m["distill_loss"], records[-1]["seconds"])

    distilled, n = ProgressiveDistiller(model, dcfg).distill(
        batch_fn=lambda _: next(stream), generator=gen, log_fn=log_fn,
        log_every=cfg.log_every_n_steps)
    stream.close()
    out = Path(args.out or Path(args.ckpt).parent / f"distilled_{n}step")
    Checkpointer(CheckpointConfig(out)).save(step, {"model": distilled.state_dict(),
                                                    "num_steps": n})
    log.info("wrote the %d-step distilled model to %s", n, out)
    return {"model": distilled, "num_steps": n, "out": out, "log": records}


if __name__ == "__main__":
    main()
