"""Diffusion evaluation entry point (the counterpart of
``script/evaluate_diffusion.py``): generate the test set, or dump its
ground-truth chunks, then score FAD.

    python -m syncfusion_tpu_torch.evaluate_diffusion --exp prepare_gh_gt \\
        --dataset_path test_shard_1.tar --experiment_path out/gh-gt
    python -m syncfusion_tpu_torch.evaluate_diffusion --exp evaluate_gh_gen \\
        --dataset_path test_shard_1.tar --experiment_path out/gh-gen \\
        --gt_dir out/gh-gt [--ckpt RUN/ckpts | --ckpt X.ckpt | --params_npz params.npz] \\
        [--model_config model.json] [--vggish_ckpt vggish.pth] [--device cpu]

``--exp`` names one of the six experiment files of ``exp/`` (``PRESETS``,
their values as plain dicts: the card's machine has no PyYAML).  The
``evaluate_*`` presets run ``eval.generation.generate_dataset`` (B = 10,
150-step DDIM, CFG 2.0 at every step, the clip's first 96000 samples, the
prefix before its first onset zeroed, 22.05 kHz out), then
``eval.fad.evaluate_fad`` against ``--gt_dir``, and write ``metrics.csv``
into the experiment path; the ``prepare_*`` presets run
``prepare_gt_for_fad``.  Flags override the values a run needs;
``--cut_length`` also sets a ``prepare_*`` preset's chunk length (its
YAML's ``length``).  The model computes in f32 without TF32 (``--precision
32``, the reference's evaluation numerics) or in bf16.  Parameters come
from ``--ckpt`` (a ``train_diffusion`` checkpoint directory: its best step,
else its latest; or a ``.ckpt``/``.pt``/``.pth`` file: a reference Lightning
checkpoint such as the published ``epoch=784-valid_loss=0.008.ckpt``, which
loads into the a-unet compat twins through ``models/adp_convert.py``, as
the JAX script does) or ``--params_npz`` (the JAX parameter tree as an
``.npz``), else they are seeded random.  The conditioning embedder is the
model config's (``embedder.amodel``, CLAP HTSAT-tiny by default, with its
``embedder_checkpoint``).  Runs on the card; ``--device cpu`` runs on the
CPU.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
from pathlib import Path

import numpy as np
import torch

from syncfusion_tpu_torch.convert import to_state_dict, unflatten
from syncfusion_tpu_torch.data.sfx_dataset import create_sfx_dataset
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.eval.fad import evaluate_fad
from syncfusion_tpu_torch.eval.generation import generate_dataset, prepare_gt_for_fad
from syncfusion_tpu_torch.generate import restore_model
from syncfusion_tpu_torch.models.adp_convert import load_diffusion_state
from syncfusion_tpu_torch.models.embedder import embedder_from_config
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion

log = logging.getLogger("syncfusion_tpu_torch.evaluate_diffusion")

PRECISIONS = {"32": torch.float32, "bf16": torch.bfloat16}
TORCH_CKPT_SUFFIXES = (".ckpt", ".pt", ".pth")


def _gen_preset(batch_size: int, cut_prefix: bool, cond_text: bool, gt_dir: str) -> dict:
    """An ``exp/evaluate_gh_gen*.yaml``: its top-level keys, its
    ``experiment`` node (``generate_dataset``'s arguments), the node's
    ``dataset`` (``create_sfx_dataset``'s) and ``evaluation``
    (``evaluate_fad``'s), with the interpolations resolved at ``work_dir``
    '.'."""
    return {
        "dataset_path": None, "experiment_path": None, "gen_length": 262144,
        "cut_length": 96000, "sample_rate": 48000, "one_chunk_per_track": True,
        "model_path": None,
        "experiment": {"run": "generate_dataset", "batch_size": batch_size,
                       "num_steps": 150, "embedding_scale": 2.0, "sample_rate": 48000,
                       "one_chunk_per_track": True, "length": 262144,
                       "cut_length": 96000, "cut_prefix": cut_prefix,
                       "downsample_rate": 22050, "cond_text": cond_text},
        "dataset": {"sample_rate": 48000, "chunk_size": 262144, "shift_augment": False,
                    "cut_prefix": False, "one_chunk_per_track": True,
                    "onset_check_length": 96000, "shardshuffle": False},
        "evaluation": {"run": "evaluate_fad", "gt_dir": gt_dir,
                       "vggish_checkpoint": None},
    }


def _gt_preset(name: str, cut_prefix: bool) -> dict:
    """An ``exp/prepare_gh_gt*.yaml`` (``prepare_gt_for_fad``), as
    ``_gen_preset``."""
    shard = {"gh-gt": "test_shard_1.tar", "gh-gt-pred": "test_onset_preds.tar"}[name]
    return {
        "dataset_path": f"./data/greatest_hit/{shard}",
        "experiment_path": f"./output/experiments/{name}", "sample_rate": 48000,
        "length": 96000, "one_chunk_per_track": True,
        "experiment": {"run": "prepare_gt_for_fad", "batch_size": 64,
                       "sample_rate": 48000, "one_chunk_per_track": True,
                       "downsample_rate": 22050},
        "dataset": {"sample_rate": 48000, "chunk_size": 96000, "shift_augment": False,
                    "cut_prefix": cut_prefix, "onset_check_length": 96000,
                    "one_chunk_per_track": True, "shardshuffle": False},
        "evaluation": None,
    }


PRESETS = {
    "evaluate_gh_gen": _gen_preset(10, True, False, "./output/experiments/gh-gt"),
    "evaluate_gh_gen_text": _gen_preset(8, True, True, "./output/experiments/gh-gt"),
    "evaluate_gh_gen_pred": _gen_preset(10, False, False, "./output/experiments/gh-gt-pred"),
    "evaluate_gh_gen_pred_augment": _gen_preset(10, False, False,
                                                "./output/experiments/gh-gt-pred"),
    "prepare_gh_gt": _gt_preset("gh-gt", True),
    "prepare_gh_gt_pred": _gt_preset("gh-gt-pred", False),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--exp", required=True, choices=sorted(PRESETS))
    ap.add_argument("--dataset_path", default=None, help="test shard(s)")
    ap.add_argument("--experiment_path", default=None, help="output directory")
    ap.add_argument("--gt_dir", default=None, help="FAD reference directory")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--num_steps", type=int, default=None)
    ap.add_argument("--gen_length", type=int, default=None,
                    help="generated samples a clip (the chunk length)")
    ap.add_argument("--cut_length", type=int, default=None,
                    help="samples kept of each clip, and of the onset check")
    ap.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim")
    ap.add_argument("--deep_cache_interval", type=int, default=0,
                    help="DeepCache: rerun the deep levels every K steps (0: off)")
    ap.add_argument("--deep_split", type=int, default=4,
                    help="DeepCache: the UNet level where the deep half starts")
    ap.add_argument("--guidance_interval", type=float, nargs=2, default=None,
                    metavar=("LO", "HI"), help="CFG only for LO <= sigma <= HI "
                    "(default: every step, as the presets)")
    ap.add_argument("--vggish_ckpt", default=None,
                    help="torchvggish state dict; FAD uses mel statistics without")
    params = ap.add_mutually_exclusive_group()
    params.add_argument("--ckpt", default=None,
                        help="train_diffusion checkpoint directory, or a reference "
                             "Lightning .ckpt/.pt/.pth (the a-unet compat model)")
    params.add_argument("--params_npz", default=None,
                        help="JAX parameter tree as .npz with '/'-joined keys")
    ap.add_argument("--model_config", default=None,
                    help="JSON of the diffusion config's model node "
                         "(default: exp/model/diffusion.yaml's values)")
    ap.add_argument("--precision", choices=sorted(PRECISIONS), default="32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    return ap.parse_args(argv)


def resolve(args) -> dict:
    """The preset ``--exp`` with the flags' overrides applied."""
    cfg = json.loads(json.dumps(PRESETS[args.exp]))  # a deep copy
    exp, ds = cfg["experiment"], cfg["dataset"]
    for key in ("dataset_path", "experiment_path"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
        if cfg[key] is None:
            raise SystemExit(f"--exp {args.exp} needs --{key}")
    if args.batch_size is not None:
        exp["batch_size"] = args.batch_size
    if exp["run"] == "generate_dataset":
        if args.gen_length is not None:
            exp["length"] = ds["chunk_size"] = args.gen_length
        if args.cut_length is not None:
            exp["cut_length"] = ds["onset_check_length"] = args.cut_length
        if args.num_steps is not None:
            exp["num_steps"] = args.num_steps
        exp.update(sampler=args.sampler, deep_cache_interval=args.deep_cache_interval,
                   deep_split=args.deep_split, guidance_interval=args.guidance_interval)
        if args.gt_dir is not None:
            cfg["evaluation"]["gt_dir"] = args.gt_dir
        if args.vggish_ckpt is not None:
            cfg["evaluation"]["vggish_checkpoint"] = args.vggish_ckpt
    elif args.cut_length is not None:
        ds["chunk_size"] = ds["onset_check_length"] = args.cut_length
    return cfg


def load_model(args, model_cfg, device) -> SyncFusionDiffusion:
    """The diffusion model at ``--precision`` on ``device``, with the
    parameters of ``--ckpt`` or ``--params_npz``, else seeded random.  A
    ``--ckpt`` with a torch suffix builds the a-unet compat twins at the
    model config's widths and loads the reference checkpoint into them."""
    torch_ckpt = bool(args.ckpt) and Path(args.ckpt).suffix in TORCH_CKPT_SUFFIXES
    model = SyncFusionDiffusion.from_config(model_cfg, dtype=PRECISIONS[args.precision],
                                            device=device, compat=True if torch_ckpt else None)
    if torch_ckpt:
        log.info("converting the reference checkpoint %s (compat model)", args.ckpt)
        load_diffusion_state(model, args.ckpt)
    elif args.ckpt:
        model.load_state_dict(restore_model(args.ckpt), strict=True)
    elif args.params_npz:
        with np.load(args.params_npz) as npz:
            model.load_state_dict(to_state_dict(unflatten(dict(npz))), strict=True)
    else:
        log.warning("no --ckpt or --params_npz: using a randomly initialized model")
    return model


def print_table(row: dict) -> None:
    """One row under its header, columns right-aligned (pandas'
    ``to_string(index=False)``)."""
    cells = [(k, f"{v:.6f}" if isinstance(v, float) else str(v)) for k, v in row.items()]
    widths = [max(len(k), len(v)) for k, v in cells]
    print(" ".join(k.rjust(w) for (k, _), w in zip(cells, widths)))
    print(" ".join(v.rjust(w) for (_, v), w in zip(cells, widths)))


def main(argv=None) -> dict:
    """Runs the experiment; returns ``{"metrics": FAD metrics or None,
    "generation": generate_dataset's statistics or None}``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = resolve(args)
    exp = dict(cfg["experiment"])
    run = exp.pop("run")
    dataset = create_sfx_dataset(cfg["dataset_path"], **cfg["dataset"])
    out = {"metrics": None, "generation": None}
    if run == "prepare_gt_for_fad":
        prepare_gt_for_fad(cfg["experiment_path"], dataset, **exp)
        return out

    device = default_device(args.device)
    if args.precision == "32":
        set_exact_f32()
    model_cfg = None
    if args.model_config:
        with open(args.model_config) as f:
            model_cfg = json.load(f)
    embedder = embedder_from_config(model_cfg, device)
    model = load_model(args, model_cfg, device)
    out["generation"] = generate_dataset(
        cfg["experiment_path"], model, dataset, embed_audio=embedder.embed_audio,
        embed_text=embedder.embed_text, **exp)

    ev = dict(cfg["evaluation"])
    ev.pop("run")
    metrics = evaluate_fad(cfg["experiment_path"], device=device, **ev)
    path = Path(cfg["experiment_path"]) / "metrics.csv"
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(metrics))
        writer.writeheader()
        writer.writerow(metrics)
    log.info("metrics: %s -> %s", metrics, path)
    print_table(metrics)
    out["metrics"] = metrics
    return out


if __name__ == "__main__":
    main()
