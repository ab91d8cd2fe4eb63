"""Onset times -> Foley audio (steps 2 and 4 of ``script/video_to_foley.py``).

    python -m syncfusion_tpu_torch.generate --onset_times times.txt \
        [--embedding emb.npy] [--ckpt DIR | --params_npz params.npz] \
        [--sampler ddim|dpm] [--deep_cache_interval K] --output foley.wav

``--onset_times``: a text file of onset times in seconds.  They become a
48 kHz binary onset track of 2^18 samples, which conditions 150-step DDIM
sampling with CFG scale 2.0 inside the sigma band (0.2, 0.8), the JAX
script's defaults.  ``--sampler dpm`` takes DPM-Solver++(2M), and
``--deep_cache_interval K`` (K > 1) reruns the UNet's levels >=
``--deep_split`` only every K-th step (DeepCache); the reference's fast
setting is ``--sampler dpm --num_steps 32 --embedding_scale 1.5
--deep_cache_interval 2``.  Without ``--embedding`` (a (1, 1, features) or
(features,) ``.npy`` CLAP embedding) the embedding is zeros.  The parameters
come from ``--ckpt`` (a ``train_diffusion`` checkpoint directory: its best
step by the monitored metric, else its latest), or ``--params_npz`` (the JAX
``{"unet", "encoder"}`` parameter tree saved as an ``.npz`` with
``/``-joined keys); without either they are random.  Runs on the card;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

from syncfusion_tpu_torch.convert import to_state_dict, unflatten
from syncfusion_tpu_torch.core.checkpoint import restore_best
from syncfusion_tpu_torch.device import default_device
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops.wav import write_wav

log = logging.getLogger("syncfusion_tpu_torch.generate")

SR = 48000
LENGTH = 2**18


def onset_track(times: np.ndarray, length: int = LENGTH, sr: int = SR) -> np.ndarray:
    """Onset times (s) -> (1, length, 1) binary track, 1.0 at each onset."""
    onsets = np.zeros((1, length, 1), np.float32)
    idx = (np.asarray(times) * sr).astype(int)
    onsets[0, idx[(idx >= 0) & (idx < length)], 0] = 1.0
    return onsets


def restore_model(directory, monitor: str = "valid_loss") -> dict:
    """The model state dict of a training checkpoint directory
    (``train_diffusion``'s; ``train_onset``'s with ``monitor="loss/val"``):
    its best step by ``monitor``, else its latest (the reference's
    ``restore_params``)."""
    log.info("parameters of %s (best by %s, else the latest)", directory, monitor)
    return restore_best(directory, monitor)["model"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--onset_times", required=True,
                    help="text file of onset times in seconds")
    ap.add_argument("--embedding", default=None, help=".npy CLAP embedding")
    params = ap.add_mutually_exclusive_group()
    params.add_argument("--ckpt", default=None,
                        help="train_diffusion checkpoint directory (its best step, "
                             "else its latest)")
    params.add_argument("--params_npz", default=None,
                        help="JAX parameter tree as .npz with '/'-joined keys")
    ap.add_argument("--model_config", default=None,
                    help="JSON of the diffusion config's model node "
                         "(default: exp/model/diffusion.yaml's values)")
    ap.add_argument("--output", default="foley.wav")
    ap.add_argument("--length", type=int, default=LENGTH)
    ap.add_argument("--num_steps", type=int, default=150)
    ap.add_argument("--embedding_scale", type=float, default=2.0)
    ap.add_argument("--guidance_interval", type=float, nargs=2,
                    default=(0.2, 0.8), metavar=("LO", "HI"),
                    help="CFG only for LO <= sigma <= HI; '-1 -1' for always")
    ap.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim")
    ap.add_argument("--deep_cache_interval", type=int, default=0,
                    help="DeepCache: rerun the deep levels every K steps (0: off)")
    ap.add_argument("--deep_split", type=int, default=4,
                    help="DeepCache: the UNet level where the deep half starts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = default_device(args.device)
    model_cfg = None
    if args.model_config:
        with open(args.model_config) as f:
            model_cfg = json.load(f)
    model = SyncFusionDiffusion.from_config(model_cfg, dtype=torch.bfloat16,
                                            device=device)
    if args.ckpt:
        model.load_state_dict(restore_model(args.ckpt), strict=True)
    elif args.params_npz:
        with np.load(args.params_npz) as npz:
            model.load_state_dict(to_state_dict(unflatten(dict(npz))), strict=True)
    else:
        log.warning("no --ckpt or --params_npz: parameters are random, the "
                    "output is noise-shaped")

    times = np.loadtxt(args.onset_times, ndmin=1)
    onsets = torch.from_numpy(onset_track(times, args.length)).to(device)
    features = model.unet.cfg.embedding_features
    if args.embedding:
        emb = np.load(args.embedding).astype(np.float32).reshape(1, 1, features)
    else:
        emb = np.zeros((1, 1, features), np.float32)
    gi = tuple(args.guidance_interval)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    noise = torch.randn((1, args.length, 1), generator=gen, device=device)
    wav = model.sample(noise, onsets, torch.from_numpy(emb).to(device),
                       num_steps=args.num_steps,
                       embedding_scale=args.embedding_scale,
                       guidance_interval=None if gi[0] < 0 else gi,
                       sampler=args.sampler,
                       deep_cache_interval=args.deep_cache_interval,
                       deep_split=args.deep_split)
    wav = wav[0, :, 0].cpu().numpy()
    write_wav(args.output, wav, SR)
    log.info("wrote %s (%.2f s @ %d Hz, %d onsets)", args.output,
             len(wav) / SR, SR, len(times))


if __name__ == "__main__":
    main()
