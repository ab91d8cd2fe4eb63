"""Video frames -> Foley audio (the counterpart of ``script/video_to_foley.py``):
the onset net's predictions -> an onset track -> conditioned diffusion
sampling.

    python -m syncfusion_tpu_torch.video_to_foley --video_dir DIR \\
        [--onset_ckpt ONSET_RUN/ckpts] [--diffusion_ckpt RUN/ckpts] \\
        [--text "hit wood" | --cond_wav timbre.wav] [--clap_ckpt CLAP.pt] \\
        [--model_config model.json] [--device cpu] --output foley.wav

``--video_dir`` is a preprocessed ``{video}/`` directory (``frames/*.jpg``,
``{video}.metadata.json``, ``{video}.times.csv``, as the Greatest Hits
preprocessing writes it).  Its 2-s chunks go through the onset net
(``--onset_ckpt``: a ``train_onset`` checkpoint directory, its best step,
else its latest; random weights without it); a raw logit above 0.5 is an
onset, and of consecutive onset frames every other one is dropped (the
reference's test protocol).  The times become a 48 kHz onset track, which
conditions ``SyncFusionDiffusion.sample`` with the sampler flags of
``generate.py``; ``--diffusion_ckpt`` takes a ``train_diffusion``
checkpoint directory as ``generate.py --ckpt`` does, and ``--model_config``
a JSON of the diffusion config's model node (in place of the JAX script's
``--override``).  The clip is conditioned on the CLAP embedding of
``--text`` or of ``--cond_wav`` (its channels' mean, resampled to 48 kHz),
with the laion checkpoint ``--clap_ckpt`` (random CLAP weights without it),
else on zeros.  ``--mux_video OUT.mp4`` muxes the clip onto ``--source_video``
at ``--mux_fps`` (trimmed to the clip, through ffmpeg), or without one onto
the video directory's own frames (``frames/{video}.frame_%06d.jpg``, stored
as Motion-JPEG by the native muxer, no ffmpeg).  Runs on the card;
``--device cpu`` runs on the CPU.  Decoding the JPEG frames needs PIL.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import tempfile
import time
from pathlib import Path
from typing import Iterable, Mapping, Optional

import numpy as np
import torch

from syncfusion_tpu_torch.core.config import model_configs
from syncfusion_tpu_torch.data.onset_dataset import GreatestHitsDataset
from syncfusion_tpu_torch.data.transforms import FrameTransform
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.eval.mux import attach_audio_to_frames, attach_audio_to_video
from syncfusion_tpu_torch.eval.onset_annotations import dedup_consecutive
from syncfusion_tpu_torch.generate import LENGTH, SR, onset_track, restore_model
from syncfusion_tpu_torch.models.embedder import embedder_from_config
from syncfusion_tpu_torch.models.onset_net import VideoOnsetNet
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops.resample import resample
from syncfusion_tpu_torch.ops.wav import read_wav, write_wav
from syncfusion_tpu_torch.train.onset_trainer import OnsetTrainer

log = logging.getLogger("syncfusion_tpu_torch.video_to_foley")


def read_chunks(video_dir: Path) -> list[dict]:
    """The 2-s chunks of a preprocessed video directory, as the onset
    dataset reads them for evaluation (Resize to 112x112, ImageNet
    normalisation on the host): dicts with ``frames`` (T, H, W, 3) f32,
    ``start_frame`` and ``frame_rate``."""
    video_dir = Path(video_dir)
    with tempfile.TemporaryDirectory() as tmp:
        split = Path(tmp) / "split.txt"
        split.write_text(video_dir.name + "\n")
        ds = GreatestHitsDataset(str(video_dir.parent), str(split),
                                 frames_transforms=FrameTransform(augment=False))
        return [ds[i] for i in range(len(ds))]


@torch.no_grad()
def onset_times(net: VideoOnsetNet, chunks: Iterable[Mapping], device,
                batch_size: int = 16) -> np.ndarray:
    """Chunks (``frames`` in any wire format of the trainer, ``start_frame``,
    ``frame_rate``) -> sorted onset times in seconds: eval-mode logits, a raw
    logit above 0.5 is an onset (the reference thresholds the logit, not the
    probability), consecutive frames deduplicated, each frame index offset
    by its chunk's start and divided by its frame rate."""
    chunks = list(chunks)
    times = []
    for start in range(0, len(chunks), batch_size):
        part = chunks[start:start + batch_size]
        frames = torch.from_numpy(np.stack([c["frames"] for c in part])).to(device)
        logits = net.eval()(OnsetTrainer.prep_frames(frames)).float().cpu().numpy()
        for chunk, row in zip(part, logits):
            idx = dedup_consecutive(np.nonzero(row > 0.5)[0].tolist())
            times += [(k + chunk["start_frame"]) / chunk["frame_rate"] for k in idx]
    return np.asarray(sorted(times))


def load_onset_net(onset_ckpt, layers, device, seed: int = 0) -> VideoOnsetNet:
    """The onset net in f32, as the JAX script computes it, with the model
    of a ``train_onset`` checkpoint directory (best step, else latest), or
    seeded random weights."""
    with torch.device(device):
        net = VideoOnsetNet(tuple(layers))
    net.init(seed)
    if onset_ckpt:
        net.load_state_dict(restore_model(onset_ckpt, monitor="loss/val"), strict=True)
    else:
        log.warning("no --onset_ckpt: the onset predictions are random")
    return net.eval()


def conditioning(text: str | None, cond_wav: str | None, clap_ckpt: str | None,
                 model_cfg: Optional[dict], device) -> torch.Tensor:
    """The (1, 1, features) embedding of the clip: the model config's
    embedder's (``embedder_from_config``: CLAP, or zeros under ``amodel:
    none``) of ``text``, else of the wav file ``cond_wav`` (mean over
    channels, resampled to 48 kHz), else zeros.  ``clap_ckpt`` takes the
    place of the node's ``embedder_checkpoint``."""
    if not (text or cond_wav):
        features = model_configs(model_cfg)[0].embedding_features
        return torch.zeros((1, 1, features), device=device)
    embedder = embedder_from_config(model_cfg, device, checkpoint_path=clap_ckpt)
    if not (clap_ckpt or (model_cfg or {}).get("embedder_checkpoint")):
        log.warning("no CLAP checkpoint: the embedder is zero or random-weight")
    if text:
        return embedder.embed_text([text])
    wav, sr = read_wav(cond_wav)
    y = wav.mean(axis=0)
    if sr != SR:
        y = resample(y, sr, SR)
    return embedder.embed_audio(y[None, :, None])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--video_dir", required=True,
                    help="preprocessed {video}/ dir with frames/ + metadata")
    ap.add_argument("--onset_ckpt", default=None,
                    help="train_onset checkpoint directory")
    ap.add_argument("--diffusion_ckpt", default=None,
                    help="train_diffusion checkpoint directory")
    ap.add_argument("--clap_ckpt", default=None,
                    help="laion_clap checkpoint (630k-audioset-best.pt)")
    ap.add_argument("--cond_wav", default=None, help="timbre reference audio")
    ap.add_argument("--text", default=None, help="text condition instead of audio")
    ap.add_argument("--output", default="foley.wav")
    ap.add_argument("--num_steps", type=int, default=150)
    ap.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim")
    ap.add_argument("--embedding_scale", type=float, default=2.0)
    ap.add_argument("--guidance_interval", type=float, nargs=2, default=(0.2, 0.8),
                    metavar=("LO", "HI"),
                    help="CFG only for LO <= sigma <= HI; '-1 -1' for always")
    ap.add_argument("--deep_cache_interval", type=int, default=0,
                    help="DeepCache: rerun the deep levels every K steps (0: off); "
                         "the validated fast point is --sampler dpm --num_steps 32 "
                         "--embedding_scale 1.5 --deep_cache_interval 2")
    ap.add_argument("--deep_split", type=int, default=4,
                    help="DeepCache: the UNet level where the deep half starts")
    ap.add_argument("--onset_layers", type=int, nargs=4, default=(2, 2, 2, 2))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mux_video", default=None,
                    help="also write the clip muxed onto the video as this .mp4")
    ap.add_argument("--source_video", default=None,
                    help="video to mux onto (ffmpeg); default: --video_dir's frames")
    ap.add_argument("--mux_fps", type=int, default=15)
    ap.add_argument("--model_config", default=None,
                    help="JSON of the diffusion config's model node "
                         "(default: exp/model/diffusion.yaml's values)")
    ap.add_argument("--length", type=int, default=LENGTH)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    return ap.parse_args(argv)


def main(argv=None, chunks=None) -> dict:
    """Writes ``--output``; returns ``{"times": onset times, "seconds":
    {"onset", "clap", "generation"}}``, each part's seconds with its models'
    set-up, the device synchronised at its end.  ``chunks``: the video's
    chunks as ``read_chunks`` gives them, in place of reading
    ``--video_dir``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = default_device(args.device)
    # the onset net in exact f32, as train_onset trains it at precision 32
    # (the raw logits are thresholded), and CLAP in f32 as the JAX package
    # runs it; generation computes in bf16
    set_exact_f32()
    seconds = {}

    # 1. onset times from the frames
    t0 = time.perf_counter()
    net = load_onset_net(args.onset_ckpt, args.onset_layers, device)
    if chunks is None:
        chunks = read_chunks(Path(args.video_dir))
    times = onset_times(net, chunks, device)
    del net
    seconds["onset"] = time.perf_counter() - t0
    log.info("predicted %d onsets: %s", len(times), np.round(times, 2)[:12])

    # 2. the onset track; 3. the conditioning embedding
    t0 = time.perf_counter()
    onsets = torch.from_numpy(onset_track(times, args.length)).to(device)
    model_cfg = None
    if args.model_config:
        with open(args.model_config) as f:
            model_cfg = json.load(f)
    embedding = conditioning(args.text, args.cond_wav, args.clap_ckpt, model_cfg, device)
    _sync(device)
    seconds["clap"] = time.perf_counter() - t0

    # 4. sampling
    t0 = time.perf_counter()
    model = SyncFusionDiffusion.from_config(model_cfg, dtype=torch.bfloat16, device=device)
    if args.diffusion_ckpt:
        model.load_state_dict(restore_model(args.diffusion_ckpt), strict=True)
    else:
        log.warning("no --diffusion_ckpt: parameters are random, the output is "
                    "noise-shaped")
    gi = tuple(args.guidance_interval)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    noise = torch.randn((1, args.length, 1), generator=gen, device=device)
    wav = model.sample(noise, onsets, embedding, num_steps=args.num_steps,
                       embedding_scale=args.embedding_scale,
                       guidance_interval=None if gi[0] < 0 else gi,
                       sampler=args.sampler,
                       deep_cache_interval=args.deep_cache_interval,
                       deep_split=args.deep_split)
    wav = wav[0, :, 0].float().cpu().numpy()
    seconds["generation"] = time.perf_counter() - t0
    write_wav(args.output, wav, SR)
    log.info("wrote %s (%.2f s @ %d Hz); seconds: %s", args.output, len(wav) / SR, SR,
             {k: round(v, 4) for k, v in seconds.items()})
    if args.mux_video:
        if args.source_video:
            attach_audio_to_video(args.source_video, args.output, args.mux_video,
                                  fps=args.mux_fps,
                                  video_duration_in_seconds=len(wav) / SR)
        else:
            name = Path(args.video_dir).name
            attach_audio_to_frames(Path(args.video_dir) / "frames",
                                   f"{name}.frame_%06d.jpg", args.output,
                                   args.mux_video, fps=args.mux_fps,
                                   n_frames=math.ceil(len(wav) / SR * args.mux_fps))
        log.info("muxed %s", args.mux_video)
    return {"times": times, "seconds": seconds}


if __name__ == "__main__":
    main()
