"""Overfit-to-quality run of the diffusion stack (the counterpart of
``script/overfit_quality.py``).

    python -m syncfusion_tpu_torch.overfit_quality [--steps 1500] \\
        [--clips 16] [--batch 8] [--lr 3e-4] [--out FILE] \\
        [--distill [--distill_steps 300]] [--sampling_steps 50] [--device cpu]

Without published weights this is the evidence that the training loop
reaches quality, not merely a falling loss: a tiny synthetic Foley set
(decaying noise bursts with pings at known onset times, drawn with numpy as
the JAX script draws it, bit for bit) is overfit with the real trainer
(``train/diffusion_trainer.py`` in f32, the reference's clip and AdamW at
``--lr``), and generation is scored at init, midway and at the end with the
real metrics: FAD of the VGGish log-mel statistics (``eval/fad.py``)
between the generated and the training clips, and onset detection on the
generated audio against the conditioning onsets (``eval/onset_detect.py``,
``eval/onset_metrics.py``).  The UNet is the JAX script's, built through
``SyncFusionDiffusion.from_config``: attention at its last level only (L =
65536 / 64 = 1024, 8 heads of 64), so training runs K1, K2a and K2b in f32
and every sampling forward runs K1.

Every line of output is one JSON object, as the JAX script prints them; the
last is ``{"quality_improved", "results"}``.  The exit code is 0 when the
final evaluation clears the JAX script's bars (FAD below a quarter of the
init's, onset accuracy >= 0.95, AP >= 0.85, count accuracy >= 0.5), else 1.
``--distill`` then distils the trained model 64 -> 8 sampler steps
(``train/distill.py``) and scores the teacher at 64 and 8 steps and the
student at 8.  ``--sampling_steps`` (the evaluations' sampler steps, 50 in
the JAX script) shortens a rehearsal.  Runs on the card; ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.eval.fad import MelStatsEmbedder, frechet_distance, gaussian_stats
from syncfusion_tpu_torch.eval.onset_detect import onset_detect
from syncfusion_tpu_torch.eval.onset_metrics import average_precision, match_onsets
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu_torch.ops.resample import resample
from syncfusion_tpu_torch.train.diffusion_trainer import DiffusionTrainer, OptimizerConfig
from syncfusion_tpu_torch.train.distill import DistillConfig, ProgressiveDistiller

SR = 48000
LENGTH = 65536  # 1.37 s: one VGGish mel patch per clip
DETECT_SR = 22050
SAMPLING_STEPS = 50
NOISE_SEED = 999  # every evaluation samples from the same noise
# the JAX script's UNet and onset encoder (the folded layout is a TPU
# layout: fold_cap 0)
MODEL_CONFIG = {
    "model": dict(channels=(8, 32, 64, 128), factors=(1, 4, 4, 4), items=(1, 2, 2, 2),
                  attentions=(0, 0, 0, 1), cross_attentions=(1, 1, 1, 1),
                  context_channels=(8, 16, 32, 0), resnet_groups=8),
    "onsets_encoder": dict(channels=4, multipliers=(1, 2, 4, 8, 8), factors=(1, 4, 4, 4),
                           num_blocks=(1, 1, 1, 1), resnet_groups=2),
    "fold_cap": 0,
}


def make_clip(rng: np.random.RandomState, length: int) -> tuple[np.ndarray, np.ndarray]:
    """One synthetic foley clip: 2-4 decaying band-noise bursts + pings."""
    n_onsets = rng.randint(2, 5)
    onsets: list[int] = []
    while len(onsets) < n_onsets:
        cand = rng.randint(4096, length - 12000)
        if all(abs(cand - o) > 9600 for o in onsets):  # >=0.2 s apart
            onsets.append(cand)
    onsets = sorted(onsets)
    wav = np.zeros(length, np.float32)
    t = np.arange(12000, dtype=np.float32) / SR
    for o in onsets:
        tau = 0.02 + 0.03 * rng.rand()
        env = np.exp(-t / tau)
        noise = rng.randn(12000).astype(np.float32)
        # crude band shaping: difference filter ~ high-pass
        noise = np.diff(noise, prepend=0.0)
        ping = np.sin(2 * np.pi * (400 + 800 * rng.rand()) * t)
        burst = env * (0.6 * noise / max(1e-6, np.abs(noise).max()) + 0.4 * ping)
        wav[o : o + 12000] += 0.7 * burst
    track = np.zeros(length, np.float32)
    track[onsets] = 1.0
    return wav, track


def build_dataset(n_clips: int, seed: int = 0):
    """(wavs, tracks), each (n_clips, LENGTH, 1) f32."""
    rng = np.random.RandomState(seed)
    wavs, tracks = zip(*(make_clip(rng, LENGTH) for _ in range(n_clips)))
    return np.stack(wavs)[..., None], np.stack(tracks)[..., None]


def build_model(device, seed: int = 0) -> SyncFusionDiffusion:
    """The JAX script's model in f32 on ``device``, weights from ``seed``."""
    return SyncFusionDiffusion.from_config(MODEL_CONFIG, dtype=torch.float32,
                                           device=device, seed=seed)


@torch.no_grad()
def generate(model, tracks: np.ndarray, noise: torch.Tensor,
             num_steps: int = SAMPLING_STEPS) -> np.ndarray:
    """Clips (B, L) f32 sampled from ``noise`` (B, L, 1) on the training
    onset tracks, without an embedding."""
    onsets = torch.from_numpy(np.asarray(tracks, np.float32)).to(noise.device)
    return model.sample(noise, onsets, None, num_steps=num_steps)[..., 0].cpu().numpy()


def score(gen: np.ndarray, wavs: np.ndarray, tracks: np.ndarray) -> dict:
    """FAD of the mel statistics against the training clips, and the onset
    metrics of the generated clips against their conditioning onsets."""
    emb = MelStatsEmbedder()
    e_gen = np.concatenate([emb.embed(g, SR) for g in gen])
    e_gt = np.concatenate([emb.embed(w, SR) for w in wavs[..., 0]])
    fad = frechet_distance(*gaussian_stats(e_gen), *gaussian_stats(e_gt))

    accs, matches = [], []
    y_true_all: list[int] = []
    y_score_all: list[float] = []
    for g, tr in zip(gen, tracks[..., 0]):
        g22 = resample(g, SR, DETECT_SR)
        pred = onset_detect(g22, sr=DETECT_SR)
        gt = np.flatnonzero(tr) * DETECT_SR // SR
        res = match_onsets(gt, pred, g22)
        accs.append(res["acc"])
        matches.append(res["count_match"])
        y_true_all += res["y_true"]
        y_score_all += res["y_score"]
    if len(set(y_true_all)) > 1:
        ap = average_precision(y_true_all, y_score_all)
    else:  # one class: scikit-learn's AP is undefined there
        ap = float(np.mean(y_true_all)) if y_true_all else 0.0
    return {"fad_melstats": round(float(fad), 4),
            "onset_acc": round(float(np.mean(accs)), 4),
            "onset_ap": round(ap, 4),
            "onset_count_acc": round(float(np.mean(matches)), 4)}


def evaluate(model, wavs: np.ndarray, tracks: np.ndarray,
             generator: torch.Generator, num_steps: int = SAMPLING_STEPS) -> dict:
    """Generate from the training onset tracks on noise drawn from
    ``generator`` (on the model's device), then ``score``."""
    device = next(model.parameters()).device
    noise = torch.randn(wavs.shape, generator=generator, device=device)
    return score(generate(model, tracks, noise, num_steps), wavs, tracks)


def quality_improved(results: list[dict]) -> bool:
    """The JAX script's bars on the final evaluation.  The onset metrics
    read as saturated even at init (the random-weight UNet leaks the onset
    context's structure to the detector), so FAD must drop hard while they
    stay high."""
    final = results[-1]
    return (final["fad_melstats"] < 0.25 * results[0]["fad_melstats"]
            and final["onset_acc"] >= 0.95
            and final["onset_ap"] >= 0.85
            and final["onset_count_acc"] >= 0.5)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--distill", action="store_true",
                    help="after training, progressively distill 64->8 sampler steps "
                         "and score the student")
    ap.add_argument("--distill_steps", type=int, default=300,
                    help="optimizer steps per halving round")
    ap.add_argument("--sampling_steps", type=int, default=SAMPLING_STEPS,
                    help="sampler steps of the init, mid and final evaluations")
    ap.add_argument("--device", default=None, help="default: the card")
    return ap.parse_args(argv)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def main(argv=None) -> int:
    """Train, evaluate and print the JSON lines; returns the exit code, 0
    when ``quality_improved``."""
    args = parse_args(argv)
    device = default_device(args.device)
    set_exact_f32()
    wavs, tracks = build_dataset(args.clips)
    model = build_model(device)
    trainer = DiffusionTrainer(model, OptimizerConfig(lr=args.lr, accumulate_grad_batches=1))
    state = trainer.create_state()

    def noise_gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def device_batch(idx):
        return {"wav": torch.from_numpy(wavs[idx]).to(device),
                "onsets": torch.from_numpy(tracks[idx]).to(device)}

    results = []

    def checkpoint(tag):
        r = {"tag": tag, "step": int(state.step)}
        r.update(evaluate(model, wavs, tracks, noise_gen(NOISE_SEED), args.sampling_steps))
        results.append(r)
        emit(r)

    emit({"params": model.param_count(), "clips": args.clips, "length": LENGTH,
          "steps": args.steps})
    checkpoint("init")

    rng = np.random.RandomState(7)
    t0 = time.time()
    mid = args.steps // 2
    for step in range(1, args.steps + 1):
        idx = rng.choice(len(wavs), args.batch, replace=False)
        metrics = trainer.train_step(state, device_batch(idx), noise_gen(step))
        if step % 50 == 0 or step == 5:
            emit({"step": step, "train_loss": round(float(metrics["train_loss"]), 5),
                  "wall_s": round(time.time() - t0, 1)})
        if step == mid:
            checkpoint("mid")
    checkpoint("final")
    improved = quality_improved(results)

    distill_report = None
    if args.distill:
        rng2 = np.random.RandomState(11)

        def batch_fn(step):
            return device_batch(rng2.choice(len(wavs), args.batch, replace=False))

        dist = ProgressiveDistiller(model, DistillConfig(
            start_steps=64, final_steps=8, steps_per_round=args.distill_steps))
        distilled, n = dist.distill(batch_fn, noise_gen(555), log_fn=emit)
        distill_report = {
            "teacher_64step": evaluate(model, wavs, tracks, noise_gen(NOISE_SEED), 64),
            f"teacher_{n}step_naive": evaluate(model, wavs, tracks, noise_gen(NOISE_SEED), n),
            f"student_{n}step_distilled": evaluate(distilled, wavs, tracks,
                                                   noise_gen(NOISE_SEED), n),
        }
        emit({"distill": distill_report})

    emit({"quality_improved": improved, "results": results})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"quality_improved": improved, "results": results,
                       "distill": distill_report}, f, indent=2)
    return 0 if improved else 1


if __name__ == "__main__":
    sys.exit(main())
