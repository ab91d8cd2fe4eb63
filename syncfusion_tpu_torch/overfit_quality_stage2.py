"""Overfit-to-quality run of the stage-2 (CondFoleyGen GPT) path (the
counterpart of ``script/overfit_quality_stage2.py``).

    python -m syncfusion_tpu_torch.overfit_quality_stage2 [--steps 600] \\
        [--batch 32] [--lr 3e-4] [--out FILE] [--device cpu]

Shows that the AV-conditional GPT learns to use its conditioning, not
merely that its loss falls.  A synthetic task with the structure of the
reference's ``Net2NetTransformerAVCond``: each example has a class c; the
prepended "video features" (``GPTFeats``'s conditioning) encode c; the
token sequence is [cond half z', ref half z], z a fixed pattern of c and z'
the pattern of an independent random class, so the ref half is predictable
only through the features.  The data are drawn from
``np.random.RandomState(0)`` as the JAX script draws them, bit for bit.
Training takes the real cross-entropy on the ref half and the stage-2
recipe (``train/transformer_trainer.py``: the global norm clipped to 1.0,
AdamW with betas (0.9, 0.95) and weight decay 0.01 on the kernels of
``decay_params`` only).  Quality: greedy next-token accuracy on the ref
half, and the exact-token accuracy of KV-cached sampling at top-k 1
(``models/mingpt_decode.py``) against the class pattern; chance is
1/vocab, learned ~1.0.

Every line of output is one JSON object, as the JAX script prints them; the
exit code is 0 when the final ``sample_acc`` is above 0.9 and above the
init's, else 1.  No hand-written kernel lies on this path: the GPT's
attention is plain PyTorch, as the JAX package runs it through XLA.  Runs
on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from syncfusion_tpu_torch.core.config import GPTConfig
from syncfusion_tpu_torch.device import default_device, set_exact_f32
from syncfusion_tpu_torch.models.init import flax_init
from syncfusion_tpu_torch.models.mingpt import GPTFeats
from syncfusion_tpu_torch.models.mingpt_decode import sample_tokens_cached
from syncfusion_tpu_torch.train.diffusion_trainer import Optimizer, OptimizerConfig
from syncfusion_tpu_torch.train.transformer_trainer import decay_params

VOCAB = 128
CLIP = 10          # tokens per half (the flagship uses 50 = 5x10 grid)
N_CLASSES = 8
FEAT_DIM = 64
N_FRAMES = 6
EVAL_BATCH = 64
GPT_CONFIG = GPTConfig(vocab_size=VOCAB, block_size=N_FRAMES + 2 * CLIP, n_layer=4,
                       n_head=4, n_embd=128)


def make_dataset(rng: np.random.RandomState):
    """(patterns (N_CLASSES, CLIP), batch): ``batch(n)`` draws n examples
    from ``rng``, ``(feats (n, N_FRAMES, FEAT_DIM) f32, tokens (n, 2·CLIP),
    c_ref (n,))``, numpy."""
    patterns = rng.randint(0, VOCAB, size=(N_CLASSES, CLIP))
    protos = rng.randn(N_CLASSES, N_FRAMES, FEAT_DIM).astype(np.float32)

    def batch(n):
        c_ref = rng.randint(0, N_CLASSES, n)
        c_cond = rng.randint(0, N_CLASSES, n)
        feats = protos[c_ref]
        tokens = np.concatenate([patterns[c_cond], patterns[c_ref]], axis=1)
        return feats, tokens, c_ref

    return patterns, batch


def build_gpt(device, seed: int = 0) -> GPTFeats:
    """The JAX script's GPT (4 layers, 4 heads, width 128, block 26) on
    ``device``, Flax's initial distributions from ``seed``."""
    with torch.device(device):
        gpt = GPTFeats(GPT_CONFIG, feat_dim=FEAT_DIM)
    return flax_init(gpt, seed)


def make_optimizer(gpt: GPTFeats, lr: float) -> Optimizer:
    """The stage-2 recipe: clip 1.0, AdamW (0.9, 0.95), eps 1e-8, weight
    decay 0.01 on ``decay_params`` alone."""
    decay = {id(p) for p in decay_params(gpt)}
    return Optimizer(gpt.parameters(),
                     OptimizerConfig(lr=lr, lr_beta1=0.9, lr_beta2=0.95, lr_eps=1e-8,
                                     lr_weight_decay=0.01, gradient_clip_val=1.0),
                     no_decay=[p for p in gpt.parameters() if id(p) not in decay])


def ce_on_ref_half(gpt: GPTFeats, tokens: torch.Tensor, feats: torch.Tensor):
    """The stage-2 objective (the JAX ``transformer_av`` loss): the mean
    cross-entropy of the ref half's tokens; returns (loss, their logits)."""
    logits = gpt(tokens[:, :-1], feats)
    logits = logits[:, feats.shape[1] - 1:][:, CLIP:]
    target = tokens[:, CLIP:]
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), target.reshape(-1))
    return loss, logits


def to_device(feats, tokens, device):
    return (torch.from_numpy(np.asarray(feats)).to(device),
            torch.from_numpy(np.asarray(tokens)).long().to(device))


@torch.no_grad()
def evaluate(gpt: GPTFeats, batch_fn, patterns: np.ndarray,
             generator: torch.Generator) -> dict:
    """``greedy_acc``: the teacher-forced argmax on the ref half of a fresh
    batch of EVAL_BATCH; ``sample_acc``: KV-cached sampling at top-k 1 from
    its cond half, against the class patterns."""
    device = next(gpt.parameters()).device
    feats_np, tokens_np, c_ref = batch_fn(EVAL_BATCH)
    feats, tokens = to_device(feats_np, tokens_np, device)
    _, logits = ce_on_ref_half(gpt, tokens, feats)
    greedy_acc = (logits.argmax(-1) == tokens[:, CLIP:]).float().mean().item()
    out = sample_tokens_cached(gpt, feats, tokens[:, :CLIP], CLIP, generator,
                               temperature=1.0, top_k=1)
    sample_acc = float(np.mean(out[:, CLIP:].cpu().numpy() == patterns[c_ref]))
    return {"greedy_acc": round(greedy_acc, 4), "sample_acc": round(sample_acc, 4)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="default: the card")
    return ap.parse_args(argv)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def main(argv=None) -> int:
    """Train, evaluate and print the JSON lines; returns the exit code, 0
    when the final ``sample_acc`` is above 0.9 and above the init's."""
    args = parse_args(argv)
    device = default_device(args.device)
    set_exact_f32()
    rng = np.random.RandomState(0)
    patterns, batch_fn = make_dataset(rng)
    batch_fn(2)  # the JAX script's init batch: keeps the draws in step
    gpt = build_gpt(device)
    opt = make_optimizer(gpt, args.lr)

    def key(seed):
        return torch.Generator(device=device).manual_seed(seed)

    results = [dict(tag="init", step=0, **evaluate(gpt, batch_fn, patterns, key(1)))]
    emit(results[-1])
    t0 = time.time()
    for step in range(1, args.steps + 1):
        feats, tokens = to_device(*batch_fn(args.batch)[:2], device)
        loss, _ = ce_on_ref_half(gpt, tokens, feats)
        loss.backward()
        opt.step()
        if step % 100 == 0:
            emit({"step": step, "loss": round(loss.item(), 4),
                  "wall_s": round(time.time() - t0, 1)})
        if step == args.steps // 2:
            results.append(dict(tag="mid", step=step,
                                **evaluate(gpt, batch_fn, patterns, key(2))))
            emit(results[-1])
    results.append(dict(tag="final", step=args.steps,
                        **evaluate(gpt, batch_fn, patterns, key(3))))
    emit(results[-1])

    improved = (results[-1]["sample_acc"] > 0.9
                and results[-1]["sample_acc"] > results[0]["sample_acc"])
    emit({"quality_improved": improved, "results": results})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"quality_improved": improved, "results": results}, f, indent=2)
    return 0 if improved else 1


if __name__ == "__main__":
    sys.exit(main())
