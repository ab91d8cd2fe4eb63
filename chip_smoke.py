#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure exits non-zero:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: ``nvcc`` compiles every kernel of ``syncfusion_tpu_torch/csrc``;
     the registers, spills and static shared memory ptxas reports for K1,
     K2a and K2b, and the dynamic shared memory each launch asks for (read
     from the built library), go into the kernels line;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes of the generation path (plus a ragged and a causal case), in
     bf16 and f32, and K1 in bf16 also at the 16 rows of the serving and fast
     configurations' in-band forward and at the 2 and 1 rows of video to
     Foley's (phase 13), K1 in f32 also at the 20 rows of evaluation's
     (phase 15), each error against its stated tolerance, with the times of
     the kernel, the plain version and one PyTorch library call;
  4. the slice at full width: ``SyncFusionDiffusion`` built from
     exp/model/diffusion.yaml's values with seeded random weights, in bf16,
     generates 2^18-sample clips in three configurations: B = 4 with
     150-step DDIM and CFG 2.0 inside the sigma band (0.2, 0.8); the serving
     configuration of bench.py (the same at B = 8 with DeepCache K = 4 at
     split 4); and the fast one of script/video_to_foley.py (DPM-Solver++(2M),
     32 steps, CFG 1.5 in the band, DeepCache K = 2, B = 8).  Each is timed as
     one warm-up and ``TIMED_RUNS`` warm runs (median and range), and every
     run's launch counts are checked.  One in-band UNet forward at the serving
     shape (16 rows) is timed whole and cached (device ms, printed; its time
     by kernel class: ``python -m syncfusion_tpu_torch.breakdown --batch 16
     --deep_split 4``);
  5. cross-check: 2 sampler steps through the kernel against 2 steps with
     the plain attention, on the same weights and noise, in f32 (gated) and
     in bf16 (the share of the attention calls' O elements that the kernel
     rounds otherwise than the plain version, gated; the output's error,
     printed); in f32 also DeepCache DDIM and DPM++ (K = 2, 4 steps, band),
     gated alike;
  6. training at full width: a synthetic shard (4 tracks of 12 s at 48 kHz,
     an onset every 0.25 s) written with numpy into a temporary directory,
     then ``train_diffusion.main`` in f32 (the config's ``precision: 32``):
     batch 4 chunks of 2^18 samples, accumulation 2, 4 micro-steps (2
     optimizer updates), one validation batch, a sample logger of 2 steps,
     zero embeddings; the losses are finite, the checkpoint reloads with
     ``strict=True``, and K1, K2a and K2b launched 9 times per forward or
     backward, the plain versions never;
  7. training cross-check: one f32 loss and gradient at full width through
     the kernels against the plain attention, on the same batch, sigma and
     noise;
  8. fused generation at full width: the same model and inputs as phase 4's
     B = 4 runs with the UNet's fused configuration on (``fused_resnet``,
     ``fused_stats`` at ``fold_cap`` 256, from the config as the JAX
     package reads it), timed as phase 4; K3, K4 and K1 launch 12, 12 and 9
     times per forward, no plain version runs;
  9. fused cross-check, f32, same weights: 2 sampler steps of the fused
     model against the plain one, and DeepCache DDIM (K = 2, 4 steps, band;
     K3 and K4 run on every forward, cached or not: they lie below the
     split), both gated as phase 5, then one full-width loss and gradient
     (gated as phase 7);
 10. fused training: phase 6's command line with a model config that turns
     the fused configuration on; K3 and K4 launch 12 times per forward;
 11. onset training at full width: ``VideoOnsetNet`` (R(2+1)D-18 with the
     keep-temporal surgery, seeded weights) at the reference recipe, B = 16
     chunks of 30 frames at 112x112 on the uint8 wire, lr 1e-4, wd 1e-3, in
     bf16 (cfg/model/model-onset.yaml's precision) and in f32
     (model-onset-f32.yaml): 2 warm-up and 5 timed steps each through
     ``train_onset.fit_epoch`` on seeded batches (about 2 onsets a chunk) via
     ``device_prefetch``; finite losses, the BatchNorm buffers moved, the
     checkpoint reloads with ``strict=True``; then the eval forward's chunks
     per second.  No TPU kernel lies on this path (cuDNN convolutions);
 12. onset cross-check, f32 without TF32: the same full-width net on the card
     and on the CPU, same weights and input (B = 2, T = 30, 64x64 frames):
     eval-mode logits, one train-mode loss, its gradients (on the card's ReLU
     masks) and the BatchNorm buffers after it, and the share of ReLU inputs
     whose sign the two disagree on;
 13. video to Foley at full width: ``video_to_foley.onset_times`` on seeded
     frames of one 6-s video (3 chunks of 30 frames, full-width onset net in
     f32 without TF32, as ``video_to_foley.main`` runs it), their onset track, then the full-width SyncFusion at the fast
     point (DPM-Solver++(2M), 32 steps, CFG 1.5 in the band, DeepCache K = 2,
     split 4) generates one 2^18-sample clip; K1 launches 153 times, its
     plain version never; one warm-up and 3 timed runs, each split into its
     onset and generation parts;
 14. CLAP at full width (HTSAT-tiny and roberta-base, seeded weights, f32
     without TF32): (a) ``ClapEmbedder.embed_audio`` timed on the training
     batch's conditioning chunks (B = 4 x 2^18 samples) and on one,
     ``embed_text`` on 1 and 4 prompts (the hashed tokenizer: the card has
     no roberta files), one warm-up and 3 runs each; (b) the same weights
     on the CPU, B = 1: the audio and text embeddings and the dB mel
     against the card's, gated; (c) ``train_diffusion.main`` with its
     default embedder, CLAP, at phase 6's command line cut to 2
     micro-steps (finite losses, 9 K1/K2a/K2b a forward or backward, no
     plain call), then micro-steps fed through ``device_prefetch`` with
     CLAP in the feeder thread against zero embeddings, in turns; (d)
     ``video_to_foley.main`` on phase 13's chunks and onset net at the fast
     point with ``--cond_wav`` (a seeded wav) and with ``--text``, one
     warm-up and 3 runs each split into onset, CLAP and generation; 153 K1
     a clip.  No TPU kernel lies inside CLAP: the JAX package runs it
     through XLA;
 15. evaluation at full width (exp/evaluate_gh_gen.yaml): a 10-track test
     shard written to a temp dir, ``evaluate_diffusion.main`` with ``--exp
     prepare_gh_gt`` (10 GT chunks) and ``--exp evaluate_gh_gen`` (B = 10,
     150-step DDIM, CFG 2.0 at every step, the prefix before the first
     onset cut, 96000 samples kept, 22.05 kHz out, f32 without TF32, CLAP
     audio conditioning; K1's f32 body 1350 times, the plain attention
     never), timed per clip and its peak memory printed; the full-width
     VGGish on both directories, card against CPU (gated), its Frechet
     distance and ms a clip; FAD of the mel statistics and
     ``evaluate_onset.main`` (finite over 10 files); one clip muxed onto
     JPEG frames and read back (gated), ffmpeg's muxer where there is one;
     ``resample_torch`` on the card against the host resampler (gated).
Phase 3 also holds the backward kernels K2a and K2b against their plain
versions at the training shapes (with the time of SDPA's backward), times
K1's f32 kernel per forward beside SDPA's f32 forward, and holds K3 and K4
(the fused resnet chain) at every shape of that chain, in bf16 at B = 8
and f32 at B = 4 (with their device time from the profiler), with a ragged
and a wide case.  The line before the last is the kernels' JSON
record, the last line ``{"ok": true, "device": ...}``.  Needs nothing but
this checkout: it imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time

sys.dont_write_bytecode = True  # write nothing into the checkout but the build

import numpy as np  # noqa: E402
import torch  # noqa: E402

LENGTH = 2**18
BATCH = 4
SR = 48000
NUM_STEPS = 150
BAND = (0.2, 0.8)
SCALE = 2.0
HEADS, HEAD_DIM = 8, 64
# phases 4 and 8: each generation configuration runs once to warm up, then
# TIMED_RUNS times, each run timed and gated
TIMED_RUNS = 3
# the serving configuration (bench.py): B = 8, 150-step DDIM, CFG 2.0 in the
# band, DeepCache K = 4 at split 4 (levels 4-7 and the bottleneck, which hold
# every attention call, rerun on refresh steps only).  band_segments gives
# segments of 30, 91 and 29 steps, refreshed 8 + 23 + 8 = 39 times: 9 K1
# calls each
SERVE_BATCH, SERVE_K, DEEP_SPLIT = 8, 4, 4
SERVE_K1 = 9 * 39
# the fast configuration (script/video_to_foley.py): DPM-Solver++(2M), 32
# steps, CFG 1.5 in the band, DeepCache K = 2, B = 8: segments of 7, 19 and 6
# steps, refreshed 4 + 10 + 3 = 17 times
FAST_STEPS, FAST_SCALE, FAST_K = 32, 1.5, 2
FAST_K1 = 9 * 17
# phase 5's f32 check of the cached path: K = 2, 4 steps in the band
# (segments of 1 and 3 steps, refreshed at 0 and at 0, 2: 3 full forwards)
CACHED_CHECK = dict(num_steps=4, embedding_scale=SCALE, guidance_interval=BAND,
                    deep_cache_interval=2, deep_split=DEEP_SPLIT)
CACHED_CHECK_K1 = 9 * 3
ROWS = 2 * BATCH  # the CFG batch inside the band
SERVE_ROWS = 2 * SERVE_BATCH
# video to Foley's one clip (phase 13): 2 rows in the band, 1 outside it
V2F_ROWS = (2, 1)
# attention calls per UNet forward at each sequence length (levels 4-7 down
# and up, plus the bottleneck at the level-7 length)
ATTN_CALLS = {2048: 2, 1024: 2, 512: 2, 256: 3}
HBM_BYTES_PER_S = 3.35e12
# dense, per type.  f32: products as accurate as f32 FMAs run on the
# tensor cores as 3xTF32 (three TF32 products each, K2a and K2b do), a third
# of the 495 TFLOP/s TF32 rate; that is above the 67 TFLOP/s of f32 FMAs on
# the CUDA cores, so the least time for f32 work is counted at it
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
# tolerances, max abs error against the plain version on the same inputs:
# f32: both sum in f32, in other orders, over up to 2048 keys;
# bf16: O is rounded to bf16 by both, so one bf16 ulp of |O| < 1 (2^-8) may
# flip; the LSE is f32 from the same bf16 inputs.
TOL = {torch.float32: {"o": 1e-4, "lse": 1e-4},
       torch.bfloat16: {"o": 8e-3, "lse": 1e-4}}
# phase 5, in f32: max |kernel - plain| / max |plain| after 2 sampler steps.
# The two sum in other orders (<= 1e-6 per call in phase 3); 2 steps through
# the ~60 layers of a random-weight net amplify that, far below 1e-3.
CROSS_TOL = 1e-3
# phase 5, in bf16: the share of O elements, over the 18 attention calls of
# those 2 steps, that the kernel rounds to another bf16 value than the plain
# version on the same inputs.  Both round an f32-accumulated O to bf16 once,
# so only elements that lie within the kernel's own error of a rounding
# boundary flip: 9.3e-4 for the tensor-core kernel (P carried as hi + lo
# bf16, 16 bits), 1.9e-4 for the CUDA-core kernel it replaced (f32 P), and
# 3.5e-2 for the same tensor-core kernel with P rounded to bf16 once
# (FlashAttention-2's arithmetic), which the limit fails (PERF.md §6, NVIDIA
# H100 80GB HBM3, 700 W).  The output's max |diff| / max |plain| is printed,
# not gated: the random-weight net carries a one-ulp flip of O (|O| up to
# ~74, an ulp of 0.5) to ~2e-2 of the output, and it read 1.9e-2, 2.1e-2 and
# 1.8e-2 on those three kernels alike.
BF16_FLIP_TOL = 5e-3
# training (phases 3, 6 and 7): batch 4 rows x 8 heads, f32
TRAIN_ROWS = BATCH
# K2a and K2b against their plain versions, max abs error relative to
# max |plain| of each output (dq, delta, dk, dv): f32 sums in other orders
# over up to 2048 keys; bf16 both round the f32 result, one ulp (2^-7 of
# the value) may flip
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
# phase 6: micro-steps, accumulation, and the sample logger's steps
TRAIN_STEPS, ACCUMULATE, SAMPLE_STEPS, SAMPLE_ITEMS = 4, 2, 2, 2
# phase 7, f32: the loss through the kernels against the plain attention,
# relative (sums in other orders, ~1e-6 per attention call); the gradients,
# max over parameter tensors of max |kernel - plain| / max |plain|, with
# max |plain| floored at GRAD_FLOOR of the largest gradient of the model
# (tests/test_trainer.py's floor for the JAX package's gradient parity):
# some tensors' exact gradients are 0 or nearly so (conv biases before a
# GroupNorm of one channel per group, the level-0 cross-attention that the
# final per-channel norm removes but for edge effects), and there the
# relative difference measures the rounding of sums that cancel (5.7e-3 at
# max |g| = 1.5e-6 against a largest gradient of 0.5, on an NVIDIA H100 80GB
# HBM3 at 700 W)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-3, 1e-3
# the fused resnet chain (phases 3, 8-10): the UNet's fused configuration
# as the JAX package reads it (model.fused_resnet, model.fused_stats and the
# top-level fold_cap); at L = 2^18 compute_folds gives folds [16, 4, 1, ...],
# so levels 0-1 run K4 and levels 2-3 run K3 where the block gate admits it
# (32 <= channels <= 128, L % 4096 == 0)
FUSED_SWITCHES = {"fused_resnet": True, "fused_stats": True}
FOLD_CAP = 256
# (C, Cout, L, K3 calls per forward in that configuration, with
# fused_resnet alone): down levels 1, 1, 2, 2, 3 and up 3, 2, 2, 1, 1
K3_SHAPES = [(40, 32, 2**16, 0, 1), (32, 32, 2**16, 0, 6), (64, 32, 2**16, 0, 1),
             (80, 64, 2**14, 1, 1), (64, 64, 2**14, 6, 6), (128, 64, 2**14, 1, 1),
             (128, 128, 2**12, 4, 4)]
# (C, Cout, L, residual, K4 calls per forward): levels 0-1, 6 blocks
K4_SHAPES = [(10, 8, 2**18, False, 1), (8, 8, 2**18, True, 2),
             (16, 8, 2**18, False, 1), (40, 32, 2**16, False, 1),
             (32, 32, 2**16, True, 4), (32, 32, 2**16, False, 2),
             (64, 32, 2**16, False, 1)]
K3_PER_FORWARD = sum(row[3] for row in K3_SHAPES)  # 12
K4_PER_FORWARD = sum(row[4] for row in K4_SHAPES)  # 12
FUSED_GROUPS = 8
# K3 and K4 against their plain versions: y, max abs error relative to max
# |plain| (f32: sums of up to 3·1024 products in other orders; bf16: both
# round the same f32 value, one ulp, 2^-8, may flip); the sums s and ss,
# relative to their bounds sqrt(n·ss) and ss (f32, other orders)
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
STATS_TOL = 1e-5
# the onset model (phases 11-13): the reference recipe's batch of 16 chunks
# of 30 frames at 112x112; 2 warm-up and 5 timed training steps
ONSET_BATCH, ONSET_T, ONSET_HW = 16, 30, 112
ONSET_WARMUP, ONSET_TIMED = 2, 5
# phase 12, f32 without TF32, card against CPU on the same weights and input:
# logits, loss and BatchNorm buffers relative to their largest magnitude
# (convolutions summed in other orders through 18 layers); gradients as
# phase 7 (TRAIN_GRAD_TOL, GRAD_FLOOR), with the CPU's ReLUs taking the
# card's masks (onset_net.ReluTape).  f32 rounding flips the few ReLU inputs
# that lie within its error of 0, and one flip moves a weight gradient by a
# sizeable share of its largest element: on the CPU, the full-width net in
# f32 against f64 on 2 chunks of 8 frames at 32x32, one flip of the input
# nearest 0 moves the f64 gradients by 3.7e-2, and on the f64 run's masks
# f32 agrees within 6.0e-5 (on its own, 4.4e-1)
# (tests/test_torch_onset.py::test_onset_gradients_hold_on_shared_relu_masks).
# So the masks are gated apart: ONSET_FLIP_TOL bounds the share of ReLU
# inputs whose sign the card and the CPU's own run disagree on.  Rounding
# alone gave 165 of 99,434,880 (1.7e-6) here on an NVIDIA H100 80GB HBM3 at
# 700 W, and 11 of 6,630,528 (1.7e-6) for the CPU's f32 against its f64 in
# that test; an error well above rounding moves far more across 0.  B = 2
# chunks at 64x64 bound the CPU's time.
ONSET_TOL = 1e-4
ONSET_FLIP_TOL = 1e-5
ONSET_CHECK_SHAPE = (2, 30, 64, 64, 3)
# phase 14, CLAP at full width (HTSAT-tiny, roberta-base), f32 without TF32
# as the JAX embedder computes it.  Card against CPU on the same weights and
# input: the unit-norm audio and text embeddings within CLAP_EMB_TOL (both
# sum in f32 in other orders, cuFFT against pocketfft and cuBLAS against the
# CPU's GEMMs, through 12 Swin blocks or 12 RoBERTa layers; the CPU tests
# held the port against the JAX package at ~1e-7 on tiny towers); the dB mel
# within CLAP_DB_TOL dB where its power is at least CLAP_DB_FLOOR of the
# largest.  Below that floor the dB value measures rounding: the frames that
# repeat-padding leaves silent sit at the 1e-10 clamp, and near them an FFT
# error of ~1e-7 of a frame's largest bin is a sizeable share of the power.
CLAP_EMB_TOL = 1e-4
CLAP_DB_TOL = 1e-3
CLAP_DB_FLOOR = 1e-6
CLAP_PROMPTS = ["hit wood", "scratch metal", "tap a ceramic plate", "rustle dry leaves"]
CLAP_TRAIN_STEPS = 2
# phase 14c's feed timing: micro-steps fed through device_prefetch, warm-up
# and timed, in turns zero embeddings / CLAP / CLAP / zero embeddings
CLAP_FEED_WARMUP, CLAP_FEED_STEPS = 2, 6
# phase 15, evaluation as exp/evaluate_gh_gen.yaml runs it: 10 test tracks
# (one chunk each) at B = 10, 150-step DDIM with CFG 2.0 at every step, so
# every forward runs 2B rows and launches K1's f32 body 9 times; the clips'
# first 96000 samples at 22.05 kHz (44100 samples, 2 s)
EVAL_TRACKS = EVAL_BATCH = 10
EVAL_ROWS = 2 * EVAL_BATCH
EVAL_K1 = 9 * NUM_STEPS
EVAL_SAMPLES = 44100
# VGGish on the card against the same weights on the CPU, f32 without TF32:
# max |diff| / max |embedding| (sums of up to 12288 products in other orders)
VGGISH_TOL = 1e-4
# the mux round trip reads back the 16-bit PCM that the container holds
MUX_TOL = 1e-6
# the host resampler against resample_torch on the card (f32 sums of ~40
# taps in other orders)
RESAMPLE_TOL = 1e-5
# a 16x16 grey baseline JPEG (PIL's encoder, quality 75): the frames of the
# mux round trip, so that the card's machine needs no image library
GREY_JPEG = bytes.fromhex(
    "ffd8ffe000104a46494600010100000100010000ffdb0043000806060706050807070709"
    "09080a0c140d0c0b0b0c1912130f141d1a1f1e1d1a1c1c20242e2720222c231c1c283729"
    "2c30313434341f27393d38323c2e333432ffc0000b080010001001011100ffc4001f0000"
    "010501010101010100000000000000000102030405060708090a0bffc400b51000020103"
    "03020403050504040000017d01020300041105122131410613516107227114328191a108"
    "2342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a434445"
    "464748494a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9faffda00080101"
    "00003f0028a28affd9")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def phase(name: str, t0: float) -> None:
    print(f"[{name}] {time.perf_counter() - t0:.3f} s", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_work(b, h, t, d, dtype, causal):
    """(bytes, operations) the function needs: q, k, v read once, O and the
    LSE written once; 4·d operations per (query, key) pair it scores."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * t * h * d * esize + b * h * t * 4
    pairs = t * (t + 1) // 2 if causal else t * t
    return nbytes, 4 * b * h * pairs * d


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bwd_work(b, h, t, d, dtype, causal):
    """(bytes, operations) of K2a and of K2b as functions.  K2a reads q, k,
    v, O, dO and the LSE and writes dq and delta: S, dP and dQ, 6·d
    operations per (query, key) pair.  K2b reads q, k, v, dO, the LSE and
    delta and writes dk and dv: S, dP, dV and dK, 8·d per pair."""
    esize = torch.tensor([], dtype=dtype).element_size()
    row = b * t * h * d * esize  # one (B, T, H, D) tensor
    vec = b * h * t * 4  # one (B, H, T) f32 vector
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    return {"dq": (6 * row + 2 * vec, 6 * d * pairs),
            "dkv": (6 * row + 2 * vec, 8 * d * pairs)}


def phase_bwd_kernels(attn):
    """Phase 3, backward: K2a and K2b against their plain versions at the
    training shapes (BH = 32), f32 and bf16, ragged and causal too; returns
    the per-backward totals of the main path's f32 shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(t, False) for t in ATTN_CALLS] + [(1000, False), (512, True)]
    total = {name: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0,
                    "max_abs_err": 0.0} for name in ("dq", "dkv")}
    library_ms = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for t, causal in cases:
            qkv = torch.randn((TRAIN_ROWS, t, 3, HEADS, HEAD_DIM), generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
            do = torch.randn((TRAIN_ROWS, t, HEADS, HEAD_DIM), generator=gen,
                             device="cuda").to(dtype)
            o, lse = attn.flash_fwd(q, k, v, causal)
            dq, delta = attn.flash_bwd_dq(q, k, v, o, lse, do, causal)
            dk, dv = attn.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
            rdq, rdelta = attn.flash_bwd_dq_reference(q, k, v, o, lse, do, causal)
            rdk, rdv = attn.flash_bwd_dkv_reference(q, k, v, do, lse, rdelta, causal)
            torch.cuda.synchronize()
            errs, rels = {}, []
            for name, got, want in (("dq", dq, rdq), ("delta", delta, rdelta),
                                    ("dk", dk, rdk), ("dv", dv, rdv)):
                err = (got.float() - want.float()).abs().max().item()
                errs[name] = err
                rels.append(err / want.float().abs().max().item())
            ok = max(rels) <= BWD_TOL[dtype]
            ms = {"dq": time_ms(lambda: attn.flash_bwd_dq(q, k, v, o, lse, do, causal), 10),
                  "dkv": time_ms(lambda: attn.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                            causal), 10)}
            plain = {"dq": time_ms(lambda: attn.flash_bwd_dq_reference(
                         q, k, v, o, lse, do, causal), 3),
                     "dkv": time_ms(lambda: attn.flash_bwd_dkv_reference(
                         q, k, v, do, lse, delta, causal), 3)}
            # SDPA's backward: forward plus backward, less the forward
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

            lib = time_ms(sdpa_fwd_bwd, 10) - time_ms(sdpa_fwd, 10)
            work = bwd_work(TRAIN_ROWS, HEADS, t, HEAD_DIM, dtype, causal)
            bounds = {n_: bound_ms(*work[n_], dtype) for n_ in work}
            print(f"  flash_bwd {str(dtype)[6:]:8s} T={t:4d} causal={int(causal)} "
                  f"BH={TRAIN_ROWS * HEADS}: err dq {errs['dq']:.3e} delta "
                  f"{errs['delta']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} "
                  f"(max rel {max(rels):.2e}, tol {BWD_TOL[dtype]:.0e}) | "
                  f"dq {ms['dq']:.4f} ms (plain {plain['dq']:.4f}, bound "
                  f"{bounds['dq'][0]:.4f} {bounds['dq'][1]}), dkv {ms['dkv']:.4f} ms "
                  f"(plain {plain['dkv']:.4f}, bound {bounds['dkv'][0]:.4f} "
                  f"{bounds['dkv'][1]}), sdpa bwd {lib:.4f} ms "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"flash_bwd {dtype} T={t} causal={causal} disagrees with "
                      f"its plain version")
            if dtype == torch.float32 and not causal and t in ATTN_CALLS:
                n = ATTN_CALLS[t]
                library_ms += n * lib
                for name, err in (("dq", max(errs["dq"], errs["delta"])),
                                  ("dkv", max(errs["dk"], errs["dv"]))):
                    tot = total[name]
                    tot["ms"] += n * ms[name]
                    tot["plain_ms"] += n * plain[name]
                    tot["bytes"] += n * work[name][0]
                    tot["ops"] += n * work[name][1]
                    tot["max_abs_err"] = max(tot["max_abs_err"], err)
    for tot in total.values():
        tot["library_ms"] = library_ms
    return total


def phase_kernels(attn):
    """Phase 3: flash attention against its plain version; returns the
    per-forward totals of the main path's shapes, by (dtype, rows): bf16 at
    ROWS (the in-band batch of 4 clips), SERVE_ROWS (of the serving and
    fast configurations' 8) and V2F_ROWS (video to Foley's one clip, in
    and out of the band), f32 at ROWS (the same shapes in the training
    recipe's type) and EVAL_ROWS (evaluation's CFG batch of 10 clips)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(t, False) for t in ATTN_CALLS] + [(1000, False), (512, True)]
    runs = [(torch.bfloat16, ROWS, cases), (torch.float32, ROWS, cases)]
    runs += [(torch.bfloat16, rows, [(t, False) for t in ATTN_CALLS])
             for rows in (SERVE_ROWS, *V2F_ROWS)]
    runs.append((torch.float32, EVAL_ROWS, [(t, False) for t in ATTN_CALLS]))
    total = {(dtype, rows): {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                             "bytes": 0, "ops": 0, "max_abs_err": 0.0}
             for dtype, rows, _ in runs}
    for dtype, rows, run_cases in runs:
        for t, causal in run_cases:
            # q, k, v as the UNet makes them: views of one qkv projection
            qkv = torch.randn((rows, t, 3, HEADS, HEAD_DIM), generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
            o, lse = attn.flash_attention(q, k, v, causal, return_lse=True)
            o_ref, lse_ref = attn.attention_reference(q, k, v, causal, return_lse=True)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_l = (lse - lse_ref).abs().max().item()
            tol = TOL[dtype]
            ok = err_o <= tol["o"] and err_l <= tol["lse"]
            ms = time_ms(lambda: attn.flash_attention(q, k, v, causal), 20)
            plain = time_ms(lambda: attn.attention_reference(q, k, v, causal), 5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), 20)
            nbytes, ops = attention_work(rows, HEADS, t, HEAD_DIM, dtype, causal)
            bms, by = bound_ms(nbytes, ops, dtype)
            print(f"  flash_fwd {str(dtype)[6:]:8s} T={t:4d} causal={int(causal)} "
                  f"BH={rows * HEADS}: err O {err_o:.3e} (tol {tol['o']:.0e}) "
                  f"LSE {err_l:.3e} (tol {tol['lse']:.0e}) | kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms "
                  f"({by}) {'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"flash_fwd {dtype} BH={rows * HEADS} T={t} causal={causal} "
                      f"disagrees with its plain version")
            if not causal and t in ATTN_CALLS:
                n = ATTN_CALLS[t]
                tot = total[dtype, rows]
                tot["max_abs_err"] = max(tot["max_abs_err"], err_o)
                tot["ms"] += n * ms
                tot["plain_ms"] += n * plain
                tot["library_ms"] += n * lib
                tot["bytes"] += n * nbytes
                tot["ops"] += n * ops
    for (dtype, rows), tot in total.items():
        tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"], dtype)
        print(f"  flash_fwd {str(dtype)[6:]} per forward (9 calls, BH={rows * HEADS}): "
              f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, sdpa "
              f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
              f"({tot['bound_by']})", flush=True)
    return total


def ptxas_report(log: str) -> dict:
    """Registers, spilled bytes and static shared memory of each kernel in
    an ``nvcc -Xptxas=-v`` log, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit:
            out[name]["spill_stores"] = int(hit.group(1))
            out[name]["spill_loads"] = int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[name]["registers"] = int(hit.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def pick_ptxas(log: str, picks: dict) -> dict:
    """``{key: report}`` of the kernels in a compiler report whose mangled
    names contain the tags of ``picks`` (``{key: tag}``), one each."""
    kernels = ptxas_report(log)
    out = {}
    for key, tag in picks.items():
        found = [v for n_, v in kernels.items() if tag in n_]
        check(len(found) == 1, f"ptxas report has {len(found)} kernels named {tag}")
        out[key] = found[0]
    return out


# K1's two kernels in flash_fwd.cu (bf16: mma.sync m16n8k16; f32: 3xTF32 on
# mma.sync m16n8k8) and K2a's and K2b's in flash_bwd.cu, by input type
K1_KERNELS = {"bfloat16": "flash_fwd_tc_kernel", "float32": "flash_fwd_3xtf32_kernel"}
K2_KERNELS = {key: {"float32": f"{name}IfE", "bfloat16": f"{name}I13__nv_bfloat16E"}
              for key, name in (("dq", "flash_bwd_dq_kernel"),
                                ("dkv", "flash_bwd_dkv_kernel"))}


# the fused kernel's two bodies in fused_resblock.cu (bf16: mma.sync
# m16n8k16; f32: mma.sync m16n8k8 tf32 as 3xTF32), one instantiation per
# (TCO, RESIDUAL, STATS)
FUSED_KERNELS = {"bfloat16": "fused_resblock_tc_kernel",
                 "float32": "fused_resblock_3xtf32_kernel"}


def fused_ptxas(log: str, tag: str) -> dict:
    """The compiler report of each instantiation of one body of the fused
    kernel, by ``tco<N>_res<0|1>_stats<0|1>``."""
    out = {}
    for name, report in ptxas_report(log).items():
        hit = re.search(r"Li(\d+)ELb([01])ELb([01])E", name)
        if tag in name and hit:
            out[f"tco{hit.group(1)}_res{hit.group(2)}_stats{hit.group(3)}"] = report
    check(len(out) == 12, f"ptxas report has {len(out)} instantiations of {tag}")
    return out


def fused_work(b, c, cout, length, dtype, residual):
    """(bytes, operations) of K3 or K4 as a function: x (and the residual)
    read once, y written once, scale, shift, weights and bias read once;
    2 operations per multiply-add of the 3-tap conv."""
    esize = torch.tensor([], dtype=dtype).element_size()
    rows = b * length * (c + cout * (2 if residual else 1))
    return rows * esize + 4 * (2 * b * c + 3 * c * cout + cout), 6 * b * length * c * cout


def device_ms(fn, tag: str, calls: int = 10) -> tuple:
    """Device time per call of ``fn`` from torch.profiler's trace: of the
    kernels whose name holds ``tag``, and of every kernel the call runs;
    then the count of kernels and copies per call.  Unlike CUDA events
    around eager calls, it leaves out the time the card waits for the host
    between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    tagged = every = launches = 0.0
    for event in prof.key_averages():
        ms = event.self_device_time_total / 1e3 / calls
        every += ms
        launches += event.count / calls if ms > 0 else 0
        if tag in event.key:
            tagged += ms
    return tagged, every, launches


def phase_fused_kernels(fr, dtypes=(torch.bfloat16, torch.float32)):
    """Phase 3, the fused resnet chain: K3 and K4 against their plain
    versions at every shape of the chain, bf16 at B = 8 (the generation
    batch) and f32 at B = 4 (training), with a ragged (L = 1000) and a wide
    (C = 1024) case; x and the residual as the blocks pass them, (B, L, C)
    views of (B, C, L) tensors.  Returns the per-forward totals of the
    main path's shapes, by dtype (bf16: the generation forward at B = 8;
    f32: the fused training forward at B = 4), and K3's per-forward time
    with fused_resnet alone.  Besides the time of eager calls (CUDA events,
    the wrapper's host time included where the card waits for it), every
    shape gets its device time from the profiler (``device_ms``)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = ([("k3", c, co, n, False, per) for c, co, n, per, _ in K3_SHAPES]
             + [("k3", 64, 64, 1000, False, 0), ("k3", 1024, 1024, 256, False, 0)]
             + [("k4", c, co, n, r, per) for c, co, n, r, per in K4_SHAPES]
             + [("k4", 32, 32, 1000, True, 0), ("k4", 1024, 1024, 256, True, 0)])
    alone = {(c, co, n): a for c, co, n, _, a in K3_SHAPES}
    total = {dtype: {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
                         "ops": 0, "max_abs_err": 0.0, "device_ms": 0.0,
                         "device_ms_all": 0.0, "library_device_ms": 0.0}
                     for k in ("k3", "k4")} for dtype in dtypes}
    k3_alone_ms = 0.0
    rows_of = {torch.bfloat16: ROWS, torch.float32: TRAIN_ROWS}
    for dtype in dtypes:
        rows = rows_of[dtype]
        for kind, c, cout, length, residual, per in cases:
            x = randn(rows, c, length).to(dtype).transpose(1, 2)
            scale, shift = randn(rows, c) * 0.3 + 1.0, randn(rows, c) * 0.5
            w = (randn(3, c, cout) / math.sqrt(3 * c)).to(dtype)
            bias = randn(cout) * 0.1
            r = (randn(rows, cout, length).to(dtype).transpose(1, 2)
                 if residual else None)
            if kind == "k3":
                def run():
                    return fr.affine_silu_conv(x, scale, shift, w, bias)

                def plain():
                    return fr._reference(x, scale, shift, w, bias)
            else:
                def run():
                    return fr.affine_silu_conv_stats(x, scale, shift, w, bias, r,
                                                     FUSED_GROUPS)

                def plain():
                    return fr._stats_reference(x, scale, shift, w, bias, r,
                                               FUSED_GROUPS)
            got, want = run(), plain()
            torch.cuda.synchronize()
            y, y_ref = (got, want) if kind == "k3" else (got[0], want[0])
            err = (y.float() - y_ref.float()).abs().max().item()
            rel = err / y_ref.float().abs().max().item()
            rel_s = 0.0
            if kind == "k4":
                n = length * cout // FUSED_GROUPS
                rel_s = max(((got[1] - want[1]).abs()
                             / (n * want[2]).sqrt()).max().item(),
                            ((got[2] - want[2]).abs() / want[2]).max().item())
            ok = rel <= FUSED_TOL[dtype] and rel_s <= STATS_TOL
            ms = time_ms(run, 20)
            plain_ms = time_ms(plain, 5)
            # the library yardstick: the conv alone, on the input already
            # normalised and activated, in the compute dtype
            h = F.silu(x.float() * scale[:, None, :] + shift[:, None, :])
            h = h.to(dtype).transpose(1, 2).contiguous()
            wt, bt = w.permute(2, 1, 0).contiguous(), bias.to(dtype)
            lib = time_ms(lambda: F.conv1d(h, wt, bt, padding=1), 20)
            lib_dev = device_ms(lambda: F.conv1d(h, wt, bt, padding=1), "")[1]
            nbytes, ops = fused_work(rows, c, cout, length, dtype, residual)
            bms, by = bound_ms(nbytes, ops, dtype)
            dev = device_ms(run, "fused_resblock")
            print(f"  {kind} {str(dtype)[6:]:8s} B={rows} C={c:4d} Cout={cout:4d} "
                  f"L={length:6d} res={int(residual)}: err y {err:.3e} (rel "
                  f"{rel:.2e}, tol {FUSED_TOL[dtype]:.0e}) sums rel {rel_s:.2e} "
                  f"(tol {STATS_TOL:.0e}) | kernel {ms:.4f} ms (device {dev[0]:.4f}, "
                  f"with the wrapper's other kernels {dev[1]:.4f}), plain "
                  f"{plain_ms:.4f} ms, conv alone {lib:.4f} ms (device {lib_dev:.4f}), "
                  f"bound {bms:.4f} ms ({by}) {'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"{kind} {dtype} C={c} Cout={cout} L={length} disagrees "
                      f"with its plain version")
            if per:
                tot = total[dtype][kind]
                tot["ms"] += per * ms
                tot["device_ms"] += per * dev[0]
                tot["device_ms_all"] += per * dev[1]
                tot["plain_ms"] += per * plain_ms
                tot["library_ms"] += per * lib
                tot["library_device_ms"] += per * lib_dev
                tot["bytes"] += per * nbytes
                tot["ops"] += per * ops
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if dtype == torch.bfloat16 and kind == "k3":
                k3_alone_ms += alone.get((c, cout, length), 0) * ms
            del x, r, h, got, want
    for dtype in dtypes:
        for key, calls in (("k3", K3_PER_FORWARD), ("k4", K4_PER_FORWARD)):
            tot = total[dtype][key]
            tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"], dtype)
            print(f"  {key.upper()} per forward ({str(dtype)[6:]}, B={rows_of[dtype]}, "
                  f"{calls} calls): kernel {tot['ms']:.4f} ms (device "
                  f"{tot['device_ms']:.4f}, with the wrapper's other kernels "
                  f"{tot['device_ms_all']:.4f}), plain {tot['plain_ms']:.4f} ms, conv "
                  f"alone {tot['library_ms']:.4f} ms (device "
                  f"{tot['library_device_ms']:.4f}), bound {tot['bound_ms']:.4f} ms "
                  f"({tot['bound_by']})")
    print(f"  K3 with fused_resnet alone (20 calls) {k3_alone_ms:.4f} ms")
    return total, k3_alone_ms


def fused_times_of(root: str, dtypes=(torch.bfloat16,)) -> dict:
    """Phase 3's K3/K4 timings (eager, device, the conv alone; per forward),
    by dtype name, for the ``syncfusion_tpu_torch`` of another checkout at
    ``root``, e.g. a parent, measured by this script:
    ``python3 -c "import chip_smoke as c; print(c.fused_times_of('<root>'))"``.
    Call it in a fresh process, before anything imports the package."""
    sys.path.insert(0, os.path.abspath(root))
    from syncfusion_tpu_torch.ops import fused_resblock as fr

    torch.backends.cudnn.allow_tf32 = False
    total, _ = phase_fused_kernels(fr, dtypes=tuple(dtypes))
    return {str(dtype)[6:]: total[dtype] for dtype in dtypes}


def compare_fused_times(roots, dtypes=("float32",)) -> dict:
    """``fused_times_of`` for each checkout of ``roots``, each in a fresh
    process, in the order given (e.g. parent, tree, tree, parent, so that
    the card's drift falls on both sides); prints each run's per-call lines,
    then the per-forward device ms of K3 and K4 side by side, and returns
    ``{root: [times, ...]}``:
    ``python3 -c "import chip_smoke as c; c.compare_fused_times(['<parent>',
    '.', '.', '<parent>'])"``."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys, torch, chip_smoke as c; t = c.fused_times_of(sys.argv[1], "
            "[getattr(torch, d) for d in sys.argv[2:]]); "
            "print('FUSED_TIMES ' + json.dumps(t))")
    out = {}
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", code, os.path.abspath(root),
                               *dtypes], cwd=here, capture_output=True, text=True)
        check(proc.returncode == 0, f"fused times of {root}:\n{proc.stdout[-3000:]}"
                                    f"\n{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        print(f"  {root}:\n" + "\n".join(ln for ln in lines if ln.startswith("  k")),
              flush=True)
        line = [ln for ln in lines if ln.startswith("FUSED_TIMES ")]
        out.setdefault(root, []).append(json.loads(line[-1][len("FUSED_TIMES "):]))
    for dtype in dtypes:
        for key in ("k3", "k4"):
            print(f"  {key.upper()} {dtype} per forward, device ms (with the wrapper's "
                  f"other kernels; eager ms), by checkout: " + "; ".join(
                      f"{root}: " + ", ".join(
                          f"{t[dtype][key]['device_ms']:.4f} ({t[dtype][key]['device_ms_all']:.4f}; "
                          f"{t[dtype][key]['ms']:.4f})" for t in runs)
                      for root, runs in out.items()), flush=True)
    return out


def fused_model_cfg() -> dict:
    """exp/model/diffusion.yaml's model node with the fused configuration
    on: ``model.fused_resnet``, ``model.fused_stats``, ``fold_cap``."""
    from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig

    return {"model": {**dataclasses.asdict(UNetConfig()), **FUSED_SWITCHES},
            "onsets_encoder": dataclasses.asdict(EncoderConfig()),
            "fold_cap": FOLD_CAP}


def kernel_vs_plain(model, attn, blocks, noise, onsets, embedding,
                    attend=None, **sample_kw) -> torch.Tensor:
    """A sample through the kernel (or ``attend``, which calls it) and
    through the plain attention: by default 2 sampler steps (one out of the
    band, one in it), else ``sample_kw``; |diff| / max |plain| of every
    output sample."""
    attns = [m for m in model.modules() if isinstance(m, blocks.SelfAttention1d)]
    sample_kw = sample_kw or dict(num_steps=2, embedding_scale=SCALE,
                                  guidance_interval=BAND)

    def run(fn):
        for m in attns:
            if fn is not None:
                m.attend = fn
        out = model.sample(noise, onsets, embedding, **sample_kw)
        for m in attns:
            m.__dict__.pop("attend", None)
        return out

    a = run(attend)
    b = run(attn.attention_reference)
    return ((a - b).abs() / b.abs().max()).flatten()


def rounding_census(attn):
    """An ``attend`` for ``kernel_vs_plain`` that returns the kernel's O and
    counts, over its calls, the O elements where the kernel's rounding
    differs from the plain version's and where the plain version's differs
    from the same attention computed in f64; returns (attend, counts)."""
    counts = {"elements": 0, "kernel_vs_plain": 0, "plain_vs_f64": 0,
              "max_abs_o": 0.0}

    def attend(q, k, v, causal=False):
        o = attn.flash_attention(q, k, v, causal)
        ref = attn.attention_reference(q, k, v, causal)
        ref64 = attn.attention_reference(q.double(), k.double(), v.double(),
                                         causal).to(q.dtype)
        counts["elements"] += o.numel()
        counts["kernel_vs_plain"] += int((o != ref).sum())
        counts["plain_vs_f64"] += int((ref != ref64).sum())
        counts["max_abs_o"] = max(counts["max_abs_o"], ref.abs().max().item())
        return o

    return attend, counts


def bf16_cross_check(model, attn, blocks, noise, onsets, embedding) -> dict:
    """Phase 5 in bf16: 2 sampler steps through the kernel against the
    plain attention; the output's max and 99.9th percentile of |diff| /
    max |plain|, and the census of ``rounding_census`` with the share of
    flipped O elements."""
    census, rounded = rounding_census(attn)
    diff = kernel_vs_plain(model, attn, blocks, noise, onsets, embedding, census)
    return dict(rounded, max=diff.max().item(),
                p999=torch.quantile(diff[:2**24].float(), 0.999).item(),
                share=rounded["kernel_vs_plain"] / rounded["elements"])


def bf16_cross_check_of(root: str) -> dict:
    """``bf16_cross_check`` of the ``syncfusion_tpu_torch`` of another
    checkout at ``root``, at phase 5's weights and inputs: how PERF.md
    reads the flip share of an earlier kernel or of a control, e.g.
    ``python3 -c "import chip_smoke as c; print(c.bf16_cross_check_of('<root>'))"``.
    Call it in a fresh process, before anything imports the package."""
    sys.path.insert(0, os.path.abspath(root))
    from syncfusion_tpu_torch.models import blocks
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.ops import attention as attn
    model = SyncFusionDiffusion.from_config(None, dtype=torch.bfloat16,
                                            device="cuda", seed=0)
    return bf16_cross_check(model, attn, blocks, *sampler_inputs())


def sampler_inputs(batch: int = BATCH) -> tuple:
    """Noise, onsets (one a clip) and text embedding of ``batch`` clips."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.randn((batch, LENGTH, 1), generator=gen, device="cuda")
    onsets = torch.zeros((batch, LENGTH, 1), device="cuda")
    onsets[torch.arange(batch), torch.arange(batch) * 9600 + 4800, 0] = 1.0
    embedding = torch.randn((batch, 1, 512), generator=gen, device="cuda")
    return noise, onsets, embedding


def full_forwards(num_steps: int, interval: int) -> int:
    """UNet forwards that run whole in a banded sample with DeepCache
    ``interval``: the refreshes of every band segment (the sampler's own
    ``band_segments`` and ``deep_cache_refresh_mask``)."""
    from syncfusion_tpu_torch.models.diffusion import band_segments, deep_cache_refresh_mask

    return sum(sum(deep_cache_refresh_mask(end - start, interval))
               for start, end, _ in band_segments(num_steps, *BAND))


def time_generation(model, attn, fr, label: str, inputs: tuple, want: dict,
                    **sample_kw) -> tuple:
    """One warm-up and ``TIMED_RUNS`` runs of ``model.sample`` on
    ``inputs``, each on the host clock up to ``torch.cuda.synchronize()``
    with the counts zeroed just before it; every run's launch counts must be
    ``want`` (names absent from it: 0).  Prints each run, the median and the
    range; returns (the last output, seconds of the timed runs, the last
    run's counts)."""
    noise, onsets, embedding = inputs
    batch = noise.shape[0]
    seconds = []
    for run in range(TIMED_RUNS + 1):
        torch.cuda.reset_peak_memory_stats()
        reset_counts(attn, fr)
        start = time.perf_counter()
        out = model.sample(noise, onsets, embedding, **sample_kw)
        torch.cuda.synchronize()
        took = time.perf_counter() - start
        launched = counts(attn, fr)
        check(tuple(out.shape) == (batch, LENGTH, 1), f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        expected = {name: want.get(name, 0) for name in launched}
        check(launched == expected, f"{label}: launch counts {launched} != {expected}")
        print(f"  {label}, {'warm-up' if run == 0 else f'run {run}'}: {took:.3f} s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"rms {out.float().pow(2).mean().sqrt().item():.4f}", flush=True)
        if run:
            seconds.append(took)
    rate = [batch * LENGTH / SR / 8.0 / t_ * 60 for t_ in seconds]
    print(f"  {label}: {batch} clips of {LENGTH} samples, median {statistics.median(seconds):.3f} "
          f"s (range {min(seconds):.3f}-{max(seconds):.3f}) over {TIMED_RUNS} warm runs, "
          f"8-s clips/min median {statistics.median(rate):.3f} (range "
          f"{min(rate):.3f}-{max(rate):.3f}); launches per run {launched}")
    return out, seconds, launched


def forward_full_vs_cached(model, attn, fr, inputs: tuple) -> dict:
    """One in-band UNet forward at the CFG batch of ``inputs`` (2B rows,
    the unconditional half masked), whole and on a DeepCache feature at
    ``DEEP_SPLIT``: device ms from the profiler (every kernel) and eager ms
    (CUDA events), and K1's launches per forward."""
    noise, onsets, embedding = inputs
    b = noise.shape[0]
    out = {}
    with torch.no_grad():
        context = [torch.cat([c, c]) for c in model.encode_context(onsets)]
        mask = torch.cat([torch.zeros(b, 1, 1), torch.ones(b, 1, 1)]).to(noise.device)
        kw = dict(context=context, embedding_cfg_mask=mask,
                  embedding=torch.cat([embedding, torch.zeros_like(embedding)]))
        x = torch.cat([noise, noise])
        sigma = torch.full((2 * b,), 0.5, device=noise.device)
        _, deep = model.unet(x, sigma, deep_split=DEEP_SPLIT, return_deep=True, **kw)
        forwards = {"full": lambda: model.unet(x, sigma, **kw),
                    "cached": lambda: model.unet(x, sigma, deep_split=DEEP_SPLIT,
                                                 deep_cache=deep, **kw)}
        for name, fn in forwards.items():
            reset_counts(attn, fr)
            fn()
            out[f"{name}_k1"] = counts(attn, fr)["kernel_launches"]
            out[f"{name}_device_ms"] = device_ms(fn, "", calls=3)[1]
            out[f"{name}_eager_ms"] = time_ms(fn, 3, warmup=1)
    return out


def write_shard(path: str, tracks: int = 4, seconds: float = 12.0,
                every: float = 0.25, seed: int = 0, first: float = 0.01,
                burst: float = 0.0) -> None:
    """A webdataset shard of noise tracks at 48 kHz with an onset every
    ``every`` seconds from ``first``, so that every 2^18-sample chunk has
    onsets; ``burst`` > 0 adds a decaying noise burst of that amplitude at
    each onset, which the onset detector finds."""
    from syncfusion_tpu_torch.ops.wav import write_wav

    rng = np.random.default_rng(seed)
    decay = np.exp(-np.arange(4800) / 1200.0)
    with tempfile.TemporaryDirectory() as tmp, tarfile.open(path, "w") as tar:
        for i in range(tracks):
            wav = 0.1 * rng.standard_normal(int(seconds * SR))
            onsets = np.arange(first, seconds, every)
            if burst:
                for x in onsets:
                    at = int(x * SR)
                    n = min(decay.size, wav.size - at)
                    wav[at:at + n] += burst * decay[:n] * rng.standard_normal(n)
            wav = wav.astype(np.float32)
            write_wav(os.path.join(tmp, "a.wav"), wav, SR)
            with open(os.path.join(tmp, "a.wav"), "rb") as f:
                audio = f.read()
            times = "".join(f"{x:.4f},hit\n" for x in onsets)
            for name, body in ((f"track{i}.resampled.wav", audio),
                               (f"track{i}.times.csv", times.encode())):
                info = tarfile.TarInfo(name)
                info.size = len(body)
                tar.addfile(info, io.BytesIO(body))


def counts(attn, fr) -> dict:
    """Every kernel's launch count and every plain version's call count:
    K1, K2a, K2b (``attn``), K3 and K4 (``fr``)."""
    out = {name: getattr(attn.flash_attention, name) for name in attn.COUNTS}
    for key, fn in (("k3", fr.affine_silu_conv), ("k4", fr.affine_silu_conv_stats)):
        out.update({f"{key}_{name}": getattr(fn, name) for name in fr.COUNTS})
    return out


def reset_counts(attn, fr) -> None:
    attn.reset_counts()
    fr.reset_counts()


def phase_train(attn, fr, tmp: str, name: str, model_cfg=None, embedder="none",
                steps: int = TRAIN_STEPS):
    """Phases 6, 10 and 14c: the training command line at full width, f32,
    ``steps`` micro-steps, with the default model or ``model_cfg`` (passed
    as ``--model_config``), and ``--embedder embedder`` (None: the default,
    CLAP).  Returns (final state, launch counts, seconds per micro-step,
    peak GiB)."""
    from syncfusion_tpu_torch import train_diffusion
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer

    shard = os.path.join(tmp, "shard.tar")
    if not os.path.exists(shard):
        write_shard(shard)
    logs = os.path.join(tmp, name)
    args = ["--train_path", shard, "--val_path", shard, "--logs_dir", logs,
            "--precision", "32", "--batch_size", str(BATCH), "--length", str(LENGTH),
            "--accumulate_grad_batches", str(ACCUMULATE),
            "--max_steps", str(steps), "--log_every_n_steps", "1",
            "--val_check_interval", str(steps), "--val_batches", "1",
            "--num_items", str(SAMPLE_ITEMS), "--sampling_steps", str(SAMPLE_STEPS),
            "--device", "cuda"]
    if embedder is not None:
        args += ["--embedder", embedder]
    if model_cfg is not None:
        path = os.path.join(tmp, f"{name}.json")
        with open(path, "w") as f:
            json.dump(model_cfg, f)
        args += ["--model_config", path]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(attn, fr)
    state = train_diffusion.main(args)
    torch.cuda.synchronize()
    launched = counts(attn, fr)
    peak = torch.cuda.max_memory_allocated() / 2**30
    (run,) = os.listdir(os.path.join(logs, "runs"))
    run = os.path.join(logs, "runs", run)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train_loss" in r]
    valid = [r["valid_loss"] for r in recs if "valid_loss" in r]
    losses = [r["train_loss"] for r in train]
    print(f"  train losses {['%.5f' % x for x in losses]}, valid loss "
          f"{['%.5f' % x for x in valid]}, sec per micro-step "
          f"{['%.3f' % r['sec_per_step'] for r in train]}")
    check(state.step == steps and len(losses) == steps,
          f"took {state.step} micro-steps, logged {len(losses)}")
    check(all(math.isfinite(x) for x in losses + valid), "non-finite loss")
    # a wav and a mel panel per clip; the panels need PIL, which the card's
    # machine does not promise (the sample logger logs their failure)
    media = sorted(os.listdir(os.path.join(run, "media")))
    wavs = [m for m in media if m.endswith(".wav")]
    pngs = [m for m in media if m.endswith(".png")]
    has_pil = importlib.util.find_spec("PIL") is not None
    check(len(wavs) == SAMPLE_ITEMS and len(pngs) == SAMPLE_ITEMS * has_pil,
          f"sample logger wrote {media}")
    saved = Checkpointer(CheckpointConfig(os.path.join(run, "ckpts"))).restore()
    state.model.load_state_dict(saved["model"], strict=True)
    check(saved["step"] == steps and saved["optimizer"]["adamw"]["state"],
          "checkpoint lacks the step or the optimizer state")
    # forwards: one per micro-step, one validation batch, one per sampler
    # step (CFG runs both branches as one forward); backwards: one per
    # micro-step
    forwards, backwards = steps + 1 + SAMPLE_STEPS, steps
    fused = model_cfg is not None
    want = {"kernel_launches": 9 * forwards, "dq_launches": 9 * backwards,
            "dkv_launches": 9 * backwards, "plain_calls": 0, "plain_bwd_calls": 0,
            "k3_kernel_launches": K3_PER_FORWARD * forwards if fused else 0,
            "k3_plain_calls": 0,
            "k4_kernel_launches": K4_PER_FORWARD * forwards if fused else 0,
            "k4_plain_calls": 0}
    print(f"  launches {launched} (expected {want}), peak memory {peak:.3f} GiB")
    check(launched == want, f"launch counts {launched} != {want}")
    sec = statistics.median(r["sec_per_step"] for r in train[1:])
    return state, launched, sec, peak


def training_batch(tmp: str) -> tuple:
    """One full-width batch of the phase-6 shard with sigma, noise and an
    embedding: (wav, onsets, embedding, sigma, noise), on the card."""
    from syncfusion_tpu_torch.data.sfx_dataset import batched, create_sfx_dataset

    items = create_sfx_dataset(os.path.join(tmp, "shard.tar"), sample_rate=SR,
                               chunk_size=LENGTH, one_chunk_per_track=False)
    b = next(batched(items, batch_size=BATCH))
    gen = torch.Generator(device="cuda").manual_seed(3)
    wav = torch.from_numpy(b["wav"]).cuda()
    onsets = torch.from_numpy(b["onsets"]).cuda()
    emb = torch.randn((BATCH, 1, 512), generator=gen, device="cuda")
    sigma = torch.rand((BATCH,), generator=gen, device="cuda")
    noise = torch.randn(wav.shape, generator=gen, device="cuda")
    return wav, onsets, emb, sigma, noise


def loss_and_grads(model, batch) -> tuple:
    """One loss and the gradient of every parameter, by name."""
    wav, onsets, emb, sigma, noise = batch
    for p in model.parameters():
        p.grad = None
    loss = model.loss(wav, onsets, emb, sigma=sigma, noise=noise)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


def grad_gaps(grads, grads_ref) -> list:
    """Per tensor, sorted worst first: (max |g - g_ref| / max(max |g_ref|,
    GRAD_FLOOR · the largest gradient), max |g_ref|, name, unfloored)."""
    top = max(g.abs().max().item() for g in grads_ref.values() if g is not None)
    floor = GRAD_FLOOR * top
    rows = []
    for name, gp in grads_ref.items():
        g = grads[name]
        check((g is None) == (gp is None), f"{name}: gradient on one side only")
        if gp is not None:
            scale = gp.abs().max().item()
            diff = (g - gp).abs().max().item()
            rows.append((diff / max(scale, floor), scale, name,
                         diff / scale if scale > 0 else 0.0))
    return sorted(rows, reverse=True)


def print_gaps(label: str, rows) -> None:
    raw = max(rows, key=lambda row: row[3])
    print(f"  {label}: worst floored {rows[0][0]:.2e} ({rows[0][2]}), worst "
          f"unfloored {raw[3]:.2e} ({raw[2]}, max |g| {raw[1]:.2e})")


def train_vs_plain(model, attn, fr, blocks, tmp: str):
    """Phase 7: one f32 loss and gradient through the kernels and through
    the plain attention, same batch, sigma and noise.  Returns (relative
    loss difference, max over tensors of max |dg| / max(max |g_plain|,
    GRAD_FLOOR · the largest gradient)).  A second plain run shows the
    run-to-run rounding of the same computation (printed)."""
    batch = training_batch(tmp)
    reset_counts(attn, fr)
    loss_k, grads_k = loss_and_grads(model, batch)
    launched = counts(attn, fr)
    check(launched["kernel_launches"] == launched["dq_launches"]
          == launched["dkv_launches"] == 9, f"cross-check launches {launched}")
    attns = [m for m in model.modules() if isinstance(m, blocks.SelfAttention1d)]
    for m in attns:
        m.attend = attn.attention_reference
    loss_p, grads_p = loss_and_grads(model, batch)
    _, grads_p2 = loss_and_grads(model, batch)
    for m in attns:
        del m.attend
    rels, rerun = grad_gaps(grads_k, grads_p), grad_gaps(grads_p2, grads_p)
    top = max(row[1] for row in rels)
    floored = sum(row[1] < GRAD_FLOOR * top for row in rels)
    print(f"  largest gradient {top:.3e}; {floored} of {len(rels)} tensors have "
          f"max |g| below {GRAD_FLOOR:.0e} of it; worst: " + ", ".join(
              f"{n_} {r:.2e} (max |g| {g:.2e})" for r, g, n_, _ in rels[:3]))
    print_gaps("kernels vs plain", rels)
    print_gaps("plain vs plain, run to run", rerun)
    return abs(loss_k - loss_p) / abs(loss_p), rels[0][0]


def fused_vs_plain(attn, fr, noise, onsets, embedding, tmp: str):
    """Phase 9, f32, the same weights: 2 sampler steps, a DeepCache DDIM
    sample (``CACHED_CHECK``) and one loss and gradient of the fused model
    against the plain one.  Returns (sampling max |diff| / max |plain|, the
    same of the cached sample, relative loss difference, worst floored
    gradient gap)."""
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion

    plain = SyncFusionDiffusion.from_config(None, dtype=torch.float32,
                                            device="cuda", seed=0)
    fused = SyncFusionDiffusion.from_config(fused_model_cfg(), dtype=torch.float32,
                                            device="cuda", seed=0)
    fused.load_state_dict(plain.state_dict(), strict=True)

    def two_steps(model):
        return model.sample(noise, onsets, embedding, num_steps=2,
                            embedding_scale=SCALE, guidance_interval=BAND)

    reset_counts(attn, fr)
    a = two_steps(fused)
    launched = counts(attn, fr)
    # 2 steps, one out of the band (B rows) and one in it (2B rows)
    check(launched["k3_kernel_launches"] == 2 * K3_PER_FORWARD
          and launched["k4_kernel_launches"] == 2 * K4_PER_FORWARD
          and launched["k3_plain_calls"] == launched["k4_plain_calls"] == 0,
          f"fused sampling launches {launched}")
    b = two_steps(plain)
    rel_sample = ((a - b).abs().max() / b.abs().max()).item()

    reset_counts(attn, fr)
    a = fused.sample(noise, onsets, embedding, **CACHED_CHECK)
    launched = counts(attn, fr)
    forwards = CACHED_CHECK["num_steps"]
    check(launched["kernel_launches"] == CACHED_CHECK_K1
          and launched["k3_kernel_launches"] == forwards * K3_PER_FORWARD
          and launched["k4_kernel_launches"] == forwards * K4_PER_FORWARD
          and launched["k3_plain_calls"] == launched["k4_plain_calls"] == 0,
          f"fused cached sampling launches {launched}")
    b = plain.sample(noise, onsets, embedding, **CACHED_CHECK)
    rel_cached = ((a - b).abs().max() / b.abs().max()).item()

    batch = training_batch(tmp)
    reset_counts(attn, fr)
    loss_f, grads_f = loss_and_grads(fused, batch)
    launched = counts(attn, fr)
    check(launched["k3_kernel_launches"] == K3_PER_FORWARD
          and launched["k4_kernel_launches"] == K4_PER_FORWARD
          and launched["k3_plain_calls"] == launched["k4_plain_calls"] == 0,
          f"fused training launches {launched}")
    loss_p, grads_p = loss_and_grads(plain, batch)
    rels = grad_gaps(grads_f, grads_p)
    print(f"  fused vs plain loss {loss_f:.6f} / {loss_p:.6f}")
    print_gaps("fused vs plain gradients", rels)
    return rel_sample, rel_cached, abs(loss_f - loss_p) / abs(loss_p), rels[0][0]


def onset_batches(n: int, seed: int, shape=(ONSET_BATCH, ONSET_T, ONSET_HW, ONSET_HW, 3)):
    """``n`` seeded host batches on the uint8 wire: frames and labels with
    2 onset frames drawn per chunk (fewer where they coincide)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        label = np.zeros(shape[:2], np.float32)
        label[np.arange(shape[0])[:, None], rng.integers(0, shape[1], (shape[0], 2))] = 1.0
        yield {"frames": rng.integers(0, 256, shape, dtype=np.uint8), "label": label}


def phase_onset_train(tmp: str, precision: str) -> float:
    """Phase 11 in one precision: ``ONSET_WARMUP + ONSET_TIMED`` steps of
    the full-width onset net through ``train_onset.fit_epoch``, logging
    every step; then the checkpoint round trip and the eval forward's rate.
    Prints them; returns the median seconds per step."""
    from syncfusion_tpu_torch import train_onset
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
    from syncfusion_tpu_torch.core.config import OnsetConfig
    from syncfusion_tpu_torch.core.logging import MetricLogger
    from syncfusion_tpu_torch.models.onset_net import VideoOnsetNet

    cfg = OnsetConfig.from_dict({"model": {"precision": precision},
                                 "trainer": {"seed": 0, "log_every_n_steps": 1}})
    trainer = train_onset.build_trainer(cfg, "cuda")
    state = trainer.create_state()
    buffers = {k: v.clone() for k, v in trainer.model.named_buffers()}
    run = os.path.join(tmp, f"onset_{precision}")
    logger = MetricLogger(run)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    steps = train_onset.fit_epoch(trainer, state,
                                  onset_batches(ONSET_WARMUP + ONSET_TIMED, 0),
                                  "cuda", logger, 1, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    logger.close()
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss/train"] for r in recs]
    secs = [r["sec_per_step"] for r in recs][ONSET_WARMUP:]
    check(steps == state.step == ONSET_WARMUP + ONSET_TIMED and len(secs) == ONSET_TIMED,
          f"onset {precision}: took {steps} steps, logged {len(recs)}")
    check(all(math.isfinite(x) for x in losses), f"onset {precision}: non-finite loss")
    moved = [k for k, v in trainer.model.named_buffers() if not torch.equal(v, buffers[k])]
    check(len(moved) == len(buffers), f"onset {precision}: {len(buffers) - len(moved)} "
          "BatchNorm buffers did not move")
    ckpt = Checkpointer(CheckpointConfig(os.path.join(run, "ckpts"), monitor="loss/val"))
    ckpt.save(state.step, state.state_dict(), {"loss/val": losses[-1]})
    saved = ckpt.restore()
    fresh = VideoOnsetNet(dtype=train_onset.PRECISIONS[precision])
    fresh.load_state_dict(saved["model"], strict=True)
    check(all(torch.equal(v.cpu(), saved["model"][k])
              for k, v in trainer.model.state_dict().items()),
          f"onset {precision}: the checkpoint does not hold the model")
    frames = torch.from_numpy(next(onset_batches(1, 2))["frames"]).cuda()
    for _ in range(2):
        trainer.forward(state, frames)
    infer_s = []
    for _ in range(TIMED_RUNS):
        start = time.perf_counter()
        logits = trainer.forward(state, frames)
        torch.cuda.synchronize()
        infer_s.append(time.perf_counter() - start)
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (ONSET_BATCH, ONSET_T),
          f"onset {precision}: eval logits")
    med, infer = statistics.median(secs), statistics.median(infer_s)
    print(f"  onset training, {precision}, B={ONSET_BATCH}x{ONSET_T}x{ONSET_HW}x{ONSET_HW}: "
          f"losses {['%.5f' % x for x in losses]}; {med:.4f} s per step (median of "
          f"steps {ONSET_WARMUP + 1}-{ONSET_WARMUP + ONSET_TIMED}, range {min(secs):.4f}-"
          f"{max(secs):.4f}), {ONSET_BATCH / med:.3f} chunks/s, peak memory "
          f"{peak:.3f} GiB; eval forward of {ONSET_BATCH} chunks: median {infer:.4f} s "
          f"over {TIMED_RUNS} ({ONSET_BATCH / infer:.3f} chunks/s); "
          f"{trainer.model.param_count():,} params; card {smi()}")
    del trainer, state
    torch.cuda.empty_cache()
    return med


def onset_cross_check() -> dict:
    """Phase 12: the full-width onset net in f32 on the card and on the CPU
    (TF32 is off for the whole run), same weights and input; the gated
    gradients from a CPU run that takes the card's ReLU masks, the printed
    ones also from a CPU run that takes its own, whose masks give the gated
    share of ReLU inputs that change sign."""
    import copy

    from syncfusion_tpu_torch.models.onset_net import ReluTape, VideoOnsetNet
    from syncfusion_tpu_torch.train.onset_trainer import OnsetTrainer, bc_loss

    cpu = VideoOnsetNet().init(0)
    gpu = copy.deepcopy(cpu).cuda()
    batch = next(onset_batches(1, 3, ONSET_CHECK_SHAPE))
    x = OnsetTrainer.prep_frames(torch.from_numpy(batch["frames"]))
    y = torch.from_numpy(batch["label"])
    with torch.no_grad():
        want = cpu.eval()(x)
        got = gpu.eval()(x.cuda()).cpu()
    rel_logits = ((got - want).abs().max() / want.abs().max()).item()

    def loss_and_grads(net, frames, labels, tape):
        with tape:
            net.train().zero_grad()
            loss = bc_loss(net(frames), labels)
            loss.backward()
        return loss.item(), {k: p.grad.cpu() for k, p in net.named_parameters()}

    buffers_c = {k: b.clone() for k, b in cpu.named_buffers()}
    card_tape, own_tape = ReluTape(), ReluTape()
    loss_g, grads_g = loss_and_grads(gpu, x.cuda(), y.cuda(), card_tape)
    start = time.perf_counter()
    loss_c, grads_c = loss_and_grads(cpu, x, y, ReluTape(replay=card_tape))
    cpu_s = time.perf_counter() - start
    buffers = dict(cpu.named_buffers())
    rel_buffers = max(((b.cpu() - buffers[k]).abs().max() / buffers[k].abs().max()).item()
                      for k, b in gpu.named_buffers())
    for k, b in buffers.items():  # the second CPU run starts where the first did
        b.copy_(buffers_c[k])
    _, grads_own = loss_and_grads(cpu, x, y, own_tape)
    flips, elements = card_tape.flips(own_tape)
    gaps = grad_gaps(grads_g, grads_c)
    own_gaps = grad_gaps(grads_g, grads_own)
    out = {"logits": rel_logits, "loss": abs(loss_g - loss_c) / abs(loss_c),
           "grads": gaps[0][0], "buffers": rel_buffers, "flips": flips / elements}
    print(f"  onset f32, card vs CPU, B={ONSET_CHECK_SHAPE[0]}x{ONSET_CHECK_SHAPE[1]}x"
          f"{ONSET_CHECK_SHAPE[2]}x{ONSET_CHECK_SHAPE[3]}: logits {out['logits']:.3e}, "
          f"loss {out['loss']:.3e} (tol {ONSET_TOL:.0e}), buffers after the train "
          f"forward {out['buffers']:.3e} (tol {ONSET_TOL:.0e}), gradients on the card's "
          f"ReLU masks {out['grads']:.3e} (tol {TRAIN_GRAD_TOL:.0e}), on the CPU's own "
          f"{own_gaps[0][0]:.3e} (not gated); {flips} of {elements:,} ReLU inputs "
          f"change sign, a share of {out['flips']:.3e} (tol {ONSET_FLIP_TOL:.0e}); "
          f"the CPU's loss and gradient took {cpu_s:.1f} s")
    print_gaps("onset gradients, card vs CPU on the card's ReLU masks", gaps)
    print_gaps("onset gradients, card vs CPU on its own ReLU masks", own_gaps)
    return out


def phase_video_to_foley(attn, fr) -> dict:
    """Phase 13: ``video_to_foley.onset_times`` on 3 seeded uint8 chunks of
    one 6-s video (the full-width onset net in f32 without TF32, as
    ``video_to_foley.main`` runs it), the onset track, and one
    clip at the fast point; one warm-up and ``TIMED_RUNS`` runs, each
    timed in two parts and gated: the times are those the logits of one
    batched forward give (raw logit > 0.5, deduplicated), the clip is
    finite, K1 launched 153 times.  Returns the last run's counts, the
    chunks, the onset net's state dict and the onset times."""
    from syncfusion_tpu_torch import video_to_foley
    from syncfusion_tpu_torch.eval.onset_annotations import dedup_consecutive
    from syncfusion_tpu_torch.generate import onset_track
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.train.onset_trainer import OnsetTrainer

    rng = np.random.default_rng(4)
    chunks = [{"frames": rng.integers(0, 256, (ONSET_T, ONSET_HW, ONSET_HW, 3),
                                      dtype=np.uint8),
               "start_frame": ONSET_T * i, "frame_rate": 15.0} for i in range(3)]
    net = video_to_foley.load_onset_net(None, (2, 2, 2, 2), "cuda", seed=0)
    # random weights put every logit of these frames below the threshold:
    # move fc2's bias so that their median logit is the threshold, and half
    # the frames are onsets before the dedup
    with torch.no_grad():
        frames = torch.from_numpy(np.stack([c["frames"] for c in chunks])).cuda()
        logits = net(OnsetTrainer.prep_frames(frames)).float()
        net.fc2.bias += 0.5 - logits.median()
        logits = net(OnsetTrainer.prep_frames(frames)).float().cpu().numpy()
    want = sorted((k + c["start_frame"]) / c["frame_rate"] for c, row in zip(chunks, logits)
                  for k in dedup_consecutive(np.flatnonzero(row > 0.5).tolist()))
    model = SyncFusionDiffusion.from_config(None, dtype=torch.bfloat16, device="cuda",
                                            seed=0)
    embedding = torch.zeros((1, 1, model.unet.cfg.embedding_features), device="cuda")
    onset_s, gen_s = [], []
    for run in range(TIMED_RUNS + 1):
        reset_counts(attn, fr)
        start = time.perf_counter()
        times = video_to_foley.onset_times(net, chunks, "cuda")
        torch.cuda.synchronize()
        mid = time.perf_counter()
        onsets = torch.from_numpy(onset_track(times, LENGTH)).cuda()
        gen = torch.Generator(device="cuda").manual_seed(run)
        noise = torch.randn((1, LENGTH, 1), generator=gen, device="cuda")
        wav = model.sample(noise, onsets, embedding, sampler="dpm", num_steps=FAST_STEPS,
                           embedding_scale=FAST_SCALE, guidance_interval=BAND,
                           deep_cache_interval=FAST_K, deep_split=DEEP_SPLIT)
        torch.cuda.synchronize()
        end = time.perf_counter()
        launched = counts(attn, fr)
        expected = {name: FAST_K1 if name == "kernel_launches" else 0 for name in launched}
        check(len(times) > 0 and times.tolist() == want,
              f"video to Foley: onset times {times} != {want}")
        check(int(onsets.sum()) == int(np.sum((times * SR).astype(int) < LENGTH)),
              "video to Foley: the onset track holds the onsets of its 2^18 samples")
        check(tuple(wav.shape) == (1, LENGTH, 1) and bool(torch.isfinite(wav).all()),
              f"video to Foley: output {tuple(wav.shape)}")
        check(launched == expected, f"video to Foley: launch counts {launched} != {expected}")
        print(f"  video to Foley, {'warm-up' if run == 0 else f'run {run}'}: {len(times)} "
              f"onsets from 3 chunks in {mid - start:.3f} s, generation {end - mid:.3f} s, "
              f"rms {wav.float().pow(2).mean().sqrt().item():.4f}", flush=True)
        if run:
            onset_s.append(mid - start)
            gen_s.append(end - mid)
    total = [a + b for a, b in zip(onset_s, gen_s)]
    print(f"  video to Foley per clip over {TIMED_RUNS} runs: median {statistics.median(total):.3f} s "
          f"(range {min(total):.3f}-{max(total):.3f}): onset {statistics.median(onset_s):.4f} s "
          f"(range {min(onset_s):.4f}-{max(onset_s):.4f}, {3 / statistics.median(onset_s):.2f} "
          f"chunks/s), generation {statistics.median(gen_s):.3f} s (range "
          f"{min(gen_s):.3f}-{max(gen_s):.3f}); launches per run {launched}")
    net_state = {k: v.cpu() for k, v in net.state_dict().items()}
    del net, model
    torch.cuda.empty_cache()
    return launched, chunks, net_state, want


def time_calls(fn, runs: int = TIMED_RUNS) -> list:
    """One warm-up and ``runs`` calls of ``fn``, each on the host clock up
    to ``torch.cuda.synchronize()``: the seconds of the timed calls."""
    secs = []
    for run in range(runs + 1):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if run:
            secs.append(time.perf_counter() - start)
    return secs


def spread(secs: list, scale: float = 1e3) -> str:
    return (f"median {statistics.median(secs) * scale:.3f} (range "
            f"{min(secs) * scale:.3f}-{max(secs) * scale:.3f})")


def phase_clap() -> dict:
    """Phases 14a and 14b: ``ClapEmbedder`` with seeded weights on the card;
    ``embed_audio`` timed on the training batch's conditioning chunks
    (B = 4 x 2^18 samples, repeat-padded to 10 s) and on one, ``embed_text``
    on 1 and 4 prompts; then the same weights on the CPU, B = 1: audio and
    text embeddings and the dB mel against the card's, gated.  Returns the
    errors."""
    from syncfusion_tpu_torch.models.clap.htsat import CLAP_SAMPLES, clap_mel, prepare_audio
    from syncfusion_tpu_torch.models.clap.model import ClapEmbedder, ClapModel
    from syncfusion_tpu_torch.ops.quantize import float32_to_int16

    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    emb = ClapEmbedder(device="cuda", seed=0)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in emb.model.parameters())
    print(f"  CLAP on the card: {params:,} parameters (HTSAT-tiny "
          f"{sum(p.numel() for p in emb.model.audio_branch.parameters()):,}, roberta-base "
          f"{sum(p.numel() for p in emb.model.text_branch.parameters()):,}), built in "
          f"{time.perf_counter() - start:.3f} s")
    chunks = (0.1 * np.random.default_rng(14).standard_normal((BATCH, LENGTH, 1))
              ).astype(np.float32)
    for rows in (BATCH, 1):
        out = emb.embed_audio(chunks[:rows])
        check(tuple(out.shape) == (rows, 1, 512) and bool(torch.isfinite(out).all())
              and (out.norm(dim=-1) - 1.0).abs().max().item() <= 1e-5,
              f"embed_audio: {tuple(out.shape)}")
        secs = time_calls(lambda: emb.embed_audio(chunks[:rows]))
        _, dev, launches = device_ms(lambda: emb.embed_audio(chunks[:rows]), "", calls=3)
        print(f"  embed_audio, B={rows} chunks of {LENGTH} samples (repeat-padded to "
              f"{CLAP_SAMPLES}): ms {spread(secs)}; device {dev:.3f} ms in "
              f"{launches:.0f} kernels and copies a call")
    for rows in (1, 4):
        out = emb.embed_text(CLAP_PROMPTS[:rows])
        check(tuple(out.shape) == (rows, 1, 512) and bool(torch.isfinite(out).all()),
              f"embed_text: {tuple(out.shape)}")
        secs = time_calls(lambda: emb.embed_text(CLAP_PROMPTS[:rows]))
        _, dev, launches = device_ms(lambda: emb.embed_text(CLAP_PROMPTS[:rows]), "",
                                     calls=3)
        print(f"  embed_text, {rows} prompt(s), 77 tokens: ms {spread(secs)}; device "
              f"{dev:.3f} ms in {launches:.0f} kernels and copies a call")
    print(f"  peak memory of 14a {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    cpu = ClapEmbedder(device="cpu", model=ClapModel())
    cpu.model.load_state_dict(emb.model.state_dict(), strict=True)
    wav = chunks[:1]
    err = {"audio": (emb.embed_audio(wav).cpu() - cpu.embed_audio(wav)).abs().max().item(),
           "text": (emb.embed_text(CLAP_PROMPTS).cpu()
                    - cpu.embed_text(CLAP_PROMPTS)).abs().max().item()}
    x = torch.from_numpy(prepare_audio(float32_to_int16(wav[:, :, 0]))).float() / 32767.0
    with torch.no_grad():
        want, got = clap_mel(x).double(), clap_mel(x.cuda()).double().cpu()
    power = 10.0 ** (want / 10.0)
    live = power >= CLAP_DB_FLOOR * power.max()
    err["db"] = (got - want).abs()[live].max().item()
    err["db_all"] = (got - want).abs().max().item()
    err["live"] = live.double().mean().item()
    print(f"  card vs CPU, same weights, B=1: audio embedding max |diff| "
          f"{err['audio']:.3e}, text ({len(CLAP_PROMPTS)} prompts) {err['text']:.3e} "
          f"(tol {CLAP_EMB_TOL:.0e}); dB mel {err['db']:.3e} dB over the "
          f"{err['live']:.4f} of bins with power >= {CLAP_DB_FLOOR:.0e} of the largest "
          f"(tol {CLAP_DB_TOL:.0e}; over all bins {err['db_all']:.3e}, not gated)")
    check(err["audio"] <= CLAP_EMB_TOL, "CLAP cross-check: audio embeddings disagree")
    check(err["text"] <= CLAP_EMB_TOL, "CLAP cross-check: text embeddings disagree")
    check(err["db"] <= CLAP_DB_TOL, "CLAP cross-check: the dB mel disagrees")
    del emb, cpu
    torch.cuda.empty_cache()
    return err


def feed_step_times(state, shard: str, embedder) -> list:
    """Seconds per micro-step of training ``state`` on batches of ``shard``
    made by ``train_diffusion.make_batches`` with ``embedder`` (its epochs
    chained) and fed by ``device_prefetch``, as ``train_diffusion.main``
    feeds them: the embedder runs in the feeder thread.  Each step is timed
    from the end of the one before to its loss read, so a wait for the
    feeder counts; ``CLAP_FEED_WARMUP`` steps, then ``CLAP_FEED_STEPS``
    timed."""
    import contextlib
    import itertools

    from syncfusion_tpu_torch.core.config import TrainConfig
    from syncfusion_tpu_torch.data.prefetch import device_prefetch
    from syncfusion_tpu_torch.train.diffusion_trainer import DiffusionTrainer
    from syncfusion_tpu_torch.train_diffusion import make_batches

    cfg = TrainConfig(batch_size=BATCH, length=LENGTH)
    trainer = DiffusionTrainer(state.model, embedding_mask_proba=cfg.embedding_mask_proba)
    batches = itertools.chain.from_iterable(
        make_batches(shard, cfg, seed, embedder) for seed in itertools.count())
    gen = torch.Generator(device="cuda").manual_seed(0)
    secs = []
    with contextlib.closing(device_prefetch(batches, torch.device("cuda"))) as stream:
        last = time.perf_counter()
        for i, batch in zip(range(CLAP_FEED_WARMUP + CLAP_FEED_STEPS), stream):
            float(trainer.train_step(state, batch, gen)["train_loss"])
            now = time.perf_counter()
            if i >= CLAP_FEED_WARMUP:
                secs.append(now - last)
            last = now
    return secs


def phase_video_to_foley_clap(attn, fr, tmp: str, chunks: list, net_state: dict,
                              want: list) -> dict:
    """Phase 14d: ``video_to_foley.main`` on phase 13's chunks and onset net
    (saved as a train_onset checkpoint), at the fast point, conditioned with
    ``--cond_wav`` (a seeded 3-s stereo wav at 44.1 kHz) and with
    ``--text``; one warm-up and ``TIMED_RUNS`` runs each, split into main's
    onset, CLAP and generation parts (each with its models' set-up); the
    onset times are phase 13's, K1 launches 153 times a clip.  Returns the
    last run's launch counts of each condition."""
    from syncfusion_tpu_torch import video_to_foley
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
    from syncfusion_tpu_torch.ops.wav import read_wav, write_wav

    onset_dir = os.path.join(tmp, "onset")
    Checkpointer(CheckpointConfig(onset_dir, monitor="loss/val")).save(
        0, {"model": net_state}, {"loss/val": 1.0})
    cond = os.path.join(tmp, "cond.wav")
    rng = np.random.default_rng(5)
    write_wav(cond, (0.1 * rng.standard_normal((2, 3 * 44100))).astype(np.float32), 44100)
    out, clips = {}, {}
    for label, flags in (("cond_wav", ["--cond_wav", cond]), ("text", ["--text", "hit wood"])):
        parts = {"onset": [], "clap": [], "generation": []}
        wall = []
        for run in range(TIMED_RUNS + 1):
            reset_counts(attn, fr)
            torch.cuda.reset_peak_memory_stats()
            clip = os.path.join(tmp, f"{label}.wav")
            start = time.perf_counter()
            res = video_to_foley.main([
                "--video_dir", tmp, "--onset_ckpt", onset_dir, "--onset_layers", "2", "2",
                "2", "2", "--sampler", "dpm", "--num_steps", str(FAST_STEPS),
                "--embedding_scale", str(FAST_SCALE), "--deep_cache_interval", str(FAST_K),
                "--deep_split", str(DEEP_SPLIT), "--output", clip, "--device", "cuda",
                *flags], chunks=chunks)
            seconds = time.perf_counter() - start
            launched = counts(attn, fr)
            expected = {k: FAST_K1 if k == "kernel_launches" else 0 for k in launched}
            wav, sr = read_wav(clip)
            check(res["times"].tolist() == want, f"video to Foley, {label}: onset times "
                  f"{res['times']} != phase 13's {want}")
            check(sr == SR and wav.shape == (1, LENGTH) and bool(np.isfinite(wav).all()),
                  f"video to Foley, {label}: output {wav.shape}")
            check(launched == expected,
                  f"video to Foley, {label}: launch counts {launched} != {expected}")
            print(f"  video to Foley --{label}, {'warm-up' if run == 0 else f'run {run}'}: "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in res["seconds"].items())
                  + f", main {seconds:.3f} s, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
            if run:
                wall.append(seconds)
                for k, v in res["seconds"].items():
                    parts[k].append(v)
        clips[label] = wav
        out[label] = launched
        print(f"  video to Foley --{label} per clip over {TIMED_RUNS} runs, s: main "
              f"{spread(wall, 1)}; " + "; ".join(f"{k} {spread(v, 1)}" for k, v in parts.items())
              + f"; launches per run {launched}")
    check(np.abs(clips["cond_wav"] - clips["text"]).max() > 1e-3,
          "video to Foley: the --cond_wav and --text clips are the same")
    return out


def phase_eval(attn, fr, tmp: str) -> dict:
    """Phase 15: the reference's evaluation through the port's entry points.
    (a) ``evaluate_diffusion.main`` with ``--exp prepare_gh_gt`` and then
    ``--exp evaluate_gh_gen`` at the preset's values (full-width UNet in
    f32, CLAP HTSAT-tiny audio conditioning, seeded weights) on a 10-track
    test shard, K1's f32 body launched 1350 times, the plain attention
    never; (b) VGGish (full width, seeded) on both directories on the card,
    held against the same weights on the CPU; (c) FAD of the mel statistics
    and ``evaluate_onset.main`` over the 10 files; (d) one generated wav
    muxed onto JPEG frames and read back, ffmpeg's muxer where there is one,
    and ``resample_torch`` on the card against the host resampler.  Returns
    the launch counts of (a)."""
    from syncfusion_tpu_torch import evaluate_diffusion, evaluate_onset
    from syncfusion_tpu_torch.device import exact_f32
    from syncfusion_tpu_torch.eval import fad, mux
    from syncfusion_tpu_torch.ops.resample import resample, resample_torch
    from syncfusion_tpu_torch.ops.wav import read_wav

    shard, gt, gen = (os.path.join(tmp, name) for name in ("test.tar", "gh-gt", "gh-gen"))
    # onsets in every track's first 2 s (the onset check of the presets),
    # the first at 0.3 s, each with a burst the onset detector finds
    write_shard(shard, tracks=EVAL_TRACKS, seconds=6.0, every=0.37, first=0.3, burst=0.8)
    evaluate_diffusion.main(["--exp", "prepare_gh_gt", "--dataset_path", shard,
                             "--experiment_path", gt])
    # K1's launches by body: the dtype of every q that flash_fwd launches on
    k1_dtypes = collections.Counter()
    launch = attn.flash_fwd

    def counted_fwd(q, *args, **kwargs):
        before = attn.flash_attention.kernel_launches
        result = launch(q, *args, **kwargs)
        k1_dtypes[str(q.dtype)] += attn.flash_attention.kernel_launches - before
        return result

    reset_counts(attn, fr)
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    attn.flash_fwd = counted_fwd
    try:
        out = evaluate_diffusion.main(["--exp", "evaluate_gh_gen", "--dataset_path", shard,
                                       "--experiment_path", gen, "--gt_dir", gt])
    finally:
        attn.flash_fwd = launch
    seconds = time.perf_counter() - start
    launched = counts(attn, fr)
    expected = {k: EVAL_K1 if k == "kernel_launches" else 0 for k in launched}
    check(launched == expected, f"evaluation: launch counts {launched} != {expected}")
    check(k1_dtypes == {"torch.float32": EVAL_K1},
          f"evaluation: K1 launches by dtype {dict(k1_dtypes)}, not all f32")
    stats = out["generation"]
    check(stats["clips"] == EVAL_TRACKS, f"evaluation generated {stats['clips']} clips")
    for d in (gt, gen):
        names = sorted(n_ for n_ in os.listdir(d) if n_.endswith(".wav"))
        check(len(names) == EVAL_TRACKS, f"{d}: {len(names)} wavs")
        for name in names:
            wav, sr = read_wav(os.path.join(d, name))
            check(sr == 22050 and wav.shape == (1, EVAL_SAMPLES)
                  and bool(np.isfinite(wav).all()), f"{d}/{name}: {wav.shape} at {sr} Hz")
    print(f"  evaluate_gh_gen, B={EVAL_BATCH}, DDIM {NUM_STEPS}, CFG {SCALE} at every "
          f"step, f32: {stats['generation_s'] / stats['clips']:.3f} s a clip generating "
          f"(embedding, noise, sampling), {stats['post_s'] / stats['clips']:.4f} s a clip "
          f"resampling to 22.05 kHz and writing; main {seconds:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {EVAL_TRACKS} + "
          f"{EVAL_TRACKS} wavs of {EVAL_SAMPLES} samples ({EVAL_SAMPLES / 22050:.2f} s) "
          f"at 22050 Hz; launches {launched}; K1 by dtype {dict(k1_dtypes)}", flush=True)

    # (b) VGGish, card against CPU
    embedder = fad.VGGishEmbedder()
    patches = {d: [fad.vggish_log_mel(read_wav(os.path.join(d, n_))[0].mean(axis=0), 22050)
                   for n_ in sorted(os.listdir(d)) if n_.endswith(".wav")]
               for d in (gen, gt)}
    fad._embed_dir(embedder, gen)  # warm-up
    torch.cuda.synchronize()
    start = time.perf_counter()
    embs = {d: fad._embed_dir(embedder, d) for d in (gen, gt)}
    vggish_ms = (time.perf_counter() - start) * 1e3 / (2 * EVAL_TRACKS)
    cpu = fad.VGGish()
    cpu.load_state_dict(embedder.net.state_dict())
    with torch.no_grad(), exact_f32():
        want = {d: cpu(torch.from_numpy(np.concatenate(p_))).numpy()
                for d, p_ in patches.items()}
    err = max(float(np.abs(embs[d] - want[d]).max() / np.abs(want[d]).max()) for d in want)
    dist = fad.frechet_distance(*fad.gaussian_stats(embs[gen]), *fad.gaussian_stats(embs[gt]))
    print(f"  VGGish ({sum(p_.numel() for p_ in cpu.parameters()):,} params, seeded), "
          f"{embs[gen].shape[0]} + {embs[gt].shape[0]} patches: {vggish_ms:.3f} ms a clip "
          f"(log-mel on the host, forward on the card); card vs CPU max |diff| / max "
          f"|embedding| {err:.3e} (tol {VGGISH_TOL:.0e}); Frechet distance {dist:.4f}",
          flush=True)
    check(err <= VGGISH_TOL, "VGGish: the card disagrees with the CPU")
    check(math.isfinite(dist), "VGGish: non-finite Frechet distance")

    # (c) FAD of the preset (mel statistics) and the onset metrics
    onset = evaluate_onset.main(["--gen_dir", gen, "--tar_dir", gt])
    print(f"  FAD (preset backend) {out['metrics']}; onset metrics {onset}", flush=True)
    check(all(math.isfinite(v) for v in out["metrics"].values()), "FAD: not finite")
    check(all(math.isfinite(v) for v in onset.values()) and onset["num_files"] == EVAL_TRACKS,
          f"onset metrics {onset}")

    # (d) the mux round trip; resample_torch on the card
    frames = os.path.join(tmp, "frames")
    os.makedirs(frames)
    for i in range(1, 31):
        with open(os.path.join(frames, f"clip.frame_{i:06d}.jpg"), "wb") as f:
            f.write(GREY_JPEG)
    clip = os.path.join(gen, sorted(n_ for n_ in os.listdir(gen) if n_.endswith(".wav"))[0])
    wav = read_wav(clip)[0][0]
    dest = mux.attach_audio_to_frames(frames, "clip.frame_%06d.jpg", clip,
                                      os.path.join(tmp, "clip.mp4"), fps=15, n_frames=30)
    back = mux.extract_video_audio(dest, 22050)
    pcm = (np.clip(wav, -1.0, 1.0 - 1 / 32768.0) * 32768.0).astype(np.int16) / 32768.0
    mux_err = float(np.abs(back - pcm).max()) if back.shape == pcm.shape else math.inf
    ran = mux.have_ffmpeg()
    if ran:
        mux.attach_audio_to_video(dest, clip, os.path.join(tmp, "clip_h264.mp4"), fps=15)
    x = np.random.default_rng(3).standard_normal((2, 96000)).astype(np.float32)
    res_err = float((resample_torch(torch.from_numpy(x).cuda(), SR, 22050).cpu()
                     - torch.from_numpy(resample(x, SR, 22050))).abs().max())
    print(f"  mux: {os.path.getsize(dest)} bytes, 30 JPEG frames + {wav.size} samples; read "
          f"back against the 16-bit PCM max |diff| {mux_err:.3e} (tol {MUX_TOL:.0e}), "
          f"against the f32 wav clipped to [-1, 1] "
          f"{float(np.abs(back - np.clip(wav, -1.0, 1.0)).max()):.3e}; ffmpeg muxer ran: "
          f"{ran}; resample_torch on the card vs the host 48 -> 22.05 kHz max |diff| "
          f"{res_err:.3e} (tol {RESAMPLE_TOL:.0e})", flush=True)
    check(mux_err <= MUX_TOL, "mux round trip disagrees")
    check(res_err <= RESAMPLE_TOL, "resample_torch on the card disagrees with the host")
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from syncfusion_tpu_torch.device import set_exact_f32
    from syncfusion_tpu_torch.models import blocks
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.ops import _build
    from syncfusion_tpu_torch.ops import attention as attn
    from syncfusion_tpu_torch.ops import fused_resblock as fr
    from syncfusion_tpu_torch.ops.wav import write_wav

    # f32 references run in full f32 (matmul and cuDNN convolutions)
    set_exact_f32()

    t0 = time.perf_counter()
    card = smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print("  importable here (information only): " + ", ".join(
        f"{name} {importlib.util.find_spec(name) is not None}" for name in ("PIL", "sklearn", "regex", "transformers")))
    phase("1 environment", t0)

    t0 = time.perf_counter()
    libs = _build.build()
    for name, path in libs.items():
        print(f"  built {name}: {path.name}")
        log = path.with_suffix(".so.log")
        if log.exists():
            print("   ", log.read_text().strip().replace("\n", "\n    "))
    k1_regs = pick_ptxas(libs["flash_fwd"].with_suffix(".so.log").read_text(),
                         K1_KERNELS)
    # ptxas reports static shared memory only: each library gives the
    # dynamic shared memory its launches ask for
    k1_smem = _build.library("flash_fwd").flash_fwd_smem
    for dtype, report in k1_regs.items():
        report["dynamic_smem_bytes"] = k1_smem(int(dtype == "bfloat16"))
    check(k1_regs["float32"]["dynamic_smem_bytes"] > 0, "no shared memory for K1 f32")
    print(f"  K1 registers and spills: {k1_regs}")
    bwd_log = libs["flash_bwd"].with_suffix(".so.log").read_text()
    k2_regs = {key: pick_ptxas(bwd_log, picks) for key, picks in K2_KERNELS.items()}
    smem = _build.library("flash_bwd").flash_bwd_smem
    for key, by_type in k2_regs.items():
        for dtype, report in by_type.items():
            report["dynamic_smem_bytes"] = smem(int(key == "dkv"),
                                                int(dtype == "bfloat16"))
            check(report["dynamic_smem_bytes"] > 0, f"no shared memory for K2 {key}")
    print(f"  K2a and K2b registers and spills: {k2_regs}")
    fused_log = libs["fused_resblock"].with_suffix(".so.log").read_text()
    fused_smem = _build.library("fused_resblock").fused_resblock_smem
    fused_regs = {dtype: fused_ptxas(fused_log, tag)
                  for dtype, tag in FUSED_KERNELS.items()}
    for dtype, reports in fused_regs.items():
        for key, report in reports.items():
            tco, res = int(key[3:key.index("_")]), int(key[key.index("res") + 3])
            report["dynamic_smem_bytes"] = fused_smem(int(dtype == "bfloat16"), tco, res)
    print(f"  K3/K4 registers and spills: {fused_regs}")
    phase("2 build", t0)

    t0 = time.perf_counter()
    total = phase_kernels(attn)
    bwd_total = phase_bwd_kernels(attn)
    fused_total, k3_alone_ms = phase_fused_kernels(fr)
    phase("3 kernels against plain versions", t0)

    t0 = time.perf_counter()
    model = SyncFusionDiffusion.from_config(None, dtype=torch.bfloat16,
                                            device="cuda", seed=0)
    print(f"  params: {model.param_count():,}")
    noise, onsets, embedding = sampler_inputs()
    torch.cuda.synchronize()
    phase("4a build the full-width model", t0)

    t0 = time.perf_counter()
    check(full_forwards(NUM_STEPS, SERVE_K) * 9 == SERVE_K1
          and full_forwards(FAST_STEPS, FAST_K) * 9 == FAST_K1,
          "the sampler's refreshes disagree with the launch gates")
    wav_plain, seconds, gen_launched = time_generation(
        model, attn, fr, "plain UNet, DDIM 150, B=4", (noise, onsets, embedding),
        {"kernel_launches": 9 * NUM_STEPS}, num_steps=NUM_STEPS,
        embedding_scale=SCALE, guidance_interval=BAND)
    with tempfile.TemporaryDirectory() as tmp:
        write_wav(os.path.join(tmp, "clip0.wav"), wav_plain[0, :, 0].cpu().numpy(), SR)
    phase("4b generate 4 full-width clips, timed runs", t0)

    t0 = time.perf_counter()
    serve_inputs = sampler_inputs(SERVE_BATCH)
    _, seconds_serve, serve_launched = time_generation(
        model, attn, fr, f"serving, DDIM 150, DeepCache K={SERVE_K}, B={SERVE_BATCH}",
        serve_inputs, {"kernel_launches": SERVE_K1}, num_steps=NUM_STEPS,
        embedding_scale=SCALE, guidance_interval=BAND, deep_cache_interval=SERVE_K,
        deep_split=DEEP_SPLIT)
    _, seconds_fast, fast_launched = time_generation(
        model, attn, fr, f"fast, DPM++(2M) {FAST_STEPS}, DeepCache K={FAST_K}, "
        f"B={SERVE_BATCH}", serve_inputs, {"kernel_launches": FAST_K1},
        sampler="dpm", num_steps=FAST_STEPS, embedding_scale=FAST_SCALE,
        guidance_interval=BAND, deep_cache_interval=FAST_K, deep_split=DEEP_SPLIT)
    clips_per_min = {}
    for label, batch, secs in (("plain B=4", BATCH, seconds),
                               ("serving B=8 K=4", SERVE_BATCH, seconds_serve),
                               ("fast B=8 K=2", SERVE_BATCH, seconds_fast)):
        clips_per_min[label] = batch * LENGTH / SR / 8.0 / statistics.median(secs) * 60
    print("  side by side, median 8-s clips/min: " + ", ".join(
        f"{k_} {v_:.3f}" for k_, v_ in clips_per_min.items()))
    phase("4c serving and fast configurations, timed runs", t0)

    t0 = time.perf_counter()
    fwd = forward_full_vs_cached(model, attn, fr, serve_inputs)
    print(f"  one in-band UNet forward, {2 * SERVE_BATCH} rows, bf16: full "
          f"{fwd['full_device_ms']:.3f} ms device ({fwd['full_eager_ms']:.3f} eager, "
          f"{fwd['full_k1']} K1), cached at split {DEEP_SPLIT} "
          f"{fwd['cached_device_ms']:.3f} ms device ({fwd['cached_eager_ms']:.3f} "
          f"eager, {fwd['cached_k1']} K1): cached / full {fwd['cached_device_ms'] / fwd['full_device_ms']:.4f} "
          f"device, {fwd['cached_eager_ms'] / fwd['full_eager_ms']:.4f} eager")
    check(fwd["full_k1"] == 9 and fwd["cached_k1"] == 0,
          f"K1 per forward full / cached {fwd['full_k1']} / {fwd['cached_k1']}")
    del serve_inputs
    torch.cuda.empty_cache()
    phase("4d full against cached forward", t0)

    t0 = time.perf_counter()
    x16 = bf16_cross_check(model, attn, blocks, noise, onsets, embedding)
    print(f"  bf16, 2 steps, kernel vs plain attention: O elements of the 18 "
          f"calls rounded otherwise than the plain version: "
          f"{x16['kernel_vs_plain']} of {x16['elements']}, share "
          f"{x16['share']:.3e} (tol {BF16_FLIP_TOL:.0e}; the plain version "
          f"against f64: {x16['plain_vs_f64']}), max |O| {x16['max_abs_o']:.3f}; "
          f"output max |diff| / max |plain| = {x16['max']:.3e}, 99.9th "
          f"percentile over samples {x16['p999']:.3e} (not gated, see "
          f"BF16_FLIP_TOL)")
    check(x16["share"] <= BF16_FLIP_TOL, "bf16 cross-check: the kernel rounds "
          "too many O elements otherwise than the plain version")
    model32 = SyncFusionDiffusion.from_config(None, dtype=torch.float32,
                                              device="cuda", seed=0)
    model32.load_state_dict(model.state_dict(), strict=True)
    rel32 = kernel_vs_plain(model32, attn, blocks, noise, onsets, embedding).max().item()
    print(f"  f32 (same params), 2 steps, kernel vs plain attention: "
          f"max |diff| / max |plain| = {rel32:.3e} (tol {CROSS_TOL:.0e})")
    check(math.isfinite(rel32) and rel32 <= CROSS_TOL, "cross-check disagrees")
    for sampler in ("ddim", "dpm"):
        reset_counts(attn, fr)
        rel_c = kernel_vs_plain(model32, attn, blocks, noise, onsets, embedding,
                                sampler=sampler, **CACHED_CHECK).max().item()
        k1 = counts(attn, fr)["kernel_launches"]
        print(f"  f32 (same params), {sampler} with DeepCache K=2, split "
              f"{DEEP_SPLIT}, 4 steps in the band, kernel vs plain attention: max "
              f"|diff| / max |plain| = {rel_c:.3e} (tol {CROSS_TOL:.0e}), {k1} K1 "
              f"launches (expected {CACHED_CHECK_K1})")
        check(k1 == CACHED_CHECK_K1, f"cached {sampler} check launched K1 {k1} times")
        check(math.isfinite(rel_c) and rel_c <= CROSS_TOL,
              f"cached {sampler} cross-check disagrees")
    del model32
    del model
    torch.cuda.empty_cache()
    phase("5 cross-check", t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        state, train_launched, sec, peak = phase_train(attn, fr, tmp, "plain")
        print(f"  training, f32, B={BATCH}, L={LENGTH}: {sec:.4f} s per micro-step "
              f"(median of steps 2-{TRAIN_STEPS}), peak memory {peak:.3f} GiB")
        phase("6 training at full width", t0)

        t0 = time.perf_counter()
        rel_loss, rel_grad = train_vs_plain(state.model, attn, fr, blocks, tmp)
        print(f"  f32 loss and gradient, kernels vs plain attention: loss "
              f"{rel_loss:.3e} relative (tol {TRAIN_LOSS_TOL:.0e}), gradients max "
              f"|diff| / max |plain| {rel_grad:.3e} (tol {TRAIN_GRAD_TOL:.0e})")
        check(rel_loss <= TRAIN_LOSS_TOL, "training loss cross-check disagrees")
        check(rel_grad <= TRAIN_GRAD_TOL, "training gradient cross-check disagrees")
        del state
        torch.cuda.empty_cache()
        phase("7 training cross-check", t0)

        t0 = time.perf_counter()
        fused = SyncFusionDiffusion.from_config(fused_model_cfg(), dtype=torch.bfloat16,
                                                device="cuda", seed=0)
        check(fused.unet.stats_levels(LENGTH) == [True, True] + [False] * 6,
              f"K4 levels {fused.unet.stats_levels(LENGTH)}")
        wav_f, seconds_f, fused_launched = time_generation(
            fused, attn, fr, "fused UNet, DDIM 150, B=4", (noise, onsets, embedding),
            {"kernel_launches": 9 * NUM_STEPS,
             "k3_kernel_launches": K3_PER_FORWARD * NUM_STEPS,
             "k4_kernel_launches": K4_PER_FORWARD * NUM_STEPS},
            num_steps=NUM_STEPS, embedding_scale=SCALE, guidance_interval=BAND)
        rel_gen = ((wav_f - wav_plain).abs().max() / wav_plain.abs().max()).item()
        med, med_f = statistics.median(seconds), statistics.median(seconds_f)
        print(f"  fused vs plain UNet, 150 steps, bf16, median of {TIMED_RUNS}: "
              f"{med_f:.3f} s against {med:.3f} s ({med / med_f:.3f}x); max |diff| "
              f"/ max |plain| {rel_gen:.3e} (not gated: bf16 roundings at other "
              f"places)")
        del fused, wav_f, wav_plain
        torch.cuda.empty_cache()
        phase("8 fused generation at full width", t0)

        t0 = time.perf_counter()
        rel_fs, rel_fc, rel_fl, rel_fg = fused_vs_plain(attn, fr, noise, onsets,
                                                        embedding, tmp)
        print(f"  f32, same params: 2 sampler steps fused vs plain max |diff| / max "
              f"|plain| {rel_fs:.3e}, DeepCache DDIM K=2 4 steps {rel_fc:.3e} (tol "
              f"{CROSS_TOL:.0e}); loss {rel_fl:.3e} relative (tol "
              f"{TRAIN_LOSS_TOL:.0e}); gradients {rel_fg:.3e} (tol {TRAIN_GRAD_TOL:.0e})")
        check(math.isfinite(rel_fs) and rel_fs <= CROSS_TOL,
              "fused sampling cross-check disagrees")
        check(math.isfinite(rel_fc) and rel_fc <= CROSS_TOL,
              "fused cached sampling cross-check disagrees")
        check(rel_fl <= TRAIN_LOSS_TOL, "fused loss cross-check disagrees")
        check(rel_fg <= TRAIN_GRAD_TOL, "fused gradient cross-check disagrees")
        torch.cuda.empty_cache()
        phase("9 fused cross-check", t0)

        t0 = time.perf_counter()
        state, fused_train, sec_f, peak_f = phase_train(attn, fr, tmp, "fused",
                                                        fused_model_cfg())
        print(f"  fused training, f32, B={BATCH}, L={LENGTH}: {sec_f:.4f} s per "
              f"micro-step (plain UNet, phase 6: {sec:.4f}), peak memory "
              f"{peak_f:.3f} GiB (phase 6: {peak:.3f})")
        del state
        torch.cuda.empty_cache()
        phase("10 fused training at full width", t0)

        t0 = time.perf_counter()
        step_s = {precision: phase_onset_train(tmp, precision) for precision in ("bf16", "32")}
        print(f"  onset training side by side, s per step: bf16 {step_s['bf16']:.4f}, "
              f"f32 {step_s['32']:.4f} ({step_s['32'] / step_s['bf16']:.3f}x)")
        phase("11 onset training at full width", t0)

    t0 = time.perf_counter()
    xo = onset_cross_check()
    check(xo["logits"] <= ONSET_TOL, "onset cross-check: logits disagree")
    check(xo["loss"] <= ONSET_TOL, "onset cross-check: loss disagrees")
    check(xo["buffers"] <= ONSET_TOL, "onset cross-check: BatchNorm buffers disagree")
    check(xo["grads"] <= TRAIN_GRAD_TOL, "onset cross-check: gradients disagree")
    check(xo["flips"] <= ONSET_FLIP_TOL, "onset cross-check: the card's ReLU inputs "
          "change sign against the CPU's more often than f32 rounding explains")
    phase("12 onset cross-check", t0)

    t0 = time.perf_counter()
    v2f_launched, v2f_chunks, v2f_net, v2f_times = phase_video_to_foley(attn, fr)
    phase("13 video to Foley at full width", t0)

    t0 = time.perf_counter()
    clap_err = phase_clap()
    phase("14ab CLAP at full width, card against CPU", t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        state, clap_train, sec_c, peak_c = phase_train(
            attn, fr, tmp, "clap", embedder=None, steps=CLAP_TRAIN_STEPS)
        print(f"  CLAP-conditioned training (default embedder), f32, B={BATCH}, "
              f"L={LENGTH}: {sec_c:.4f} s at micro-step {CLAP_TRAIN_STEPS} (phase 6, "
              f"zero embeddings: {sec:.4f}, median of steps 2-{TRAIN_STEPS}), peak "
              f"memory {peak_c:.3f} GiB (phase 6: {peak:.3f})")
        from syncfusion_tpu_torch.models.clap import ClapEmbedder
        from syncfusion_tpu_torch.models.embedder import ZeroEmbedder

        clap = ClapEmbedder(device="cuda")
        zero = ZeroEmbedder(512, device="cuda")
        feed = {"zero": [], "clap": []}
        for label in ("zero", "clap", "clap", "zero"):
            secs = feed_step_times(state, os.path.join(tmp, "shard.tar"),
                                   clap if label == "clap" else zero)
            feed[label].append(statistics.median(secs))
            print(f"  fed micro-steps, {label} embeddings in the feeder thread: s "
                  f"{spread(secs, 1)}", flush=True)
        med = {k: statistics.median(v) for k, v in feed.items()}
        print(f"  CLAP in the feeder thread: {med['clap']:.4f} s per micro-step against "
              f"{med['zero']:.4f} with zero embeddings ({med['clap'] / med['zero']:.4f}x; "
              f"turns {feed})")
        del state, clap
        torch.cuda.empty_cache()
        phase("14c CLAP-conditioned training", t0)

        t0 = time.perf_counter()
        v2f_clap = phase_video_to_foley_clap(attn, fr, tmp, v2f_chunks, v2f_net, v2f_times)
        phase("14d CLAP-conditioned video to Foley", t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        eval_launched = phase_eval(attn, fr, tmp)
        phase("15 evaluation at full width", t0)

    fwd16, fwd32 = total[torch.bfloat16, ROWS], total[torch.float32, ROWS]
    serve16 = total[torch.bfloat16, SERVE_ROWS]
    v2f16 = {rows: total[torch.bfloat16, rows] for rows in V2F_ROWS}
    eval32 = total[torch.float32, EVAL_ROWS]
    paths = {"generate": gen_launched, "generate_serving": serve_launched,
             "generate_fast": fast_launched, "train": train_launched,
             "generate_fused": fused_launched, "train_fused": fused_train,
             "video_to_foley": v2f_launched, "train_clap": clap_train,
             "video_to_foley_cond_wav": v2f_clap["cond_wav"],
             "video_to_foley_text": v2f_clap["text"], "evaluate": eval_launched}

    def launched_by_path(key):
        return {p_: c_[key] for p_, c_ in paths.items()}

    rows = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "syncfusion_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "syncfusion_tpu/ops/attention.py:34",
        "launches": sum(launched_by_path("kernel_launches").values()),
        "launches_by_path": launched_by_path("kernel_launches"),
        "max_abs_err": max(fwd16["max_abs_err"], serve16["max_abs_err"],
                           *(tot["max_abs_err"] for tot in v2f16.values()),
                           eval32["max_abs_err"]),
        "ms": fwd16["ms"],
        "plain_ms": fwd16["plain_ms"],
        "bound_ms": fwd16["bound_ms"],
        "bound_by": fwd16["bound_by"],
        "library_ms": fwd16["library_ms"],
        "work": "the 9 attention calls of one in-band UNet forward, bf16, "
                "BH=64, T=2048x2, 1024x2, 512x2, 256x3",
        "serving": {key: serve16[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "serving_work": f"the same 9 calls at BH={SERVE_ROWS * HEADS}, the in-band "
                        "forward of the serving and fast configurations (B=8)",
        "video_to_foley": {f"rows_{rows}": {key: tot[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for rows, tot in v2f16.items()},
        "video_to_foley_work": "the same 9 calls at BH=16 (2 rows, in the band) "
                               "and BH=8 (1 row, outside it): video to Foley's "
                               "whole forwards (B=1)",
        "float32": {key: fwd32[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "float32_work": "the same 9 calls in f32 (the training forward's type)",
        "evaluate": {key: eval32[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "evaluate_work": f"the same 9 calls in f32 at BH={EVAL_ROWS * HEADS}: the "
                         f"evaluation's forward (B={EVAL_BATCH}, CFG at every step)",
        "design": {"bfloat16": "tensor cores: mma.sync m16n8k16 (P as hi + lo "
                               "bf16), cp.async K/V ring of 2 stages, 4 warps "
                               "of 32 query rows a block",
                   "float32": "tensor cores: mma.sync m16n8k8 tf32, q, K, V "
                              "and P as 3xTF32, per-tile partial sums of P·V "
                              "added in f32, cp.async K/V ring of 2 stages, 4 "
                              "warps of 16 query rows a block"},
        "ptxas": k1_regs,
    }]
    for name, replaces, key in (("flash_bwd_dq", "syncfusion_tpu/ops/attention.py:137",
                                 "dq"),
                                ("flash_bwd_dkv", "syncfusion_tpu/ops/attention.py:181",
                                 "dkv")):
        tot = bwd_total[key]
        bms, by = bound_ms(tot["bytes"], tot["ops"], torch.float32)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "syncfusion_tpu_torch/csrc/flash_bwd.cu",
            "replaces": replaces,
            "launches": sum(launched_by_path(f"{key}_launches").values()),
            "launches_by_path": launched_by_path(f"{key}_launches"),
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": tot["library_ms"],
            "library_note": "SDPA forward+backward minus forward: dq, dk and dv "
                            "together",
            "work": "the 9 attention calls of one training backward, f32, "
                    "BH=32, T=2048x2, 1024x2, 512x2, 256x3",
            "design": "tensor cores: mma.sync m16n8k8 tf32, f32 operands as "
                      "3xTF32 (bf16 q, k, v, dO unsplit), cp.async ring of 2 "
                      "stages, 4 warps of 16 rows a block",
            "ptxas": k2_regs[key],
        })
    for name, replaces, key, work in (
            ("fused_resblock_k3",
             "syncfusion_tpu/ops/fused_resblock.py:54, "
             "syncfusion_tpu/ops/fused_resblock.py:136", "k3",
             f"the {K3_PER_FORWARD} K3 calls of one in-band UNet forward "
             f"(fused_resnet + fused_stats, fold_cap {FOLD_CAP}), bf16, B={ROWS}: "
             "levels 2-3, C 64-128, L 16384 and 4096"),
            ("fused_resblock_k4", "syncfusion_tpu/ops/fused_resblock.py:342", "k4",
             f"the {K4_PER_FORWARD} K4 calls of one in-band UNet forward "
             f"(same configuration), bf16, B={ROWS}: levels 0-1, C 8-64, "
             "L 262144 and 65536")):
        tot = fused_total[torch.bfloat16][key]
        tot32 = fused_total[torch.float32][key]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "syncfusion_tpu_torch/csrc/fused_resblock.cu",
            "replaces": replaces,
            "launches": sum(launched_by_path(f"{key}_kernel_launches").values()),
            "launches_by_path": launched_by_path(f"{key}_kernel_launches"),
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"],
            "device_ms": tot["device_ms"],
            "device_ms_with_wrapper": tot["device_ms_all"],
            "library_device_ms": tot["library_device_ms"],
            "float32": {k_: tot32[k_] for k_ in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "library_device_ms")}
            | {"device_ms_with_wrapper": tot32["device_ms_all"]},
            "float32_work": f"the same {K3_PER_FORWARD if key == 'k3' else K4_PER_FORWARD} "
                            f"calls in f32 at B={TRAIN_ROWS}, the fused training "
                            "forward",
            "library_note": "F.conv1d alone on the already-activated input, a "
                            "partial yardstick: no single PyTorch call computes "
                            "GroupNorm-affine + SiLU + conv k3 (+ residual, + "
                            "group sums)",
            "work": work,
            "design": {"bfloat16": "tensor cores: mma.sync m16n8k16, activation "
                                   "as hi + lo bf16, 8 warps of 16 positions, "
                                   "chunks of 32 channels (16 at Cout 8) in a "
                                   "ring of 2 stages, f32 epilogue tile",
                       "float32": "tensor cores: mma.sync m16n8k8 tf32, x "
                                  "and the weights as 3xTF32 split once when "
                                  "staged, 8 warps of 16 positions (4 of 32 "
                                  "at Cout <= 16), chunks of 16 channels, "
                                  "per-chunk partial sums in f32, x by "
                                  "cp.async in a 3-stage ring, f32 epilogue "
                                  "tile"},
            "ptxas": {dtype: {k_: r_ for k_, r_ in reports.items()
                              if k_.endswith("stats" + str(int(key == "k4")))}
                      for dtype, reports in fused_regs.items()},
        })
    rows[3]["ms_fused_resnet_alone"] = k3_alone_ms
    print(f"  CLAP card vs CPU errors: {clap_err}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
