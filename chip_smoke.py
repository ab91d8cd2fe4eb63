#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure exits non-zero:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: ``nvcc`` compiles every kernel of ``syncfusion_tpu_torch/csrc``;
     the registers, spills and static shared memory ptxas reports for K1,
     K2a and K2b at head widths 64 and 128 (K1's bf16 kernels gated to no
     spills and no C7520, their plan checked against ``fwd_plan``:
     ``k1_ptxas``) and for their wide kernels (K1
     of ``flash_fwd_wide_sm90.cu`` and K2a and K2b of
     ``flash_bwd_wide_sm90.cu`` at each width 192-512, gated to no spills,
     with their launch plans checked against ``wide_fwd_plan`` and
     ``wide_bwd_plan``; K1 on thread-block clusters of
     ``flash_fwd_cluster_sm90.cu`` at each slice 128-512, gated likewise,
     its plan checked against ``cluster_fwd_plan`` at every width 576-4096;
     the chunked K1, K2a and K2b of ``flash_wide.cu`` for heads wider than
     512), and the dynamic shared memory each launch asks for (read from
     the built library), go into the kernels line;
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
     package reads it), a warm-up and SIDE_RUNS timed runs; K3, K4 and K1 launch 12, 12 and 9
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
     ``resample_torch`` on the card against the host resampler (gated);
 16. multi-device on the one card, (a)-(c) in one child of ``python -m
     torch.distributed.run --standalone --nproc_per_node 1`` (NCCL,
     ``cuda:LOCAL_RANK``; ``chip_smoke.py --multi-device OUT DIR`` is the
     child, which runs them one after the other): (a)
     ``DataParallelSampler`` at the serving configuration (B = 8, one
     warm-up and SIDE_RUNS timed runs, 351 K1 a run, the plain attention never;
     ``local_indices`` 0..7; 2 f32 steps against
     ``SyncFusionDiffusion.sample`` on the same noise, gated); (b)
     ``train_diffusion.main`` at phase 6's command line with the model in
     DDP (9 K2a and 9 K2b a backward; the losses against phase 6's, gated;
     fresh trainers in DDP and in one process timed on one batch in turns;
     one DDP micro-step profiled, whose device events must show NCCL's
     all-reduce); (c) the onset trainer with synchronised
     BatchNorm, bf16, B = 16: one step against the single-process trainer on
     the same weights and batch (loss and buffers, gated), then phase 11's
     steps timed; (d) here, 16b's checkpoint into a single-process
     ``DiffusionTrainer``, strictly.  The machine has one card and NCCL
     takes one rank a device, so FSDP and ``model_parallel`` (a model axis
     of at least 2 ranks) do not run here: tests/test_torch_parallel.py
     runs them on the CPU over gloo.
 17. the CondFoleyGen baseline's generation at the full width of
     cfg/condfoleygen/*.yaml (the GPT 24 x 1024, SpecVQGAN ch 128, MelGAN
     ngf 32, the R(2+1)D-18 video net at 112 x 112), seeded weights, f32
     without TF32: (a) B = 4 seeded 2-s 22.05 kHz wavs and 60 frames, one
     warm-up and 3 runs, each stage between CUDA events (wav_to_spec, VQ
     encode, video features, 50 KV-cached GPT steps at top-k 512, VQ
     decode, MelGAN, 32 Griffin-Lim iterations), clips/s, peak memory; (b)
     the card against the CPU on one item (spectrogram, VQ codes under the
     tie rule, video features, teacher-forced logits, top-k 1 tokens, the
     cached decode against the uncached one on the card, the decoded mel,
     MelGAN, Griffin-Lim from one phase), gated; (c) where PIL is
     importable, ``generate_audio.main`` on a 4-item processed root of
     GREY_JPEG frames and ``evaluate_onset_baseline.main --gt_root`` on its
     output; the phase prints whether (c) ran.  No hand-written kernel
     launches in it (gated): no TPU kernel lies on this path.
 18. the CondFoleyGen baseline's training at the same full width, seeded
     weights, f32 without TF32: (a) ``VQGANTrainer`` at the codebook
     YAML's B = 40 x 80 x 160 with a seeded LPAPS and an ``n_layers=3``
     discriminator, ``disc_start`` 3 (both regimes), 5 steps timed (the
     median of steps 3-5), peak memory, one step's device time; (b)
     ``TransformerTrainer`` on the 305 M GPT at B = 4 with 60 frames of
     112 x 112, timed alike, then one ``log_images``; (c) the card against
     the CPU for one VQGAN step at B = 2 (G's and D's losses and
     gradients, D's new running statistics; each f32 run's gradients
     against an f64 step on its own side of every kink, D's on one input)
     and one GPT step at B = 1 (loss, gradients), codes
     under phase 17's tie rule, gated; (d) where PIL is importable,
     ``train_codebook``, ``train_transformer --vq_ckpt`` (the GPT at full
     depth) and ``generate_audio --vq_ckpt
     --transformer_ckpt_path``, one epoch each on phase 17's 4-item root:
     metrics, checkpoints, every media file and the generated wavs checked.
     No hand-written kernel launches and no trainer logs a caught failure
     (gated): no TPU kernel lies on this path.
 19. the reference's published-checkpoint paths at the same full width:
     (a) a Lightning checkpoint of the reference's diffusion module written
     from the port's manifests with seeded tensors (exp/model/diffusion.yaml
     widths, the shared-module duplicates and a frozen embedder entry),
     loaded strictly through ``models/adp_convert.py`` into the a-unet
     compat twins; (b) one whole forward of a CFG pair at L = 2^18 in f32
     and in bf16 through K1 (20 launches, the plain version never) and
     through the plain attention, gated as phase 5, timed (host clock to
     synchronize, device ms by the profiler); (c) one f32 loss and gradient at B = 1,
     K1, K2a and K2b 20 launches each, against the plain attention, gated
     as phase 7; (d) the f32 forward at L = 2^14, card against CPU; (e)
     ``evaluate_diffusion.main --ckpt X.ckpt`` at the evaluate_gh_gen preset
     on phase 15's 10 tracks (B = 10, DDIM with CFG at every step, f32, the
     preset's 150 steps cut to 50: K1's f32 body 1000 times), s a clip and
     peak memory; (f) ``generate_audio --style_transfer --vgg19_ckpt`` (a
     seeded torchvision-layout VGG19) on phase 17's root with one onset a
     video (2 items) at 300
     L-BFGS steps where PIL is importable, and ``run_style_transfer``'s
     first loss on the card against the CPU; no hand-written kernel
     launches on the style path (gated).
 20. distillation, remat and the raw-data tail at the same full width:
     (a) ``gh_make_synthetic`` writes 4 videos of 8 s at 48 kHz,
     ``gh_make_shards`` packs them, the native tar reader (g++) reads the
     shard as the Python reader does (gated), ``spectral_gate`` on one 8-s
     clip on the card against the CPU (the share of gate cells flipped and
     the output on one gate, gated; ms a clip); (b) ``distill_diffusion.main``
     on a seeded phase-6-style checkpoint and 20a's shard, f32, B = 4, 8 -> 4
     -> 2 steps in rounds of 3 (K1 27, K2a 9, K2b 9 a step, gated), then a
     guided round (cfg_scale 2, 3 steps, launches gated step by step), the
     distillation loss and gradients against the plain attention (gated as
     phase 7), ``generate.main --ckpt <distilled> --num_steps 2`` (K1 18);
     s a step and peak memory, all with cuDNN's deterministic algorithms;
     (c) one f32 micro-step's loss and gradients
     with ``remat`` off and on, plain and fused (1e-6 and 1e-5 of max |g|,
     gated; K1/K2 9 either way, K3/K4 12 and 24), peaks and seconds; (d)
     ``r2plus1d_18``, ``r3d_18`` and ``mc3_18`` at 2 x 3 x 16 x 112 x 112,
     f32, ms a batch through ``core.profiler.StepTimer``, the card against
     the CPU at 1 x 3 x 8 x 112 x 112 (gated), and ``core.profiler.trace``
     around K1 launches in a child process (``chip_smoke.py --trace DIR``),
     whose Chrome trace must name the ``flash_fwd`` kernel.
 21. any head width and the overfit-to-quality entry points: (a)
     ``flash_attention`` forward and backward at head widths 8, 32, 64 and
     128 (8 and 32 zero-padded to the 64-wide kernels, 128 on their 128-wide
     instantiations), bf16 and f32, at B = 2 x 8 heads, T = 1024, against
     the plain versions (gated as phases 3 and 5), one launch of K1, K2a and
     K2b each (gated), timed beside SDPA and the bounds; the tiny parity
     config's UNet (``attention_features`` 8) on the card against the CPU
     (gated); (b) ``overfit_quality.main`` at a cut depth (40 steps on 4
     clips at batch 4, evaluations of 8 sampler steps; K1 3 a training step
     and a sampling step, K2a and K2b 3 a training step) and
     ``overfit_quality_stage2.main`` at 60 steps (no hand-written kernel):
     their JSON lines, exit codes and counts (gated), no plain version on
     the card; (c) heads wider than 128, K1 of ``flash_fwd_wide_sm90.cu``
     and K2a and K2b of ``flash_bwd_wide_sm90.cu`` (TMA, wgmma) up to 512,
     above K1 on thread-block clusters (``flash_fwd_cluster_sm90.cu``) and
     the chunked K2a and K2b of ``flash_wide.cu``: as (a) at D = 160, 192,
     256, 320, 512, 576 and 1024 with heads x D = 512 (3, 3, 2, 2, 1, 1
     and 1 heads), with the backend SDPA picks and the C entries that ran
     (gated by width), K1 alone above CLUSTER_FWD_MAX, where it stays the
     chunked kernel (both types, 2 x 1 head of 4160, T = 256: gated as
     phase 3, one ``flash_fwd_chunked`` launch each), and K1 alone at the
     2 x 256 UNet's largest calls
     (bf16 16 rows x 2 heads, f32 4 x 2, T = 2048: gated as phase 3, 1
     launch a call, timed beside its bound, the plain version and SDPA),
     K2a and K2b at its training call (f32 4 x 2, T = 2048: gated as phase
     5, timed beside their bounds, the plain versions and SDPA's backward);
     the full-width UNet
     with 2 heads of 256 (exp/model/diffusion.yaml's node, inner width 512
     kept): one bf16 forward at 2 rows through the kernels against the
     plain attention (phase 5's gate, 9 K1) and one f32 loss and gradient
     (phase 7's gates, 9 K1, K2a, K2b); ``generate --model_config`` on one
     clip (DPM++(2M) 8 steps, DeepCache K = 2) and ``train_diffusion
     --model_config`` for 2 micro-steps, their outputs and counts (gated).
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
import contextlib
import dataclasses
import importlib.util
import io
import json
import logging
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
# TIMED_RUNS times (phase 8 and 16a, off the main path: SIDE_RUNS), each run
# timed and gated
TIMED_RUNS = 3
SIDE_RUNS = 1
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


# K1's two kernels in flash_fwd.cu (bf16: TMA and wgmma; f32: 3xTF32 on
# mma.sync m16n8k8) and K2a's and K2b's in flash_bwd.cu, by input type and
# head width (the 64-wide instantiations under the type's name, the 128-wide
# ones with "_d128"), as tags of their mangled names
K1_KERNELS = {f"{dtype}{sfx}": f"{name}ILi{d}E"
              for d, sfx in ((64, ""), (128, "_d128"))
              for dtype, name in (("bfloat16", "flash_fwd_sm90_kernel"),
                                  ("float32", "flash_fwd_3xtf32_kernel"))}
K2_KERNELS = {key: {f"{dtype}{sfx}": f"{name}I{arg}Li{d}E"
                    for d, sfx in ((64, ""), (128, "_d128"))
                    for dtype, arg in (("float32", "f"), ("bfloat16", "13__nv_bfloat16"))}
              for key, name in (("dq", "flash_bwd_dq_kernel"),
                                ("dkv", "flash_bwd_dkv_kernel"))}
# the chunked kernels of flash_wide.cu (heads wider than 512), one
# instantiation per input type, by kernel and type
WIDE_KERNELS = {key: {dtype: f"{name}I{arg}E"
                      for dtype, arg in (("float32", "f"), ("bfloat16", "13__nv_bfloat16"))}
                for key, name in (("fwd", "flash_fwd_wide_kernel"),
                                  ("dq", "flash_bwd_dq_wide_kernel"),
                                  ("dkv", "flash_bwd_dkv_wide_kernel"))}
# the wide K1 of flash_fwd_wide_sm90.cu, one instantiation per input type
# and head width, by "<type>_d<width>"
WIDE_FWD_WIDTHS = tuple(range(192, 513, 64))
WIDE_FWD_KERNELS = {f"{dtype}_d{w}": f"flash_fwd_wide_sm90_kernelI{arg}Li{w}EE"
                    for w in WIDE_FWD_WIDTHS
                    for dtype, arg in (("float32", "f"), ("bfloat16", "13__nv_bfloat16"))}
PLAN_KEYS = ("q_rows", "key_tile", "stages", "row_groups", "col_groups", "threads",
             "smem_bytes", "box_cols", "ops_per_pair")
# the wide K2a and K2b of flash_bwd_wide_sm90.cu, one instantiation per
# input type and head width, by kernel and "<type>_d<width>"
WIDE_BWD_KERNELS = {key: {f"{dtype}_d{w}": f"{name}I{arg}Li{w}EE"
                          for w in WIDE_FWD_WIDTHS
                          for dtype, arg in (("float32", "f"),
                                             ("bfloat16", "13__nv_bfloat16"))}
                    for key, name in (("dq", "flash_bwd_dq_wide_sm90_kernel"),
                                      ("dkv", "flash_bwd_dkv_wide_sm90_kernel"))}
BWD_PLAN_KEYS = ("rows", "ring_rows", "stages", "parts", "roles", "threads",
                 "smem_bytes", "box_cols", "dq_ops_per_pair", "dkv_ops_per_pair")


# K1 on thread-block clusters, flash_fwd_cluster_sm90.cu (heads wider than
# 512), one instantiation per input type and slice (a block's columns), by
# "<type>_s<slice>"
CLUSTER_SLICES = tuple(range(128, 513, 64))
CLUSTER_FWD_KERNELS = {f"{dtype}_s{s}": f"flash_fwd_cluster_sm90_kernelI{arg}Li{s}EE"
                       for s in CLUSTER_SLICES
                       for dtype, arg in (("float32", "f"), ("bfloat16", "13__nv_bfloat16"))}
CLUSTER_PLAN_KEYS = ("cluster", "slice", "key_tile", "stages", "threads", "smem_bytes",
                     "box_cols", "ops_per_pair")


# the fused kernel's two bodies in fused_resblock.cu (bf16: mma.sync
# m16n8k16; f32: mma.sync m16n8k8 tf32 as 3xTF32), one instantiation per
# (TCO, RESIDUAL, STATS)
FUSED_KERNELS = {"bfloat16": "fused_resblock_tc_kernel",
                 "float32": "fused_resblock_3xtf32_kernel"}


FWD_PLAN_KEYS = ("q_rows", "groups", "key_tile", "stages", "threads", "smem_bytes",
                 "box_cols", "ops_per_pair", "blocks")


def k1_ptxas(build, libs) -> dict:
    """K1's ptxas report (flash_fwd.cu) by type and width, with the dynamic
    shared memory each launch asks for; gated: no wgmma serialized in the
    library (ptxas C7520: a wgmma that may diverge waits for the one
    before), and the bf16 kernels (TMA and wgmma) at most 255 registers, no
    spills, shared memory within SMEM_MAX, their launch plan ``fwd_plan``'s
    at the main path's shapes on this card (BH = 8-128 and evaluation's
    160, every T of ATTN_CALLS).  Returns ``{key: report}``, the bf16 ones
    with ``plans`` by "BH=<n> T=<t>"."""
    import ctypes

    from syncfusion_tpu_torch.ops import attention as attn

    log = libs["flash_fwd"].with_suffix(".so.log").read_text()
    serialized = [ln.strip() for ln in log.splitlines()
                  if "C7520" in ln or "serialized" in ln]
    check(not serialized, f"K1: ptxas serializes its wgmma: {serialized[:2]}")
    reports = pick_ptxas(log, K1_KERNELS)
    lib = build.library("flash_fwd")
    plan_of = lib.flash_fwd_plan
    plan_of.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key, report in reports.items():
        bf16, width = key.startswith("bfloat16"), 128 if key.endswith("_d128") else 64
        report["dynamic_smem_bytes"] = lib.flash_fwd_smem(int(bf16), width)
        check(report["dynamic_smem_bytes"] > 0, f"no shared memory for K1 {key}")
        if not bf16:
            continue
        check(report["registers"] <= 255 and report.get("spill_stores", 0) == 0
              and report.get("spill_loads", 0) == 0
              and report["dynamic_smem_bytes"] + report["smem_bytes"] <= attn.SMEM_MAX,
              f"K1 {key}: registers, spills or shared memory {report}")
        report["plans"] = {}
        for rows in (V2F_ROWS[1], V2F_ROWS[0], ROWS, SERVE_ROWS, EVAL_ROWS):
            for t in ATTN_CALLS:
                out = (ctypes.c_int * len(FWD_PLAN_KEYS))()
                check(plan_of(width, rows * HEADS, t, sms, out) == 0,
                      f"no plan for K1 {key}")
                plan = dict(zip(FWD_PLAN_KEYS, out))
                want = attn.fwd_plan(width, rows * HEADS, t, sms)
                check(plan == want, f"K1 {key} at BH={rows * HEADS} T={t}: the "
                                    f"library's plan {plan} is not fwd_plan's {want}")
                report["plans"][f"BH={rows * HEADS} T={t}"] = (
                    f"{plan['groups']} groups, {plan['blocks']} blocks")
    return reports


def wide_fwd_ptxas(build, libs) -> dict:
    """The wide K1's ptxas report at each width and type, with the launch
    plan its library returns, which must equal ``wide_fwd_plan``'s; gated:
    at most 255 registers, no spills, shared memory within SMEM_MAX."""
    import ctypes

    from syncfusion_tpu_torch.ops import attention as attn

    log = libs["flash_fwd_wide_sm90"].with_suffix(".so.log").read_text()
    reports = pick_ptxas(log, WIDE_FWD_KERNELS)
    plan_of = build.library("flash_fwd_wide_sm90").flash_fwd_wide_plan
    plan_of.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for key, report in reports.items():
        dtype, width = key.split("_d")
        out = (ctypes.c_int * len(PLAN_KEYS))()
        check(plan_of(int(dtype == "bfloat16"), int(width), out) == 0,
              f"no plan for wide K1 {key}")
        plan = dict(zip(PLAN_KEYS, out))
        want = attn.wide_fwd_plan(int(width), getattr(torch, dtype))
        check(plan == want, f"wide K1 {key}: the library's plan {plan} is not "
                            f"wide_fwd_plan's {want}")
        report["plan"] = plan
        report["dynamic_smem_bytes"] = plan["smem_bytes"]
        check(report["registers"] <= 255 and report.get("spill_stores", 0) == 0
              and report.get("spill_loads", 0) == 0
              and plan["smem_bytes"] + report["smem_bytes"] <= attn.SMEM_MAX,
              f"wide K1 {key}: registers, spills or shared memory {report}")
    return reports


def cluster_fwd_ptxas(build, libs) -> dict:
    """The cluster K1's ptxas report at each slice and type, gated: at most
    255 registers, no spills, shared memory within SMEM_MAX at the slice's
    plan, and no wgmma serialized (ptxas C7520: a wgmma that may diverge
    waits for the one before, which cost bf16 6-9%); and the launch plan its
    library returns at every width it takes (576-CLUSTER_FWD_MAX), which
    must equal ``cluster_fwd_plan``'s.  Returns ``{key: report}`` with each
    slice's plan and the widths that take it."""
    import ctypes

    from syncfusion_tpu_torch.ops import attention as attn

    log = libs["flash_fwd_cluster_sm90"].with_suffix(".so.log").read_text()
    serialized = [ln.strip() for ln in log.splitlines()
                  if "C7520" in ln or "serialized" in ln]
    check(not serialized, f"cluster K1: ptxas serializes its wgmma: {serialized[:2]}")
    reports = pick_ptxas(log, CLUSTER_FWD_KERNELS)
    plan_of = build.library("flash_fwd_cluster_sm90").flash_fwd_cluster_plan
    plan_of.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for width in range(attn.WIDE_FWD_MAX + 64, attn.CLUSTER_FWD_MAX + 1, 64):
        for dtype in ("float32", "bfloat16"):
            out = (ctypes.c_int * len(CLUSTER_PLAN_KEYS))()
            check(plan_of(int(dtype == "bfloat16"), width, out) == 0,
                  f"no plan for the cluster K1 {dtype} at {width}")
            plan = dict(zip(CLUSTER_PLAN_KEYS, out))
            want = attn.cluster_fwd_plan(width, getattr(torch, dtype))
            check(plan == want, f"cluster K1 {dtype} at {width}: the library's plan "
                                f"{plan} is not cluster_fwd_plan's {want}")
            report = reports[f"{dtype}_s{plan['slice']}"]
            report.setdefault("widths", []).append(width)
            report["plan"] = {k_: v_ for k_, v_ in plan.items() if k_ != "cluster"}
    for key, report in reports.items():
        smem = report.get("plan", {}).get("smem_bytes", 0)
        report["dynamic_smem_bytes"] = smem
        check(report["registers"] <= 255 and report.get("spill_stores", 0) == 0
              and report.get("spill_loads", 0) == 0
              and smem + report["smem_bytes"] <= attn.SMEM_MAX,
              f"cluster K1 {key}: registers, spills or shared memory {report}")
    return reports


def wide_bwd_ptxas(build, libs) -> dict:
    """The wide K2a's and K2b's ptxas reports at each width and type, with
    the launch plan their library returns, which must equal
    ``wide_bwd_plan``'s; gated: at most 255 registers, no spills, shared
    memory within SMEM_MAX.  Returns ``{"dq": {key: report}, "dkv": ...}``."""
    import ctypes

    from syncfusion_tpu_torch.ops import attention as attn

    log = libs["flash_bwd_wide_sm90"].with_suffix(".so.log").read_text()
    plan_of = build.library("flash_bwd_wide_sm90").flash_bwd_wide_plan
    plan_of.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = {}
    for kernel, picks in WIDE_BWD_KERNELS.items():
        out[kernel] = pick_ptxas(log, picks)
        for key, report in out[kernel].items():
            dtype, width = key.split("_d")
            buf = (ctypes.c_int * len(BWD_PLAN_KEYS))()
            check(plan_of(int(dtype == "bfloat16"), int(width), buf) == 0,
                  f"no plan for wide K2 {key}")
            plan = dict(zip(BWD_PLAN_KEYS, buf))
            want = attn.wide_bwd_plan(int(width), getattr(torch, dtype))
            check(plan == want, f"wide K2 {key}: the library's plan {plan} is not "
                                f"wide_bwd_plan's {want}")
            report["plan"] = plan
            report["dynamic_smem_bytes"] = plan["smem_bytes"]
            check(report["registers"] <= 255 and report.get("spill_stores", 0) == 0
                  and report.get("spill_loads", 0) == 0
                  and plan["smem_bytes"] + report["smem_bytes"] <= attn.SMEM_MAX,
                  f"wide {kernel} {key}: registers, spills or shared memory {report}")
    return out


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


def attention_times_of(root: str) -> dict:
    """K1's (bf16 and f32, BH = 64; bf16 also at BH = 128, 16 and 8 as
    ``fwd_bf16_bh<n>``) and K2a's and K2b's (f32, BH = 32)
    ms per forward or backward (the 9 calls of phase 3's main-path shapes,
    through the wrappers on qkv views), then K1 and SDPA at phase 21a's
    128-wide bf16 call (``fwd_bf16_d128``, ``sdpa_bf16_d128``: HW_ROWS x
    8 heads, T = HW_T), for the ``syncfusion_tpu_torch`` of
    the checkout at ``root``, e.g. a parent: eager (CUDA events around back
    to back calls, which the host's launch cost may bound at the short
    lengths) and, under ``<key>_device``, the kernel's own device time from
    the profiler.  Call it in a fresh process, before anything imports the
    package."""
    sys.path.insert(0, os.path.abspath(root))
    from syncfusion_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    more = {f"fwd_bf16_bh{rows * HEADS}": rows for rows in (SERVE_ROWS, *V2F_ROWS)}
    out = {f"{key}{sfx}": 0.0 for key in ("fwd_bf16", "fwd_f32", "dq_f32", "dkv_f32",
                                          *more)
           for sfx in ("", "_device")}

    def add(key, n, fn, tag):
        out[key] += n * time_ms(fn, 30)
        out[f"{key}_device"] += n * device_ms(fn, tag)[0]

    for t, n in ATTN_CALLS.items():
        for dtype, key in ((torch.bfloat16, "fwd_bf16"), (torch.float32, "fwd_f32")):
            q, k, v = torch.randn((ROWS, t, 3, HEADS, HEAD_DIM), generator=gen,
                                  device="cuda").to(dtype).unbind(2)
            add(key, n, lambda: attn.flash_fwd(q, k, v), "flash_fwd")
        for key, rows in more.items():
            q, k, v = torch.randn((rows, t, 3, HEADS, HEAD_DIM), generator=gen,
                                  device="cuda").to(torch.bfloat16).unbind(2)
            add(key, n, lambda: attn.flash_fwd(q, k, v), "flash_fwd")
        q, k, v = torch.randn((TRAIN_ROWS, t, 3, HEADS, HEAD_DIM), generator=gen,
                              device="cuda").unbind(2)
        do = torch.randn((TRAIN_ROWS, t, HEADS, HEAD_DIM), generator=gen, device="cuda")
        o, lse = attn.flash_fwd(q, k, v)
        _, delta = attn.flash_bwd_dq(q, k, v, o, lse, do)
        add("dq_f32", n, lambda: attn.flash_bwd_dq(q, k, v, o, lse, do), "flash_bwd_dq")
        add("dkv_f32", n, lambda: attn.flash_bwd_dkv(q, k, v, do, lse, delta),
            "flash_bwd_dkv")
    import torch.nn.functional as F

    q, k, v = torch.randn((HW_ROWS, HW_T, 3, HEADS, 128), generator=gen,
                          device="cuda").to(torch.bfloat16).unbind(2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for key, fn, tag in (
            ("fwd_bf16_d128", lambda: attn.flash_fwd(q, k, v), "flash_fwd"),
            ("sdpa_bf16_d128", lambda: F.scaled_dot_product_attention(qt, kt, vt), "")):
        out[key], out[f"{key}_device"] = 0.0, 0.0
        add(key, 1, fn, tag)
    return out


def wide_times_of(root: str) -> dict:
    """The wide K1's, K2a's and K2b's ms a call for the
    ``syncfusion_tpu_torch`` of the checkout at ``root``, eager (CUDA
    events) and, under ``<key>_device``, their device time from the
    profiler: at the 2 x 256 UNet's largest calls (WIDE_LARGEST, T =
    WIDE_T; the f32 one is its training call) and at phase 21c(a)'s shapes
    (B = HW_ROWS, T = HW_T, heads x D = 512, D = 192-512), on qkv views.
    Then K1 alone above 512 (``k1_*``): at 21c(a)'s D = 576 and 1024 (one
    head) in both types and at one larger call (bf16, WIDE_FWD_ROWS x 1 head
    of 1024, T = WIDE_T), each with SDPA's time (``_sdpa``) and the bound
    (``_bound``).  Call it in a fresh process, as ``attention_times_of``."""
    sys.path.insert(0, os.path.abspath(root))
    from syncfusion_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(f"largest_{str(dtype)[6:]}", dtype, rows, 2, WIDE_T, 256)
              for dtype, rows in WIDE_LARGEST]
    shapes += [(f"d{d}_{str(dtype)[6:]}", dtype, HW_ROWS, WIDE_HEADS[d], HW_T, d)
               for d in WIDE_WIDTHS if d % 64 == 0 and d <= 512
               for dtype in (torch.bfloat16, torch.float32)]
    out = {}
    for key, dtype, rows, heads, t, d in shapes:
        q, k, v = torch.randn((rows, t, 3, heads, d), generator=gen,
                              device="cuda").to(dtype).unbind(2)
        do = torch.randn((rows, t, heads, d), generator=gen, device="cuda").to(dtype)
        o, lse = attn.flash_fwd(q, k, v)
        _, delta = attn.flash_bwd_dq(q, k, v, o, lse, do)
        for kernel, fn, tag in (
                ("fwd", lambda: attn.flash_fwd(q, k, v), "flash_fwd_wide"),
                ("dq", lambda: attn.flash_bwd_dq(q, k, v, o, lse, do), "flash_bwd_dq"),
                ("dkv", lambda: attn.flash_bwd_dkv(q, k, v, do, lse, delta),
                 "flash_bwd_dkv")):
            name = key if kernel == "fwd" else f"{key}_{kernel}"
            out[name] = time_ms(fn, 30)
            out[f"{name}_device"] = device_ms(fn, tag)[0]
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    import torch.nn.functional as F

    k1_shapes = [(f"k1_d{d}_{str(dtype)[6:]}", dtype, HW_ROWS, HW_T, d)
                 for d in (576, 1024) for dtype in (torch.bfloat16, torch.float32)]
    k1_shapes.append((f"k1_d1024_{WIDE_FWD_ROWS}rows_bfloat16", torch.bfloat16,
                      WIDE_FWD_ROWS, WIDE_T, 1024))
    for key, dtype, rows, t, d in k1_shapes:
        q, k, v = torch.randn((rows, t, 3, 1, d), generator=gen,
                              device="cuda").to(dtype).unbind(2)
        out[key] = time_ms(lambda: attn.flash_fwd(q, k, v), 30)
        out[f"{key}_device"] = device_ms(lambda: attn.flash_fwd(q, k, v), "flash_fwd")[0]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out[f"{key}_sdpa"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 30)
        out[f"{key}_bound"] = bound_ms(*attention_work(rows, 1, t, d, dtype, False),
                                       dtype)[0]
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def compare_attention_times(roots, of: str = "attention_times_of") -> dict:
    """``attention_times_of`` (or the function of this module named ``of``,
    e.g. ``wide_times_of``) for each checkout of ``roots``, each in a fresh
    process, in the order given (parent, tree, tree, parent), printed side
    by side; returns ``{root: [times, ...]}``:
    ``python3 -c "import chip_smoke as c; c.compare_attention_times(['<parent>',
    '.', '.', '<parent>'])"``."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys, chip_smoke as c; "
            f"print('ATTN_TIMES ' + json.dumps(c.{of}(sys.argv[1])))")
    out = {}
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", code, os.path.abspath(root)],
                              cwd=here, capture_output=True, text=True)
        check(proc.returncode == 0, f"attention times of {root}:\n{proc.stdout[-3000:]}"
                                    f"\n{proc.stderr[-3000:]}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("ATTN_TIMES ")]
        times = json.loads(line[-1][len("ATTN_TIMES "):])
        out.setdefault(root, []).append(times)
        print(f"  {root}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
              flush=True)
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
                    runs: int = TIMED_RUNS, **sample_kw) -> tuple:
    """One warm-up and ``runs`` runs of ``model.sample`` on
    ``inputs``, each on the host clock up to ``torch.cuda.synchronize()``
    with the counts zeroed just before it; every run's launch counts must be
    ``want`` (names absent from it: 0).  Prints each run, the median and the
    range; returns (the last output, seconds of the timed runs, the last
    run's counts)."""
    noise, onsets, embedding = inputs
    batch = noise.shape[0]
    seconds = []
    for run in range(runs + 1):
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
          f"s (range {min(seconds):.3f}-{max(seconds):.3f}) over {runs} warm runs, "
          f"8-s clips/min median {statistics.median(rate):.3f} (range "
          f"{min(rate):.3f}-{max(rate):.3f}); launches per run {launched}")
    return out, seconds, launched


def forward_full_vs_cached(model, attn, fr, inputs: tuple) -> dict:
    """One in-band UNet forward at the CFG batch of ``inputs`` (2B rows,
    the unconditional half masked), whole and on a DeepCache feature at
    ``DEEP_SPLIT``: device ms from the profiler (every kernel, and K1's
    alone) and eager ms (CUDA events), and K1's launches per forward."""
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
            out[f"{name}_k1_device_ms"], out[f"{name}_device_ms"], _ = device_ms(
                fn, "flash_fwd", calls=3)
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


def train_args(shard: str, logs: str, steps: int) -> list:
    """Phase 6's command line: f32, B = 4 x 2^18, accumulation 2, ``steps``
    micro-steps, one validation batch and a 2-step sample logger at the
    end."""
    return ["--train_path", shard, "--val_path", shard, "--logs_dir", logs,
            "--precision", "32", "--batch_size", str(BATCH), "--length", str(LENGTH),
            "--accumulate_grad_batches", str(ACCUMULATE), "--max_steps", str(steps),
            "--log_every_n_steps", "1", "--val_check_interval", str(steps),
            "--val_batches", "1", "--num_items", str(SAMPLE_ITEMS), "--sampling_steps",
            str(SAMPLE_STEPS)]


def phase_train(attn, fr, tmp: str, name: str, model_cfg=None, embedder="none",
                steps: int = TRAIN_STEPS):
    """Phases 6, 10 and 14c: the training command line at full width, f32,
    ``steps`` micro-steps, with the default model or ``model_cfg`` (passed
    as ``--model_config``), and ``--embedder embedder`` (None: the default,
    CLAP).  Returns (final state, launch counts, seconds per micro-step,
    peak GiB, the micro-steps' losses)."""
    from syncfusion_tpu_torch import train_diffusion
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer

    shard = os.path.join(tmp, "shard.tar")
    if not os.path.exists(shard):
        write_shard(shard)
    logs = os.path.join(tmp, name)
    args = train_args(shard, logs, steps) + ["--device", "cuda"]
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
    fused = bool(model_cfg and model_cfg["model"].get("fused_resnet"))
    want = {"kernel_launches": 9 * forwards, "dq_launches": 9 * backwards,
            "dkv_launches": 9 * backwards, "plain_calls": 0, "plain_bwd_calls": 0,
            "k3_kernel_launches": K3_PER_FORWARD * forwards if fused else 0,
            "k3_plain_calls": 0,
            "k4_kernel_launches": K4_PER_FORWARD * forwards if fused else 0,
            "k4_plain_calls": 0}
    print(f"  launches {launched} (expected {want}), peak memory {peak:.3f} GiB")
    check(launched == want, f"launch counts {launched} != {want}")
    sec = statistics.median(r["sec_per_step"] for r in train[1:])
    return state, launched, sec, peak, losses


def training_batch(tmp: str, shard: str | None = None) -> tuple:
    """One full-width batch of the phase-6 shard (or of ``shard``) with
    sigma, noise and an embedding: (wav, onsets, embedding, sigma, noise),
    on the card."""
    from syncfusion_tpu_torch.data.sfx_dataset import batched, create_sfx_dataset

    items = create_sfx_dataset(shard or os.path.join(tmp, "shard.tar"), sample_rate=SR,
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


# phase 16: the multi-device runs 16a-16c share one child of ``python -m
# torch.distributed.run --standalone --nproc_per_node 1`` (one start-up, not
# three): one rank, NCCL, cuda:LOCAL_RANK.  The card's machine has one H100 and NCCL refuses two
# ranks on one device, so FSDP and model_parallel (a model axis of at least
# 2 ranks) cannot run here; tests/test_torch_parallel.py runs them on the
# CPU over gloo.
MULTI_DEVICE_TIMEOUT = 400
# 16b and 16c: the ranks' numbers against the single process's on the same
# command, weights and batch.  At world size 1 the all-reduces leave every
# number as it was (NCCL's average over one rank multiplies by 1.0), so the
# first micro-step and the onset step agree to rounding; later micro-steps
# carry cuDNN's weight-gradient algorithms, which may sum in another order
# from one run to the next.
MD_FIRST_TOL, MD_LATER_TOL = 1e-6, 1e-4
MD_ONSET_TOL = 1e-6
# 16a: the data-parallel sampler's rows against SyncFusionDiffusion.sample on
# the same noise, 2 f32 steps: the same kernels on the same batch
MD_SAMPLE_TOL = 1e-6


def torchrun(out_dir: str) -> dict:
    """Phase 16's parts 16a-16c, one after the other, in one child under
    torchrun (one rank); returns the JSON it wrote: each part's numbers and
    its seconds in the child.  A child that exits non-zero fails the
    phase."""
    out = os.path.join(out_dir, "multi_device.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__), "--multi-device",
           out, out_dir]
    proc = subprocess.run(cmd, timeout=MULTI_DEVICE_TIMEOUT)
    check(proc.returncode == 0, f"phase 16: the rank exited {proc.returncode}")
    with open(out) as f:
        return json.load(f)


def md_sampler(device, attn, fr) -> dict:
    """16a: ``DataParallelSampler`` at the serving configuration, B = 8 on
    the one rank; one warm-up and SIDE_RUNS timed runs, each gated on its
    launches; then 2 f32 steps against ``SyncFusionDiffusion.sample``."""
    from syncfusion_tpu_torch.core.mesh import create_mesh
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.parallel.sampling import DataParallelSampler

    mesh = create_mesh()
    serving = dict(num_steps=NUM_STEPS, embedding_scale=SCALE, guidance_interval=BAND,
                   deep_cache_interval=SERVE_K, deep_split=DEEP_SPLIT)
    model = SyncFusionDiffusion.from_config(None, dtype=torch.bfloat16, device=device,
                                            seed=0)
    _, onsets, embedding = sampler_inputs(SERVE_BATCH)
    sampler = DataParallelSampler(model, mesh, per_chip_batch=SERVE_BATCH,
                                  length=LENGTH, **serving)
    check(sampler.local_indices().tolist() == list(range(SERVE_BATCH)),
          f"local_indices {sampler.local_indices()}")
    seconds = []
    want = {name: 0 for name in counts(attn, fr)} | {"kernel_launches": SERVE_K1}
    for run in range(SIDE_RUNS + 1):
        reset_counts(attn, fr)
        gen = torch.Generator(device=device).manual_seed(1)
        start = time.perf_counter()
        rows = sampler(onsets, embedding, gen)
        torch.cuda.synchronize()
        took = time.perf_counter() - start
        launched = counts(attn, fr)
        check(tuple(rows.shape) == (SERVE_BATCH, LENGTH) and bool(torch.isfinite(rows).all()),
              f"16a: rows {tuple(rows.shape)}")
        check(launched == want, f"16a: launch counts {launched} != {want}")
        print(f"  16a sampler, {'warm-up' if run == 0 else f'run {run}'}: {took:.3f} s",
              flush=True)
        if run:
            seconds.append(took)
    del model, sampler
    model32 = SyncFusionDiffusion.from_config(None, dtype=torch.float32, device=device,
                                              seed=0)
    check_kw = dict(serving, num_steps=2)
    rows = DataParallelSampler(model32, mesh, per_chip_batch=SERVE_BATCH, length=LENGTH,
                               **check_kw)(onsets, embedding,
                                           torch.Generator(device=device).manual_seed(7))
    noise = torch.randn((SERVE_BATCH, LENGTH, 1), device=device,
                        generator=torch.Generator(device=device).manual_seed(7))
    ref = model32.sample(noise, onsets, embedding, **check_kw)[:, :, 0]
    rel = ((rows - ref).abs().max() / ref.abs().max()).item()
    check(rel <= MD_SAMPLE_TOL, f"16a: rows against sample {rel:.3e}")
    return {"seconds": seconds, "launches": launched, "rel_vs_sample": rel,
            "clips_per_min": [SERVE_BATCH * LENGTH / SR / 8.0 / t_ * 60 for t_ in seconds]}


def md_train(device, attn, fr, tmp: str) -> dict:
    """16b: ``train_diffusion.main`` at phase 6's command line on the rank
    (the model in DDP); then fresh trainers, in DDP and in one process, take
    micro-steps on one batch in turns (timed), and one DDP micro-step under
    the profiler, whose device events must show NCCL's all-reduce."""
    from torch.profiler import ProfilerActivity, profile

    from syncfusion_tpu_torch import train_diffusion
    from syncfusion_tpu_torch.core.mesh import mesh_for_batch
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.train.diffusion_trainer import DiffusionTrainer, OptimizerConfig

    shard = os.path.join(tmp, "shard.tar")
    write_shard(shard)
    logs = os.path.join(tmp, "ddp")
    reset_counts(attn, fr)
    state = train_diffusion.main(train_args(shard, logs, TRAIN_STEPS) + ["--embedder", "none"])
    torch.cuda.synchronize()
    launched = counts(attn, fr)
    check(isinstance(state.model, torch.nn.parallel.DistributedDataParallel),
          f"16b: the model is a {type(state.model).__name__}, not DDP")
    forwards, backwards = TRAIN_STEPS + 1 + SAMPLE_STEPS, TRAIN_STEPS
    want = {name: 0 for name in launched} | {
        "kernel_launches": 9 * forwards, "dq_launches": 9 * backwards,
        "dkv_launches": 9 * backwards}
    check(launched == want, f"16b: launch counts {launched} != {want}")
    (run,) = os.listdir(os.path.join(logs, "runs"))
    run = os.path.join(logs, "runs", run)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        train = [r for r in map(json.loads, f) if "train_loss" in r]
    del state
    torch.cuda.empty_cache()

    mesh = mesh_for_batch(BATCH)
    trainers = {name: DiffusionTrainer(
        SyncFusionDiffusion.from_config(None, device=device, seed=0),
        OptimizerConfig(accumulate_grad_batches=ACCUMULATE),
        mesh=mesh if name == "ddp" else None) for name in ("ddp", "single")}
    states = {name: tr.create_state() for name, tr in trainers.items()}
    wav, onsets, emb, _, _ = training_batch(tmp)
    batch = {"wav": wav, "onsets": onsets, "embedding": emb}

    def micro_step(name, seed):
        torch.cuda.synchronize()
        start = time.perf_counter()
        trainers[name].train_step(states[name], batch,
                                  torch.Generator(device=device).manual_seed(seed))
        torch.cuda.synchronize()
        return time.perf_counter() - start

    # the same micro-steps in DDP and in one process, in turns
    turns = {"ddp": [], "single": []}
    for name in ("ddp", "single", "single", "ddp", "ddp", "single"):
        secs = [micro_step(name, i) for i in range(2 * ACCUMULATE)]
        turns[name] += secs[ACCUMULATE:]  # the first update of each turn warms up
    print(f"  16b micro-steps on one batch, in turns: DDP s {turns['ddp']}, one "
          f"process s {turns['single']}", flush=True)
    del trainers["single"], states["single"]
    trainer, fresh = trainers["ddp"], states["ddp"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(fresh, batch, torch.Generator(device=device).manual_seed(1))
        torch.cuda.synchronize()
    on_device = sorted({e.name for e in prof.events()
                        if e.device_type.name == "CUDA" and "nccl" in e.name.lower()})
    onerank = sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"
                      and "onerank" in e.name.lower()})
    check(bool(on_device), "16b: no NCCL event on the device in a profiled micro-step")
    return {"losses": [r["train_loss"] for r in train],
            "sec_per_step": statistics.median(r["sec_per_step"] for r in train[1:]),
            "secs": [r["sec_per_step"] for r in train],
            "turns": {k: statistics.median(v) for k, v in turns.items()},
            "launches": launched, "ckpt_dir": os.path.join(run, "ckpts"),
            "nccl_device_events": on_device, "nccl_kernels": onerank}


def md_onset(device, tmp: str) -> dict:
    """16c: the full-width onset trainer over the one-rank mesh (DDP,
    synchronised BatchNorm) against the single-process ``OnsetTrainer`` on
    the same weights and batch, one bf16 step each; then phase 11's steps
    through ``train_onset.fit_epoch`` on the rank, timed."""
    from syncfusion_tpu_torch import train_onset
    from syncfusion_tpu_torch.core.config import OnsetConfig
    from syncfusion_tpu_torch.core.logging import MetricLogger
    from syncfusion_tpu_torch.core.mesh import mesh_for_batch
    from syncfusion_tpu_torch.data.prefetch import to_device

    cfg = OnsetConfig.from_dict({"model": {"precision": "bf16"},
                                 "trainer": {"seed": 0, "log_every_n_steps": 1}})
    mesh = mesh_for_batch(ONSET_BATCH)
    ranked = train_onset.build_trainer(cfg, device, mesh=mesh)
    single = train_onset.build_trainer(cfg, device)
    batch = next(onset_batches(1, 0))
    out = {}
    for name, trainer in (("ranked", ranked), ("single", single)):
        state = trainer.create_state()
        metrics, _ = trainer.train_step(state, to_device(batch, device, trainer.mesh))
        out[name] = (metrics["loss/train"].item(),
                     {k: v.clone() for k, v in trainer.model.named_buffers()})
    (loss_r, buf_r), (loss_s, buf_s) = out["ranked"], out["single"]
    rel_loss = abs(loss_r - loss_s) / abs(loss_s)
    rel_buf = max(((buf_r[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                  for k, v in buf_s.items())
    check(rel_loss <= MD_ONSET_TOL and rel_buf <= MD_ONSET_TOL,
          f"16c: loss {rel_loss:.3e}, buffers {rel_buf:.3e} against one process")
    del single
    state = ranked.create_state()
    logger = MetricLogger(os.path.join(tmp, "onset_ddp"))
    train_onset.fit_epoch(ranked, state, onset_batches(ONSET_WARMUP + ONSET_TIMED, 0),
                          device, logger, 1, torch.Generator(device=device).manual_seed(1))
    logger.close()
    with open(os.path.join(tmp, "onset_ddp", "metrics.jsonl")) as f:
        secs = [r["sec_per_step"] for r in map(json.loads, f)][ONSET_WARMUP:]
    return {"rel_loss": rel_loss, "rel_buffers": rel_buf, "seconds": secs,
            "sec_per_step": statistics.median(secs)}


def multi_device_child(out: str, tmp: str) -> int:
    """The one rank of phase 16 (under torchrun): joins NCCL on
    cuda:LOCAL_RANK, runs 16a, 16b and 16c (``tmp`` holds 16b's and 16c's
    files) and writes their numbers to ``out``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from syncfusion_tpu_torch.core.mesh import init_distributed
    from syncfusion_tpu_torch.device import set_exact_f32
    from syncfusion_tpu_torch.ops import attention as attn
    from syncfusion_tpu_torch.ops import fused_resblock as fr

    set_exact_f32()
    device = init_distributed()
    want = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    check(dist.get_backend() == "nccl" and device == want,
          f"rank on {device} over {dist.get_backend()}, not {want} over nccl")
    result = {"world_size": dist.get_world_size(), "backend": dist.get_backend(),
              "device": str(device)}
    for part, run in (("sampler", lambda: md_sampler(device, attn, fr)),
                      ("train", lambda: md_train(device, attn, fr, tmp)),
                      ("onset", lambda: md_onset(device, tmp))):
        start = time.perf_counter()
        result[part] = run()
        torch.cuda.empty_cache()
        result[part]["child_seconds"] = time.perf_counter() - start
    with open(out, "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def phase_multi_device(tmp: str, serve_clips_per_min: float, train_losses: list,
                       train_sec: float, onset_sec: float) -> dict:
    """Phase 16: 16a-16c in one child under torchrun, 16d here: 16b's
    checkpoint into a single-process ``DiffusionTrainer``, strictly."""
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.train.diffusion_trainer import DiffusionTrainer

    t0 = time.perf_counter()
    child = torchrun(tmp)
    phase("16a-c one torchrun child: sampler, DDP training, onset training", t0)
    sampler, train, onset = child["sampler"], child["train"], child["onset"]
    cpm = sampler["clips_per_min"]
    print(f"  16a data-parallel sampler, serving configuration, B={SERVE_BATCH} on "
          f"1 rank: s {spread(sampler['seconds'], 1)}, 8-s clips/min median "
          f"{statistics.median(cpm):.3f} (range {min(cpm):.3f}-{max(cpm):.3f}; phase "
          f"4c {serve_clips_per_min:.3f}); K1 {sampler['launches']['kernel_launches']} "
          f"a run, rows against sample (2 f32 steps) {sampler['rel_vs_sample']:.3e} "
          f"(tol {MD_SAMPLE_TOL:.0e}); {sampler['child_seconds']:.3f} s in the child",
          flush=True)
    first = abs(train["losses"][0] - train_losses[0]) / abs(train_losses[0])
    later = max(abs(a - b) / abs(b) for a, b in zip(train["losses"][1:], train_losses[1:]))
    print(f"  16b DDP training: losses {['%.6f' % x for x in train['losses']]} against "
          f"phase 6's {['%.6f' % x for x in train_losses]}: first {first:.3e} (tol "
          f"{MD_FIRST_TOL:.0e}), later {later:.3e} (tol {MD_LATER_TOL:.0e}); "
          f"{train['sec_per_step']:.4f} s per micro-step (median of steps 2-"
          f"{TRAIN_STEPS}, each {['%.4f' % x for x in train['secs']]}; phase 6: "
          f"{train_sec:.4f}); on one batch in turns, median DDP "
          f"{train['turns']['ddp']:.4f} s against one process "
          f"{train['turns']['single']:.4f} s "
          f"({train['turns']['ddp'] / train['turns']['single']:.4f}x); "
          f"NCCL on the device: {train['nccl_device_events']}, kernels "
          f"{train['nccl_kernels']}; {train['child_seconds']:.3f} s in the child", flush=True)
    check(len(train["losses"]) == len(train_losses), "16b: micro-steps logged")
    check(first <= MD_FIRST_TOL and later <= MD_LATER_TOL,
          "16b: the rank's losses disagree with the single process's")
    print(f"  16c onset training, synchronised BatchNorm, bf16, B={ONSET_BATCH}: one "
          f"step against one process: loss {onset['rel_loss']:.3e}, buffers "
          f"{onset['rel_buffers']:.3e} (tol {MD_ONSET_TOL:.0e}); "
          f"{onset['sec_per_step']:.4f} s per step (phase 11: {onset_sec:.4f}; steps "
          f"{['%.4f' % x for x in onset['seconds']]}); {onset['child_seconds']:.3f} s in "
          "the child", flush=True)

    t0 = time.perf_counter()
    saved = Checkpointer(CheckpointConfig(train["ckpt_dir"])).restore()
    state = DiffusionTrainer(SyncFusionDiffusion.from_config(
        None, device="cuda", seed=1)).create_state()
    state.load_state_dict(saved)
    check(state.step == TRAIN_STEPS and all(
        torch.equal(v.cpu(), saved["model"][k]) for k, v in state.model.state_dict().items()),
        "16d: the restored state is not the checkpoint's")
    print(f"  16d: 16b's checkpoint (step {state.step}) restored into one process "
          f"with strict=True", flush=True)
    del state, saved
    torch.cuda.empty_cache()
    phase("16d checkpoint into one process", t0)
    print(json.dumps({"multi_device": {
        "world_size": child["world_size"], "backend": child["backend"],
        "launcher": "python -m torch.distributed.run --standalone --nproc_per_node 1",
        "device": child["device"],
        "ran": ["16a DataParallelSampler (serving)", "16b train_diffusion.main in DDP",
                "16c OnsetTrainer with synchronised BatchNorm",
                "16d the DDP checkpoint into one process"],
        "not_run": "FSDP and model_parallel: a model axis needs 2 ranks, one card "
                   "has 1 (tests/test_torch_parallel.py runs them over gloo)"}}))
    return {"sampler": sampler["launches"], "train": train["launches"]}


# phase 17: the CondFoleyGen baseline's generation (generate_audio) at the
# full width of cfg/condfoleygen/*.yaml: the GPT 24 x 1024 (16 heads, block
# 160), SpecVQGAN ch 128 (1, 1, 2, 2, 4), MelGAN ngf 32, the R(2+1)D-18
# video net on 112 x 112 frames; seeded weights, f32 without TF32; B = 4
# (generate_audio's --batch_size), 2-s 22.05 kHz clips and 60 frames
CFG_BATCH = 4
CFG_TOP_K = 512
CFG_SAMPLES = 44100
CFG_FRAMES = 60
CFG_GL_ITERS = 32
CFG_STAGES = ("wav_to_spec", "vq_encode", "video_features", "gpt_50_cached_steps",
              "vq_decode", "melgan", "griffin_lim_32")
# card against CPU, same weights and inputs (one item), f32 without TF32:
# the spectrogram in [-1, 1] absolute; the VQ latent, the video features,
# the teacher-forced logits, the decoded mel and MelGAN's wav relative to
# their largest magnitude (sums of up to 9216 products in other orders); a
# code or token may differ only where the CPU's two best lie within
# CFG_GAP_TOL of the largest distance or logit; Griffin-Lim from one phase
# after 32 momentum iterations (which amplify each one's rounding) over the
# mel's 160 x 256 samples, relative to its largest sample, as
# tests/test_torch_condfoleygen.py holds it against the JAX package
CFG_SPEC_TOL = 1e-5
CFG_REL_TOL = 1e-4
CFG_GAP_TOL = 2 * CFG_REL_TOL
CFG_GL_TOL = 1e-3


def baseline_inputs(batch: int, seed: int = 17) -> tuple:
    """Seeded 2-s 22.05 kHz wavs (B, 44100) and 60 normalised frames (B,
    60, 112, 112, 3), numpy f32."""
    rng = np.random.default_rng(seed)
    wav = (0.1 * rng.standard_normal((batch, CFG_SAMPLES))).astype(np.float32)
    frames = rng.standard_normal((batch, CFG_FRAMES, 112, 112, 3)).astype(np.float32)
    return wav, frames


def first_flip_gap(got, want, scores, pre: int) -> float:
    """0 where ``got`` equals ``want`` (rows of ints); else the largest, over
    the rows that differ, of |scores[want] - scores[got]| at the row's first
    differing step after ``pre``; ``scores`` (B, steps, V) are the logits
    or distances of the run that gave ``want``."""
    gap = 0.0
    for b in torch.nonzero((got != want).any(dim=1)).flatten().tolist():
        i = int(torch.nonzero(got[b] != want[b])[0])
        row = scores[b, i - pre]
        gap = max(gap, float((row[want[b, i]] - row[got[b, i]]).abs()))
    return gap


def baseline_cross_check(model, vocoder, wav: np.ndarray, frames: np.ndarray) -> dict:
    """The full-width baseline on the card against a CPU copy of it, on one
    item: the spectrogram; the VQ latent and codes (on the CPU's
    spectrogram); the video features; 50 cached top-k 1 GPT steps on both
    and the uncached ``sample_tokens`` on the card (on the CPU's tokens and
    features), with the teacher-forced logits on the CPU's buffer; the
    decoded mel, MelGAN and 32 Griffin-Lim iterations from one phase, on the
    CPU's grid.  Returns the errors (relative where CFG_REL_TOL applies) and
    the gaps at flipped codes or tokens over their scale."""
    import copy

    from syncfusion_tpu_torch.device import exact_f32
    from syncfusion_tpu_torch.generate_audio import spec01
    from syncfusion_tpu_torch.models.mingpt import sample_tokens
    from syncfusion_tpu_torch.models.mingpt_decode import sample_tokens_cached
    from syncfusion_tpu_torch.models.transformer_av import column_major, column_major_inverse
    from syncfusion_tpu_torch.models.vqgan.model import wav_to_spec
    from syncfusion_tpu_torch.ops.mel import mel01_to_waveform_gl

    def rel(card, cpu):
        return float((card.cpu() - cpu).abs().max() / cpu.abs().max())

    cpu = copy.deepcopy(model).cpu()
    cpu_voc = copy.deepcopy(vocoder.net).cpu()
    out = {}
    with torch.inference_mode(), exact_f32():
        x = torch.from_numpy(wav)
        spec = wav_to_spec(x)[:, None]
        out["spec"] = float((wav_to_spec(x.cuda())[:, None].cpu() - spec).abs().max())
        h = cpu.vq.quant_conv(cpu.vq.encoder(spec))
        out["vq_latent"] = rel(model.vq.quant_conv(model.vq.encoder(spec.cuda())), h)
        codes = cpu.vq.encode_indices(spec)
        dist = cpu.vq.quantize.distances(h.permute(0, 2, 3, 1).reshape(-1, h.shape[1]))
        out["code_gap"] = first_flip_gap(model.vq.encode_indices(spec.cuda()).cpu().reshape(1, -1),
                                         codes.reshape(1, -1), dist[None], 0
                                         ) / float(dist.abs().max())
        feats = cpu.encode_to_c(torch.from_numpy(frames))
        out["video_features"] = rel(model.encode_to_c(torch.from_numpy(frames).cuda()), feats)
        zp = column_major(codes)[:, :model.clip]
        steps = model.clip
        buf = sample_tokens_cached(cpu.gpt, feats, zp, steps, top_k=1)
        buf_card = sample_tokens_cached(model.gpt, feats.cuda(), zp.cuda(), steps, top_k=1).cpu()
        buf_plain = sample_tokens(model.gpt, feats.cuda(), zp.cuda(), steps, top_k=1).cpu()
        pos = feats.shape[1] + zp.shape[1] - 1
        logits = cpu.gpt(buf[:, :-1], feats)[:, pos:]
        logits_card = model.gpt(buf_card[:, :-1].cuda(), feats.cuda())[:, pos:].cpu()
        out["logits"] = rel(model.gpt(buf[:, :-1].cuda(), feats.cuda())[:, pos:], logits)
        scale = float(logits.abs().max())
        out["token_gap"] = first_flip_gap(buf_card, buf, logits, zp.shape[1]) / scale
        out["uncached_gap"] = first_flip_gap(buf_plain, buf_card, logits_card,
                                             zp.shape[1]) / scale
        out["tokens_flipped"] = int((buf_card != buf).sum())
        out["uncached_flipped"] = int((buf_plain != buf_card).sum())
        out["tokens_in_range"] = bool(((buf_card >= 0) & (buf_card < cpu.gpt.cfg.vocab_size)).all())
        grid = column_major_inverse(buf[:, zp.shape[1]:])
        mel = spec01(cpu, grid)
        out["decoded_mel"] = rel(spec01(model, grid.cuda()), mel)
        out["melgan"] = rel(vocoder.net(mel.cuda()), cpu_voc(mel))
        theta = 2.0 * math.pi * torch.rand((1, 513, mel.shape[-1]),
                                           generator=torch.Generator().manual_seed(0))
        span = mel.shape[-1] * 256
        gl = mel01_to_waveform_gl(mel, 22050, n_iter=CFG_GL_ITERS, theta=theta)[:, :span]
        out["griffin_lim"] = rel(mel01_to_waveform_gl(mel.cuda(), 22050, n_iter=CFG_GL_ITERS,
                                                      theta=theta.cuda())[:, :span], gl)
    del cpu, cpu_voc
    return out


def baseline_failed_gates(err: dict) -> list:
    """The names of ``baseline_cross_check``'s errors over their tolerance."""
    tol = {"spec": CFG_SPEC_TOL, "griffin_lim": CFG_GL_TOL,
           **{k_: CFG_REL_TOL for k_ in ("vq_latent", "video_features", "logits",
                                          "decoded_mel", "melgan")},
           **{k_: CFG_GAP_TOL for k_ in ("code_gap", "token_gap", "uncached_gap")}}
    failed = [k_ for k_, t_ in tol.items() if not err[k_] <= t_]
    return failed + ([] if err["tokens_in_range"] else ["tokens_in_range"])


def time_baseline(model, vocoder, wav: np.ndarray, frames: np.ndarray, gen) -> dict:
    """One pass of the generation over a batch, each stage between CUDA
    events: ms per stage, the host's seconds, and the outputs' checks."""
    from syncfusion_tpu_torch.generate_audio import spec01
    from syncfusion_tpu_torch.models.mingpt_decode import sample_tokens_cached
    from syncfusion_tpu_torch.models.transformer_av import column_major_inverse
    from syncfusion_tpu_torch.models.vqgan.model import wav_to_spec
    from syncfusion_tpu_torch.ops.mel import mel01_to_waveform_gl

    x, f = torch.from_numpy(wav).cuda(), torch.from_numpy(frames).cuda()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(CFG_STAGES) + 1)]
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.inference_mode():
        events[0].record()
        spec = wav_to_spec(x)[:, None]
        events[1].record()
        zp = model.encode_to_z(spec)[:, :model.clip]
        events[2].record()
        feats = model.encode_to_c(f)
        events[3].record()
        buf = sample_tokens_cached(model.gpt, feats, zp, model.clip, gen, top_k=CFG_TOP_K)
        events[4].record()
        mel = spec01(model, column_major_inverse(buf[:, model.clip:]))
        events[5].record()
        wav_mg = vocoder(mel)
        events[6].record()
        wav_gl = mel01_to_waveform_gl(mel, 22050, n_iter=CFG_GL_ITERS)
        events[7].record()
    torch.cuda.synchronize()
    host = time.perf_counter() - start
    ms = {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(CFG_STAGES)}
    b = wav.shape[0]
    check(tuple(spec.shape) == (b, 1, 80, 160) and tuple(feats.shape) == (b, CFG_FRAMES, 512)
          and tuple(mel.shape) == (b, 80, 160), "baseline: stage shapes")
    check(bool(((buf >= 0) & (buf < model.gpt.cfg.vocab_size)).all()), "baseline: token range")
    check(tuple(wav_mg.shape) == (b, 160 * 256) and tuple(wav_gl.shape) == (b, 512 + 256 * 159)
          and all(bool(torch.isfinite(a).all()) for a in (mel, wav_mg, wav_gl)),
          f"baseline: wavs {tuple(wav_mg.shape)}, {tuple(wav_gl.shape)}")
    return {"ms": ms, "host_s": host}


def write_baseline_root(root: str, onsets=(0.5, 1.0)) -> str:
    """A processed Greatest Hits root of 2 videos of 3 s at 15 fps
    (GREY_JPEG frames 1-46), each with ``onsets`` (one item each: 4 items by
    default; 30 frames a chunk) and a 22.05 kHz track of noise with a burst
    at each onset; its split file is test.txt.  Returns a JSON config of
    it."""
    from syncfusion_tpu_torch.ops.wav import write_wav

    rng = np.random.default_rng(18)
    names = ["clip_a", "clip_b"]
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(os.path.join(d, "audio"))
        os.makedirs(os.path.join(d, "frames"))
        with open(os.path.join(d, f"{name}.metadata.json"), "w") as f:
            json.dump({"processed": {"video_frame_rate": 15, "video_duration": 3.0}}, f)
        with open(os.path.join(d, f"{name}.times.csv"), "w") as f:
            f.write("".join(f"{t},hit\n" for t in onsets))
        wav = 0.01 * rng.standard_normal(3 * 22050)
        for onset in onsets:
            i = int(onset * 22050)
            wav[i:i + 2205] += 0.8 * rng.standard_normal(2205) * np.exp(-np.arange(2205) / 400)
        write_wav(os.path.join(d, "audio", f"{name}.resampled.wav"), wav.astype(np.float32),
                  22050)
        for i in range(1, 47):
            with open(os.path.join(d, "frames", f"{name}.frame_{i:06d}.jpg"), "wb") as f:
                f.write(GREY_JPEG)
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    cfg = os.path.join(root, "baseline.json")
    with open(cfg, "w") as f:
        json.dump({"data": {"root_dir": root,
                            "test_split_file_path": os.path.join(root, "test.txt")}}, f)
    return cfg


def phase_condfoleygen(attn, fr, tmp: str) -> dict:
    """Phase 17: the CondFoleyGen baseline's generation at full width, f32
    without TF32: (a) the parts' parameter counts, then one warm-up and
    ``TIMED_RUNS`` runs at B = 4 timed stage by stage (CUDA events), with
    the peak memory, and the device time of the GPT's decode and the video
    features by torch.profiler; (b) the card against the CPU on one item
    (``baseline_cross_check``), gated; (c) ``generate_audio.main`` on a
    4-item processed root written to ``tmp`` and
    ``evaluate_onset_baseline.main --gt_root`` on its output, where PIL is
    importable (it decodes the frames).  No hand-written kernel launches:
    the counts are zeroed before and gated at 0 after.  Returns the
    counts."""
    from syncfusion_tpu_torch import evaluate_onset_baseline, generate_audio
    from syncfusion_tpu_torch.core.config import BaselineConfig
    from syncfusion_tpu_torch.models.melgan import Vocoder
    from syncfusion_tpu_torch.models.mingpt_decode import sample_tokens_cached
    from syncfusion_tpu_torch.models.vqgan.model import wav_to_spec
    from syncfusion_tpu_torch.ops.wav import read_wav

    reset_counts(attn, fr)
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    model = generate_audio.build_model(BaselineConfig(), "cuda", seed=0)
    vocoder = Vocoder(device="cuda")
    torch.cuda.synchronize()
    sizes = {name: sum(p_.numel() for p_ in getattr(model, name).parameters())
             for name in ("vq", "video", "gpt")}
    sizes["melgan"] = sum(p_.numel() for p_ in vocoder.net.parameters())
    print(f"  full-width baseline built in {time.perf_counter() - start:.3f} s: parameters "
          + ", ".join(f"{k_} {v_:,}" for k_, v_ in sizes.items()), flush=True)

    wav, frames = baseline_inputs(CFG_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = [time_baseline(model, vocoder, wav, frames, gen) for _ in range(TIMED_RUNS + 1)][1:]
    ms = {name: [r["ms"][name] for r in runs] for name in CFG_STAGES}
    common = [sum(r["ms"][n_] for n_ in CFG_STAGES[:5]) for r in runs]
    for label, stage in (("MelGAN", "melgan"), ("Griffin-Lim", "griffin_lim_32")):
        total = [c + m for c, m in zip(common, ms[stage])]
        print(f"  B={CFG_BATCH}, top-k {CFG_TOP_K}, {label}: ms a batch {spread(total, 1)} "
              f"(CUDA events), {CFG_BATCH / statistics.median(total) * 1e3:.3f} clips/s")
    print("  stages, ms a batch over " + f"{TIMED_RUNS} runs: " + "; ".join(
        f"{name} {spread(v_, 1)}" for name, v_ in ms.items()))
    print(f"  host s a pass (all stages, both vocoders): {spread([r['host_s'] for r in runs], 1)}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    with torch.inference_mode():
        f = torch.from_numpy(frames).cuda()
        zp = model.encode_to_z(wav_to_spec(torch.from_numpy(wav).cuda())[:, None])[:, :model.clip]
        feats = model.encode_to_c(f)
        _, gpt_dev, gpt_kernels = device_ms(lambda: sample_tokens_cached(
            model.gpt, feats, zp, model.clip, gen, top_k=CFG_TOP_K), "", calls=2)
        _, video_dev, video_kernels = device_ms(lambda: model.encode_to_c(f), "", calls=2)
    gpt_ms = statistics.median(ms["gpt_50_cached_steps"])
    print(f"  device time (torch.profiler) a batch: GPT 50 cached steps {gpt_dev:.3f} ms in "
          f"{gpt_kernels:.0f} kernels and copies, against {gpt_ms:.3f} ms between CUDA events "
          f"(idle share {1 - gpt_dev / gpt_ms:.3f}); video features {video_dev:.3f} ms in "
          f"{video_kernels:.0f}", flush=True)

    err = baseline_cross_check(model, vocoder, wav[:1], frames[:1])
    print(f"  card vs CPU, one item: spectrogram {err['spec']:.3e} (tol {CFG_SPEC_TOL:.0e}); "
          f"VQ latent {err['vq_latent']:.3e}, video features {err['video_features']:.3e}, "
          f"teacher-forced logits {err['logits']:.3e}, decoded mel {err['decoded_mel']:.3e}, "
          f"MelGAN {err['melgan']:.3e} (tol {CFG_REL_TOL:.0e}); Griffin-Lim "
          f"{CFG_GL_ITERS} iterations {err['griffin_lim']:.3e} (tol {CFG_GL_TOL:.0e}); "
          f"codes flipped at gap {err['code_gap']:.3e}, top-k 1 tokens card vs CPU "
          f"{err['tokens_flipped']} flipped (gap {err['token_gap']:.3e}), cached vs "
          f"uncached on the card {err['uncached_flipped']} flipped (gap "
          f"{err['uncached_gap']:.3e}; tol {CFG_GAP_TOL:.0e})", flush=True)
    failed = baseline_failed_gates(err)
    check(not failed, f"baseline: card against CPU fails {failed}")
    del model, vocoder
    torch.cuda.empty_cache()

    if importlib.util.find_spec("PIL") is None:
        print("  generate_audio.main on a processed root: not run (PIL, which decodes "
              "the frames, is not importable here)")
    else:
        root, out = os.path.join(tmp, "gh"), os.path.join(tmp, "gen")
        os.makedirs(root)
        cfg = write_baseline_root(root)
        start = time.perf_counter()
        summary = generate_audio.main(["--gh_testset", "-c", cfg, "--output_dir", out])
        seconds = time.perf_counter() - start
        wavs = sorted(os.listdir(os.path.join(out, "generated_audio")))
        check(summary["clips"] == len(wavs) == 4, f"generate_audio wrote {wavs}")
        for name in wavs:
            w, sr = read_wav(os.path.join(out, "generated_audio", name))
            check(sr == 22050 and w.shape == (1, 512 + 256 * 159) and bool(np.isfinite(w).all()),
                  f"generate_audio: {name} {w.shape} at {sr} Hz")
        for sub in ("generated_video", "orig_video", "cond_video"):
            check(len([n_ for n_ in os.listdir(os.path.join(out, sub)) if n_.endswith(".mp4")])
                  >= 2, f"generate_audio: {sub}")
        metrics = evaluate_onset_baseline.main(["--gen_dir", out, "--gt_root", root])
        check(metrics["num_files"] == 4 and all(math.isfinite(v) for v in metrics.values()),
              f"evaluate_onset_baseline: {metrics}")
        print(f"  generate_audio.main ran (PIL importable): 4 clips with the artifact set in "
              f"{seconds:.3f} s (model build, PIL frames, Griffin-Lim, muxing); "
              f"evaluate_onset_baseline --gt_root {metrics}", flush=True)
    launched = counts(attn, fr)
    check(not any(launched.values()), f"baseline: a hand-written kernel or its plain "
          f"version ran: {launched}")
    print(f"  launch counts over the phase: {launched} (no TPU kernel lies on this path)")
    return launched


# phase 18: the baseline's training at the full width of
# cfg/condfoleygen/greatesthit_{codebook,transformer}.yaml, f32 without TF32
VQT_BATCH = 40  # the codebook YAML's batch
VQT_DISC_START = 3  # both regimes inside the timed steps
GPT_BATCH = 4  # the transformer YAML's batch
TRAIN_STEPS_18 = 5  # timed; the median of steps 3-5
# card against CPU, same weights and batch (VQGAN B = 2, GPT B = 1): losses
# and D's new running statistics CFG_REL_TOL relative; gradients of the
# trained parameters as phase 7 holds gradients (TRAIN_GRAD_TOL of each
# tensor's largest, floored at GRAD_FLOOR of the largest of all); a code may
# flip only within CFG_GAP_TOL of the largest distance (phase 17's rule),
# and where one flips the losses and gradients are printed, not gated (a
# flipped code moves them by far more than rounding).  The VQGAN's f32
# gradients are held against the CPU's f64 ones on the same side of every
# kink (``vqgan_cross_check`` says why), beside the CPU's own f32 ones as a
# witness: each tensor's gap on the card may be WITNESS_FACTOR times the
# CPU f32's, and TRAIN_GRAD_TOL in any case
WITNESS_FACTOR = 4.0


def baseline_specs(batch: int, seed: int, device) -> torch.Tensor:
    """Seeded 2-s 22.05 kHz wavs -> spectrograms (B, 1, 80, 160) made on
    ``device``."""
    from syncfusion_tpu_torch.models.vqgan.model import wav_to_spec

    wav = 0.1 * np.random.default_rng(seed).standard_normal((batch, CFG_SAMPLES))
    return wav_to_spec(torch.from_numpy(wav.astype(np.float32)).to(device))[:, None]


def step_seconds(fn, steps: int) -> list:
    """``fn`` called ``steps`` times, each on the host clock up to
    ``torch.cuda.synchronize()``."""
    secs = []
    for _ in range(steps):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - start)
    return secs


def code_flips(vq_card, vq_cpu, spec_cpu: torch.Tensor) -> tuple:
    """(codes ``vq_card`` picks otherwise than ``vq_cpu``, the largest gap at
    a flip over the largest distance) of one spectrogram batch, each VQ on
    its own device and in its own type."""
    with torch.no_grad():
        h = vq_cpu.quant_conv(vq_cpu.encoder(spec_cpu))
        flat = h.permute(0, 2, 3, 1).reshape(-1, h.shape[1])
        dist = vq_cpu.quantize.distances(flat)
        want = dist.argmin(dim=1)
        p = next(vq_card.parameters())
        got = vq_card.encode_indices(spec_cpu.to(p.device, p.dtype)).cpu().reshape(-1)
    gap = first_flip_gap(got[None], want[None], dist[None], 0) / float(dist.abs().max())
    return int((got != want).sum()), gap


def stat_gap(card: dict, cpu: dict) -> float:
    return max(float((card[k].cpu() - v).abs().max() / v.abs().max()) for k, v in cpu.items())


class KinkTape:
    """Stands in for ``torch.nn.functional`` in the VQGAN trainer, LPAPS
    and discriminator modules inside ``with tape:``.  Recording, it calls
    the same functions and keeps each ReLU's and LeakyReLU's mask and each
    max-pool's choices in call order; with ``replay`` (another run's tape)
    each takes that run's side and choice instead (the exact gradient on
    that run's path) and notes where its own differ (``flips``) and how
    near the kink its value was (``gap``: |value| at a flip, or the pooled
    value's shortfall, over the tensor's largest |value|).  ``l1_path``
    does the same for the sign of G's L1 term."""

    def __init__(self, replay: "KinkTape | None" = None):
        self.sides = [] if replay is None else replay.sides
        self.l1 = None if replay is None else replay.l1
        self.replay = replay is not None
        self.calls, self.flips, self.gap = 0, 0, 0.0

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def _modules(self):
        from syncfusion_tpu_torch.models.vqgan import discriminator, lpaps
        from syncfusion_tpu_torch.train import vqgan_trainer
        return discriminator, lpaps, vqgan_trainer

    def __enter__(self) -> "KinkTape":
        for m_ in self._modules():
            m_.F = self
        return self

    def __exit__(self, *exc) -> None:
        for m_ in self._modules():
            m_.F = torch.nn.functional

    def _side(self, record: torch.Tensor):
        """The side ``record`` (a mask or indices) of this site: recorded
        and None, or the replayed run's."""
        if not self.replay:
            self.sides.append(record.cpu())
            return None
        self.calls += 1
        return self.sides[self.calls - 1].to(record.device)

    def _note(self, differ: torch.Tensor, dist: torch.Tensor, scale: torch.Tensor) -> None:
        if differ.any():
            self.flips += int(differ.sum())
            self.gap = max(self.gap, float(dist[differ].max() / scale))

    def relu(self, x):
        want = self._side((x > 0).detach())
        if want is None:
            return torch.nn.functional.relu(x)
        self._note((x > 0) != want, x.detach().abs(), x.detach().abs().max())
        return x * want.to(x.dtype)

    def leaky_relu(self, x, negative_slope=0.01):
        want = self._side((x > 0).detach())
        if want is None:
            return torch.nn.functional.leaky_relu(x, negative_slope)
        self._note((x > 0) != want, x.detach().abs(), x.detach().abs().max())
        return torch.where(want, x, negative_slope * x)

    def max_pool2d(self, x, kernel_size, stride):
        y, own = torch.nn.functional.max_pool2d(x, kernel_size, stride, return_indices=True)
        want = self._side(own)
        if want is None:
            return y
        picked = x.flatten(2).gather(2, want.flatten(2)).view_as(y)
        self._note(want != own, (y - picked).detach(), x.detach().abs().max())
        return picked

    def l1_path(self, x: torch.Tensor, xrec: torch.Tensor) -> torch.Tensor:
        """``xrec`` for G's L1 term: recording, as it is (its signs kept);
        replaying, moved by 2|x - xrec| where the replayed run's sign of
        x - xrec differs, the gradient passed straight through."""
        d = (x - xrec).detach()
        if not self.replay:
            self.l1 = (d > 0).cpu()
            return xrec
        want = self.l1.to(d.device)
        self._note((d > 0) != want, d.abs(), d.abs().max())
        return xrec - (torch.where(want, d.abs(), -d.abs()) - d)


def vqgan_step_parts(trainer, state, spec: torch.Tensor, dev: str, dtype,
                     xrec_d: torch.Tensor = None, replay: KinkTape = None) -> tuple:
    """One VQGAN step's parts on ``dev`` in ``dtype``, on copies of the
    trained weights and the discriminator on (factor 1), under a
    ``KinkTape`` (replaying ``replay`` where it is given): G's loss, its
    gradients over the VQ and its reconstruction (on the CPU); D's loss,
    its gradients and its running statistics after the real call and the
    fake one, on ``xrec_d`` where it is given, else on G's reconstruction;
    the tape.  Returns (parts, the VQ)."""
    import copy

    from syncfusion_tpu_torch.train.vqgan_trainer import VQGANTrainer

    model, lpaps, disc = (copy.deepcopy(m_).to(dev, dtype)
                          for m_ in (state.model, trainer.lpaps, state.disc))
    tr = VQGANTrainer(model, trainer.cfg, trainer.learning_rate, lpaps, disc)
    tape = KinkTape(replay)
    tr.recon_loss = lambda x_, xrec_: VQGANTrainer.recon_loss(tr, x_, tape.l1_path(x_, xrec_))
    model, disc, x = tr.model.train(), tr.disc, spec.to(dev, dtype)
    with tape:
        loss, xrec, _ = tr.g_loss(model, disc, x, 1.0)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        d = tr.d_loss(disc, x, xrec if xrec_d is None else xrec_d.to(dev, dtype), 1.0)
        dgrads = torch.autograd.grad(d, list(disc.parameters()))
    return {"g": loss.item(), "d": d.item(), "xrec": xrec.detach().cpu(), "tape": tape,
            "g_grads": {k: g_.cpu() for (k, _), g_ in zip(model.named_parameters(), grads)},
            "d_grads": {k: g_.cpu() for (k, _), g_ in zip(disc.named_parameters(), dgrads)},
            "stats": {k: v.detach().cpu().clone() for k, v in disc.state_dict().items()
                      if "running" in k}}, model


def step_gaps(card: dict, ref: dict) -> dict:
    return {"g_loss": abs(card["g"] - ref["g"]) / abs(ref["g"]),
            "d_loss": abs(card["d"] - ref["d"]) / abs(ref["d"]),
            "g_grads": grad_gaps(card["g_grads"], ref["g_grads"]),
            "d_grads": grad_gaps(card["d_grads"], ref["d_grads"]),
            "stats": stat_gap(card["stats"], ref["stats"])}


def witness_rows(card_rows: list, cpu_rows: list) -> list:
    """Per tensor, worst first: (the card's floored gap over its tolerance
    max(TRAIN_GRAD_TOL, WITNESS_FACTOR x the CPU's), the card's gap, the
    CPU's, name); both gaps ``grad_gaps``'s, to the same reference."""
    cpu = {row[2]: row[0] for row in cpu_rows}
    return sorted((row[0] / max(TRAIN_GRAD_TOL, WITNESS_FACTOR * cpu[row[2]]), row[0],
                   cpu[row[2]], row[2]) for row in card_rows)[::-1]


def vqgan_cross_check(trainer, state) -> tuple:
    """One VQGAN step's parts (``vqgan_step_parts``) at B = 2, same batch,
    on the card and on the CPU in f32 and in f64, and on the card in f32
    with cuDNN off (its own convolutions, no FFT or Winograd algorithm).
    Each f32 run is held against a CPU f64 step that replays its
    ``KinkTape``: the side of every ReLU, LeakyReLU, max-pool and L1 sign
    that run took.  f32 rounding puts the few inputs within its error of a
    kink on either side, which run crosses which is chance, and one
    crossing moves a sum over positions (a norm's bias gradient, say) by
    percents of its largest value: against an f64 step on its own path the
    gap is rounding.  A run may cross a kink only within CFG_GAP_TOL of
    its tensor's largest |value| (gated).  Every run's D also takes one
    input, the CPU f64 run's reconstruction, so that D's gradients hold
    D's own rounding.  Returns (f32 errors: the losses and statistics card
    against CPU, each f32 run's gradients against its f64 replay with the
    CPU f32's as witness, the crossings; f64 errors: card against CPU)."""
    spec = baseline_specs(2, 31, "cpu")
    parts, vqs = {}, {}
    parts["cpu64"], vqs["cpu64"] = vqgan_step_parts(trainer, state, spec, "cpu", torch.float64)
    xrec = parts["cpu64"]["xrec"]
    for side, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("card64", "cuda", torch.float64)):
        parts[side], vqs[side] = vqgan_step_parts(trainer, state, spec, dev, dtype, xrec)
    with torch.backends.cudnn.flags(enabled=False):
        parts["no_cudnn"], _ = vqgan_step_parts(trainer, state, spec, "cuda", torch.float32,
                                                xrec)
    f32 = step_gaps(parts["card"], parts["cpu"])
    f32["flips"], f32["gap"] = code_flips(vqs["card"], vqs["cpu"], spec)
    ref = {side: vqgan_step_parts(trainer, state, spec, "cpu", torch.float64, xrec,
                                  parts[side]["tape"])[0] for side in ("card", "cpu", "no_cudnn")}
    f32["kink_flips"] = {side: r["tape"].flips for side, r in ref.items()}
    f32["kink_gap"] = max(r["tape"].gap for r in ref.values())
    for key in ("g_grads", "d_grads"):
        cpu_rows = grad_gaps(parts["cpu"][key], ref["cpu"][key])
        f32[key] = witness_rows(grad_gaps(parts["card"][key], ref["card"][key]), cpu_rows)
        f32[key + "_no_cudnn"] = witness_rows(
            grad_gaps(parts["no_cudnn"][key], ref["no_cudnn"][key]), cpu_rows)
    f64 = step_gaps(parts["card64"], parts["cpu64"])
    f64["flips"], f64["gap"] = code_flips(vqs["card64"], vqs["cpu64"], spec.double())
    return f32, f64


def gpt_cross_check(model) -> dict:
    """One GPT step's loss and gradients at B = 1 on the card and on a CPU
    copy of the whole model (frozen stages too), same batch; the flips of
    the ref and cond codes."""
    import copy

    spec, cond = baseline_specs(1, 32, "cpu"), baseline_specs(1, 33, "cpu")
    _, frames = baseline_inputs(1, seed=34)
    frames = torch.from_numpy(frames)
    cpu = copy.deepcopy(model).cpu()
    out = {}
    for side, m, dev in (("card", model, "cuda"), ("cpu", cpu, "cpu")):
        loss = m.loss(spec.to(dev), cond.to(dev), frames.to(dev))
        grads = torch.autograd.grad(loss, list(m.gpt.parameters()))
        out[side] = {"loss": loss.item(), "grads": {
            k: g_.cpu() for (k, _), g_ in zip(m.gpt.named_parameters(), grads)}}
    flips = [code_flips(model.vq, cpu.vq, x) for x in (spec, cond)]
    del cpu
    return {"loss": abs(out["card"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"]),
            "grads": grad_gaps(out["card"]["grads"], out["cpu"]["grads"]),
            "flips": sum(f[0] for f in flips), "gap": max(f[1] for f in flips)}


def gate_cross_check(label: str, err: dict, gated: tuple, shown: tuple = (),
                     witnessed: tuple = ()) -> None:
    """Print ``err`` and gate it: the code gap always; the entries named in
    ``gated`` (losses and statistics at CFG_REL_TOL, gradients, lists of
    ``grad_gaps`` rows, at TRAIN_GRAD_TOL; those also named in ``witnessed``
    are ``witness_rows``, each within its own tolerance) where no code
    flipped; those in ``shown`` are printed only."""
    def fmt(k):
        v = err[k]
        if k in witnessed:
            big = max(v, key=lambda row: row[1])
            return (f"{k} worst over tolerance {v[0][0]:.3f} ({v[0][3]}: {v[0][1]:.3e}, CPU "
                    f"f32 {v[0][2]:.3e}), largest {big[1]:.3e} ({big[3]}, CPU f32 "
                    f"{big[2]:.3e})")
        return f"{k} worst floored {v[0][0]:.3e} ({v[0][2]})" if isinstance(v, list) \
            else f"{k} {v:.3e}"

    print(f"  {label} card vs CPU: gated " + ", ".join(fmt(k) for k in gated)
          + ("; not gated " + ", ".join(fmt(k) for k in shown) if shown else "")
          + f"; codes flipped {err['flips']} (gap {err['gap']:.3e}, tol {CFG_GAP_TOL:.0e}); "
          f"tolerances: losses and statistics {CFG_REL_TOL:.0e}, gradients "
          f"{TRAIN_GRAD_TOL:.0e}" + (f" or {WITNESS_FACTOR:g} x the CPU f32's against f64"
                                     if witnessed else ""), flush=True)
    check(err["gap"] <= CFG_GAP_TOL, f"{label}: a code flips beyond the tie tolerance")
    if err["flips"]:
        print(f"  {label}: {err['flips']} codes flipped within the tie tolerance: the "
              "losses and gradients above are not gated")
        return
    failed = [k for k in gated if not (
        err[k][0][0] <= 1.0 if k in witnessed
        else err[k][0][0] <= TRAIN_GRAD_TOL if isinstance(err[k], list)
        else err[k] <= CFG_REL_TOL)]
    check(not failed, f"{label}: card against CPU fails {failed}")


class WarningRecords(logging.Handler):
    """Collects the WARNING records of the port's loggers (a media failure
    that a trainer catches and logs)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def phase_baseline_train_clis(tmp: str) -> dict:
    """Phase 18d: ``train_codebook``, then ``train_transformer --vq_ckpt``,
    then ``generate_audio --vq_ckpt --transformer_ckpt_path``, one epoch
    each on phase 17's 4-item root (batch 4: one step), both at the YAMLs'
    full size: the GPT's checkpoint (its weights and AdamW's moments) is
    written by ``train_transformer`` and loaded by ``generate_audio``.
    Checks each run's metrics, checkpoint and media files and the generated
    wavs; returns the seconds of each."""
    from syncfusion_tpu_torch import generate_audio, train_codebook, train_transformer
    from syncfusion_tpu_torch.ops.wav import read_wav

    root = os.path.join(tmp, "gh18")
    os.makedirs(root)
    with open(write_baseline_root(root)) as f:
        cfg = json.load(f)
    split = os.path.join(root, "test.txt")
    cfg["data"].update(train_split_file_path=split, val_split_file_path=split, batch_size=4)
    cfg.update(trainer={"max_epochs": 1})
    seconds = {}

    def run(name, main, argv):
        cfg["logs_dir"] = os.path.join(tmp, f"logs_{name}")
        path = os.path.join(tmp, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        start = time.perf_counter()
        out = main(["-c", path] + argv)
        seconds[name] = time.perf_counter() - start
        return out, path

    def check_run(out, metric, media):
        run_dir = out["run_dir"]
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        check(len(lines) == 1 and math.isfinite(lines[0][metric]), f"{run_dir}: {lines}")
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpts")))
        check(ckpts == ["metrics.json", "step_1.pt"], f"{run_dir}: ckpts {ckpts}")
        names = sorted(os.listdir(os.path.join(run_dir, "media")))
        check(names == sorted(media), f"{run_dir}: media {names}")
        for name in names:
            if name.endswith(".wav"):
                w, sr = read_wav(os.path.join(run_dir, "media", name))
                check(sr == 22050 and bool(np.isfinite(w).all()), f"{name}: {w.shape}")
        return lines[0][metric]

    step = "step00000001"
    cb, _ = run("codebook", train_codebook.main, [])
    rec = check_run(cb, "val/rec_loss", [f"reconstructions_{step}.png"] + [
        f"val_{k}_{i}_{step}.wav" for k in ("inputs", "reconstructions") for i in (0, 1)])
    vq_ckpt = os.path.join(cb["run_dir"], "ckpts")
    tr, path = run("transformer", train_transformer.main, ["--vq_ckpt", vq_ckpt])
    val = check_run(tr, "val/loss", [f"val_{step}.png"] + [
        f"val_att_{k}_{step}.png" for k in ("half", "nopix", "det")] + [
        f"val_samples_nopix_{i}_{step}.wav" for i in (0, 1)])
    gpt_ckpt = os.path.join(tr["run_dir"], "ckpts", "step_1.pt")
    ckpt_gb = os.path.getsize(gpt_ckpt) / 1e9
    out = os.path.join(tmp, "gen18")
    start = time.perf_counter()
    summary = generate_audio.main(["--gh_testset", "-c", path, "--vq_ckpt", vq_ckpt,
                                   "--transformer_ckpt_path",
                                   os.path.join(tr["run_dir"], "ckpts"),
                                   "--output_dir", out, "--audio_only"])
    seconds["generate_audio"] = time.perf_counter() - start
    wavs = sorted(os.listdir(os.path.join(out, "generated_audio")))
    check(summary["clips"] == len(wavs) == 4, f"generate_audio wrote {wavs}")
    for name in wavs:
        w, sr = read_wav(os.path.join(out, "generated_audio", name))
        check(sr == 22050 and w.shape == (1, 512 + 256 * 159) and bool(np.isfinite(w).all()),
              f"generate_audio: {name} {w.shape} at {sr} Hz")
    print(f"  CLIs on the 4-item root, one epoch each: train_codebook {seconds['codebook']:.3f} s "
          f"(val/rec_loss {rec:.4f}), train_transformer --vq_ckpt "
          f"{seconds['transformer']:.3f} s (GPT at full depth, val/loss {val:.4f}, checkpoint "
          f"{ckpt_gb:.3f} GB), "
          f"generate_audio from both checkpoints {seconds['generate_audio']:.3f} s (4 clips)",
          flush=True)
    return seconds


def phase_baseline_train(attn, fr, tmp: str) -> dict:
    """Phase 18: the baseline's training at full width, f32 without TF32,
    seeded weights: (a) ``VQGANTrainer`` at B = 40 x 80 x 160 with LPAPS and
    an ``n_layers=3`` discriminator, ``disc_start`` 3, TRAIN_STEPS_18 steps
    timed (the median of steps 3-5), peak memory, one step's device time;
    (b) ``TransformerTrainer`` on the 305 M GPT at B = 4 with 60 frames of
    112 x 112, timed alike, then one ``log_images``; (c) the card against
    the CPU for one VQGAN step at B = 2 (the f32 gradients against the
    CPU's f64 ones on the same side of every kink, beside the CPU's f32
    ones; D on one reconstruction) and one GPT step at B = 1 (gated);
    (d) the three CLIs on a processed root where PIL is importable (it
    decodes the frames and writes the panels).  No hand-written kernel or
    plain version runs (gated), and no trainer logs a caught failure
    (gated).  Returns the launch counts."""
    import dataclasses

    from syncfusion_tpu_torch.core.config import BaselineConfig
    from syncfusion_tpu_torch.generate_audio import build_model
    from syncfusion_tpu_torch.models.vqgan.model import VQModel
    from syncfusion_tpu_torch.train.transformer_trainer import TransformerTrainer
    from syncfusion_tpu_torch.train.vqgan_trainer import VQGANTrainer

    warnings = WarningRecords()
    logging.getLogger("syncfusion_tpu_torch").addHandler(warnings)
    reset_counts(attn, fr)
    cfg = BaselineConfig()
    part_s, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        part_s[name] = round(time.perf_counter() - t_part, 3)
        t_part = time.perf_counter()

    # (a) the codebook's step
    torch.cuda.reset_peak_memory_stats()
    trainer = VQGANTrainer(
        VQModel(**dataclasses.asdict(cfg.model)).cuda(),
        dataclasses.replace(cfg.lossconfig, disc_start=VQT_DISC_START),
        learning_rate=cfg.vq_learning_rate)
    trainer.disc.cuda()
    state = trainer.init(0)
    spec = baseline_specs(VQT_BATCH, 30, "cuda")
    metrics = []
    secs = step_seconds(lambda: metrics.append(trainer.train_step(state, spec)), TRAIN_STEPS_18)
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    check(all(math.isfinite(v) for m in values for v in m.values()), f"VQGAN metrics {values}")
    check(values[2]["loss/disc"] == 0.0 and values[3]["loss/disc"] > 0.0,
          f"the discriminator joins at step {VQT_DISC_START}: {values}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, dev_ms, kernels = device_ms(lambda: trainer.train_step(state, spec), "", calls=1)
    med = statistics.median(secs[2:])
    print(f"  VQGAN step, B={VQT_BATCH} x 80 x 160 (LPAPS, n_layers=3 D, disc_start "
          f"{VQT_DISC_START}): s {', '.join(f'{s_:.4f}' for s_ in secs)}; median of steps "
          f"3-{TRAIN_STEPS_18} {med:.4f} s, {VQT_BATCH / med:.2f} spectrograms/s; peak "
          f"memory {peak:.3f} GiB; one step's device time {dev_ms:.3f} ms in {kernels:.0f} "
          f"kernels and copies (idle share {1 - dev_ms / 1e3 / med:.3f}); losses {values}",
          flush=True)
    part("a VQGAN steps")

    # (c), VQGAN half, on the state (a) trained: each f32 run's gradients
    # against a CPU f64 step on its own side of every kink, the card's
    # within WITNESS_FACTOR of the CPU f32's gap, the cuDNN-off run shown
    # beside them; f64 on both sides; D's fake call on the CPU f64 run's
    # reconstruction in every run
    f32, f64 = vqgan_cross_check(trainer, state)
    print(f"  VQGAN step, B=2, f32: kinks (ReLU, LeakyReLU, max-pool, L1 sign) each f32 "
          f"run took on another side than its f64 replay would {f32['kink_flips']}, the "
          f"farthest from its kink {f32['kink_gap']:.3e} of its tensor's largest |value| "
          f"(tol {CFG_GAP_TOL:.0e})", flush=True)
    check(f32["kink_gap"] <= CFG_GAP_TOL, "VQGAN step: a kink crossed beyond the tie "
          "tolerance")
    witnessed = ("g_grads", "d_grads", "g_grads_no_cudnn", "d_grads_no_cudnn")
    gate_cross_check("VQGAN step, B=2, f32", f32, ("g_loss", "d_loss", "stats", "g_grads",
                                                   "d_grads"),
                     ("g_grads_no_cudnn", "d_grads_no_cudnn"), witnessed)
    gate_cross_check("VQGAN step, B=2, f64", f64, ("g_loss", "d_loss", "stats", "g_grads",
                                                   "d_grads"))
    del trainer, state, spec
    part("c VQGAN card vs CPU")
    torch.cuda.empty_cache()

    # (b) the GPT's step
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda", seed=0)
    gpt_trainer = TransformerTrainer(model, learning_rate=cfg.learning_rate,
                                     weight_decay=cfg.weight_decay)
    gstate = gpt_trainer.create_state()
    _, frames = baseline_inputs(GPT_BATCH, seed=35)
    batch = {"spec": baseline_specs(GPT_BATCH, 36, "cuda"),
             "cond_spec": baseline_specs(GPT_BATCH, 37, "cuda"),
             "frames": torch.from_numpy(frames).cuda()}
    losses = []
    secs = step_seconds(lambda: losses.append(gpt_trainer.train_step(gstate, batch)),
                        TRAIN_STEPS_18)
    losses = [float(m["train/loss"]) for m in losses]
    check(all(math.isfinite(v) for v in losses), f"GPT losses {losses}")
    peak_g = torch.cuda.max_memory_allocated() / 2**30
    _, dev_g, kernels_g = device_ms(lambda: gpt_trainer.train_step(gstate, batch), "", calls=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = time.perf_counter()
    media = model.log_images(batch["spec"], batch["cond_spec"], batch["frames"], gen)
    torch.cuda.synchronize()
    media_s = time.perf_counter() - start
    check(all(bool(torch.isfinite(v).all()) for v in media.values())
          and tuple(media["att_det"].shape) == (GPT_BATCH, 16, 160, 160)
          and tuple(media["samples_nopix"].shape) == (GPT_BATCH, 1, 80, 160),
          "log_images: shapes or values")
    med_g = statistics.median(secs[2:])
    n_gpt = sum(p_.numel() for p_ in model.gpt.parameters())
    print(f"  GPT step, B={GPT_BATCH} ({n_gpt:,} trained parameters, 60 frames of 112 x 112, "
          f"frozen VQ and video net): s {', '.join(f'{s_:.4f}' for s_ in secs)}; median of "
          f"steps 3-{TRAIN_STEPS_18} {med_g:.4f} s; peak memory {peak_g:.3f} GiB; one step's "
          f"device time {dev_g:.3f} ms in {kernels_g:.0f} kernels and copies (idle share "
          f"{1 - dev_g / 1e3 / med_g:.3f}); losses {[round(v_, 4) for v_ in losses]}; "
          f"log_images (3 samplings, 3 attention forwards, 5 decodes) {media_s:.3f} s",
          flush=True)
    part("b GPT steps and log_images")
    err = gpt_cross_check(model)
    gate_cross_check("GPT step, B=1, f32", err, ("loss", "grads"))
    del gpt_trainer, gstate, model, media, batch
    torch.cuda.empty_cache()
    part("c GPT card vs CPU")

    # (d) the command lines
    if importlib.util.find_spec("PIL") is None:
        print("  the CLIs on a processed root: not run (PIL, which decodes the frames and "
              "writes the panels, is not importable here)")
    else:
        phase_baseline_train_clis(tmp)
    part("d CLIs")
    print(f"  phase 18's seconds by part (with the model builds): {part_s}")
    logging.getLogger("syncfusion_tpu_torch").removeHandler(warnings)
    failures = [m_ for m_ in warnings.records if "failed" in m_]
    check(not failures, f"a trainer caught and logged a failure: {failures}")
    launched = counts(attn, fr)
    check(not any(launched.values()), f"baseline training: a hand-written kernel or its "
          f"plain version ran: {launched}")
    print(f"  launch counts over the phase: {launched} (no TPU kernel lies on this path)")
    return {"launched": launched, "vqgan_step_s": med, "gpt_step_s": med_g}


# phase 19: the reference's published-checkpoint paths at full width.  The
# a-unet compat twins' self-attention runs at levels 4-7, every item, down
# and up: 2 + 2 + 2 + 4 items, 20 K1 calls a whole forward (no bottleneck
# block: level 7 is the innermost)
COMPAT_K1 = 2 * (2 + 2 + 2 + 4)
COMPAT_ROWS = 2  # one CFG pair
# card against CPU: the same f32 forward at L = 2^14 (the CPU's share of the
# budget), max |diff| / max |CPU| (f32 sums in other orders through ~200
# layers; K1 as 3xTF32)
COMPAT_CPU_LENGTH = 2**14
COMPAT_CPU_TOL = 1e-4
# evaluate_diffusion --ckpt X.ckpt at the evaluate_gh_gen preset, CFG at
# every step, so 20 K1 calls a step; its 150 steps cut to 50 to keep the
# script within half its limit (all 150 took 34.9 s of a 127-s phase on an
# NVIDIA H100 80GB HBM3 at 700 W, 3.190 s a clip)
COMPAT_EVAL_STEPS = 50
COMPAT_EVAL_K1 = COMPAT_K1 * COMPAT_EVAL_STEPS
# the style transfer: generate_audio's default steps; the first step's loss,
# card against CPU, relative (f32 convolutions in other orders)
STYLE_STEPS = 300
# one onset a video: 2 items of the 2-video root (cut from 4 to keep the
# script within half its time limit)
STYLE_ONSETS = (0.5,)
STYLE_ITEMS = 2
STYLE_TOL = 1e-4
# torchvision's vgg19 ``features`` convs, (index, in, out): the five of the
# style transfer (0, 2, 5, 7, 10) and the rest, so that the file is what
# torchvision writes for ``features``
VGG19_CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
               (12, 256, 256), (14, 256, 256), (16, 256, 256), (19, 256, 512),
               (21, 512, 512), (23, 512, 512), (25, 512, 512), (28, 512, 512),
               (30, 512, 512), (32, 512, 512), (34, 512, 512)]


def reference_tensor(name: str, shape, gen) -> torch.Tensor:
    """A seeded tensor for one entry of the reference's state dict: kernels
    normal with variance 1/fan_in (a transposed conv's fan-in is in x k),
    norm scales 1 + 0.1 N, biases 0.01 N, the Fourier frequencies and the
    fixed embedding N(0, 1)."""
    x = torch.randn(shape, generator=gen)
    if name.endswith(("embedder.weights", "fixed_embedding.weight")):
        return x
    if name.endswith(".bias"):
        return 0.01 * x
    if len(shape) == 1:
        return 1.0 + 0.1 * x
    fan_in = shape[0] * shape[2] if name.endswith("upsample.weight") else math.prod(shape[1:])
    return x / math.sqrt(fan_in)


def write_reference_ckpt(path: str, seed: int = 19) -> dict:
    """A Lightning checkpoint of the reference's ``module_diffusion.Model``
    at exp/model/diffusion.yaml's widths: the port's manifests filled with
    seeded tensors, under ``model.net.`` with the shared-module duplicates
    ``model.diffusion.net.`` and ``model.sampler.net.`` (the same tensors),
    ``onsets_encoder.`` and a frozen ``embedder.`` entry.  Returns the
    UNet's and the encoder's state dicts."""
    from syncfusion_tpu_torch.models.adp_torch_recon import (
        Encoder1dConfig,
        UNetV0Config,
        encoder_manifest,
        unet_manifest,
    )

    gen = torch.Generator().manual_seed(seed)
    unet = {k: reference_tensor(k, s, gen) for k, s in unet_manifest(UNetV0Config())}
    enc = {k: reference_tensor(k, s, gen) for k, s in encoder_manifest(Encoder1dConfig())}
    sd = {}
    for prefix in ("model.net.", "model.diffusion.net.", "model.sampler.net."):
        sd.update({prefix + k: v for k, v in unet.items()})
    sd.update({f"onsets_encoder.{k}": v for k, v in enc.items()})
    sd["embedder.model.logit_scale_a"] = torch.zeros(())
    torch.save({"state_dict": sd, "epoch": 784, "global_step": 0}, path)
    return {"unet": unet, "encoder": enc}


def set_attend(model, fn) -> None:
    """Every attention module of ``model`` that takes ``attend`` uses ``fn``
    (None: its class's, the kernel)."""
    for m in model.modules():
        if hasattr(type(m), "attend"):
            if fn is None:
                m.__dict__.pop("attend", None)
            else:
                m.attend = fn


def compat_inputs(length: int, device) -> tuple:
    """One CFG pair: (x, sigma, onsets, embedding, mask), the conditional
    row and the unconditional one (mask 1) on the same x, onsets and
    sigma."""
    gen = torch.Generator(device=device).manual_seed(19)
    x = torch.randn((1, length, 1), generator=gen, device=device).repeat(2, 1, 1)
    onsets = torch.zeros((2, length, 1), device=device)
    onsets[:, length // 8::length // 4, 0] = 1.0
    emb = torch.cat([torch.randn((1, 1, 512), generator=gen, device=device),
                     torch.zeros((1, 1, 512), device=device)])
    mask = torch.tensor([0.0, 1.0], device=device).reshape(2, 1, 1)
    return x, torch.full((2,), 0.5, device=device), onsets, emb, mask


@torch.no_grad()
def compat_forward(model, inputs) -> torch.Tensor:
    x, sigma, onsets, emb, mask = inputs
    return model.unet(x, sigma, context=model.encode_context(onsets), embedding=emb,
                      embedding_cfg_mask=mask)


def phase_compat(attn, fr, tmp: str) -> dict:
    """Phase 19: the reference's published-checkpoint paths at full width.
    (a) a reference Lightning checkpoint written from the manifests with
    seeded tensors, loaded through ``adp_convert`` (strictly) into the
    a-unet twins; (b) one whole f32 and one bf16 forward of a CFG pair at L
    = 2^18 through K1 (20 launches, the plain version never) and through
    the plain attention, gated as phase 5, each timed (host clock to
    synchronize; device ms and idle share by the profiler); (c) one f32 loss and gradient at B
    = 1 through the kernels (K1, K2a, K2b 20 each) and through the plain
    attention, gated as phase 7; (d) the f32 forward at L = 2^14 on the card
    against the CPU; (e) ``evaluate_diffusion.main --ckpt X.ckpt`` at the
    evaluate_gh_gen preset on phase 15's 10 tracks, K1's f32 body 20 a
    step; (f) ``generate_audio --style_transfer --vgg19_ckpt`` on phase
    17's root with one onset a video (2 items; where PIL is importable) at
    300 steps, and
    ``run_style_transfer``'s first loss on the card against the CPU, no
    hand-written kernel launched.  Returns the launch counts by path."""
    from syncfusion_tpu_torch import evaluate_diffusion, generate_audio
    from syncfusion_tpu_torch.eval import style_transfer
    from syncfusion_tpu_torch.models.adp_compat import UNetV0Compat
    from syncfusion_tpu_torch.models.adp_convert import load_diffusion_state
    from syncfusion_tpu_torch.models.adp_torch_recon import Encoder1dConfig, UNetV0Config
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.ops.wav import read_wav

    launched = {}
    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "epoch=784-valid_loss=0.008.ckpt")
    written = write_reference_ckpt(ckpt)
    t_write = time.perf_counter() - t0
    model = SyncFusionDiffusion.from_config(None, compat=True, device="cuda")
    load_diffusion_state(model, ckpt)
    check(isinstance(model.unet, UNetV0Compat), "the checkpoint did not build the twins")
    i, j = len(model.onsets_encoder.cfg.factors) - 1, model.onsets_encoder.cfg.num_blocks[-1] - 1
    check(torch.equal(model.unet.net.inner.upsample_kernel.cpu(),
                      written["unet"]["net.inner.upsample.weight"].permute(2, 0, 1))
          and torch.equal(getattr(model.onsets_encoder, f"ds{i}_b{j}_conv2").weight.cpu(),
                          written["encoder"][f"downsamples.{i}.blocks.{j}.block2.project.weight"]),
          "the loaded parameters differ from the checkpoint's")
    print(f"  reference checkpoint {os.path.getsize(ckpt) / 2**20:.1f} MiB written in "
          f"{t_write:.3f} s, loaded strictly in {time.perf_counter() - t0 - t_write:.3f} s; "
          f"twins {model.param_count():,} params", flush=True)

    # (b) whole forwards, f32 and bf16, kernel against plain
    inputs = compat_inputs(LENGTH, "cuda")
    bf16 = SyncFusionDiffusion.from_config(None, compat=True, dtype=torch.bfloat16,
                                           device="cuda")
    bf16.load_state_dict(model.state_dict(), strict=True)
    for label, m in (("f32", model), ("bf16", bf16)):
        reset_counts(attn, fr)
        out_k = compat_forward(m, inputs)
        got = counts(attn, fr)
        check(got["kernel_launches"] == COMPAT_K1 and not any(
            v for k, v in got.items() if k != "kernel_launches"),
            f"compat forward {label}: launches {got}")
        set_attend(m, attn.attention_reference)
        out_p = compat_forward(m, inputs)
        secs_plain = time_calls(lambda: compat_forward(m, inputs))
        set_attend(m, None)
        secs = time_calls(lambda: compat_forward(m, inputs))
        dev, every, kernels = device_ms(lambda: compat_forward(m, inputs), "flash_fwd", calls=3)
        rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        check(out_k.shape == (COMPAT_ROWS, LENGTH, 1) and bool(torch.isfinite(out_k).all()),
              f"compat forward {label}: {tuple(out_k.shape)}")
        line = (f"  compat forward {label}, {COMPAT_ROWS} rows x 2^18: {spread(secs)} ms "
                f"(host clock to synchronize; plain attention {spread(secs_plain)}), device "
                f"{every:.3f} ms in {kernels:.0f} kernels, K1 {dev:.3f} ms, idle share "
                f"{1 - every / (statistics.median(secs) * 1e3):.3f}; kernel vs plain max "
                f"|diff| / max |plain| {rel:.3e}")
        if label == "f32":
            print(line + f" (tol {CROSS_TOL:.0e})", flush=True)
            check(math.isfinite(rel) and rel <= CROSS_TOL, "compat f32 forward disagrees")
        else:
            census, rounded = rounding_census(attn)
            reset_counts(attn, fr)
            set_attend(m, census)
            compat_forward(m, inputs)
            set_attend(m, None)
            share = rounded["kernel_vs_plain"] / rounded["elements"]
            check(attn.flash_attention.kernel_launches == COMPAT_K1,
                  "compat bf16 census launches")
            print(line + f" (not gated); O elements rounded otherwise than the plain "
                  f"version {rounded['kernel_vs_plain']} of {rounded['elements']}, share "
                  f"{share:.3e} (tol {BF16_FLIP_TOL:.0e}; plain vs f64 "
                  f"{rounded['plain_vs_f64']})", flush=True)
            check(share <= BF16_FLIP_TOL, "compat bf16: the kernel rounds too many O "
                  "elements otherwise than the plain version")
    launched["compat_forward"] = {"kernel_launches": 2 * COMPAT_K1}
    del bf16, out_k, out_p
    torch.cuda.empty_cache()

    # (c) loss and gradient, f32, B = 1
    gen = torch.Generator(device="cuda").manual_seed(20)
    wav = 0.1 * torch.randn((1, LENGTH, 1), generator=gen, device="cuda")
    onsets = inputs[2][:1]
    emb = torch.randn((1, 1, 512), generator=gen, device="cuda")
    batch = (wav, onsets, emb, torch.rand((1,), generator=gen, device="cuda"),
             torch.randn(wav.shape, generator=gen, device="cuda"))
    reset_counts(attn, fr)
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    loss_k, grads_k = loss_and_grads(model, batch)
    sec = time.perf_counter() - start
    got = counts(attn, fr)
    check(got["kernel_launches"] == got["dq_launches"] == got["dkv_launches"] == COMPAT_K1
          and got["plain_calls"] == got["plain_bwd_calls"] == 0,
          f"compat loss and gradient: launches {got}")
    launched["compat_train"] = got
    set_attend(model, attn.attention_reference)
    loss_p, grads_p = loss_and_grads(model, batch)
    set_attend(model, None)
    rels = grad_gaps(grads_k, grads_p)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  compat f32 loss and gradient, B=1: {sec:.3f} s, peak {peak:.3f} GiB; "
          f"kernels vs plain attention: loss {rel_loss:.3e} relative (tol "
          f"{TRAIN_LOSS_TOL:.0e}), gradients {rels[0][0]:.3e} (tol {TRAIN_GRAD_TOL:.0e}); "
          f"launches {got}", flush=True)
    print_gaps("compat kernels vs plain", rels)
    check(rel_loss <= TRAIN_LOSS_TOL, "compat loss disagrees")
    check(rels[0][0] <= TRAIN_GRAD_TOL, "compat gradients disagree")
    for p in model.parameters():
        p.grad = None
    del grads_k, grads_p
    torch.cuda.empty_cache()

    # (d) card against CPU at L = 2^14
    cpu = SyncFusionDiffusion(UNetV0Config(), Encoder1dConfig())
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    small = compat_inputs(COMPAT_CPU_LENGTH, "cuda")
    reset_counts(attn, fr)
    card = compat_forward(model, small).cpu()
    check(attn.flash_attention.kernel_launches == COMPAT_K1, "compat card forward launches")
    start = time.perf_counter()
    want = compat_forward(cpu.eval(), tuple(t_.cpu() for t_ in small))
    rel_cpu = ((card - want).abs().max() / want.abs().max()).item()
    print(f"  compat f32 forward at L=2^14, card vs CPU: max |diff| / max |CPU| "
          f"{rel_cpu:.3e} (tol {COMPAT_CPU_TOL:.0e}; the CPU forward "
          f"{time.perf_counter() - start:.3f} s)", flush=True)
    check(math.isfinite(rel_cpu) and rel_cpu <= COMPAT_CPU_TOL,
          "compat forward: the card disagrees with the CPU")
    del cpu, model
    torch.cuda.empty_cache()

    # (e) evaluate_diffusion on the checkpoint
    shard, gt, gen_dir = (os.path.join(tmp, n_) for n_ in ("test.tar", "gh-gt", "gh-gen"))
    write_shard(shard, tracks=EVAL_TRACKS, seconds=6.0, every=0.37, first=0.3, burst=0.8)
    evaluate_diffusion.main(["--exp", "prepare_gh_gt", "--dataset_path", shard,
                             "--experiment_path", gt])
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
        out = evaluate_diffusion.main([
            "--exp", "evaluate_gh_gen", "--dataset_path", shard, "--experiment_path",
            gen_dir, "--gt_dir", gt, "--ckpt", ckpt, "--num_steps", str(COMPAT_EVAL_STEPS)])
    finally:
        attn.flash_fwd = launch
    seconds = time.perf_counter() - start
    got = counts(attn, fr)
    want = {k: COMPAT_EVAL_K1 if k == "kernel_launches" else 0 for k in got}
    check(got == want, f"compat evaluation: launch counts {got} != {want}")
    check(k1_dtypes == {"torch.float32": COMPAT_EVAL_K1},
          f"compat evaluation: K1 by dtype {dict(k1_dtypes)}")
    launched["evaluate_compat"] = got
    stats = out["generation"]
    check(stats["clips"] == EVAL_TRACKS, f"compat evaluation: {stats['clips']} clips")
    for name in sorted(n_ for n_ in os.listdir(gen_dir) if n_.endswith(".wav")):
        w, sr = read_wav(os.path.join(gen_dir, name))
        check(sr == 22050 and w.shape == (1, EVAL_SAMPLES) and bool(np.isfinite(w).all()),
              f"compat evaluation: {name} {w.shape} at {sr} Hz")
    check(all(math.isfinite(v) for v in out["metrics"].values()), "compat FAD: not finite")
    steps_note = ("" if COMPAT_EVAL_STEPS == NUM_STEPS else
                  f" (steps cut from {NUM_STEPS} to {COMPAT_EVAL_STEPS})")
    print(f"  evaluate_diffusion --ckpt {os.path.basename(ckpt)} (compat twins), "
          f"evaluate_gh_gen, B={EVAL_BATCH}, DDIM {COMPAT_EVAL_STEPS}{steps_note}, CFG "
          f"{SCALE} at every step, f32: {stats['generation_s'] / stats['clips']:.3f} s a clip "
          f"generating, {stats['post_s'] / stats['clips']:.4f} s a clip writing; main "
          f"{seconds:.3f} s (checkpoint conversion and load included); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {got}; K1 by dtype "
          f"{dict(k1_dtypes)}; FAD {out['metrics']}", flush=True)

    # (f) style transfer
    vgg_path = os.path.join(tmp, "vgg19.pth")
    gen_cpu = torch.Generator().manual_seed(21)
    vgg_sd = {}
    for index, cin, cout in VGG19_CONVS:
        vgg_sd[f"features.{index}.weight"] = torch.randn(
            (cout, cin, 3, 3), generator=gen_cpu) / math.sqrt(9 * cin)
        vgg_sd[f"features.{index}.bias"] = 0.01 * torch.randn((cout,), generator=gen_cpu)
    torch.save(vgg_sd, vgg_path)
    reset_counts(attn, fr)
    style = {}
    if importlib.util.find_spec("PIL") is not None:
        root = os.path.join(tmp, "root")
        cfg = write_baseline_root(root, STYLE_ONSETS)
        out_dir = os.path.join(tmp, "styled")
        start = time.perf_counter()
        summary = generate_audio.main(["--gh_testset", "-c", cfg, "--output_dir", out_dir,
                                       "--style_transfer", "--vgg19_ckpt", vgg_path,
                                       "--style_steps", str(STYLE_STEPS)])
        style["main_s"] = time.perf_counter() - start
        check(summary["clips"] == STYLE_ITEMS, f"style transfer: {summary}")
        for name in os.listdir(os.path.join(out_dir, "generated_audio")):
            w, sr = read_wav(os.path.join(out_dir, "generated_audio", name))
            check(sr == 22050 and w.shape[0] == 1 and bool(np.isfinite(w).all()),
                  f"style transfer: {name} {w.shape} at {sr} Hz")
    vgg = generate_audio.load_vgg19(vgg_path, "cuda")
    rng = np.random.default_rng(22)
    panels = [rng.uniform(0.0, 1.0, (80, 160)).astype(np.float32) for _ in range(2)]
    imgs = [style_transfer.load_specs_as_img(p_, 160) for p_ in panels]
    start = time.perf_counter()
    _, first_card = style_transfer.run_style_transfer(vgg, *(i_.cuda() for i_ in imgs),
                                                      num_steps=1)
    torch.cuda.synchronize()
    style["one_step_s"] = time.perf_counter() - start
    vgg_cpu = style_transfer.Vgg19Prefix()
    vgg_cpu.load_state_dict(vgg.state_dict())
    _, first_cpu = style_transfer.run_style_transfer(vgg_cpu, *imgs, num_steps=1)
    rel_style = abs(first_card - first_cpu) / abs(first_cpu)
    got = counts(attn, fr)
    check(not any(got.values()), f"style transfer: a hand-written kernel or its plain "
          f"version ran: {got}")
    ran = "main_s" in style
    print(f"  style transfer, 80 x 160: generate_audio --style_transfer, {STYLE_STEPS} "
          f"L-BFGS steps, "
          + (f"on {STYLE_ITEMS} items {style['main_s']:.3f} s ({style['main_s'] / STYLE_ITEMS:.3f} s a clip, model "
             f"build, reconstructions, Griffin-Lim and muxing included)" if ran else
             "did not run (no PIL)")
          + f"; run_style_transfer's first step {style['one_step_s']:.3f} s, its loss card "
          f"vs CPU {rel_style:.3e} relative (tol {STYLE_TOL:.0e}); "
          f"launches {got} (no TPU kernel lies on this path)", flush=True)
    check(rel_style <= STYLE_TOL, "style transfer: the card's first loss disagrees with "
          "the CPU's")
    return launched


# phase 20: the raw-data tail, progressive distillation, remat and the video
# ResNet family at full width
SYNTH_VIDEOS, SYNTH_SECONDS = 4, 8.0
GATE_FLIP_SHARE = 1e-3  # mask cells the card and the CPU may put on other sides
DENOISE_TOL = 1e-4      # of max |out|, the card against the CPU on one gate
DISTILL_START, DISTILL_FINAL, DISTILL_ROUND_STEPS = 8, 2, 3  # two rounds, six steps
DISTILL_STEPS = 6
GUIDED_SCALE = 2.0
REMAT_LOSS_TOL, REMAT_GRAD_TOL = 1e-6, 1e-5  # relative; of max |g|
VR_BATCH, VR_CPU = (2, 3, 16, 112, 112), (1, 3, 8, 112, 112)
VR_TOL = 1e-4
VR_TIMED = 5
TRACE_LAUNCHES, TRACE_TIMEOUT = 3, 120


def phase_raw_data(tmp: str) -> dict:
    """Phase 20a: ``gh_make_synthetic`` writes 4 videos of 8 s at 48 kHz,
    ``gh_make_shards`` packs all four into one shard, which the native reader
    (``native=True``, built with g++) reads as the Python one does; then
    ``spectral_gate`` on one 8-s clip on the card against the CPU: the
    share of gate cells on other sides (gated), the card's output with the
    CPU's gate against the CPU's (gated; the whole gate's printed) and ms a
    clip.  Returns the shard's path and the seconds."""
    from syncfusion_tpu_torch import gh_make_shards, gh_make_synthetic
    from syncfusion_tpu_torch.data import native, shards
    from syncfusion_tpu_torch.ops import denoise
    from syncfusion_tpu_torch.ops.wav import read_wav

    root = os.path.join(tmp, "processed")
    t0 = time.perf_counter()
    gh_make_synthetic.main(["--output_dir", root, "--n_videos", str(SYNTH_VIDEOS),
                            "--min_dur", str(SYNTH_SECONDS), "--max_dur",
                            str(SYNTH_SECONDS), "--num_workers", str(SYNTH_VIDEOS)])
    t_synth = time.perf_counter() - t0
    names = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    check(len(names) == SYNTH_VIDEOS, f"gh_make_synthetic wrote {names}")
    split = os.path.join(root, "all.txt")
    with open(split, "w") as f:
        f.write("\n".join(names) + "\n")
    (shard,) = gh_make_shards.main(["--root", root, "--split", split, "--output",
                                    os.path.join(tmp, "synth_%d.tar")])
    t0 = time.perf_counter()
    check(native.available(), "the native reader did not build")
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_native = list(shards.iter_tar_samples(shard, native=True))
    t_native = time.perf_counter() - t0
    by_python = list(shards.iter_tar_samples(shard, native=False))
    check(by_native == by_python and len(by_native) == SYNTH_VIDEOS,
          "the native reader's members differ from the Python reader's")
    frames = sum(len(os.listdir(os.path.join(root, nm, "frames"))) for nm in names)
    print(f"  gh_make_synthetic: {SYNTH_VIDEOS} videos of {SYNTH_SECONDS:.0f} s "
          f"({frames} frames) in {t_synth:.3f} s; gh_make_shards: {shard} "
          f"({os.path.getsize(shard) / 2**20:.1f} MiB), read natively in "
          f"{t_native * 1e3:.1f} ms (g++ build {t_build:.3f} s), its members equal "
          f"the Python reader's")

    wav, sr = read_wav(os.path.join(root, names[0], "audio",
                                    f"{names[0]}.resampled.wav"))
    check(sr == SR and wav.shape == (1, int(SYNTH_SECONDS * SR)), f"clip {wav.shape}")
    x = torch.from_numpy(wav)
    spec_cpu, mask_cpu = denoise.gate_mask(x)
    want = denoise.apply_gate(spec_cpu, mask_cpu, x.shape[-1])
    xc = x.cuda()
    spec, mask = denoise.gate_mask(xc)
    flips = (mask.cpu() != mask_cpu).float().mean().item()
    same_gate = denoise.apply_gate(spec, mask_cpu.cuda(), x.shape[-1]).cpu()
    whole = denoise.spectral_gate(xc).cpu()
    scale = want.abs().max().item()
    err = (same_gate - want).abs().max().item() / scale
    err_whole = (whole - want).abs().max().item() / scale
    ms = time_ms(lambda: denoise.spectral_gate(xc), 10)
    print(f"  spectral_gate, one {SYNTH_SECONDS:.0f}-s clip at {SR} Hz: card "
          f"{ms:.3f} ms a clip (CUDA events, 10 calls); gate cells flipped "
          f"against the CPU {flips:.3e} (tol {GATE_FLIP_SHARE:.0e}; kept "
          f"{mask_cpu.mean().item():.4f}); with the CPU's gate max |diff| / max "
          f"|out| {err:.3e} (tol {DENOISE_TOL:.0e}); whole {err_whole:.3e}")
    check(flips <= GATE_FLIP_SHARE, "spectral_gate: too many gate cells flipped")
    check(torch.isfinite(whole).all() and err <= DENOISE_TOL,
          "spectral_gate: the card disagrees with the CPU")
    if flips == 0:
        check(err_whole <= DENOISE_TOL, "spectral_gate: the whole gate disagrees")
    return {"shard": shard, "root": root, "denoise_ms": ms}


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block: its others add a
    convolution's weight gradients in any order, so two runs of the same
    step differ."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def phase_distill(attn, fr, blocks, tmp: str, shard: str) -> dict:
    """Phase 20b: ``distill_diffusion.main`` on a phase-6-style checkpoint
    of the full-width model (seeded) and 20a's shard, f32 without TF32, B =
    4 x 2^18, zero embeddings, 8 -> 4 -> 2 steps in rounds of 3 steps; K1
    27, K2a 9 and K2b 9 a step, the plain versions never (gated); then one
    guided round (cfg_scale 2, 2 -> 1, 3 steps) through
    ``ProgressiveDistiller``, its launches gated step by step; the
    distillation loss and gradients through the kernels against the plain
    attention (gated as phase 7, a rerun through the kernels printed as the
    witness); ``generate.main --ckpt`` on the written
    directory at 2 steps (K1 18, gated).  Returns the launch counts by
    path and the seconds a step."""
    from syncfusion_tpu_torch import distill_diffusion, generate
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer
    from syncfusion_tpu_torch.core.config import TrainConfig
    from syncfusion_tpu_torch.models.embedder import ZeroEmbedder
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.ops.wav import read_wav
    from syncfusion_tpu_torch.train.distill import DistillConfig, ProgressiveDistiller

    launched = {}
    t0 = time.perf_counter()
    teacher = SyncFusionDiffusion.from_config(None, device="cuda", seed=0)
    ckpts = os.path.join(tmp, "teacher", "ckpts")
    Checkpointer(CheckpointConfig(ckpts)).save(0, {"step": 0, "model": teacher.state_dict()},
                                               {"valid_loss": 1.0})
    t_ckpt = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts(attn, fr)
    t0 = time.perf_counter()
    result = distill_diffusion.main([
        "--ckpt", ckpts, "--train_path", shard, "--embedder", "none", "--device",
        "cuda", "--precision", "32", "--batch_size", str(BATCH), "--length",
        str(LENGTH), "--log_every_n_steps", "1",
        "--distill.start_steps", str(DISTILL_START),
        "--distill.final_steps", str(DISTILL_FINAL),
        "--distill.steps_per_round", str(DISTILL_ROUND_STEPS)])
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launched["distill"] = counts(attn, fr)
    peak = torch.cuda.max_memory_allocated() / 2**30
    logs = result["log"]
    losses = [m["distill_loss"] for m in logs]
    check(result["num_steps"] == DISTILL_FINAL and len(logs) == DISTILL_STEPS
          and all(math.isfinite(v) for v in losses), f"distillation logged {logs}")
    want = {"kernel_launches": 27 * DISTILL_STEPS, "dq_launches": 9 * DISTILL_STEPS,
            "dkv_launches": 9 * DISTILL_STEPS, "plain_calls": 0, "plain_bwd_calls": 0}
    got = {k: launched["distill"][k] for k in want}
    print(f"  distill_diffusion.main, {DISTILL_START} -> {DISTILL_FINAL} steps in "
          f"rounds of {DISTILL_ROUND_STEPS}: losses {['%.5f' % v for v in losses]}, "
          f"launches {got} (expected {want}), peak {peak:.3f} GiB, main {t_main:.3f} s "
          f"(teacher checkpoint written in {t_ckpt:.3f} s)")
    check(got == want, f"distillation launches {got} != {want}")
    # each logged step syncs the card (the loss is read): a step's seconds
    # are the gaps between logs, the first step of each round (a fresh
    # teacher copy and optimizer) apart
    stamps = [m["seconds"] for m in logs]
    steps_s = [b - a for a, b, m in zip(stamps, stamps[1:], logs[1:]) if m["step"] > 0]
    sec = statistics.median(steps_s)

    model = result["model"]
    cfg = TrainConfig(batch_size=BATCH, length=LENGTH)
    stream = distill_diffusion.batches(shard, cfg, ZeroEmbedder(512, device="cuda"),
                                       torch.device("cuda"))
    per_step, stamps = [], []

    def batch_fn(step):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(counts(attn, fr))
        return next(stream)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(attn, fr)
    guided, n = ProgressiveDistiller(model, DistillConfig(
        DISTILL_FINAL, DISTILL_FINAL // 2, DISTILL_ROUND_STEPS, cfg_scale=GUIDED_SCALE)
    ).distill(batch_fn, torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    per_step.append(counts(attn, fr))
    launched["distill_guided"] = per_step[-1]
    peak_g = torch.cuda.max_memory_allocated() / 2**30
    stream.close()
    keys = ("kernel_launches", "dq_launches", "dkv_launches")
    steps = [tuple(b[k] - a[k] for k in keys) for a, b in zip(per_step, per_step[1:])]
    sec_g = statistics.median(b - a for a, b in zip(stamps[1:], stamps[2:]))
    print(f"  guided round (cfg_scale {GUIDED_SCALE}, {DISTILL_FINAL} -> {n} steps): "
          f"K1, K2a, K2b per step {steps}, peak {peak_g:.3f} GiB")
    check(n == DISTILL_FINAL // 2 and steps == [(27, 9, 9)] * DISTILL_ROUND_STEPS
          and per_step[-1]["plain_calls"] == per_step[-1]["plain_bwd_calls"] == 0,
          f"guided distillation launches {steps}")
    del guided

    # the loss and the student's gradients through the kernels and through
    # the plain attention: same student, teacher, batch and draws
    d = ProgressiveDistiller(model)
    stream = distill_diffusion.batches(shard, cfg, ZeroEmbedder(512, device="cuda"),
                                       torch.device("cuda"))
    batch = next(stream)
    stream.close()
    i, noise = d.draws(batch["wav"], DISTILL_FINAL,
                       torch.Generator(device="cuda").manual_seed(8))
    teacher.requires_grad_(False)

    def loss_and_grads_d():
        for p in model.parameters():
            p.grad = None
        loss = d.loss(model, teacher, batch["wav"], batch["onsets"], batch["embedding"],
                      DISTILL_FINAL, i=i, noise=noise)
        loss.backward()
        return loss.item(), {k: p.grad for k, p in model.named_parameters()}

    reset_counts(attn, fr)
    loss_k, grads_k = loss_and_grads_d()
    one = counts(attn, fr)
    check((one["kernel_launches"], one["dq_launches"], one["dkv_launches"]) == (27, 9, 9),
          f"distillation cross-check launches {one}")
    grads_k = {k: None if g is None else g.clone() for k, g in grads_k.items()}
    _, grads_w = loss_and_grads_d()
    attns = [m for net in (model, teacher) for m in net.modules()
             if isinstance(m, blocks.SelfAttention1d)]
    for m in attns:
        m.attend = attn.attention_reference
    loss_p, grads_p = loss_and_grads_d()
    for m in attns:
        del m.attend
    rels = grad_gaps(grads_k, grads_p)
    rerun = grad_gaps(grads_k, grads_w)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  distillation loss, kernels vs plain attention: {rel_loss:.3e} relative "
          f"(tol {TRAIN_LOSS_TOL:.0e}); gradients worst floored {rels[0][0]:.3e} "
          f"({rels[0][2]}; tol {TRAIN_GRAD_TOL:.0e}; through the kernels run to run "
          f"{rerun[0][0]:.3e})")
    check(rel_loss <= TRAIN_LOSS_TOL, "distillation loss cross-check disagrees")
    check(rels[0][0] <= TRAIN_GRAD_TOL, "distillation gradient cross-check disagrees")
    del model, teacher, grads_k, grads_p, grads_w, result
    torch.cuda.empty_cache()

    times = os.path.join(tmp, "times.txt")
    with open(times, "w") as f:
        f.write("0.5\n1.25\n2.0\n3.5\n")
    out = os.path.join(tmp, "distilled.wav")
    reset_counts(attn, fr)
    t0 = time.perf_counter()
    generate.main(["--onset_times", times, "--ckpt",
                   os.path.join(tmp, "teacher", f"distilled_{DISTILL_FINAL}step"),
                   "--num_steps", str(DISTILL_FINAL), "--length", str(LENGTH),
                   "--output", out])
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launched["generate_distilled"] = counts(attn, fr)
    wav, sr = read_wav(out)
    k1 = launched["generate_distilled"]["kernel_launches"]
    print(f"  generate.main --ckpt <distilled> --num_steps {DISTILL_FINAL}: {t_gen:.3f} s "
          f"(model build and load included), K1 {k1} (expected {9 * DISTILL_FINAL})")
    check(k1 == 9 * DISTILL_FINAL and launched["generate_distilled"]["plain_calls"] == 0,
          f"generate from the distilled model launched K1 {k1} times")
    check(sr == SR and wav.shape == (1, LENGTH) and np.isfinite(wav).all(),
          f"the distilled model's clip {wav.shape}")
    print(f"  distillation, f32, B={BATCH}, L={LENGTH}: {sec:.4f} s a step unguided "
          f"(median of {len(steps_s)}), {sec_g:.4f} s guided; peak {peak:.3f} / "
          f"{peak_g:.3f} GiB")
    return {"launched": launched, "sec": sec, "sec_guided": sec_g, "peak": peak}


def phase_remat(attn, fr, shard: str) -> dict:
    """Phase 20c: one f32 training micro-step's loss and gradients at 4 x
    2^18 on 20a's shard with ``remat`` off and on, plain and with the fused
    configuration (same weights, batch, sigma and noise), after a warm-up
    step of each, with cuDNN's deterministic algorithms (its others add weight
    gradients in any order: a rerun without remat is printed as the
    witness): the loss within 1e-6 relative and every gradient within 1e-5
    of the largest (gated); K1, K2a, K2b 9 each either way, K3 and K4 12 a
    forward and 12 more with remat, whose backward recomputes the fused
    blocks (gated); peak memory and seconds of each."""
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion

    batch = training_batch(None, shard)
    out = {}
    with cudnn_deterministic():
        for label, cfg in (("plain", None), ("fused", fused_model_cfg())):
            out[label] = remat_pair(attn, fr, batch, label,
                                    SyncFusionDiffusion.from_config(cfg, device="cuda",
                                                                    seed=0))
            torch.cuda.empty_cache()
    return out


def remat_pair(attn, fr, batch, label: str, model) -> dict:
    """Phase 20c's runs of one model: a warm-up of each (remat off first:
    its gradients are the run-to-run witness), then remat off and on, timed;
    gated; returns their seconds, peaks and counts."""
    unet_cfg = model.unet.cfg
    _, ref = loss_and_grads(model, batch)
    ref = {k: g.clone() for k, g in ref.items() if g is not None}
    model.unet.cfg = dataclasses.replace(unet_cfg, remat=True)
    loss_and_grads(model, batch)
    runs = []
    for remat in (False, True):
        model.unet.cfg = dataclasses.replace(unet_cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(attn, fr)
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        runs.append((loss, grads, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated() / 2**30, counts(attn, fr)))
    (loss_a, ga, sec_a, peak_a, ca), (loss_b, gb, sec_b, peak_b, cb) = runs
    top = max(g.abs().max().item() for g in ga.values() if g is not None)
    gap = max((gb[k] - g).abs().max().item() for k, g in ga.items() if g is not None)
    rerun = max((ref[k] - g).abs().max().item() for k, g in ga.items() if g is not None)
    rel = abs(loss_b - loss_a) / abs(loss_a)
    k34 = K3_PER_FORWARD if unet_cfg.fused_resnet else 0
    want_a = {"kernel_launches": 9, "dq_launches": 9, "dkv_launches": 9,
              "k3_kernel_launches": k34, "k4_kernel_launches": k34}
    want_b = {**want_a, "k3_kernel_launches": 2 * k34, "k4_kernel_launches": 2 * k34}
    got_a, got_b = ({k: c[k] for k in want_a} for c in (ca, cb))
    print(f"  {label}: remat off {sec_a:.4f} s, peak {peak_a:.3f} GiB; on {sec_b:.4f} s, "
          f"peak {peak_b:.3f} GiB; loss {rel:.3e} relative (tol {REMAT_LOSS_TOL:.0e}), "
          f"gradients max |diff| / max |g| {gap / top:.3e} (tol {REMAT_GRAD_TOL:.0e}; "
          f"without remat run to run {rerun / top:.3e}); launches off {got_a}, on "
          f"{got_b}")
    check(rel <= REMAT_LOSS_TOL and gap <= REMAT_GRAD_TOL * top,
          f"{label}: remat changes the loss or the gradients")
    check(got_a == want_a and got_b == want_b
          and ca["plain_calls"] == cb["plain_calls"] == 0
          and ca["k3_plain_calls"] == cb["k3_plain_calls"] == 0,
          f"{label}: remat launches {got_a} / {got_b}")
    return {"sec": (sec_a, sec_b), "peak": (peak_a, peak_b), "launched": (ca, cb)}


def phase_video_resnets(tmp: str) -> None:
    """Phase 20d: ``r2plus1d_18``, ``r3d_18`` and ``mc3_18`` (seeded, eval
    mode, f32 without TF32) at B = 2 x 3 x 16 x 112 x 112: ms a batch over
    ``VR_TIMED`` batches, each closed by ``StepTimer.tick`` (which syncs
    the card); at 1 x 3 x 8 x 112 x 112 the card against the CPU (gated);
    then ``core.profiler.trace`` around K1 launches in a child process
    (``--trace``): its Chrome trace exists and names the ``flash_fwd``
    kernel (gated)."""
    import copy

    from syncfusion_tpu_torch.core import profiler
    from syncfusion_tpu_torch.models import video_resnet

    gen = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn(VR_BATCH, generator=gen, device="cuda")
    small = torch.randn(VR_CPU, generator=gen, device="cuda")
    for name in ("r2plus1d_18", "r3d_18", "mc3_18"):
        net = getattr(video_resnet, name)().cuda().init(0).eval()
        timer = profiler.StepTimer(warmup=1)
        with torch.no_grad():
            timer.start()
            for _ in range(VR_TIMED + 1):
                y = net(x)
                timer.tick()
            got = net(small).cpu()
            want = copy.deepcopy(net).cpu()(small.cpu())
        err = (got - want).abs().max().item() / want.abs().max().item()
        print(f"  {name}: B = {VR_BATCH[0]} x {VR_BATCH[1:]}, f32: "
              f"{timer.mean * 1e3:.3f} ms a batch (best {timer.best * 1e3:.3f}, "
              f"{len(timer.times)} timed); card vs CPU at {VR_CPU}: {err:.3e} (tol "
              f"{VR_TOL:.0e})")
        check(y.shape == (VR_BATCH[0], 512) and torch.isfinite(y).all()
              and len(timer.times) == VR_TIMED, f"{name}: output {tuple(y.shape)}")
        check(err <= VR_TOL, f"{name}: the card disagrees with the CPU")
        del net
    # the trace in a fresh process, as a run profiles itself: in this one,
    # after some thirty profiler sessions, torch.profiler once recorded no
    # device event at all for it
    trace_dir = os.path.join(tmp, "trace")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace", trace_dir],
                          timeout=TRACE_TIMEOUT)
    check(proc.returncode == 0, f"the trace child exited {proc.returncode}")
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({ev["name"] for ev in events if ev.get("cat") == "kernel"
                      and "flash_fwd" in ev.get("name", "")})
    print(f"  profiler.trace (a child process, {TRACE_LAUNCHES} K1 launches): {path} "
          f"({os.path.getsize(path)} bytes, {len(events)} events), flash_fwd kernels "
          f"{[k[:60] for k in kernels]}")
    check(bool(kernels), "the trace names no flash_fwd kernel")


# phase 21a: K1, K2a and K2b at every head width flash_attention takes on
# the card, at one UNet shape (B = 2 x 8 heads, T = 1024): widths below 64
# zero-padded to the 64-wide kernels, 128 through their 128-wide
# instantiations; tolerances as phases 3 (O, LSE) and 5 (gradients, relative
# to max |plain|, BWD_TOL)
HEAD_WIDTHS = (8, 32, 64, 128)
HW_ROWS, HW_T = 2, 1024
HW_ITERS = 50
# the repo's tiny parity config (tests/test_diffusion_stack.py): 2 heads of
# 8 features at levels 2-3; its UNet forward on the card against the CPU,
# f32 without TF32, relative to max |CPU| (sums in other orders)
TINY_MODEL = {
    "model": dict(in_channels=1, channels=(4, 8, 16, 16), factors=(1, 4, 4, 2),
                  items=(1, 1, 1, 2), attentions=(0, 0, 1, 1),
                  cross_attentions=(1, 1, 1, 1), context_channels=(2, 8, 16, 16),
                  attention_heads=2, attention_features=8, embedding_features=16,
                  modulation_features=32, resnet_groups=2),
    "onsets_encoder": dict(in_channels=1, channels=2, multipliers=(1, 1, 4, 8, 8),
                           factors=(1, 4, 4, 2), num_blocks=(1, 1, 1, 1),
                           resnet_groups=2)}
TINY_TOL = 1e-4
TINY_L = 4096
TINY_K1 = 5  # attention calls a forward: levels 2-3 down and up, the bottleneck
# phase 21b: the overfit-to-quality entry points at a cut depth (the
# defaults: 1500 steps, 16 clips, batch 8, 50 sampling steps; 600 stage-2
# steps)
OQ_ARGS = {"--steps": 40, "--clips": 4, "--batch": 4, "--sampling_steps": 8}
OQ2_STEPS = 60
# phase 21c: heads wider than 128 (the Hopper sources csrc/*_wide_sm90.cu up
# to 512; above, K1 csrc/flash_fwd_cluster_sm90.cu up to CLUSTER_FWD_MAX and
# csrc/flash_wide.cu beyond, K2a and K2b csrc/flash_wide.cu).  (a) K1, K2a
# and K2b at these widths,
# as 21a, with heads x D = 512 as in the UNet (the nearest whole number of
# heads at 160 and 320; one head above 512): 3, 3, 2, 2, 1, 1, 1 heads
WIDE_WIDTHS = (160, 192, 256, 320, 512, 576, 1024)
WIDE_HEADS = {d: max(1, round(512 / d)) for d in WIDE_WIDTHS}
# above CLUSTER_FWD_MAX K1 stays the chunked kernel: one head, this T, both
# types
CHUNKED_T = 256
# wide_times_of's larger K1 call above 512: bf16, these rows x 1 head of
# 1024, T = WIDE_T
WIDE_FWD_ROWS = 16
# (b) exp/model/diffusion.yaml's model node with 2 heads of 256 features in
# place of 8 of 64: the inner width stays 512, so every parameter shape and
# the 196M parameters stay; one forward at 2 rows, one f32 micro-step.
# (c) generate --model_config on one clip, the fast configuration's sampler
# (DPM++(2M), CFG 1.5 in the band, DeepCache K = 2) cut to WIDE_GEN_STEPS
# steps, and train_diffusion --model_config for WIDE_TRAIN_STEPS micro-steps
WIDE_SWITCHES = {"attention_heads": 2, "attention_features": 256}
# (a) also K1 alone at that UNet's largest calls, T = 2048: the in-band
# forward of the serving and fast configurations (16 rows, bf16) and the
# training forward (4 rows, f32)
WIDE_LARGEST = ((torch.bfloat16, 2 * SERVE_BATCH), (torch.float32, TRAIN_ROWS))
WIDE_T = 2048
WIDE_ROWS = 2
WIDE_GEN_STEPS = 8
WIDE_TRAIN_STEPS = 2


def sdpa_backend(q, k, v) -> str:
    """The backend that ``scaled_dot_product_attention``'s own dispatcher
    picks for these (B, H, L, D) inputs, by name, or "unknown"."""
    try:
        from torch.nn.attention import SDPBackend

        names = {int(b): name for name, b in SDPBackend.__members__.items()}
        return names.get(int(torch._fused_sdp_choice(q, k, v)), "unknown")
    except (ImportError, AttributeError, RuntimeError, TypeError):
        return "unknown"


def head_width_case(attn, d: int, heads: int, dtype, seed: int) -> dict:
    """``flash_attention`` forward and backward at head width ``d``, B =
    HW_ROWS x ``heads``, T = HW_T, against the plain versions at the true
    width (O and LSE as phase 3, the gradients of q, k and v relative to max
    |plain| as BWD_TOL), one launch of K1, K2a and K2b each and no plain
    call (gated).  Times K1, K2a and K2b on the operands padded to the
    kernel width, the autograd forward with its pad, the plain versions,
    SDPA's forward and backward (with the backend it picks) and the bounds
    at the true width.  Returns the record."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((HW_ROWS, HW_T, 3, heads, d), generator=gen,
                      device="cuda").to(dtype)
    do = torch.randn((HW_ROWS, HW_T, heads, d), generator=gen, device="cuda").to(dtype)
    q, k, v = (x.detach().requires_grad_() for x in qkv.unbind(2))
    attn.reset_counts()
    o, lse = attn.flash_attention(q, k, v, return_lse=True)
    o.backward(do)
    torch.cuda.synchronize()
    got = {c: getattr(attn.flash_attention, c) for c in attn.COUNTS}
    entries = dict(attn.flash_attention.entry_launches)
    width = attn.kernel_width(d)
    want_entries = {attn._ENTRIES[attn.kernel_source(i, width)][i]: 1 for i in range(3)}
    qr, kr, vr = (x.detach().requires_grad_() for x in qkv.unbind(2))
    o_ref, lse_ref = attn.attention_reference(qr, kr, vr, return_lse=True)
    o_ref.backward(do)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    rels = [((a.grad.float() - b.grad.float()).abs().max()
             / b.grad.float().abs().max()).item()
            for a, b in ((q, qr), (k, kr), (v, vr))]
    ok = (err_o <= TOL[dtype]["o"] and err_l <= TOL[dtype]["lse"]
          and max(rels) <= BWD_TOL[dtype])
    qp, kp, vp, dop = (F.pad(x.detach(), (0, width - d)) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    op, lsep = attn.flash_fwd(qp, kp, vp, False, scale)
    _, delta = attn.flash_bwd_dq(qp, kp, vp, op, lsep, dop, False, scale)
    qd, kd, vd = (x.detach() for x in (q, k, v))
    ms = time_ms(lambda: attn.flash_fwd(qp, kp, vp, False, scale), HW_ITERS)
    ms_autograd = time_ms(lambda: attn.flash_attention(qd, kd, vd), HW_ITERS)
    ms_dq = time_ms(lambda: attn.flash_bwd_dq(qp, kp, vp, op, lsep, dop, False, scale),
                    HW_ITERS)
    ms_dkv = time_ms(lambda: attn.flash_bwd_dkv(qp, kp, vp, dop, lsep, delta, False,
                                                scale), HW_ITERS)
    plain = time_ms(lambda: attn.attention_reference(qd, kd, vd), 5)
    plain_dq = time_ms(lambda: attn.flash_bwd_dq_reference(
        qd, kd, vd, o_ref.detach(), lse_ref, do), 3)
    plain_dkv = time_ms(lambda: attn.flash_bwd_dkv_reference(
        qd, kd, vd, do, lse_ref, delta), 3)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    backend = sdpa_backend(qt, kt, vt)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt)

    lib = time_ms(sdpa_fwd, HW_ITERS)
    lib_bwd = time_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot),
                      HW_ITERS) - lib
    bms, by = bound_ms(*attention_work(HW_ROWS, heads, HW_T, d, dtype, False), dtype)
    work = bwd_work(HW_ROWS, heads, HW_T, d, dtype, False)
    rec = {"max_abs_err": err_o, "lse_err": err_l, "grad_rel_err": max(rels),
           "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
           "library_ms": lib, "library_backend": backend, "kernel_width": width,
           "heads": heads, "autograd_ms": ms_autograd, "entries": entries}
    for key, kms, pms in (("dq", ms_dq, plain_dq), ("dkv", ms_dkv, plain_dkv)):
        kb, kby = bound_ms(*work[key], dtype)
        rec[key] = {"max_abs_err": max(rels), "ms": kms, "plain_ms": pms,
                    "bound_ms": kb, "bound_by": kby, "library_ms": lib_bwd,
                    "library_backend": backend}
    print(f"  D={d:3d} {str(dtype)[6:]:8s} BH={HW_ROWS * heads} T={HW_T} (kernel "
          f"width {width}): err O {err_o:.3e} (tol {TOL[dtype]['o']:.0e}) LSE "
          f"{err_l:.3e} dq/dk/dv rel {max(rels):.3e} (tol {BWD_TOL[dtype]:.0e}) | "
          f"K1 {ms:.4f} ms (autograd call with its pad {ms_autograd:.4f}, plain "
          f"{plain:.4f}, sdpa {lib:.4f}, bound {bms:.4f} {by}), K2a {ms_dq:.4f} ms "
          f"(plain {plain_dq:.4f}, bound {rec['dq']['bound_ms']:.4f}), K2b "
          f"{ms_dkv:.4f} ms (plain {plain_dkv:.4f}, bound "
          f"{rec['dkv']['bound_ms']:.4f}), sdpa bwd {lib_bwd:.4f} ms (sdpa backend "
          f"{backend}); launches {got} by entry {entries} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, f"head width {d} {dtype} disagrees with the plain versions")
    check(got == {"kernel_launches": 1, "dq_launches": 1, "dkv_launches": 1,
                  "plain_calls": 0, "plain_bwd_calls": 0},
          f"head width {d} {dtype}: launches {got}")
    check(entries == want_entries,
          f"head width {d} {dtype}: C entries {entries}, want {want_entries}")
    return rec


def chunked_fwd_case(attn, dtype, seed: int) -> dict:
    """Phase 21c(a): K1 above CLUSTER_FWD_MAX, where it stays the chunked
    kernel of flash_wide.cu (one body a type): B = HW_ROWS x 1 head of
    CLUSTER_FWD_MAX + 64, T = CHUNKED_T, in ``dtype``, on views of one
    packed projection, against the plain version (phase 3's gates), one
    launch of ``flash_fwd_chunked`` and no plain call (gated), timed beside
    the plain version, SDPA and the bound.  Returns the record, as
    ``head_width_case``'s for K1."""
    import torch.nn.functional as F

    d = attn.CLUSTER_FWD_MAX + 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = torch.randn((HW_ROWS, CHUNKED_T, 3, 1, d), generator=gen,
                          device="cuda").to(dtype).unbind(2)
    attn.reset_counts()
    o, lse = attn.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    got = {c: getattr(attn.flash_attention, c) for c in attn.COUNTS}
    entries = dict(attn.flash_attention.entry_launches)
    o_ref, lse_ref = attn.attention_reference(q, k, v, return_lse=True)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    ok = err_o <= TOL[dtype]["o"] and err_l <= TOL[dtype]["lse"]
    ms = time_ms(lambda: attn.flash_fwd(q, k, v), HW_ITERS)
    plain = time_ms(lambda: attn.attention_reference(q, k, v), 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    backend = sdpa_backend(qt, kt, vt)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), HW_ITERS)
    bms, by = bound_ms(*attention_work(HW_ROWS, 1, CHUNKED_T, d, dtype, False), dtype)
    print(f"  K1 above CLUSTER_FWD_MAX, D={d} {str(dtype)[6:]} BH={HW_ROWS} T={CHUNKED_T}: "
          f"err O "
          f"{err_o:.3e} (tol {TOL[dtype]['o']:.0e}) LSE {err_l:.3e} | kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, sdpa {lib:.4f} ms ({backend}), bound {bms:.4f} ms "
          f"({by}); launches {got} by entry {entries} {'ok' if ok else 'MISMATCH'}",
          flush=True)
    check(ok, f"K1 at D={d} {dtype} disagrees with its plain version")
    check(got == {"kernel_launches": 1, "dq_launches": 0, "dkv_launches": 0,
                  "plain_calls": 0, "plain_bwd_calls": 0},
          f"K1 at D={d} {dtype}: launches {got}")
    check(entries == {"flash_fwd_chunked": 1}, f"K1 at D={d} {dtype}: C entries {entries}")
    return {"max_abs_err": err_o, "lse_err": err_l, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "library_backend": backend, "kernel_width": d, "heads": 1,
            "entries": entries}


def wide_largest_calls(attn) -> dict:
    """Phase 21c(a): K1 at the 2 x 256 UNet's largest calls (WIDE_LARGEST,
    T = WIDE_T; q, k and v views of one packed projection, as the UNet
    makes them) against the plain version (phase 3's gates), one launch a
    call and no plain call (gated), timed beside the plain version, SDPA
    (with the backend it picks) and the bound.  Returns ``{type: record}``."""
    import torch.nn.functional as F

    heads, d = WIDE_SWITCHES["attention_heads"], WIDE_SWITCHES["attention_features"]
    gen = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for dtype, rows in WIDE_LARGEST:
        qkv = torch.randn((rows, WIDE_T, 3, heads, d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
        attn.reset_counts()
        o, lse = attn.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        got = {c: getattr(attn.flash_attention, c) for c in attn.COUNTS}
        o_ref, lse_ref = attn.attention_reference(q, k, v, return_lse=True)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        ok = err_o <= TOL[dtype]["o"] and err_l <= TOL[dtype]["lse"]
        ms = time_ms(lambda: attn.flash_fwd(q, k, v), HW_ITERS)
        plain = time_ms(lambda: attn.attention_reference(q, k, v), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        backend = sdpa_backend(qt, kt, vt)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), HW_ITERS)
        bms, by = bound_ms(*attention_work(rows, heads, WIDE_T, d, dtype, False), dtype)
        print(f"  K1 at the 2 x 256 UNet's largest call, {str(dtype)[6:]} BH="
              f"{rows * heads} T={WIDE_T} D={d}: err O {err_o:.3e} (tol "
              f"{TOL[dtype]['o']:.0e}) LSE {err_l:.3e} | kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms ({backend}), bound {bms:.4f} ms "
              f"({by}); launches {got} {'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, f"wide K1 at BH={rows * heads} {dtype} disagrees with its plain version")
        check(got == {"kernel_launches": 1, "dq_launches": 0, "dkv_launches": 0,
                      "plain_calls": 0, "plain_bwd_calls": 0},
              f"wide K1 at BH={rows * heads} {dtype}: launches {got}")
        out[str(dtype)[6:]] = {"max_abs_err": err_o, "lse_err": err_l, "ms": ms,
                               "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                               "library_ms": lib, "library_backend": backend,
                               "rows": rows}
        del qkv, q, k, v, o, lse
        torch.cuda.empty_cache()
    return out


def wide_training_backward(attn) -> dict:
    """Phase 21c(a): K2a and K2b at the 2 x 256 UNet's training call (f32,
    TRAIN_ROWS x 2 heads of 256, T = WIDE_T; q, k and v views of one packed
    projection) against their plain versions (phase 5's gate: dq, dk and dv
    relative to max |plain|, BWD_TOL; delta as the LSE), one launch each and
    no plain call (gated), timed beside the plain versions, SDPA's backward
    (with the backend it picks) and the bounds.  Returns ``{"dq": record,
    "dkv": record}``."""
    import torch.nn.functional as F

    heads, d = WIDE_SWITCHES["attention_heads"], WIDE_SWITCHES["attention_features"]
    rows, dtype = TRAIN_ROWS, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(29)
    qkv = torch.randn((rows, WIDE_T, 3, heads, d), generator=gen, device="cuda")
    q, k, v = qkv.unbind(2)
    do = torch.randn((rows, WIDE_T, heads, d), generator=gen, device="cuda")
    o, lse = attn.flash_fwd(q, k, v)
    attn.reset_counts()
    dq, delta = attn.flash_bwd_dq(q, k, v, o, lse, do)
    dk, dv = attn.flash_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    got = {c: getattr(attn.flash_attention, c) for c in attn.COUNTS}
    want_dq, want_delta = attn.flash_bwd_dq_reference(q, k, v, o, lse, do)
    want_dk, want_dv = attn.flash_bwd_dkv_reference(q, k, v, do, lse, want_delta)
    rels = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            for a, b in ((dq, want_dq), (dk, want_dk), (dv, want_dv))]
    err_delta = (delta - want_delta).abs().max().item()
    del want_dq, want_dk, want_dv
    ok = max(rels) <= BWD_TOL[dtype] and err_delta <= TOL[dtype]["lse"]
    ms = {"dq": time_ms(lambda: attn.flash_bwd_dq(q, k, v, o, lse, do), HW_ITERS),
          "dkv": time_ms(lambda: attn.flash_bwd_dkv(q, k, v, do, lse, delta), HW_ITERS)}
    plain = {"dq": time_ms(lambda: attn.flash_bwd_dq_reference(q, k, v, o, lse, do), 3),
             "dkv": time_ms(lambda: attn.flash_bwd_dkv_reference(q, k, v, do, lse, delta),
                            3)}
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    backend = sdpa_backend(qt, kt, vt)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt)

    lib = time_ms(sdpa_fwd, HW_ITERS)
    lib_bwd = time_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot),
                      HW_ITERS) - lib
    work = bwd_work(rows, heads, WIDE_T, d, dtype, False)
    blocks = attn.wide_bwd_blocks(d, dtype, rows * heads, WIDE_T, WIDE_T)
    out = {}
    for key in ("dq", "dkv"):
        bms, by = bound_ms(*work[key], dtype)
        out[key] = {"max_abs_err": max(rels), "delta_err": err_delta, "ms": ms[key],
                    "plain_ms": plain[key], "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_bwd, "library_backend": backend, "rows": rows,
                    "blocks": blocks[key]}
    print(f"  K2a and K2b at the 2 x 256 UNet's training call, f32 BH={rows * heads} "
          f"T={WIDE_T} D={d}: dq/dk/dv rel {max(rels):.3e} (tol {BWD_TOL[dtype]:.0e}) "
          f"delta {err_delta:.3e} | K2a {ms['dq']:.4f} ms (plain {plain['dq']:.4f}, "
          f"bound {out['dq']['bound_ms']:.4f}), K2b {ms['dkv']:.4f} ms (plain "
          f"{plain['dkv']:.4f}, bound {out['dkv']['bound_ms']:.4f}), sdpa bwd "
          f"{lib_bwd:.4f} ms ({backend}); blocks {blocks}; launches {got} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, "wide K2a/K2b at the training call disagree with their plain versions")
    check(got == {"kernel_launches": 0, "dq_launches": 1, "dkv_launches": 1,
                  "plain_calls": 0, "plain_bwd_calls": 0},
          f"wide K2a/K2b at the training call: launches {got}")
    del qkv, q, k, v, do, o, lse, dq, dk, dv, delta
    torch.cuda.empty_cache()
    return out


def kernel_record(rec: dict, key: str) -> dict:
    """K1's part (``key`` "fwd") of a ``head_width_case`` record, or K2a's
    ("dq") or K2b's ("dkv")."""
    return rec if key == "fwd" else rec[key]


def phase_head_widths(attn) -> dict:
    """Phase 21a: ``head_width_case`` at each of HEAD_WIDTHS in bf16 and
    f32, 8 heads, then the tiny parity config's UNet forward on the card
    against the CPU (gated).  Returns ``({(d, dtype): record}, the tiny
    config's record)``."""
    out = {(d, str(dtype)[6:]): head_width_case(attn, d, HEADS, dtype, 21 + d)
           for d in HEAD_WIDTHS for dtype in (torch.bfloat16, torch.float32)}
    return out, tiny_parity_forward(attn)


def tiny_parity_forward(attn) -> dict:
    """The tiny parity config's UNet forward at L = TINY_L, B = 2, on the
    card against the same weights on the CPU (f32 without TF32, gated), 5
    K1 launches and no plain call (gated)."""
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion

    cpu = SyncFusionDiffusion.from_config(TINY_MODEL, device="cpu", seed=0)
    gpu = SyncFusionDiffusion.from_config(TINY_MODEL, device="cuda", seed=0)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, TINY_L, 1), generator=gen)
    onsets = torch.zeros((2, TINY_L, 1))
    onsets[:, ::300] = 1.0
    emb = torch.randn((2, 1, 16), generator=gen)
    sigma = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        want = cpu.unet(x, sigma, context=cpu.encode_context(onsets), embedding=emb)
        attn.reset_counts()
        got = gpu.unet(x.cuda(), sigma.cuda(), context=gpu.encode_context(onsets.cuda()),
                       embedding=emb.cuda())
        torch.cuda.synchronize()
    rel = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    k1, plain = attn.flash_attention.kernel_launches, attn.flash_attention.plain_calls
    print(f"  tiny parity config (attention_features 8), UNet forward B=2 L={TINY_L}: "
          f"card vs CPU max |diff| / max |CPU| {rel:.3e} (tol {TINY_TOL:.0e}), {k1} K1 "
          f"(expected {TINY_K1}), {plain} plain")
    check(math.isfinite(rel) and rel <= TINY_TOL, "the tiny parity config disagrees")
    check(k1 == TINY_K1 and plain == 0, f"the tiny parity config launched {k1} K1, {plain} plain")
    return {"rel_err": rel, "k1": k1}


def run_entry_point(main, argv: list) -> tuple:
    """``main(argv)`` with its standard output captured (and echoed);
    returns (exit code, the JSON objects of its lines, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    text = buf.getvalue()
    print("    " + text.strip().replace("\n", "\n    "))
    lines = []
    for line in text.strip().splitlines():
        try:
            lines.append(json.loads(line))
        except json.JSONDecodeError:
            check(False, f"a line of {main.__module__} is not JSON: {line!r}")
    return rc, lines, sec


def phase_overfit_quality(attn, fr, tmp: str) -> dict:
    """Phase 21b: ``overfit_quality.main`` at OQ_ARGS (f32: K1, K2a and K2b
    3 a training step, the UNet's 3 attention calls; K1 3 a sampling step of
    3 evaluations) and ``overfit_quality_stage2.main`` at OQ2_STEPS steps
    (no hand-written kernel), on the card: every line JSON, the result line
    last with the init, mid and final evaluations, the file ``--out`` wrote
    equal to it, the exact counts and no plain call (gated).  Quality is not
    gated at this depth.  Returns the launch counts by path."""
    from syncfusion_tpu_torch import overfit_quality, overfit_quality_stage2

    launched = {}
    argv = [str(a) for kv in OQ_ARGS.items() for a in kv]
    steps, n_samp = OQ_ARGS["--steps"], OQ_ARGS["--sampling_steps"]
    per_forward = 3  # the UNet's SelfAttention1d blocks, all at its last level
    for name, main, args, want in (
            ("overfit_quality", overfit_quality.main, argv,
             {"kernel_launches": per_forward * (steps + 3 * n_samp),
              "dq_launches": per_forward * steps, "dkv_launches": per_forward * steps}),
            ("overfit_quality_stage2", overfit_quality_stage2.main,
             ["--steps", str(OQ2_STEPS)],
             {"kernel_launches": 0, "dq_launches": 0, "dkv_launches": 0})):
        out = os.path.join(tmp, f"{name}.json")
        reset_counts(attn, fr)
        rc, lines, sec = run_entry_point(main, [*args, "--out", out])
        got = counts(attn, fr)
        last = lines[-1] if lines else {}
        with open(out) as f:
            saved = json.load(f)
        tags = [r.get("tag") for r in last.get("results", [])]
        print(f"  {name}: exit code {rc}, {len(lines)} JSON lines, {sec:.3f} s, "
              f"quality_improved {last.get('quality_improved')}, launches "
              f"{ {k: got[k] for k in want} } (expected {want})")
        check(tags == ["init", "mid", "final"] and rc == (0 if last["quality_improved"] else 1)
              and saved["results"] == last["results"], f"{name}: result lines {last}")
        check({k: got[k] for k in want} == want and got["plain_calls"] == 0
              and got["plain_bwd_calls"] == 0 and got["k3_kernel_launches"] == 0
              and got["k4_kernel_launches"] == 0, f"{name}: launches {got}")
        launched[name] = got
    return launched


def wide_model_cfg() -> dict:
    """exp/model/diffusion.yaml's model node with WIDE_SWITCHES: 2 heads of
    256 features."""
    from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig

    return {"model": {**dataclasses.asdict(UNetConfig()), **WIDE_SWITCHES},
            "onsets_encoder": dataclasses.asdict(EncoderConfig())}


def phase_wide_model(attn, fr, blocks, tmp: str, n_params: int, narrow: dict) -> dict:
    """Phase 21c (b): the full-width UNet with 2 heads of 256, seeded
    weights: its parameter count is the default model's (gated); one whole
    bf16 forward at WIDE_ROWS rows (a 1-step sample, outside the band)
    through the kernels against the same model with the plain attention on
    the card, phase 5's gate (the share of O elements the kernel rounds
    otherwise than the plain version) and 9 K1 launches; the in-band
    forward at the serving shape whole and cached, timed as phase 4d times
    the default model (``narrow``, its record), 9 and 0 K1 (gated); one f32
    loss and gradient against the plain attention, phase 7's and 9's
    gates, 9 K1, 9 K2a and 9 K2b (``train_vs_plain``).  Returns the
    figures."""
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion

    model = SyncFusionDiffusion.from_config(wide_model_cfg(), dtype=torch.bfloat16,
                                            device="cuda", seed=0)
    check(model.param_count() == n_params,
          f"2 x 256 heads: {model.param_count()} parameters, not {n_params}")
    noise, onsets, embedding = sampler_inputs(WIDE_ROWS)
    census, tally = rounding_census(attn)
    reset_counts(attn, fr)
    rel = kernel_vs_plain(model, attn, blocks, noise, onsets, embedding, attend=census,
                          num_steps=1, embedding_scale=SCALE, guidance_interval=BAND)
    k1 = counts(attn, fr)["kernel_launches"]
    share = tally["kernel_vs_plain"] / tally["elements"]
    print(f"  2 x 256 heads, {model.param_count():,} params, one bf16 forward at "
          f"{WIDE_ROWS} rows: O elements rounded otherwise than the plain version "
          f"{tally['kernel_vs_plain']} of {tally['elements']}, share {share:.3e} (tol "
          f"{BF16_FLIP_TOL:.0e}; the plain version against f64: {tally['plain_vs_f64']}); "
          f"output max |diff| / max |plain| {rel.max().item():.3e} (not gated, as phase "
          f"5); {k1} K1 (expected 9)", flush=True)
    check(bool(torch.isfinite(rel).all()) and rel.numel() == WIDE_ROWS * LENGTH,
          "2 x 256 heads: the forward is not finite or of the wrong shape")
    check(share <= BF16_FLIP_TOL, "2 x 256 heads: the kernel rounds too many O "
          "elements otherwise than the plain version")
    check(k1 == 9, f"2 x 256 heads: {k1} K1 launches in one forward")
    fwd = forward_full_vs_cached(model, attn, fr, sampler_inputs(SERVE_BATCH))
    print(f"  2 x 256 heads, one in-band forward, {2 * SERVE_BATCH} rows, bf16: full "
          f"{fwd['full_device_ms']:.3f} ms device, K1 {fwd['full_k1_device_ms']:.3f} of it "
          f"({fwd['full_eager_ms']:.3f} eager, {fwd['full_k1']} K1), cached "
          f"{fwd['cached_device_ms']:.3f} ms device ({fwd['cached_k1']} K1); 8 x 64 heads "
          f"(phase 4d): full {narrow['full_device_ms']:.3f} ms device, K1 "
          f"{narrow['full_k1_device_ms']:.3f} of it; wide / narrow "
          f"{fwd['full_device_ms'] / narrow['full_device_ms']:.4f}", flush=True)
    check(fwd["full_k1"] == 9 and fwd["cached_k1"] == 0,
          f"2 x 256 heads: K1 per forward full / cached {fwd['full_k1']} / "
          f"{fwd['cached_k1']}")
    model32 = SyncFusionDiffusion.from_config(wide_model_cfg(), dtype=torch.float32,
                                              device="cuda", seed=0)
    model32.load_state_dict(model.state_dict(), strict=True)
    del model
    write_shard(os.path.join(tmp, "shard.tar"))
    rel_loss, rel_grad = train_vs_plain(model32, attn, fr, blocks, tmp)
    print(f"  2 x 256 heads, f32 loss and gradient, kernels vs plain attention: loss "
          f"{rel_loss:.3e} relative (tol {TRAIN_LOSS_TOL:.0e}), gradients max |diff| / "
          f"max |plain| {rel_grad:.3e} (tol {TRAIN_GRAD_TOL:.0e})", flush=True)
    check(rel_loss <= TRAIN_LOSS_TOL, "2 x 256 heads: loss cross-check disagrees")
    check(rel_grad <= TRAIN_GRAD_TOL, "2 x 256 heads: gradient cross-check disagrees")
    del model32
    torch.cuda.empty_cache()
    return {"flip_share": share, "output_rel": rel.max().item(), "loss_rel": rel_loss,
            "grad_rel": rel_grad, "forward_device_ms": fwd["full_device_ms"],
            "forward_k1_device_ms": fwd["full_k1_device_ms"], "launched": {
                "forward": {"kernel_launches": k1},
                "micro_step": {"kernel_launches": 9, "dq_launches": 9,
                               "dkv_launches": 9}}}


def phase_wide_entry_points(attn, fr, tmp: str) -> dict:
    """Phase 21c (c): ``generate.main`` with ``--model_config`` of the 2 x
    256 model on one clip (DPM++(2M), DeepCache K = FAST_K, WIDE_GEN_STEPS
    steps): exit, a finite wav of LENGTH samples, 9 K1 a whole forward and
    none elsewhere (gated); then ``train_diffusion.main`` with it for
    WIDE_TRAIN_STEPS micro-steps through ``phase_train`` (its gates: losses,
    checkpoint, media, 9 K1 a forward and 9 K2a and K2b a backward).
    Returns the launch counts by entry point."""
    from syncfusion_tpu_torch import generate
    from syncfusion_tpu_torch.ops.wav import read_wav

    cfg = os.path.join(tmp, "wide.json")
    with open(cfg, "w") as f:
        json.dump(wide_model_cfg(), f)
    times = os.path.join(tmp, "times.txt")
    with open(times, "w") as f:
        f.write("0.5\n1.5\n3.25\n")
    out = os.path.join(tmp, "wide.wav")
    argv = ["--onset_times", times, "--model_config", cfg, "--output", out,
            "--length", str(LENGTH), "--sampler", "dpm", "--num_steps", str(WIDE_GEN_STEPS), "--embedding_scale",
            str(FAST_SCALE), "--deep_cache_interval", str(FAST_K)]
    want = {"kernel_launches": 9 * full_forwards(WIDE_GEN_STEPS, FAST_K),
            "dq_launches": 0, "dkv_launches": 0, "plain_calls": 0, "plain_bwd_calls": 0}
    reset_counts(attn, fr)
    t0 = time.perf_counter()
    rc = generate.main(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = counts(attn, fr)
    wav, sr = read_wav(out)
    print(f"  generate --model_config (2 x 256 heads), DPM++(2M) {WIDE_GEN_STEPS} steps, "
          f"DeepCache K={FAST_K}: {sec:.3f} s, wav {wav.shape} at {sr} Hz, max |wav| "
          f"{np.abs(wav).max():.4f}, launches { {k: got[k] for k in want} } (expected "
          f"{want})", flush=True)
    check(rc in (None, 0), f"generate returned {rc}")
    check(wav.size == LENGTH and sr == SR and bool(np.isfinite(wav).all()),
          f"generate wrote {wav.shape} at {sr} Hz")
    check({k: got[k] for k in want} == want, f"generate (2 x 256 heads): launches {got}")
    launched = {"generate_wide": got}
    state, launched["train_wide"], sec_t, peak, _ = phase_train(
        attn, fr, tmp, "wide", wide_model_cfg(), steps=WIDE_TRAIN_STEPS)
    print(f"  train_diffusion --model_config (2 x 256 heads), f32, B={BATCH}, "
          f"L={LENGTH}: {sec_t:.4f} s at micro-step {WIDE_TRAIN_STEPS}, peak memory "
          f"{peak:.3f} GiB", flush=True)
    del state
    torch.cuda.empty_cache()
    return launched


def trace_child(trace_dir: str) -> int:
    """``chip_smoke.py --trace DIR``: ``core.profiler.trace`` around
    ``TRACE_LAUNCHES`` K1 launches (f32, 2 x 2048 x 8 x 64), written to
    DIR/trace.json; the kernels are the checkout's, built by phase 2."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from syncfusion_tpu_torch.core import profiler
    from syncfusion_tpu_torch.ops import attention as attn

    q = torch.randn((2, 2048, HEADS, HEAD_DIM), device="cuda")
    with profiler.trace(trace_dir):
        for _ in range(TRACE_LAUNCHES):
            attn.flash_attention(q, q, q)
        torch.cuda.synchronize()
    return 0


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
    # ptxas reports static shared memory only: each library gives the
    # dynamic shared memory its launches ask for
    k1_regs = k1_ptxas(_build, libs)
    print(f"  K1 registers, spills and bf16 plans: {k1_regs}")
    bwd_log = libs["flash_bwd"].with_suffix(".so.log").read_text()
    k2_regs = {key: pick_ptxas(bwd_log, picks) for key, picks in K2_KERNELS.items()}
    smem = _build.library("flash_bwd").flash_bwd_smem
    for key, by_type in k2_regs.items():
        for dtype, report in by_type.items():
            report["dynamic_smem_bytes"] = smem(int(key == "dkv"),
                                                int(dtype.startswith("bfloat16")),
                                                128 if dtype.endswith("_d128") else 64)
            check(report["dynamic_smem_bytes"] > 0, f"no shared memory for K2 {key}")
    print(f"  K2a and K2b registers and spills: {k2_regs}")
    wide_log = libs["flash_wide"].with_suffix(".so.log").read_text()
    wide_smem = _build.library("flash_wide").flash_wide_smem
    wide_regs = {key: pick_ptxas(wide_log, picks) for key, picks in WIDE_KERNELS.items()}
    for key, by_type in wide_regs.items():
        for dtype, report in by_type.items():
            report["dynamic_smem_bytes"] = wide_smem(int(dtype == "bfloat16"))
            check(report["dynamic_smem_bytes"] > 0, f"no shared memory for wide {key}")
    print(f"  chunked K1, K2a and K2b (flash_wide.cu) registers and spills: "
          f"{wide_regs}")
    chunked_regs = wide_regs
    wide_regs = {"fwd": wide_fwd_ptxas(_build, libs), **wide_bwd_ptxas(_build, libs)}
    print(f"  wide K1 (flash_fwd_wide_sm90.cu) registers, spills and plans: "
          f"{wide_regs['fwd']}")
    print(f"  wide K2a and K2b (flash_bwd_wide_sm90.cu) registers, spills and plans: "
          f"dq {wide_regs['dq']}, dkv {wide_regs['dkv']}")
    cluster_regs = cluster_fwd_ptxas(_build, libs)
    print(f"  cluster K1 (flash_fwd_cluster_sm90.cu) registers, spills and plans: "
          f"{cluster_regs}")
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
    n_params = model.param_count()
    print(f"  params: {n_params:,}")
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
          f"{fwd['full_device_ms']:.3f} ms device, K1 {fwd['full_k1_device_ms']:.3f} of it "
          f"({fwd['full_eager_ms']:.3f} eager, {fwd['full_k1']} K1), cached at split {DEEP_SPLIT} "
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
        state, train_launched, sec, peak, train_losses = phase_train(attn, fr, tmp,
                                                                      "plain")
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
            runs=SIDE_RUNS, num_steps=NUM_STEPS, embedding_scale=SCALE,
            guidance_interval=BAND)
        rel_gen = ((wav_f - wav_plain).abs().max() / wav_plain.abs().max()).item()
        med, med_f = statistics.median(seconds), statistics.median(seconds_f)
        print(f"  fused vs plain UNet, 150 steps, bf16, medians of {SIDE_RUNS} and "
              f"{TIMED_RUNS}: "
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
        state, fused_train, sec_f, peak_f, _ = phase_train(attn, fr, tmp, "fused",
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
        state, clap_train, sec_c, peak_c, _ = phase_train(
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

    with tempfile.TemporaryDirectory() as tmp:
        md_launched = phase_multi_device(tmp, clips_per_min["serving B=8 K=4"],
                                         train_losses, sec, step_s["bf16"])

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        phase_condfoleygen(attn, fr, tmp)
        phase("17 CondFoleyGen generation at full width", t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        phase_baseline_train(attn, fr, tmp)
        phase("18 CondFoleyGen training at full width", t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        compat_launched = phase_compat(attn, fr, tmp)
        phase("19 published-checkpoint paths at full width", t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        raw = phase_raw_data(tmp)
        phase("20a raw data to shards, the denoiser", t0)
        t0 = time.perf_counter()
        # cuDNN deterministic, as 20c: with its other algorithms the
        # distilled student differed run to run, and with it the encoder's
        # small bias gradients in the 1e-3 gate (2.2e-4 to 1.6e-3 of the floor
        # over seven runs on an NVIDIA H100 80GB HBM3 at 700 W; deterministic,
        # 7.9e-4 every run)
        with cudnn_deterministic():
            dist = phase_distill(attn, fr, blocks, tmp, raw["shard"])
        phase("20b progressive distillation at full width", t0)
        t0 = time.perf_counter()
        remat = phase_remat(attn, fr, raw["shard"])
        phase("20c remat at full width", t0)
        t0 = time.perf_counter()
        phase_video_resnets(tmp)
        phase("20d the video ResNet family, StepTimer and trace", t0)

    t0 = time.perf_counter()
    widths, tiny = phase_head_widths(attn)
    phase("21a K1, K2a and K2b at every head width", t0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        oq_launched = phase_overfit_quality(attn, fr, tmp)
        phase("21b the overfit-to-quality entry points", t0)
    t0 = time.perf_counter()
    wide = {(d, str(dtype)[6:]): head_width_case(attn, d, WIDE_HEADS[d], dtype, 210 + d)
            for d in WIDE_WIDTHS for dtype in (torch.bfloat16, torch.float32)}
    above = {(attn.CLUSTER_FWD_MAX + 64, str(dtype)[6:]): chunked_fwd_case(attn, dtype, seed)
             for dtype, seed in ((torch.bfloat16, 4160), (torch.float32, 4161))}
    largest = wide_largest_calls(attn)
    train_bwd = wide_training_backward(attn)
    phase("21c(a) K1, K2a and K2b at heads wider than 128", t0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        wide_model = phase_wide_model(attn, fr, blocks, tmp, n_params, fwd)
        phase("21c(b) the full-width UNet with 2 heads of 256", t0)
        t0 = time.perf_counter()
        wide_launched = phase_wide_entry_points(attn, fr, tmp)
        phase("21c(c) generate and train_diffusion with 2 heads of 256", t0)

    fwd16, fwd32 = total[torch.bfloat16, ROWS], total[torch.float32, ROWS]
    serve16 = total[torch.bfloat16, SERVE_ROWS]
    v2f16 = {rows: total[torch.bfloat16, rows] for rows in V2F_ROWS}
    eval32 = total[torch.float32, EVAL_ROWS]
    paths = {"generate": gen_launched, "generate_serving": serve_launched,
             "generate_fast": fast_launched, "train": train_launched,
             "generate_fused": fused_launched, "train_fused": fused_train,
             "video_to_foley": v2f_launched, "train_clap": clap_train,
             "video_to_foley_cond_wav": v2f_clap["cond_wav"],
             "video_to_foley_text": v2f_clap["text"], "evaluate": eval_launched,
             "sample_data_parallel": md_launched["sampler"],
             "train_ddp": md_launched["train"],
             "compat_forward": compat_launched["compat_forward"],
             "compat_train": compat_launched["compat_train"],
             "evaluate_compat": compat_launched["evaluate_compat"],
             **dist["launched"],
             "remat_step": remat["plain"]["launched"][1],
             "fused_remat_step": remat["fused"]["launched"][1],
             **oq_launched}

    def launched_by_path(key):
        return {p_: c_.get(key, 0) for p_, c_ in paths.items()}

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
        "design": {"bfloat16": "TMA through 4-D tensor maps into K and V rings "
                               "on mbarriers; S on wgmma m64n64k16 at 64 (64-key "
                               "tiles) and m64n128k16 at 128 (128-key tiles), P·V "
                               "on m64n64k16 (P as hi + lo bf16 from registers), the next "
                               "tile's S issued with this tile's P·V; one "
                               "warpgroup a 64-row q tile, two a block where the "
                               "grid fills the card (fwd_plan)",
                   "float32": "tensor cores: mma.sync m16n8k8 tf32, q, K, V "
                              "and P as 3xTF32, per-tile partial sums of P·V "
                              "added in f32, cp.async K/V ring of 2 stages, 4 "
                              "warps of 16 query rows a block",
                   "head_widths": "templates of the head width, built at 64 and "
                                  "128; a narrower head zero-padded by the "
                                  "autograd Function"},
        "ptxas": k1_regs,
        "head_widths": {f"d{d}_{dtype}": {k_: r_ for k_, r_ in rec.items()
                                           if k_ not in ("dq", "dkv")}
                        for (d, dtype), rec in widths.items()},
        "head_widths_work": f"one call at B={HW_ROWS} x {HEADS} heads, T={HW_T}: D 8 "
                            "and 32 zero-padded to the 64-wide kernel, 128 on the "
                            "128-wide one; ms on the padded operands, autograd_ms "
                            "of flash_attention with its pad; bounds at the true "
                            "width",
        "tiny_parity_config": tiny,
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
            "head_widths": {f"d{d}_{dtype}": rec[key]
                            for (d, dtype), rec in widths.items()},
            "head_widths_work": f"one call at B={HW_ROWS} x {HEADS} heads, T={HW_T}, "
                                "on operands padded to the kernel width; library_ms "
                                "is SDPA's whole backward (dq, dk and dv)",
        })
    wide_paths = {"wide_forward": wide_model["launched"]["forward"],
                  "wide_micro_step": wide_model["launched"]["micro_step"],
                  **wide_launched}
    hopper = {dk_: rec for dk_, rec in wide.items() if dk_[0] <= attn.WIDE_FWD_MAX}
    chunked = {dk_: rec for dk_, rec in wide.items() if dk_[0] > attn.WIDE_FWD_MAX}
    for name, replaces, key in (
            ("flash_fwd_wide", "syncfusion_tpu/ops/attention.py:34", "fwd"),
            ("flash_bwd_dq_wide", "syncfusion_tpu/ops/attention.py:137", "dq"),
            ("flash_bwd_dkv_wide", "syncfusion_tpu/ops/attention.py:181", "dkv")):
        count = {"fwd": "kernel_launches"}.get(key, f"{key}_launches")
        by_path = {p_: c_.get(count, 0) for p_, c_ in wide_paths.items()}
        fwd = key == "fwd"
        main_rec = largest["bfloat16"] if fwd else train_bwd[key]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "syncfusion_tpu_torch/csrc/"
                      + ("flash_fwd_wide_sm90.cu" if fwd else "flash_bwd_wide_sm90.cu"),
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max([kernel_record(rec, key)["max_abs_err"]
                                for rec in hopper.values()]
                               + [r_["max_abs_err"] for r_ in
                                  (largest.values() if fwd else [train_bwd[key]])]),
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "library_backend": main_rec["library_backend"],
            "work": (f"the 2 x 256 UNet's largest call, bf16 (generation's "
                     f"type), B={WIDE_LARGEST[0][1]} x 2 heads of 256, T={WIDE_T}; "
                     "float32: its training forward's, B="
                     f"{WIDE_LARGEST[1][1]} x 2; max_abs_err over every width "
                     "192-512 and type of phase 21c and those calls (O absolute)") if fwd
                    else (f"the 2 x 256 UNet's training call, f32, B={TRAIN_ROWS} x 2 "
                          f"heads of 256, T={WIDE_T}; library_ms is SDPA's whole "
                          "backward (dq, dk and dv); max_abs_err over it and every "
                          "width 192-512 and type of phase 21c (gradients relative "
                          "to max |plain|)"),
            "design": ("TMA (4-D tensor maps of the strided operands, 128-byte "
                       "boxes, 128-byte swizzle) into a ring of 2 slots signalled "
                       "by mbarriers, the loads issued by one lane; two "
                       "warpgroups, over two 64-row q tiles (bf16, W <= 256) or "
                       "over O's columns (each computing S), O at the full width "
                       "in registers, S once a key tile a group; bf16 on wgmma "
                       "m64n64k16 (P as hi + lo bf16 from registers, V MN-major), "
                       "f32 as 3xTF32 on mma.sync m16n8k8 from the swizzled "
                       "tiles") if fwd
                      else ("TMA (4-D tensor maps, 128-byte boxes and swizzle; the "
                            "LSE and delta as flat maps) into a ring of 2 slots "
                            "signalled by mbarriers, the loads issued by one lane; "
                            "the block's own rows (K2a q, K2b keys) and their two "
                            "operands stay, the other side's stream; outputs at the "
                            "full width in registers of 8 warps split by columns, "
                            "no recompute per chunk; bf16: 64-row blocks, S and dP "
                            "on wgmma m64n32k16 once a warpgroup, outputs on "
                            "m64n64k16 with P/dS as hi + lo bf16 from registers, "
                            "K2b a dK and a dV block; f32: 32-row blocks, 3xTF32 on "
                            "mma.sync from the swizzled tiles, S and dP split over "
                            "four column parts whose partial sums are exchanged "
                            "through shared memory, K2b dK and dV in one block"),
            "ptxas": wide_regs[key],
            "head_widths": {f"d{d}_{dtype}": {k_: r_ for k_, r_
                                               in kernel_record(rec, key).items()
                                               if k_ not in ("dq", "dkv")}
                            for (d, dtype), rec in hopper.items()},
            "head_widths_work": f"one call at B={HW_ROWS}, T={HW_T}, heads x D = 512 "
                                "(3, 3, 2, 2, 1 heads at D = 160, 192, 256, 320, "
                                "512); D = 160 padded to 192",
            "wide_model": {k_: wide_model[k_] for k_ in (
                "flip_share", "output_rel", "loss_rel", "grad_rel", "forward_device_ms",
                "forward_k1_device_ms")},
        })
        if fwd:
            rows[-1]["float32"] = largest["float32"]
    by_path = {f"head_width_{d}_{dtype}": rec["entries"].get("flash_fwd_cluster", 0)
               for (d, dtype), rec in chunked.items()}
    main_rec = chunked[1024, "bfloat16"]
    rows.append({
        "name": "flash_fwd_cluster",
        "route": "cuda",
        "source": "syncfusion_tpu_torch/csrc/flash_fwd_cluster_sm90.cu",
        "replaces": "syncfusion_tpu/ops/attention.py:34",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(rec["max_abs_err"] for rec in chunked.values()),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "library_backend": main_rec["library_backend"],
        "work": f"one call at B={HW_ROWS} x 1 head of 1024, T={HW_T}, bf16; "
                "max_abs_err over D = 576 and 1024 in both types (O absolute); no "
                "configuration has heads wider than 512",
        "design": "thread-block clusters of up to 8 blocks along grid x, one "
                  "cluster a 64-row q tile, each block a slice of the head's "
                  "columns (two warpgroups, O's pieces in registers), TMA into a "
                  "2-slot mbarrier ring; each group's partial S (bf16 wgmma, f32 "
                  "3xTF32 mma.sync) summed in the block, then across the "
                  "cluster's shared memory (mapa + ld.shared::cluster, rank "
                  "order, one cluster barrier a key tile, double-buffered), S "
                  "once a key tile; P·V as flash_fwd_wide_sm90.cu",
        "ptxas": cluster_regs,
        "head_widths": {f"d{d}_{dtype}": {k_: r_ for k_, r_ in rec.items()
                                           if k_ not in ("dq", "dkv")}
                        for (d, dtype), rec in chunked.items()},
        "head_widths_work": f"one call at B={HW_ROWS} x 1 head, T={HW_T}",
    })
    for name, replaces, key in (
            ("flash_fwd_chunked", "syncfusion_tpu/ops/attention.py:34", "fwd"),
            ("flash_bwd_dq_chunked", "syncfusion_tpu/ops/attention.py:137", "dq"),
            ("flash_bwd_dkv_chunked", "syncfusion_tpu/ops/attention.py:181", "dkv")):
        fwd = key == "fwd"
        recs = above if fwd else chunked
        by_path = {f"head_width_{d}_{dtype}": rec["entries"].get(name, 0)
                   for (d, dtype), rec in recs.items()}
        main_rec = (above[attn.CLUSTER_FWD_MAX + 64, "bfloat16"] if fwd
                    else kernel_record(chunked[576, "float32"], key))
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "syncfusion_tpu_torch/csrc/flash_wide.cu",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(kernel_record(rec, key)["max_abs_err"]
                               for rec in recs.values()),
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "library_backend": main_rec["library_backend"],
            "work": (f"one call at B={HW_ROWS} x 1 head of {attn.CLUSTER_FWD_MAX + 64} "
                     f"(above CLUSTER_FWD_MAX), T={CHUNKED_T}, bf16; max_abs_err over "
                     "both types (O absolute)"
                     if fwd else
                     f"one call at B={HW_ROWS} x 1 head of 576, T={HW_T}, f32; "
                     "max_abs_err over D = 576 and 1024 in both types (gradients "
                     "relative to max |plain|); no configuration has heads wider "
                     "than 512"),
            "design": "head dim streamed in pieces of 64 columns through a cp.async "
                      "ring of 2 stages, a grid dimension over chunks of 128 output "
                      "columns (S and dP recomputed a chunk; K2b a dK and a dV "
                      "block a chunk), mma.sync m16n8k8 tf32, f32 as 3xTF32, bf16 "
                      "operands unsplit, 4 warps of 16 rows a block",
            "ptxas": chunked_regs[key],
            "head_widths": {f"d{d}_{dtype}": {k_: r_ for k_, r_
                                               in kernel_record(rec, key).items()
                                               if k_ not in ("dq", "dkv")}
                            for (d, dtype), rec in recs.items()},
            "head_widths_work": f"one call at B={HW_ROWS} x 1 head, T="
                                f"{CHUNKED_T if fwd else HW_T}",
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
    next(r_ for r_ in rows if r_["name"] == "fused_resblock_k3")[
        "ms_fused_resnet_alone"] = k3_alone_ms
    print(f"  CLAP card vs CPU errors: {clap_err}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-device"]:
        sys.exit(multi_device_child(*sys.argv[2:]))
    if sys.argv[1:2] == ["--trace"]:
        sys.exit(trace_child(*sys.argv[2:]))
    sys.exit(main())
