#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure exits non-zero:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: ``nvcc`` compiles every kernel of ``syncfusion_tpu_torch/csrc``;
     the registers, spills and static shared memory ptxas reports for K1,
     K2a and K2b, and the dynamic shared memory each K2 launch asks for
     (read from the built library), go into the kernels line;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes of the generation path (plus a ragged and a causal case), in
     bf16 and f32, each error against its stated tolerance, with the times of
     the kernel, the plain version and one PyTorch library call;
  4. the slice at full width: ``SyncFusionDiffusion`` built from
     exp/model/diffusion.yaml's values with seeded random weights, in bf16,
     generates B = 4 clips of 2^18 samples (150-step DDIM, CFG 2.0 inside
     the sigma band (0.2, 0.8)); the kernel's launch count is checked;
  5. cross-check: 2 sampler steps through the kernel against 2 steps with
     the plain attention, on the same weights and noise, in f32 (gated) and
     in bf16 (the share of the attention calls' O elements that the kernel
     rounds otherwise than the plain version, gated; the output's error,
     printed);
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
  8. fused generation at full width: the same model and inputs as phase 4
     with the UNet's fused configuration on (``fused_resnet``,
     ``fused_stats`` at ``fold_cap`` 256, from the config as the JAX
     package reads it); K3, K4 and K1 launch 12, 12 and 9 times per
     forward, no plain version runs;
  9. fused cross-check, f32, same weights: 2 sampler steps of the fused
     model against the plain one (gated as phase 5), then one full-width
     loss and gradient (gated as phase 7);
 10. fused training: phase 6's command line with a model config that turns
     the fused configuration on; K3 and K4 launch 12 times per forward.
Phase 3 also holds the backward kernels K2a and K2b against their plain
versions at the training shapes (with the time of SDPA's backward), times
K1's f32 instantiation per forward beside SDPA's f32 forward, and holds K3
and K4 (the fused resnet chain) at every shape of that chain, in bf16 at
B = 8 and f32 at B = 4, with a ragged and a wide case.  The line before the last is the kernels' JSON
record, the last line ``{"ok": true, "device": ...}``.  Needs nothing but
this checkout: it imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
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
ROWS = 2 * BATCH  # the CFG batch inside the band
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
    per-forward totals of the main path's shapes, by dtype (bf16: the
    generation path; f32: the same shapes in the training recipe's type)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(t, False) for t in ATTN_CALLS] + [(1000, False), (512, True)]
    total = {dtype: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
                     "ops": 0, "max_abs_err": 0.0}
             for dtype in (torch.bfloat16, torch.float32)}
    for dtype in total:
        for t, causal in cases:
            # q, k, v as the UNet makes them: views of one qkv projection
            qkv = torch.randn((ROWS, t, 3, HEADS, HEAD_DIM), generator=gen,
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
            nbytes, ops = attention_work(ROWS, HEADS, t, HEAD_DIM, dtype, causal)
            bms, by = bound_ms(nbytes, ops, dtype)
            print(f"  flash_fwd {str(dtype)[6:]:8s} T={t:4d} causal={int(causal)} "
                  f"BH={ROWS * HEADS}: err O {err_o:.3e} (tol {tol['o']:.0e}) "
                  f"LSE {err_l:.3e} (tol {tol['lse']:.0e}) | kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms "
                  f"({by}) {'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"flash_fwd {dtype} T={t} causal={causal} disagrees "
                      f"with its plain version")
            if not causal and t in ATTN_CALLS:
                n = ATTN_CALLS[t]
                tot = total[dtype]
                tot["max_abs_err"] = max(tot["max_abs_err"], err_o)
                tot["ms"] += n * ms
                tot["plain_ms"] += n * plain
                tot["library_ms"] += n * lib
                tot["bytes"] += n * nbytes
                tot["ops"] += n * ops
    for dtype, tot in total.items():
        tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"], dtype)
        print(f"  flash_fwd {str(dtype)[6:]} per forward (9 calls, BH={ROWS * HEADS}): "
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


# K1's two instantiations in flash_fwd.cu (bf16 on the tensor cores, f32 on
# the CUDA cores) and K2a's and K2b's in flash_bwd.cu, by input type
K1_KERNELS = {"bfloat16": "flash_fwd_tc_kernel", "float32": "flash_fwd_kernelIfE"}
K2_KERNELS = {key: {"float32": f"{name}IfE", "bfloat16": f"{name}I13__nv_bfloat16E"}
              for key, name in (("dq", "flash_bwd_dq_kernel"),
                                ("dkv", "flash_bwd_dkv_kernel"))}


def fused_work(b, c, cout, length, dtype, residual):
    """(bytes, operations) of K3 or K4 as a function: x (and the residual)
    read once, y written once, scale, shift, weights and bias read once;
    2 operations per multiply-add of the 3-tap conv."""
    esize = torch.tensor([], dtype=dtype).element_size()
    rows = b * length * (c + cout * (2 if residual else 1))
    return rows * esize + 4 * (2 * b * c + 3 * c * cout + cout), 6 * b * length * c * cout


def phase_fused_kernels(fr):
    """Phase 3, the fused resnet chain: K3 and K4 against their plain
    versions at every shape of the chain, bf16 at B = 8 (the generation
    batch) and f32 at B = 4 (training), with a ragged (L = 1000) and a wide
    (C = 1024) case; x and the residual as the blocks pass them, (B, L, C)
    views of (B, C, L) tensors.  Returns the per-forward totals of the
    main path's bf16 shapes and K3's per-forward time with fused_resnet
    alone."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = ([("k3", c, co, n, False, per) for c, co, n, per, _ in K3_SHAPES]
             + [("k3", 64, 64, 1000, False, 0), ("k3", 1024, 1024, 256, False, 0)]
             + [("k4", c, co, n, r, per) for c, co, n, r, per in K4_SHAPES]
             + [("k4", 32, 32, 1000, True, 0), ("k4", 1024, 1024, 256, True, 0)])
    alone = {(c, co, n): a for c, co, n, _, a in K3_SHAPES}
    total = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
                 "ops": 0, "max_abs_err": 0.0} for k in ("k3", "k4")}
    k3_alone_ms = 0.0
    for dtype, rows in ((torch.bfloat16, ROWS), (torch.float32, TRAIN_ROWS)):
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
            nbytes, ops = fused_work(rows, c, cout, length, dtype, residual)
            bms, by = bound_ms(nbytes, ops, dtype)
            print(f"  {kind} {str(dtype)[6:]:8s} B={rows} C={c:4d} Cout={cout:4d} "
                  f"L={length:6d} res={int(residual)}: err y {err:.3e} (rel "
                  f"{rel:.2e}, tol {FUSED_TOL[dtype]:.0e}) sums rel {rel_s:.2e} "
                  f"(tol {STATS_TOL:.0e}) | kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, conv alone {lib:.4f} ms, bound {bms:.4f} ms "
                  f"({by}) {'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"{kind} {dtype} C={c} Cout={cout} L={length} disagrees "
                      f"with its plain version")
            if dtype == torch.bfloat16 and per:
                tot = total[kind]
                tot["ms"] += per * ms
                tot["plain_ms"] += per * plain_ms
                tot["library_ms"] += per * lib
                tot["bytes"] += per * nbytes
                tot["ops"] += per * ops
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if dtype == torch.bfloat16 and kind == "k3":
                k3_alone_ms += alone.get((c, cout, length), 0) * ms
            del x, r, h, got, want
    print(f"  per in-band forward (bf16, B={ROWS}): K3 {total['k3']['ms']:.4f} ms "
          f"x {K3_PER_FORWARD} calls, K4 {total['k4']['ms']:.4f} ms x "
          f"{K4_PER_FORWARD}; K3 with fused_resnet alone (20 calls) "
          f"{k3_alone_ms:.4f} ms")
    return total, k3_alone_ms


def fused_model_cfg() -> dict:
    """exp/model/diffusion.yaml's model node with the fused configuration
    on: ``model.fused_resnet``, ``model.fused_stats``, ``fold_cap``."""
    from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig

    return {"model": {**dataclasses.asdict(UNetConfig()), **FUSED_SWITCHES},
            "onsets_encoder": dataclasses.asdict(EncoderConfig()),
            "fold_cap": FOLD_CAP}


def kernel_vs_plain(model, attn, blocks, noise, onsets, embedding,
                    attend=None) -> torch.Tensor:
    """2 sampler steps (one out of the band, one in it) through the kernel
    (or ``attend``, which calls it) and through the plain attention;
    |diff| / max |plain| of every output sample."""
    attns = [m for m in model.modules() if isinstance(m, blocks.SelfAttention1d)]

    def two_steps(fn):
        for m in attns:
            if fn is not None:
                m.attend = fn
        out = model.sample(noise, onsets, embedding, num_steps=2,
                           embedding_scale=SCALE, guidance_interval=BAND)
        for m in attns:
            m.__dict__.pop("attend", None)
        return out

    a = two_steps(attend)
    b = two_steps(attn.attention_reference)
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


def sampler_inputs() -> tuple:
    """Noise, onsets (one a clip) and text embedding of the 4 clips."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.randn((BATCH, LENGTH, 1), generator=gen, device="cuda")
    onsets = torch.zeros((BATCH, LENGTH, 1), device="cuda")
    onsets[torch.arange(BATCH), torch.arange(BATCH) * 9600 + 4800, 0] = 1.0
    embedding = torch.randn((BATCH, 1, 512), generator=gen, device="cuda")
    return noise, onsets, embedding


def write_shard(path: str, tracks: int = 4, seconds: float = 12.0,
                every: float = 0.25, seed: int = 0) -> None:
    """A webdataset shard of noise tracks at 48 kHz with an onset every
    ``every`` seconds, so that every 2^18-sample chunk has onsets."""
    from syncfusion_tpu_torch.ops.wav import write_wav

    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp, tarfile.open(path, "w") as tar:
        for i in range(tracks):
            wav = (0.1 * rng.standard_normal(int(seconds * SR))).astype(np.float32)
            write_wav(os.path.join(tmp, "a.wav"), wav, SR)
            with open(os.path.join(tmp, "a.wav"), "rb") as f:
                audio = f.read()
            times = "".join(f"{x:.4f},hit\n" for x in np.arange(0.01, seconds, every))
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


def phase_train(attn, fr, tmp: str, name: str, model_cfg=None):
    """Phases 6 and 10: the training command line at full width, f32, with
    the default model or ``model_cfg`` (passed as ``--model_config``).
    Returns (final state, launch counts, seconds per micro-step, peak GiB)."""
    from syncfusion_tpu_torch import train_diffusion
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer

    shard = os.path.join(tmp, "shard.tar")
    if not os.path.exists(shard):
        write_shard(shard)
    logs = os.path.join(tmp, name)
    args = ["--train_path", shard, "--val_path", shard,
            "--logs_dir", logs, "--embedder", "none",
            "--precision", "32", "--batch_size", str(BATCH), "--length", str(LENGTH),
            "--accumulate_grad_batches", str(ACCUMULATE),
            "--max_steps", str(TRAIN_STEPS), "--log_every_n_steps", "1",
            "--val_check_interval", str(TRAIN_STEPS), "--val_batches", "1",
            "--num_items", str(SAMPLE_ITEMS), "--sampling_steps", str(SAMPLE_STEPS),
            "--device", "cuda"]
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
    check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
          f"took {state.step} micro-steps, logged {len(losses)}")
    check(all(math.isfinite(x) for x in losses + valid), "non-finite loss")
    media = sorted(os.listdir(os.path.join(run, "media")))
    check(len(media) == SAMPLE_ITEMS, f"sample logger wrote {media}")
    saved = Checkpointer(CheckpointConfig(os.path.join(run, "ckpts"))).restore()
    state.model.load_state_dict(saved["model"], strict=True)
    check(saved["step"] == TRAIN_STEPS and saved["optimizer"]["adamw"]["state"],
          "checkpoint lacks the step or the optimizer state")
    # forwards: one per micro-step, one validation batch, one per sampler
    # step (CFG runs both branches as one forward); backwards: one per
    # micro-step
    forwards, backwards = TRAIN_STEPS + 1 + SAMPLE_STEPS, TRAIN_STEPS
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
    """Phase 9, f32, the same weights: 2 sampler steps and one loss and
    gradient of the fused model against the plain one.  Returns (sampling
    max |diff| / max |plain|, relative loss difference, worst floored
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
    return rel_sample, abs(loss_f - loss_p) / abs(loss_p), rels[0][0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from syncfusion_tpu_torch.models import blocks
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.ops import _build
    from syncfusion_tpu_torch.ops import attention as attn
    from syncfusion_tpu_torch.ops import fused_resblock as fr
    from syncfusion_tpu_torch.ops.wav import write_wav

    # f32 references run in full f32 (matmul and cuDNN convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    card = smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
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
    print(f"  K1 registers and spills: {k1_regs}")
    bwd_log = libs["flash_bwd"].with_suffix(".so.log").read_text()
    k2_regs = {key: pick_ptxas(bwd_log, picks) for key, picks in K2_KERNELS.items()}
    # ptxas reports static shared memory only: the library gives the
    # dynamic shared memory each K2 launch asks for
    smem = _build.library("flash_bwd").flash_bwd_smem
    for key, by_type in k2_regs.items():
        for dtype, report in by_type.items():
            report["dynamic_smem_bytes"] = smem(int(key == "dkv"),
                                                int(dtype == "bfloat16"))
            check(report["dynamic_smem_bytes"] > 0, f"no shared memory for K2 {key}")
    print(f"  K2a and K2b registers and spills: {k2_regs}")
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

    def generate(m, label):
        """One run of 4 clips; returns (clips, seconds, launch counts)."""
        start = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(attn, fr)
        out = m.sample(noise, onsets, embedding, num_steps=NUM_STEPS,
                       embedding_scale=SCALE, guidance_interval=BAND)
        torch.cuda.synchronize()
        took = time.perf_counter() - start
        launched = counts(attn, fr)
        check(tuple(out.shape) == (BATCH, LENGTH, 1), f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite output")
        clips = BATCH * LENGTH / SR / 8.0
        print(f"  {label}: generated {tuple(out.shape)}: {took:.3f} s, "
              f"{clips / took * 60:.3f} 8-s clips/min, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches "
              f"{launched}, rms {out.float().pow(2).mean().sqrt().item():.4f}")
        return out, took, launched

    t0 = time.perf_counter()
    wav, seconds, gen_launched = generate(model, "plain UNet")
    launches = gen_launched["kernel_launches"]
    want = {name: 0 for name in gen_launched}
    want["kernel_launches"] = 9 * NUM_STEPS
    check(gen_launched == want, f"launch counts {gen_launched} != {want}")
    with tempfile.TemporaryDirectory() as tmp:
        write_wav(os.path.join(tmp, "clip0.wav"), wav[0, :, 0].cpu().numpy(), SR)
    phase("4b generate 4 full-width clips", t0)

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
    del model32
    print(f"  f32 (same params), 2 steps, kernel vs plain attention: "
          f"max |diff| / max |plain| = {rel32:.3e} (tol {CROSS_TOL:.0e})")
    check(math.isfinite(rel32) and rel32 <= CROSS_TOL, "cross-check disagrees")
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
        wav_f, seconds_f, fused_launched = generate(fused, "fused UNet")
        want = {name: 0 for name in fused_launched}
        want.update(kernel_launches=9 * NUM_STEPS,
                    k3_kernel_launches=K3_PER_FORWARD * NUM_STEPS,
                    k4_kernel_launches=K4_PER_FORWARD * NUM_STEPS)
        check(fused_launched == want, f"launch counts {fused_launched} != {want}")
        rel_gen = ((wav_f - wav).abs().max() / wav.abs().max()).item()
        print(f"  fused vs plain UNet, 150 steps, bf16: {seconds_f:.3f} s against "
              f"{seconds:.3f} s ({seconds / seconds_f:.3f}x); max |diff| / max "
              f"|plain| {rel_gen:.3e} (not gated: bf16 roundings at other places)")
        del fused, wav_f
        torch.cuda.empty_cache()
        phase("8 fused generation at full width", t0)

        t0 = time.perf_counter()
        rel_fs, rel_fl, rel_fg = fused_vs_plain(attn, fr, noise, onsets, embedding, tmp)
        print(f"  f32, same params: 2 sampler steps fused vs plain max |diff| / max "
              f"|plain| {rel_fs:.3e} (tol {CROSS_TOL:.0e}); loss {rel_fl:.3e} "
              f"relative (tol {TRAIN_LOSS_TOL:.0e}); gradients {rel_fg:.3e} "
              f"(tol {TRAIN_GRAD_TOL:.0e})")
        check(math.isfinite(rel_fs) and rel_fs <= CROSS_TOL,
              "fused sampling cross-check disagrees")
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
        phase("10 fused training at full width", t0)

    fwd16, fwd32 = total[torch.bfloat16], total[torch.float32]
    paths = {"generate": gen_launched, "train": train_launched,
             "generate_fused": fused_launched, "train_fused": fused_train}

    def launched_by_path(key):
        return {p_: c_[key] for p_, c_ in paths.items()}

    rows = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "syncfusion_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "syncfusion_tpu/ops/attention.py:34",
        "launches": sum(launched_by_path("kernel_launches").values()),
        "launches_by_path": launched_by_path("kernel_launches"),
        "max_abs_err": fwd16["max_abs_err"],
        "ms": fwd16["ms"],
        "plain_ms": fwd16["plain_ms"],
        "bound_ms": fwd16["bound_ms"],
        "bound_by": fwd16["bound_by"],
        "library_ms": fwd16["library_ms"],
        "work": "the 9 attention calls of one in-band UNet forward, bf16, "
                "BH=64, T=2048x2, 1024x2, 512x2, 256x3",
        "float32": {key: fwd32[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "float32_work": "the same 9 calls in f32 (the training forward's type)",
        "design": {"bfloat16": "tensor cores: mma.sync m16n8k16 (P as hi + lo "
                               "bf16), cp.async K/V ring of 2 stages, 4 warps "
                               "of 32 query rows a block",
                   "float32": "CUDA cores: f32 FMAs, 64-key tiles staged in "
                              "shared memory as f32"},
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
        tot = fused_total[key]
        bms, by = bound_ms(tot["bytes"], tot["ops"], torch.bfloat16)
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
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": tot["library_ms"],
            "library_note": "F.conv1d alone on the already-activated input: no "
                            "single PyTorch call computes the fused function",
            "work": work,
        })
    rows[3]["ms_fused_resnet_alone"] = k3_alone_ms
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
