#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure exits non-zero:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: ``nvcc`` compiles every kernel of ``syncfusion_tpu_torch/csrc``;
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
     in bf16 (printed);
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
     noise.
Phase 3 also holds the backward kernels K2a and K2b against their plain
versions at the training shapes.  The line before the last is the kernels'
JSON record, the last line ``{"ok": true, "device": ...}``.  Needs nothing
but this checkout: it imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import io
import json
import math
import os
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
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type
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
    per-forward totals of the main path's bf16 shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(t, False) for t in ATTN_CALLS] + [(1000, False), (512, True)]
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
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
            if dtype == torch.bfloat16 and not causal and t in ATTN_CALLS:
                n = ATTN_CALLS[t]
                max_err = max(max_err, err_o)
                total["ms"] += n * ms
                total["plain_ms"] += n * plain
                total["library_ms"] += n * lib
                total["bytes"] += n * nbytes
                total["ops"] += n * ops
    total["max_abs_err"] = max_err
    return total


def kernel_vs_plain(model, attn, blocks, noise, onsets, embedding) -> float:
    """2 sampler steps (one out of the band, one in it) through the kernel
    and through the plain attention; max |diff| / max |plain|."""
    def two_steps():
        return model.sample(noise, onsets, embedding, num_steps=2,
                            embedding_scale=SCALE, guidance_interval=BAND)

    a = two_steps()
    attns = [m for m in model.modules() if isinstance(m, blocks.SelfAttention1d)]
    for m in attns:
        m.attend = attn.attention_reference
    b = two_steps()
    for m in attns:
        del m.attend
    return ((a - b).abs().max() / b.abs().max()).item()


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


def counts(attn) -> dict:
    return {name: getattr(attn.flash_attention, name) for name in attn.COUNTS}


def phase_train(attn, tmp: str):
    """Phase 6: the training command line at full width, f32.  Returns
    (final state, launch counts, seconds per micro-step, peak GiB)."""
    from syncfusion_tpu_torch import train_diffusion
    from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer

    shard = os.path.join(tmp, "shard.tar")
    write_shard(shard)
    args = ["--train_path", shard, "--val_path", shard,
            "--logs_dir", os.path.join(tmp, "logs"), "--embedder", "none",
            "--precision", "32", "--batch_size", str(BATCH), "--length", str(LENGTH),
            "--accumulate_grad_batches", str(ACCUMULATE),
            "--max_steps", str(TRAIN_STEPS), "--log_every_n_steps", "1",
            "--val_check_interval", str(TRAIN_STEPS), "--val_batches", "1",
            "--num_items", str(SAMPLE_ITEMS), "--sampling_steps", str(SAMPLE_STEPS),
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    attn.reset_counts()
    state = train_diffusion.main(args)
    torch.cuda.synchronize()
    launched = counts(attn)
    peak = torch.cuda.max_memory_allocated() / 2**30
    (run,) = os.listdir(os.path.join(tmp, "logs", "runs"))
    run = os.path.join(tmp, "logs", "runs", run)
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
    want = {"kernel_launches": 9 * forwards, "dq_launches": 9 * backwards,
            "dkv_launches": 9 * backwards, "plain_calls": 0, "plain_bwd_calls": 0}
    print(f"  launches {launched} (expected {want}), peak memory {peak:.3f} GiB")
    check(launched == want, f"launch counts {launched} != {want}")
    sec = statistics.median(r["sec_per_step"] for r in train[1:])
    return state, launched, sec, peak


def train_vs_plain(model, attn, blocks, tmp: str):
    """Phase 7: one f32 loss and gradient through the kernels and through
    the plain attention, same batch, sigma and noise.  Returns (relative
    loss difference, max over tensors of max |dg| / max(max |g_plain|,
    GRAD_FLOOR · the largest gradient)).  A second plain run shows the
    run-to-run rounding of the same computation (printed)."""
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

    def loss_and_grads():
        for p in model.parameters():
            p.grad = None
        loss = model.loss(wav, onsets, emb, sigma=sigma, noise=noise)
        loss.backward()
        return loss.item(), {k: p.grad for k, p in model.named_parameters()}

    attn.reset_counts()
    loss_k, grads_k = loss_and_grads()
    launched = counts(attn)
    check(launched["kernel_launches"] == launched["dq_launches"]
          == launched["dkv_launches"] == 9, f"cross-check launches {launched}")
    attns = [m for m in model.modules() if isinstance(m, blocks.SelfAttention1d)]
    for m in attns:
        m.attend = attn.attention_reference
    loss_p, grads_p = loss_and_grads()
    _, grads_p2 = loss_and_grads()
    for m in attns:
        del m.attend
    top = max(g.abs().max().item() for g in grads_p.values() if g is not None)
    floor = GRAD_FLOOR * top

    def worst_of(grads):
        rows = []
        for name, gp in grads_p.items():
            g = grads[name]
            check((g is None) == (gp is None), f"{name}: gradient on one side only")
            if gp is not None:
                scale = gp.abs().max().item()
                diff = (g - gp).abs().max().item()
                rows.append((diff / max(scale, floor), scale, name,
                             diff / scale if scale > 0 else 0.0))
        return sorted(rows, reverse=True)

    rels, rerun = worst_of(grads_k), worst_of(grads_p2)
    floored = sum(row[1] < floor for row in rels)
    print(f"  largest gradient {top:.3e}; {floored} of {len(rels)} tensors have "
          f"max |g| below {GRAD_FLOOR:.0e} of it; worst: " + ", ".join(
              f"{n_} {r:.2e} (max |g| {g:.2e})" for r, g, n_, _ in rels[:3]))
    for label, rows in (("kernels vs plain", rels), ("plain vs plain, run to run",
                                                     rerun)):
        raw = max(rows, key=lambda row: row[3])
        print(f"  {label}: worst floored {rows[0][0]:.2e} ({rows[0][2]}), worst "
              f"unfloored {raw[3]:.2e} ({raw[2]}, max |g| {raw[1]:.2e})")
    worst = rels[0][0]
    return abs(loss_k - loss_p) / abs(loss_p), worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from syncfusion_tpu_torch.models import blocks
    from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion
    from syncfusion_tpu_torch.ops import _build
    from syncfusion_tpu_torch.ops import attention as attn
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
    phase("2 build", t0)

    t0 = time.perf_counter()
    total = phase_kernels(attn)
    bwd_total = phase_bwd_kernels(attn)
    phase("3 kernels against plain versions", t0)

    t0 = time.perf_counter()
    model = SyncFusionDiffusion.from_config(None, dtype=torch.bfloat16,
                                            device="cuda", seed=0)
    print(f"  params: {model.param_count():,}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.randn((BATCH, LENGTH, 1), generator=gen, device="cuda")
    onsets = torch.zeros((BATCH, LENGTH, 1), device="cuda")
    onsets[torch.arange(BATCH), torch.arange(BATCH) * 9600 + 4800, 0] = 1.0
    embedding = torch.randn((BATCH, 1, 512), generator=gen, device="cuda")
    torch.cuda.synchronize()
    phase("4a build the full-width model", t0)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_counts()
    wav = model.sample(noise, onsets, embedding, num_steps=NUM_STEPS,
                       embedding_scale=SCALE, guidance_interval=BAND)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = attn.flash_attention.kernel_launches
    plain_calls = attn.flash_attention.plain_calls
    check(counts(attn)["dq_launches"] == counts(attn)["dkv_launches"] == 0,
          "sampling launched a backward kernel")
    check(tuple(wav.shape) == (BATCH, LENGTH, 1), f"output shape {tuple(wav.shape)}")
    check(bool(torch.isfinite(wav).all()), "non-finite output")
    expected = 9 * NUM_STEPS
    check(launches == expected, f"kernel_launches {launches} != {expected}")
    check(plain_calls == 0, f"plain_calls {plain_calls} != 0")
    clips = BATCH * LENGTH / SR / 8.0
    print(f"  generated {tuple(wav.shape)}: {seconds:.3f} s, "
          f"{clips / seconds * 60:.3f} 8-s clips/min, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"flash launches {launches}, plain calls {plain_calls}, "
          f"rms {wav.float().pow(2).mean().sqrt().item():.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        write_wav(os.path.join(tmp, "clip0.wav"), wav[0, :, 0].cpu().numpy(), SR)
    phase("4b generate 4 full-width clips", t0)

    t0 = time.perf_counter()
    rel16 = kernel_vs_plain(model, attn, blocks, noise, onsets, embedding)
    print(f"  bf16, 2 steps, kernel vs plain attention: max |diff| / max |plain| "
          f"= {rel16:.3e} (not gated: both round O to bf16, and the "
          f"random-weight net amplifies one-ulp flips)")
    model32 = SyncFusionDiffusion.from_config(None, dtype=torch.float32,
                                              device="cuda", seed=0)
    model32.load_state_dict(model.state_dict(), strict=True)
    rel32 = kernel_vs_plain(model32, attn, blocks, noise, onsets, embedding)
    del model32
    print(f"  f32 (same params), 2 steps, kernel vs plain attention: "
          f"max |diff| / max |plain| = {rel32:.3e} (tol {CROSS_TOL:.0e})")
    check(math.isfinite(rel32) and rel32 <= CROSS_TOL, "cross-check disagrees")
    del model
    torch.cuda.empty_cache()
    phase("5 cross-check", t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        state, train_launched, sec, peak = phase_train(attn, tmp)
        print(f"  training, f32, B={BATCH}, L={LENGTH}: {sec:.4f} s per micro-step "
              f"(median of steps 2-{TRAIN_STEPS}), peak memory {peak:.3f} GiB")
        phase("6 training at full width", t0)

        t0 = time.perf_counter()
        rel_loss, rel_grad = train_vs_plain(state.model, attn, blocks, tmp)
        print(f"  f32 loss and gradient, kernels vs plain attention: loss "
              f"{rel_loss:.3e} relative (tol {TRAIN_LOSS_TOL:.0e}), gradients max "
              f"|diff| / max |plain| {rel_grad:.3e} (tol {TRAIN_GRAD_TOL:.0e})")
        check(rel_loss <= TRAIN_LOSS_TOL, "training loss cross-check disagrees")
        check(rel_grad <= TRAIN_GRAD_TOL, "training gradient cross-check disagrees")
        del state
        phase("7 training cross-check", t0)

    bms, by = bound_ms(total["bytes"], total["ops"], torch.bfloat16)
    fwd_launches = launches + train_launched["kernel_launches"]
    rows = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "syncfusion_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "syncfusion_tpu/ops/attention.py:34",
        "launches": fwd_launches,
        "launches_by_path": {"generate": launches,
                             "train": train_launched["kernel_launches"]},
        "max_abs_err": total["max_abs_err"],
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": total["library_ms"],
        "work": "the 9 attention calls of one in-band UNet forward, bf16, "
                "BH=64, T=2048x2, 1024x2, 512x2, 256x3",
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
            "launches": train_launched[f"{key}_launches"],
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
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
