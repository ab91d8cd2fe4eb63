"""Where one UNet forward's, or one onset training step's, time goes on
the card.

    python -m syncfusion_tpu_torch.breakdown [--batch 8] [--length 262144]
        [--model_config model.json] [--deep_split S]
    python -m syncfusion_tpu_torch.breakdown --onset bf16|32 [--batch 16]
    python -m syncfusion_tpu_torch.breakdown --baseline vqgan|gpt [--batch 40|4]

Builds the full-width model of exp/model/diffusion.yaml, or of
``--model_config`` (JSON of the diffusion config's model node, as in
``generate.py``: e.g. with ``model.fused_resnet``, ``model.fused_stats``
and ``fold_cap`` for the fused resnet chain), with seeded random weights
in bf16, computes the context once, and profiles ``--iters``
forwards of the UNet at ``--batch`` rows (8 = the in-band CFG batch of 4
clips) with ``torch.profiler``; with ``--deep_split S``, the DeepCache
forward on a deep feature taken once from a whole forward.  With
``--onset``, the full-width onset net (seeded, cfg/model/model-onset.yaml's
recipe in that precision) takes ``--iters`` training steps of ``--batch``
chunks (default 16) of 30 frames at 112x112 on the uint8 wire.  With
``--baseline``, a CondFoleyGen training step at the full width of
cfg/condfoleygen/*.yaml, seeded, f32 without TF32: ``vqgan`` the codebook's
(LPAPS, an ``n_layers=3`` discriminator on, batch default 40 spectrograms
of 80 x 160), ``gpt`` the transformer's (batch default 4, 60 frames of
112 x 112, the frozen VQ and video net included).  Prints the
device time per forward by kernel class and the top kernels, the host wall
time per forward and the device's idle share, and a last JSON line with the
same numbers.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion

# kernel class by substring of the kernel's full name, first match wins
CLASSES = (("flash_fwd", ("flash_fwd",)),
           ("fused_resblock", ("fused_resblock",)),
           ("group_norm", ("RowwiseMoments", "GroupNorm", "group_norm",
                           "ComputeFusedParams")),
           ("batch_norm", ("bn_fw", "bn_bw")),
           # cuDNN's FFT algorithms: its transforms, complex products and sums
           ("conv_fft", ("fft", "pointwise_mult_and_sum_complex", "gemm_cf32")),
           ("conv", ("convolve", "cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm",
                     "winograd", "nchwToNhwc", "nhwcToNchw")),
           ("reduce", ("reduce_kernel",)),
           ("gemm", ("gemm", "Gemm", "cutlass")),
           ("copy/cast/cat/fill", ("copy_kernel", "CatArray", "FillFunctor")),
           ("optimizer", ("multi_tensor_apply",)),
           ("layer_norm", ("layer_norm", "LayerNorm")),
           ("softmax", ("softmax", "Softmax")),
           ("max_pool", ("max_pool",)),
           ("elementwise", ("elementwise", "Functor", "silu")))


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def onset_step(args):
    """(one onset training step, its label)."""
    import numpy as np

    from syncfusion_tpu_torch.core.config import OnsetConfig
    from syncfusion_tpu_torch.train_onset import build_trainer

    cfg = OnsetConfig.from_dict({"model": {"precision": args.onset},
                                 "trainer": {"seed": 0}})
    trainer = build_trainer(cfg, "cuda")
    state = trainer.create_state()
    b = args.batch or 16
    rng = np.random.default_rng(0)
    batch = {"frames": torch.from_numpy(rng.integers(0, 256, (b, 30, 112, 112, 3),
                                                     dtype=np.uint8)).cuda(),
             "label": torch.from_numpy((rng.random((b, 30)) < 0.07).astype(np.float32)).cuda()}
    return (lambda: trainer.train_step(state, batch),
            f"onset training step, {args.onset}, batch {b} x 30 x 112 x 112")


def baseline_step(args):
    """(one CondFoleyGen training step, its label)."""
    import dataclasses

    import numpy as np

    from syncfusion_tpu_torch.core.config import BaselineConfig
    from syncfusion_tpu_torch.device import set_exact_f32
    from syncfusion_tpu_torch.generate_audio import build_model
    from syncfusion_tpu_torch.models.vqgan.model import VQModel, wav_to_spec
    from syncfusion_tpu_torch.train.transformer_trainer import TransformerTrainer
    from syncfusion_tpu_torch.train.vqgan_trainer import VQGANTrainer

    set_exact_f32()
    cfg = BaselineConfig()
    rng = np.random.default_rng(0)

    def specs(b):
        wav = (0.1 * rng.standard_normal((b, 44100))).astype(np.float32)
        return wav_to_spec(torch.from_numpy(wav).cuda())[:, None]

    if args.baseline == "vqgan":
        b = args.batch or 40
        trainer = VQGANTrainer(VQModel(**dataclasses.asdict(cfg.model)).cuda(),
                               dataclasses.replace(cfg.lossconfig, disc_start=0),
                               learning_rate=cfg.vq_learning_rate)
        trainer.disc.cuda()
        state = trainer.init(0)
        spec = specs(b)
        return (lambda: trainer.train_step(state, spec),
                f"VQGAN training step, batch {b} x 80 x 160, f32")
    b = args.batch or 4
    trainer = TransformerTrainer(build_model(cfg, "cuda", seed=0))
    state = trainer.create_state()
    frames = rng.standard_normal((b, 60, 112, 112, 3)).astype(np.float32)
    batch = {"spec": specs(b), "cond_spec": specs(b), "frames": torch.from_numpy(frames).cuda()}
    return (lambda: trainer.train_step(state, batch),
            f"GPT training step, batch {b}, 60 frames of 112 x 112, f32")


def unet_forward(args):
    """(one UNet forward, its label)."""
    model_cfg = None
    if args.model_config:
        with open(args.model_config) as f:
            model_cfg = json.load(f)
    model = SyncFusionDiffusion.from_config(model_cfg, dtype=torch.bfloat16,
                                            device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, length = args.batch or 8, args.length
    x = torch.randn((b, length, 1), generator=gen, device="cuda")
    onsets = torch.zeros((b, length, 1), device="cuda")
    onsets[:, ::9600, 0] = 1.0
    emb = torch.randn((b, 1, 512), generator=gen, device="cuda")
    sigma = torch.full((b,), 0.5, device="cuda")
    kw = {"context": model.encode_context(onsets), "embedding": emb}
    if args.deep_split:
        with torch.no_grad():
            _, deep = model.unet(x, sigma, deep_split=args.deep_split,
                                 return_deep=True, **kw)
        kw.update(deep_split=args.deep_split, deep_cache=deep)

    @torch.no_grad()
    def forward():
        return model.unet(x, sigma, **kw)

    cached = f", cached at split {args.deep_split}" if args.deep_split else ""
    return forward, (f"UNet forward ({args.model_config or 'default model'}{cached}), "
                     f"batch {b}, L {length}, bf16")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="rows of the UNet forward (8) or onset chunks (16)")
    ap.add_argument("--length", type=int, default=2**18)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--model_config", default=None,
                    help="JSON of the diffusion config's model node "
                         "(default: exp/model/diffusion.yaml's values)")
    ap.add_argument("--deep_split", type=int, default=0,
                    help="profile the cached forward at this split (0: whole)")
    ap.add_argument("--onset", choices=("bf16", "32"), default=None,
                    help="profile an onset training step in this precision")
    ap.add_argument("--baseline", choices=("vqgan", "gpt"), default=None,
                    help="profile a CondFoleyGen training step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: needs the card")
    forward, label = (onset_step(args) if args.onset else baseline_step(args)
                      if args.baseline else unet_forward(args))

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            forward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.iters * 1e3

    by_class: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3 / args.iters
        if ms <= 0:
            continue
        kernels.append((ms, evt.count // args.iters, evt.key))
        cls = classify(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    device = sum(by_class.values())
    print(f"{label}: host wall {wall:.3f} ms, device busy {device:.3f} ms, idle "
          f"share {1 - device / wall:.3f}")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:12s} {ms:9.3f} ms  {ms / device:6.1%}")
    print("top kernels (ms per iteration, launches per iteration, name):")
    for ms, count, name in sorted(kernels, reverse=True)[:20]:
        print(f"  {ms:9.3f} {count:5d}  {name[:110]}")
    print(json.dumps({"what": label, "model_config": args.model_config,
                      "deep_split": args.deep_split, "onset": args.onset,
                      "baseline": args.baseline,
                      "wall_ms": wall, "device_ms": device, "by_class_ms": by_class}))


if __name__ == "__main__":
    main()
