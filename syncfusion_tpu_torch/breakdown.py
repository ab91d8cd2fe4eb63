"""Where one UNet forward's time goes on the card.

    python -m syncfusion_tpu_torch.breakdown [--batch 8] [--length 262144]
        [--model_config model.json] [--deep_split S]

Builds the full-width model of exp/model/diffusion.yaml, or of
``--model_config`` (JSON of the diffusion config's model node, as in
``generate.py``: e.g. with ``model.fused_resnet``, ``model.fused_stats``
and ``fold_cap`` for the fused resnet chain), with seeded random weights
in bf16, computes the context once, and profiles ``--iters``
forwards of the UNet at ``--batch`` rows (8 = the in-band CFG batch of 4
clips) with ``torch.profiler``; with ``--deep_split S``, the DeepCache
forward on a deep feature taken once from a whole forward.  Prints the
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
           ("conv", ("convolve", "cudnn", "xmma", "nchwToNhwc", "nhwcToNchw")),
           ("gemm", ("gemm", "Gemm", "cutlass")),
           ("copy/cast/cat/fill", ("copy_kernel", "CatArray", "FillFunctor")),
           ("elementwise", ("elementwise", "Functor", "silu")))


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--length", type=int, default=2**18)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--model_config", default=None,
                    help="JSON of the diffusion config's model node "
                         "(default: exp/model/diffusion.yaml's values)")
    ap.add_argument("--deep_split", type=int, default=0,
                    help="profile the cached forward at this split (0: whole)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: needs the card")

    model_cfg = None
    if args.model_config:
        with open(args.model_config) as f:
            model_cfg = json.load(f)
    model = SyncFusionDiffusion.from_config(model_cfg, dtype=torch.bfloat16,
                                            device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, length = args.batch, args.length
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
    cached = f", cached at split {args.deep_split}" if args.deep_split else ""
    print(f"UNet forward ({args.model_config or 'default model'}{cached}), batch {b}, "
          f"L {length}, bf16: host wall {wall:.3f} ms, "
          f"device busy {device:.3f} ms, idle share {1 - device / wall:.3f}")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:12s} {ms:9.3f} ms  {ms / device:6.1%}")
    print("top kernels (ms per forward, launches per forward, name):")
    for ms, count, name in sorted(kernels, reverse=True)[:20]:
        print(f"  {ms:9.3f} {count:5d}  {name[:110]}")
    print(json.dumps({"model_config": args.model_config,
                      "deep_split": args.deep_split, "batch": b,
                      "length": length, "wall_ms": wall,
                      "device_ms": device, "by_class_ms": by_class}))


if __name__ == "__main__":
    main()
