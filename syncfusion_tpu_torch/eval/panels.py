"""Label line plots of the onset model's test run (port of
``write_label_plot`` of ``syncfusion_tpu/eval/panels.py``).  The mel panels
of that module wait on ``ops/mel`` (ROADMAP.md, port queue: 'CLAP').  PIL
is imported inside the function, so the module imports without it: PIL is
not among the card machine's promised packages, and only the ``test``
subcommand draws."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_label_plot(
    out_dir: str | Path,
    name: str,
    target: np.ndarray,
    pred_prob: np.ndarray,
    step: int = 0,
    px_per_frame: int = 12,
    height: int = 160,
) -> Path:
    """Per-frame onset label line plot: target (step trace, dark) vs
    predicted probability (light trace), the disk copy of the reference's
    wandb line plots (main/module_onset.py:231-261)."""
    from PIL import Image, ImageDraw

    target = np.asarray(target, np.float32).ravel()
    pred_prob = np.asarray(pred_prob, np.float32).ravel()
    t = len(target)
    img = Image.new("RGB", (max(t, 2) * px_per_frame, height), (255, 255, 255))
    draw = ImageDraw.Draw(img)

    def y(v):  # value in [0,1] → pixel row (margin 10)
        return int((height - 10) - float(np.clip(v, 0, 1)) * (height - 20))

    draw.line([(0, y(0.5)), (img.width, y(0.5))], fill=(230, 230, 230))
    for series, color in ((target, (30, 60, 200)), (pred_prob, (220, 80, 40))):
        pts = [(i * px_per_frame + px_per_frame // 2, y(v))
               for i, v in enumerate(series)]
        if len(pts) > 1:
            draw.line(pts, fill=color, width=2)
        for p in pts:
            draw.ellipse([p[0] - 2, p[1] - 2, p[0] + 2, p[1] + 2], fill=color)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}_step{step:08d}.png"
    img.save(path)
    return path
