"""Spectrogram panels of the diffusion trainer's sample logger, label
line plots of the onset model's test run, the CondFoleyGen trainers'
attention panels and vocoded wavs (port of ``write_spec_panel``,
``spec_to_image``, ``_colormap``, ``write_label_plot``,
``visualize_attention``, ``write_attention_panel`` and ``write_media_wavs``
of ``syncfusion_tpu/eval/panels.py``) and the baseline generation's coolwarm
spectrogram images (``write_spec_image``, for the matplotlib ``imshow`` of
``script/generate_audio.py``: the card's machine has no matplotlib).  PIL
is imported inside the functions
that draw, so the module imports without it: PIL is not among the card
machine's promised packages."""

from __future__ import annotations

from pathlib import Path

import numpy as np

# compact viridis approximation (anchor colours, linearly interpolated)
_VIRIDIS = np.array(
    [[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98], [253, 231, 37]],
    np.float32,
)


# matplotlib's coolwarm at 9 anchors (blue -> grey -> red)
_COOLWARM = np.array(
    [[59, 76, 192], [98, 130, 234], [141, 176, 254], [184, 208, 249],
     [221, 221, 221], [245, 196, 173], [244, 154, 123], [222, 96, 77],
     [180, 4, 38]], np.float32,
)


def _colormap(x: np.ndarray, table: np.ndarray = _VIRIDIS) -> np.ndarray:
    """x in [0, 1] -> (..., 3) uint8 colours, ``table``'s anchors linearly
    interpolated (viridis-like by default)."""
    x = np.clip(x, 0.0, 1.0) * (len(table) - 1)
    i = np.clip(x.astype(int), 0, len(table) - 2)
    frac = (x - i)[..., None]
    rgb = table[i] * (1 - frac) + table[i + 1] * frac
    return rgb.astype(np.uint8)


def spec_to_image(spec: np.ndarray, upscale: int = 3, table: np.ndarray = _VIRIDIS):
    """(H, W) spectrogram (any range) -> PIL image, min-max scaled, low
    frequencies at the bottom, each bin ``upscale`` pixels square."""
    from PIL import Image

    s = np.asarray(spec, np.float32)
    rng = s.max() - s.min()
    s = (s - s.min()) / rng if rng > 0 else np.zeros_like(s)
    img = Image.fromarray(_colormap(s[::-1], table))
    return img.resize((img.width * upscale, img.height * upscale), Image.NEAREST)


def write_spec_panel(out_dir: str | Path, name: str, specs: dict[str, np.ndarray],
                     step: int = 0) -> Path:
    """Write ``{name}_step{step:08d}.png``, one row per entry of ``specs``
    (e.g. ``{"sample": mel}``); returns its path."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = [spec_to_image(s) for s in specs.values()]
    panel = Image.new("RGB", (max(r.width for r in rows), sum(r.height for r in rows)))
    y = 0
    for r in rows:
        panel.paste(r, (0, y))
        y += r.height
    path = out_dir / f"{name}_step{step:08d}.png"
    panel.save(path)
    return path


def write_spec_image(spec: np.ndarray, dest: str | Path) -> Path:
    """One (H, W) spectrogram as a coolwarm image at ``dest`` (its suffix
    names the format, ``.jpg`` in the generation's artifact set), low
    frequencies at the bottom, one pixel a bin."""
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    spec_to_image(spec, upscale=1, table=_COOLWARM).save(dest)
    return dest


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


def visualize_attention(att, scale_by_prior: bool = True) -> np.ndarray:
    """(B, H, T, T) attention probabilities -> (B, T, T) maps: with
    ``scale_by_prior`` the causal uniform prior 1/(row + 1) subtracted below
    the diagonal, then summed over heads."""
    att = np.asarray(att, np.float32)
    t = att.shape[-1]
    if scale_by_prior:
        prior = np.tril(1.0 / np.arange(1, t + 1, dtype=np.float32)[:, None]
                        * np.ones((t, t), np.float32))
        att = att - prior[None, None]
    return att.sum(axis=1)


def write_attention_panel(out_dir: str | Path, name: str, att, step: int = 0,
                          scale_by_prior: bool = True, max_maps: int = 4) -> Path:
    """``{name}_step{step:08d}.png``: the first ``max_maps`` items' maps
    (``visualize_attention``) side by side, min-max scaled over the whole
    grid, viridis, each upscaled by whole pixels to about 256 wide, 2-pixel
    gaps."""
    from PIL import Image

    maps = visualize_attention(att, scale_by_prior)[:max_maps]
    lo, hi = maps.min(), maps.max()
    maps = (maps - lo) / (hi - lo) if hi > lo else np.zeros_like(maps)
    tiles = [Image.fromarray(_colormap(m)) for m in maps]
    upscale = max(1, 256 // tiles[0].width)
    tiles = [t.resize((t.width * upscale, t.height * upscale), Image.NEAREST) for t in tiles]
    pad = 2
    panel = Image.new("RGB", (sum(t.width for t in tiles) + pad * (len(tiles) - 1),
                              tiles[0].height))
    x = 0
    for t in tiles:
        panel.paste(t, (x, 0))
        x += t.width + pad
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}_step{step:08d}.png"
    panel.save(path)
    return path


def write_media_wavs(out_dir: str | Path, name: str, specs01: dict, step: int = 0,
                     sample_rate: int = 22050, n_iter: int = 16,
                     max_items: int = 2) -> list[Path]:
    """Vocode [0, 1] mel panels (B, 80, T), numpy or tensors (on their
    device), by ``n_iter`` Griffin-Lim iterations (``ops.mel.
    mel01_to_waveform_gl``) and write ``{name}_{key}_{i}_step{step:08d}.wav``
    for the first ``max_items`` items of each; returns the paths."""
    import torch

    from syncfusion_tpu_torch.ops.mel import mel01_to_waveform_gl
    from syncfusion_tpu_torch.ops.wav import write_wav

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for key, spec in specs01.items():
        spec = torch.as_tensor(spec, dtype=torch.float32)[:max_items]
        wavs = mel01_to_waveform_gl(spec, sample_rate, n_iter=n_iter).cpu().numpy()
        for i in range(wavs.shape[0]):
            path = out_dir / f"{name}_{key}_{i}_step{step:08d}.wav"
            write_wav(path, wavs[i], sample_rate)
            paths.append(path)
    return paths
