"""Frame transforms for the onset dataset (numpy, seeded RNG; port of
``syncfusion_tpu/data/transforms.py``).

Implements the torchvision transform semantics the reference configs use
(cfg/data/data-onset-greatesthit*.yaml): Resize (bilinear antialias),
RandomCrop, CenterCrop, ColorJitter(brightness, contrast, saturation, hue)
and ImageNet Normalize.  All transforms operate on a whole frame stack
``(T, H, W, 3) float32 in [0,1]`` with ONE random draw per chunk (matching
torchvision-on-video behavior: the same params apply to every frame of the
clip).  PIL is imported inside ``resize`` only: the rest runs without it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize(frames: np.ndarray, size) -> np.ndarray:
    """size: int (short side) or (h, w)."""
    t, h, w, _ = frames.shape
    if isinstance(size, int):
        if h <= w:
            nh, nw = size, max(1, round(w * size / h))
        else:
            nh, nw = max(1, round(h * size / w)), size
    else:
        nh, nw = size
    if (nh, nw) == (h, w):
        return frames
    from PIL import Image

    out = np.empty((t, nh, nw, 3), np.float32)
    for i in range(t):
        img = Image.fromarray((frames[i] * 255.0 + 0.5).astype(np.uint8))
        out[i] = np.asarray(
            img.resize((nw, nh), Image.BILINEAR), np.float32
        ) / 255.0
    return out


def crop(frames: np.ndarray, top: int, left: int, size: int) -> np.ndarray:
    return frames[:, top : top + size, left : left + size, :]


def center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    _, h, w, _ = frames.shape
    return crop(frames, (h - size) // 2, (w - size) // 2, size)


def random_crop(frames: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    _, h, w, _ = frames.shape
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return crop(frames, top, left, size)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def adjust_brightness(x, f):
    return _blend(x, np.zeros_like(x), f)


def adjust_contrast(x, f):
    gray = (x @ np.array([0.299, 0.587, 0.114], np.float32)).mean(
        axis=(-2, -1), keepdims=True
    )[..., None]
    return _blend(x, np.broadcast_to(gray, x.shape), f)


def adjust_saturation(x, f):
    gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
    return _blend(x, np.repeat(gray[..., None], 3, axis=-1), f)


def adjust_hue(x, f):
    """Shift hue by ``f`` (fraction of the full circle, |f| ≤ 0.5)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc, minc = x.max(-1), x.min(-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-8), 0.0)
    dc = np.maximum(deltac, 1e-8)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(deltac == 0, 0.0, h)
    h = (h + f) % 1.0
    i = np.floor(h * 6.0)
    frac = h * 6.0 - i
    p, q, t_ = v * (1 - s), v * (1 - s * frac), v * (1 - s * (1 - frac))
    i = i.astype(np.int32) % 6
    conds = [i == k for k in range(6)]
    r2 = np.select(conds, [v, q, p, p, t_, v])
    g2 = np.select(conds, [t_, v, v, q, p, p])
    b2 = np.select(conds, [p, p, t_, v, v, q])
    return np.stack([r2, g2, b2], axis=-1).astype(np.float32)


def color_jitter(
    frames: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
    hue: float = 0.0,
) -> np.ndarray:
    """torchvision ColorJitter semantics: uniform factors, random op order."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x, f=f: adjust_brightness(x, f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda x, f=f: adjust_contrast(x, f))
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda x, f=f: adjust_saturation(x, f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(lambda x, f=f: adjust_hue(x, f))
    for idx in rng.permutation(len(ops)):
        frames = ops[idx](frames)
    return frames


def normalize(frames: np.ndarray) -> np.ndarray:
    return (frames - IMAGENET_MEAN) / IMAGENET_STD


def rgb_to_yuv420(frames: np.ndarray) -> np.ndarray:
    """float [0,1] RGB ``(..., H, W, 3)`` → packed planar 4:2:0 uint8
    ``(..., H + H//2, W)``.

    Layout: rows ``[0:H]`` = full-resolution luma Y; rows ``[H:]`` = the
    quarter-resolution chroma planes side by side (``U | V``, each
    ``H/2 × W/2``).  BT.601 full-range YPbPr with Pb/Pr biased by +0.5.
    Half the bytes of the uint8 RGB wire; the source GH frames are 4:2:0
    JPEGs already, so the chroma detail this drops never existed.  Decoded
    back to RGB on the device by the trainer
    (``OnsetTrainer.decode_wire``).  H and W must be even.
    """
    r, g, b = frames[..., 0], frames[..., 1], frames[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    pb = (b - y) / 1.772 + 0.5
    pr = (r - y) / 1.402 + 0.5
    H, W = y.shape[-2], y.shape[-1]

    def down(c):  # 2×2 mean pool
        c = c.reshape(*c.shape[:-2], H // 2, 2, W // 2, 2)
        return c.mean(axis=(-3, -1))

    uv = np.concatenate([down(pb), down(pr)], axis=-1)  # (..., H/2, W)
    packed = np.concatenate([y, uv], axis=-2)           # (..., H+H/2, W)
    return (np.clip(packed, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


@dataclasses.dataclass
class FrameTransform:
    """Composed per-chunk transform pipeline.

    ``augment=False`` → Resize(112,112) + Normalize (reference eval default,
    main/dataset_onset.py:47-50); ``augment=True`` → Resize(128) +
    RandomCrop(112) + ColorJitter(0.4, 0.2, 0.4, 0.1) + Normalize
    (cfg/data/data-onset-greatesthit-augment.yaml:8-30).
    """

    augment: bool = False
    size: int = 112
    resize_to: int = 128
    brightness: float = 0.4
    contrast: float = 0.2
    saturation: float = 0.4
    hue: float = 0.1
    # uint8 wire format: skip the host-side Normalize and emit uint8 pixels,
    # a quarter of the bytes of f32 for a (B, T, 112, 112, 3) clip batch
    # (72 MB -> 18 MB at batch 16); the trainer normalises on the device
    # (OnsetTrainer.prep_frames), keyed on the input dtype.  The
    # quantisation error is <= 0.5/255 per pixel, below the source video's
    # own 8-bit precision.
    wire_uint8: bool = False
    # device_jitter: leave ColorJitter to the trainer's step on the device
    # (ops/augment.color_jitter_device, 16 elementwise passes over the
    # batch) instead of the host's numpy loop.  The cheap RandomCrop stays
    # on the host (a uint8 slice), keeping the wire at crop size.
    device_jitter: bool = False
    # 4:2:0 wire format (takes precedence over wire_uint8): HALF the bytes
    # of uint8 RGB — see rgb_to_yuv420.  Requires the trainer's device-side
    # decode (it keys on the packed array's missing channel dim).
    wire_yuv420: bool = False

    def resize_stage(self, frames: np.ndarray) -> np.ndarray:
        """Deterministic prefix (Resize) — cacheable across epochs."""
        if self.augment:
            return resize(frames, self.resize_to)
        return resize(frames, (self.size, self.size))

    def finish(self, frames: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Stochastic suffix (RandomCrop/ColorJitter) + output encoding."""
        if self.augment:
            rng = rng if rng is not None else np.random.default_rng()
            frames = random_crop(frames, self.size, rng)
            if not self.device_jitter:
                frames = color_jitter(
                    frames, rng,
                    self.brightness, self.contrast, self.saturation, self.hue,
                )
        if self.wire_yuv420:
            return rgb_to_yuv420(frames)
        if self.wire_uint8:
            return (frames * 255.0 + 0.5).astype(np.uint8)
        return normalize(frames)

    @property
    def jitter_params(self) -> tuple[float, float, float, float]:
        """(brightness, contrast, saturation, hue) for the device jitter."""
        return (self.brightness, self.contrast, self.saturation, self.hue)

    def __call__(self, frames: np.ndarray, rng: Optional[np.random.Generator] = None):
        return self.finish(self.resize_stage(frames), rng)
