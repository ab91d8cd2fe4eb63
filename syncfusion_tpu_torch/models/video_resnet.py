"""torchvision's video ResNet family (port of
``syncfusion_tpu/models/video_resnet.py``).

The onset model uses only the keep-temporal R(2+1)D-18
(``models/onset_net.py``), but the reference vendors the whole torchvision
family (main/resnet.py): three conv builders (``Conv3DSimple``,
``Conv3DNoTemporal``, ``Conv2Plus1D``, main/resnet.py:15-78), two stems
(:165-192), ``BasicBlock`` and ``Bottleneck`` (:81-162) and the entry
points ``r3d_18``, ``mc3_18`` and ``r2plus1d_18`` (:298-347), with
torchvision's strides (the temporal stride is ``stride`` where torchvision
says so, unlike the onset surgery, which pins it to 1).

Layout: channels first, ``(B, 3, T, H, W)``, as the onset net runs inside.
The forward is the reference's patched ``VideoResNet.forward``
(main/resnet.py:234-251): the global (T, H, W) average, without the fc head
(``num_classes=None``); an int applies it.  Parameters carry torchvision's
names (``stem.0``, ``layer1.0.conv1.0.0``, ``downsample.1``, ...), so a
torchvision state dict loads with ``strict=True``; ``from_jax`` turns the
JAX family's ``{"params", "batch_stats"}`` tree into one.  BatchNorm is
Flax's (``models/batchnorm.py``: batch statistics, momentum 0.9, the biased
variance); its ``num_batches_tracked`` buffer only takes torchvision's
entry.  Convolutions compute in ``dtype``, BatchNorm in f32.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.convert import flatten
from syncfusion_tpu_torch.models.batchnorm import BatchNorm
from syncfusion_tpu_torch.models.onset_net import Conv3d, midplanes


class _BatchNorm(BatchNorm):
    """``models/batchnorm.BatchNorm`` with torchvision's
    ``num_batches_tracked`` buffer (loaded, never read)."""

    def __init__(self, channels: int):
        super().__init__(channels)
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))


def _conv(cin, cout, kernel, stride, padding, dtype):
    return Conv3d(cin, cout, kernel, stride, padding, dtype)


class Conv3DSimple(Conv3d):
    """Full 3x3x3 conv, stride (s, s, s) (main/resnet.py:15-33)."""

    def __init__(self, in_planes: int, out_planes: int, mid_planes: int = 0,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_planes, out_planes, (3, 3, 3), (stride,) * 3, (1, 1, 1), dtype)

    @staticmethod
    def downsample_stride(s: int) -> tuple:
        return (s, s, s)


class Conv3DNoTemporal(Conv3d):
    """1x3x3 conv, stride (1, s, s) (main/resnet.py:59-78)."""

    def __init__(self, in_planes: int, out_planes: int, mid_planes: int = 0,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_planes, out_planes, (1, 3, 3), (1, stride, stride),
                         (0, 1, 1), dtype)

    @staticmethod
    def downsample_stride(s: int) -> tuple:
        return (1, s, s)


class Conv2Plus1DFull(nn.Sequential):
    """Factored (1, 3, 3) + (3, 1, 1) conv with torchvision's strides:
    spatial stride on the first conv and temporal stride on the second
    (main/resnet.py:36-56; the onset surgery's variant pins the temporal
    stride to 1)."""

    def __init__(self, in_planes: int, out_planes: int, mid_planes: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(
            _conv(in_planes, mid_planes, (1, 3, 3), (1, stride, stride), (0, 1, 1), dtype),
            _BatchNorm(mid_planes), nn.ReLU(),
            _conv(mid_planes, out_planes, (3, 1, 1), (stride, 1, 1), (1, 0, 0), dtype))

    @staticmethod
    def downsample_stride(s: int) -> tuple:
        return (s, s, s)


_BUILDERS = {"simple": Conv3DSimple, "no_temporal": Conv3DNoTemporal,
             "2plus1d": Conv2Plus1DFull}


def _downsample(in_planes, out_planes, builder, stride, dtype) -> nn.Sequential:
    return nn.Sequential(
        _conv(in_planes, out_planes, (1, 1, 1), builder.downsample_stride(stride),
              (0, 0, 0), dtype),
        _BatchNorm(out_planes))


class FamilyBasicBlock(nn.Module):
    """BasicBlock over any conv builder (main/resnet.py:81-114)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, builder: str, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = _BUILDERS[builder]
        mid = midplanes(in_planes, planes)
        self.conv1 = nn.Sequential(conv(in_planes, planes, mid, stride, dtype),
                                   _BatchNorm(planes), nn.ReLU())
        self.conv2 = nn.Sequential(conv(planes, planes, mid, 1, dtype), _BatchNorm(planes))
        self.downsample = (_downsample(in_planes, planes, conv, stride, dtype)
                           if stride != 1 or in_planes != planes else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + residual)


class FamilyBottleneck(nn.Module):
    """Bottleneck: 1x1x1 -> builder 3x3 -> 1x1x1, expansion 4
    (main/resnet.py:117-162); the builder's mid width comes from the
    block's input width, as torchvision computes it (resnet.py:123-124)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, builder: str, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = _BUILDERS[builder]
        mid = midplanes(in_planes, planes)
        out_planes = planes * self.expansion
        self.conv1 = nn.Sequential(_conv(in_planes, planes, (1, 1, 1), 1, (0, 0, 0), dtype),
                                   _BatchNorm(planes), nn.ReLU())
        self.conv2 = nn.Sequential(conv(planes, planes, mid, stride, dtype),
                                   _BatchNorm(planes), nn.ReLU())
        self.conv3 = nn.Sequential(_conv(planes, out_planes, (1, 1, 1), 1, (0, 0, 0), dtype),
                                   _BatchNorm(out_planes))
        self.downsample = (_downsample(in_planes, out_planes, conv, stride, dtype)
                           if stride != 1 or in_planes != out_planes else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + residual)


class VideoResNet(nn.Module):
    """Generic video ResNet (main/resnet.py:195-285): ``builders`` a conv
    builder per stage, ``block`` "basic" or "bottleneck", ``stem`` "basic"
    (3x7x7) or "r2plus1d" (factored).  (B, 3, T, H, W) -> pooled (B,
    512·expansion) features, or (B, num_classes) with ``num_classes``."""

    def __init__(self, builders: Sequence[str] = ("2plus1d",) * 4,
                 layers: Sequence[int] = (2, 2, 2, 2), block: str = "basic",
                 stem: str = "r2plus1d", num_classes: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if stem == "r2plus1d":  # R2Plus1dStem (main/resnet.py:177-192)
            self.stem = nn.Sequential(
                _conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), dtype), _BatchNorm(45),
                nn.ReLU(), _conv(45, 64, (3, 1, 1), 1, (1, 0, 0), dtype),
                _BatchNorm(64), nn.ReLU())
        else:  # BasicStem (main/resnet.py:165-174)
            self.stem = nn.Sequential(
                _conv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), dtype), _BatchNorm(64),
                nn.ReLU())
        blk = FamilyBasicBlock if block == "basic" else FamilyBottleneck
        in_planes = 64
        for stage, (planes, blocks, builder) in enumerate(
                zip((64, 128, 256, 512), layers, builders), start=1):
            mods = []
            for b in range(blocks):
                mods.append(blk(in_planes, planes, builder,
                                2 if stage > 1 and b == 0 else 1, dtype))
                in_planes = planes * blk.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*mods))
        self.fc = nn.Linear(in_planes, num_classes) if num_classes is not None else None

    @torch.no_grad()
    def init(self, seed: int) -> "VideoResNet":
        """Random parameters from ``seed``: kernels normal with variance
        1/fan_in (Flax draws them truncated), BatchNorm at scale 1, bias 0
        and the identity statistics, the head's bias 0."""
        gen = torch.Generator(device=self.stem[0].weight.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv3d, nn.Linear)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, _BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        return self

    def forward(self, x):
        x = self.stem(x)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        x = x.float().mean(dim=(2, 3, 4))  # AdaptiveAvgPool3d((1, 1, 1))
        return x if self.fc is None else self.fc(x)


def r3d_18(**kw) -> VideoResNet:
    """18-layer ResNet3D (main/resnet.py:298-313)."""
    return VideoResNet(builders=("simple",) * 4, stem="basic", **kw)


def mc3_18(**kw) -> VideoResNet:
    """18-layer mixed-convolution net (main/resnet.py:316-330)."""
    return VideoResNet(builders=("simple",) + ("no_temporal",) * 3, stem="basic", **kw)


def r2plus1d_18(**kw) -> VideoResNet:
    """18-layer R(2+1)D, torchvision's strides (main/resnet.py:333-347)."""
    return VideoResNet(builders=("2plus1d",) * 4, stem="r2plus1d", **kw)


_STEMS = {"stem_spatial": "stem.0", "stem_bn1": "stem.1", "stem_temporal": "stem.3",
          "stem_bn2": "stem.4", "stem_conv": "stem.0", "stem_bn": "stem.1"}
_FACTORED = {"spatial": "0", "bn": "1", "temporal": "3"}


def _torchvision_name(path: tuple) -> str:
    """A JAX family path (module names, no leaf) -> torchvision's module
    name."""
    head, *rest = path
    if head in _STEMS:
        return _STEMS[head]
    if head == "fc":
        return "fc"
    stage, b = head[len("layer"):].split("_")
    out = [f"layer{stage}", b]
    sub, *inner = rest
    if sub.startswith("downsample"):
        out += ["downsample", "0" if sub.endswith("conv") else "1"]
    elif sub.startswith("bn"):  # bn{i} follows conv{i}
        out += [f"conv{sub[2:]}", "1"]
    else:  # conv{i}: a bare kernel, {"conv"} or {"spatial", "bn", "temporal"}
        out += [sub, "0"]
        if inner and inner[0] in _FACTORED:
            out.append(_FACTORED[inner[0]])
    return ".".join(out)


def from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``VideoResNet``'s ``{"params", "batch_stats"}`` tree (numpy
    or JAX arrays) -> a state dict for the port's family with torchvision's
    names (``load_state_dict(strict=True)``; ``num_batches_tracked`` 0)."""
    sd = {}
    for path, a in flatten(variables["params"]).items():
        *mods, leaf = path
        name = _torchvision_name(tuple(mods))
        if leaf == "kernel" and a.ndim == 5:  # (kt, kh, kw, in, out) -> (out, in, ...)
            a, leaf = a.transpose(4, 3, 0, 1, 2), "weight"
        elif leaf == "kernel":  # Dense (in, out) -> Linear (out, in)
            a, leaf = a.T, "weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[f"{name}.{leaf}"] = torch.from_numpy(np.array(a, np.float32, order="C"))
    for path, a in flatten(variables.get("batch_stats", {})).items():
        *mods, leaf = path
        name = _torchvision_name(tuple(mods))
        sd[f"{name}.running_{leaf}"] = torch.from_numpy(np.array(a, np.float32, order="C"))
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd
