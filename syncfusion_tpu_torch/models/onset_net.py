"""Video onset-detection network: R(2+1)D-18 with the keep-temporal
surgery (port of ``syncfusion_tpu/models/onset_net.py``).

Every stride is spatial only, so a 30-frame chunk gives 30 per-frame onset
logits: a (1, 7, 7) stem conv 3 -> 45 at spatial stride 2, BN, ReLU, a
(3, 1, 1) conv 45 -> 64, BN, ReLU; four stages of BasicBlocks at 64, 128,
256 and 512 channels, each (2+1)D conv a (1, 3, 3) spatial conv to
torchvision's ``midplanes`` width (230/460/921 at the stage entries), BN,
ReLU and a (3, 1, 1) temporal conv; then the mean over H and W (T kept),
Linear 512 -> 128, ReLU, Linear 128 -> 1.

The public functions take channels-last ``(B, T, H, W, 3)`` frames, as the
JAX package's do; inside, the net runs ``(B, C, T, H, W)`` for
``F.conv3d``.  Padding is symmetric (torch's), as the JAX module spells it
out.  Submodules carry the Flax names, so ``convert.onset_state_dict`` of
a JAX ``{"params", "batch_stats"}`` tree loads with ``strict=True``.

Precision follows Flax's ``dtype``: with ``dtype=bfloat16`` only the
convolutions compute in bf16 (input and weight cast, bf16 out); BatchNorm
and the Dense head carry no ``dtype`` there and so compute in f32, which is
what their f32 parameters promote a bf16 input to.  Parameters stay f32.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.models.batchnorm import BN_EPS, BN_MOMENTUM, BatchNorm  # noqa: F401
from syncfusion_tpu_torch.models.blocks import Linear
from syncfusion_tpu_torch.models.init import flax_init

def midplanes(c_in: int, c_out: int) -> int:
    """torchvision's (2+1)D factorisation width."""
    return (c_in * c_out * 3 * 3 * 3) // (c_in * 3 * 3 + 3 * c_out)


class Conv3d(nn.Module):
    """Flax ``Conv`` without bias on (B, C, T, H, W): weight (out, in, kt,
    kh, kw), ``stride`` (t, h, w) or an int s for (1, s, s), symmetric
    ``padding`` (t, h, w)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: tuple,
                 stride: int | tuple = 1, padding: tuple = (0, 0, 0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel))
        self.stride = (1, stride, stride) if isinstance(stride, int) else tuple(stride)
        self.padding = padding
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv3d(x.to(dt), self.weight.to(dt), None, stride=self.stride,
                        padding=self.padding)


class Conv2Plus1D(nn.Module):
    """(1, 3, 3) spatial conv -> BN -> ReLU -> (3, 1, 1) temporal conv."""

    def __init__(self, in_planes: int, out_planes: int, mid_planes: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spatial = Conv3d(in_planes, mid_planes, (1, 3, 3), stride,
                              (0, 1, 1), dtype)
        self.bn = BatchNorm(mid_planes)
        self.temporal = Conv3d(mid_planes, out_planes, (3, 1, 1), 1, (1, 0, 0),
                               dtype)

    def forward(self, x):
        return self.temporal(F.relu(self.bn(self.spatial(x))))


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # one width for both convs of the block, from (in_planes, planes)
        mid = midplanes(in_planes, planes)
        self.conv1 = Conv2Plus1D(in_planes, planes, mid, stride, dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2Plus1D(planes, planes, mid, 1, dtype)
        self.bn2 = BatchNorm(planes)
        self.downsample = stride != 1 or in_planes != planes
        if self.downsample:
            self.downsample_conv = Conv3d(in_planes, planes, (1, 1, 1), stride,
                                          dtype=dtype)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(h + residual)


class R2Plus1D18KeepTemp(nn.Module):
    """Backbone: (B, 3, T, H, W) -> (B, T, 512) per-frame features."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem_spatial = Conv3d(3, 45, (1, 7, 7), 2, (0, 3, 3), dtype)
        self.stem_bn1 = BatchNorm(45)
        self.stem_temporal = Conv3d(45, 64, (3, 1, 1), 1, (1, 0, 0), dtype)
        self.stem_bn2 = BatchNorm(64)
        self.block_names = []
        in_planes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers),
                                                 start=1):
            for b in range(blocks):
                stride = 2 if stage > 1 and b == 0 else 1
                name = f"layer{stage}_{b}"
                self.add_module(name, BasicBlock(in_planes, planes, stride, dtype))
                self.block_names.append(name)
                in_planes = planes

    def forward(self, x):
        x = F.relu(self.stem_bn1(self.stem_spatial(x)))
        x = F.relu(self.stem_bn2(self.stem_temporal(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.mean(dim=(3, 4)).transpose(1, 2)  # mean over H, W; T kept


class VideoOnsetNet(nn.Module):
    """(B, T, H, W, 3) frames -> (B, T) per-frame onset logits, f32 (f64
    with ``dtype=float64``).

    ``layers``: blocks per stage; (2, 2, 2, 2) is the reference's
    R(2+1)D-18, (1, 1, 1, 1) a lighter R(2+1)D-10.
    """

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = R2Plus1D18KeepTemp(layers, dtype)
        # Flax's Dense without dtype: the promoted type of the f32 features
        # and parameters
        head = torch.promote_types(dtype, torch.float32)
        self.fc1 = Linear(512, 128, head)
        self.fc2 = Linear(128, 1, head)

    def forward(self, frames):
        feats = self.backbone(frames.permute(0, 4, 1, 2, 3))
        return self.fc2(F.relu(self.fc1(feats)))[..., 0]

    def init(self, seed: int) -> "VideoOnsetNet":
        return flax_init(self, seed)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


class ReluTape:
    """Records or replays the ReLU masks of this module's nets, to hold the
    f32 gradients of one run against another's (across devices or types):
    rounding flips the few ReLU inputs that lie within its error of 0, and
    one flip can move a weight gradient by far more than rounding does.
    ``with ReluTape() as tape:`` records each ``relu``'s mask in call
    order; ``with ReluTape(replay=tape):`` multiplies by ``tape``'s masks
    in turn instead.  Inside the ``with``, the tape stands in for
    ``torch.nn.functional`` in this module."""

    def __init__(self, replay: "ReluTape | None" = None):
        self.masks = [] if replay is None else replay.masks
        self.replay = replay is not None
        self.calls = 0

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def relu(self, x):
        if self.replay:
            self.calls += 1
            return x * self.masks[self.calls - 1].to(x.device, x.dtype)
        self.masks.append((x > 0).detach())
        return torch.relu(x)

    def flips(self, other: "ReluTape") -> tuple[int, int]:
        """(ReLU inputs whose sign differs from ``other``'s, ReLU inputs)."""
        return (sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(self.masks, other.masks)),
                sum(m.numel() for m in self.masks))

    def __enter__(self) -> "ReluTape":
        global F
        F = self
        return self

    def __exit__(self, *exc) -> None:
        global F
        F = torch.nn.functional


def convert_torch_r2plus1d(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A torchvision ``r2plus1d_18`` or reference ``VideoOnsetNet``
    ``state_dict`` -> this net's keys (``backbone.*``, and ``fc1``/``fc2``
    where the reference's ``fc.0``/``fc.2`` head is there).

    Keys may carry the reference's prefixes (``model.net.model.``,
    ``net.model.``, ``model.``).  torch's layouts are this net's, so no
    tensor is transposed; ``num_batches_tracked`` and torchvision's
    classifier ``fc`` are dropped.  Load the result with
    ``load_state_dict(..., strict=False)`` when it has no head.
    """
    sd = {}
    for k, v in state_dict.items():
        for prefix in ("model.net.model.", "net.model.", "model.", ""):
            if k.startswith(prefix):
                sd[k[len(prefix):]] = torch.as_tensor(v)
                break
    out = {}

    def put_conv(dst: str, src: str):
        out[f"backbone.{dst}.weight"] = sd[f"{src}.weight"]

    def put_bn(dst: str, src: str):
        for a, b in (("weight", "weight"), ("bias", "bias"),
                     ("running_mean", "running_mean"), ("running_var", "running_var")):
            out[f"backbone.{dst}.{a}"] = sd[f"{src}.{b}"]

    # stem: Sequential [conv, bn, relu, conv, bn, relu]
    put_conv("stem_spatial", "stem.0")
    put_bn("stem_bn1", "stem.1")
    put_conv("stem_temporal", "stem.3")
    put_bn("stem_bn2", "stem.4")
    for stage in range(1, 5):
        for b in range(2):
            src = f"layer{stage}.{b}"
            if f"{src}.conv1.0.0.weight" not in sd:
                continue
            dst = f"layer{stage}_{b}"
            for ci in (1, 2):
                # torchvision's Conv2Plus1D is Sequential [conv, bn, relu, conv]
                put_conv(f"{dst}.conv{ci}.spatial", f"{src}.conv{ci}.0.0")
                put_bn(f"{dst}.conv{ci}.bn", f"{src}.conv{ci}.0.1")
                put_conv(f"{dst}.conv{ci}.temporal", f"{src}.conv{ci}.0.3")
                put_bn(f"{dst}.bn{ci}", f"{src}.conv{ci}.1")
            if f"{src}.downsample.0.weight" in sd:
                put_conv(f"{dst}.downsample_conv", f"{src}.downsample.0")
                put_bn(f"{dst}.downsample_bn", f"{src}.downsample.1")
    for idx, name in ((0, "fc1"), (2, "fc2")):
        for cand in (f"fc.{idx}", f"model.fc.{idx}"):
            if f"{cand}.weight" in sd:
                out[f"{name}.weight"] = sd[f"{cand}.weight"]
                out[f"{name}.bias"] = sd[f"{cand}.bias"]
                break
    return out
