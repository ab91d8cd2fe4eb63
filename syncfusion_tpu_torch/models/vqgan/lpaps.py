"""LPAPS, LPIPS for one-channel spectrograms (port of
``syncfusion_tpu/models/vqgan/lpaps.py``), the perceptual term of the
VQGAN's reconstruction loss.

``Vggishish16`` is the VGG16 trunk with one input channel (13 3 x 3 convs
with ReLU, 2 x 2 max pools between the five stages) and returns the five
ReLU slices relu1_2 .. relu5_3 (64, 128, 256, 512, 512 channels).
``LPAPS`` maps both inputs by ``(x − shift) / scale``, divides each slice
by its channel norm floored at 1e-10 (a maximum, not ``norm + eps``),
takes the squared difference, a bias-free 1 x 1 ``lin{i}`` conv to one
channel and its mean over (C, H, W), and sums over the slices: (B,).

The module is frozen in training.  Its weights are the reference's
``vggishish16.pt`` and LPAPS lin heads (neither is in the repository;
``reference_state_dict`` maps them) or, without them, Flax's default
distributions (``models.init.flax_init``), as the JAX trainer initialises
it.
Submodules carry the Flax names (``convert.lpaps_state_dict``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

SLICE_CHANNELS = (64, 128, 256, 512, 512)
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512)
SLICE_ENDS = (2, 4, 7, 10, 13)  # convs counted at the end of each slice


class Vggishish16(nn.Module):
    def __init__(self):
        super().__init__()
        c_in, i = 1, 0
        for item in VGG16_CFG:
            if item != "M":
                self.add_module(f"conv_{i}", nn.Conv2d(c_in, item, 3, padding=1))
                c_in, i = item, i + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """(B, 1, H, W) -> the five ReLU slices, (B, C_i, H_i, W_i)."""
        slices, i = [], 0
        for item in VGG16_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv_{i}")(x))
            i += 1
            if i in SLICE_ENDS:
                slices.append(x)
        return slices


class LPAPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.shift = nn.Parameter(torch.zeros(1, 1, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, 1, 1, 1))
        self.net = Vggishish16()
        for i, c in enumerate(SLICE_CHANNELS):
            self.add_module(f"lin{i}", nn.Conv2d(c, 1, 1, bias=False))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y (B, 1, H, W) scaled spectrograms -> perceptual distance (B,)."""
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(1e-10)
            b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp_min(1e-10)
            lin = getattr(self, f"lin{i}")((a - b) ** 2)
            total = total + lin.mean(dim=(1, 2, 3))
        return total


def reference_state_dict(vgg_state: Mapping[str, torch.Tensor],
                         lin_state: Optional[Mapping[str, torch.Tensor]] = None
                         ) -> dict[str, torch.Tensor]:
    """The reference's ``vggishish16.pt`` state dict (its ``features.{k}``
    convs, in layer order) and, where given, its LPAPS lin heads
    (``lin{i}.model.1.weight`` or ``lins.{i}.model.1.weight``) and scaling
    layer -> a ``state_dict`` for ``LPAPS.load_state_dict``: the counterpart
    of the JAX ``convert_lpaps``.  Without lin weights the heads are left
    out (load with ``strict=False`` over a seeded module)."""
    def layer(k):
        parts = k.split(".")
        return int(parts[1]) if parts[0] == "features" else 0

    convs = sorted((k for k, v in vgg_state.items()
                    if k.endswith(".weight") and v.ndim == 4), key=layer)
    n_convs = sum(1 for c in VGG16_CFG if c != "M")
    sd = {}
    for i, k in enumerate(convs[:n_convs]):
        sd[f"net.conv_{i}.weight"] = vgg_state[k].float()
        sd[f"net.conv_{i}.bias"] = vgg_state[k[:-len("weight")] + "bias"].float()
    sd["shift"] = torch.zeros(1, 1, 1, 1)
    sd["scale"] = torch.ones(1, 1, 1, 1)
    for i in range(len(SLICE_CHANNELS)):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if lin_state and cand in lin_state:
                sd[f"lin{i}.weight"] = lin_state[cand].float()
                break
    if lin_state and "scaling_layer.shift" in lin_state:
        sd["shift"] = lin_state["scaling_layer.shift"].float().reshape(1, 1, 1, 1)
        sd["scale"] = lin_state["scaling_layer.scale"].float().reshape(1, 1, 1, 1)
    return sd

