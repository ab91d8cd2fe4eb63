"""The VQGAN's PatchGAN discriminator (port of
``syncfusion_tpu/models/vqgan/discriminator.py``).

``NLayerDiscriminator(ndf=64, n_layers=3)``: a 4 x 4 conv at stride 2 with
bias and LeakyReLU 0.2, then ``n_layers`` bias-free 4 x 4 convs to
``ndf·min(2^n, 8)`` channels (stride 2, the last stride 1), each with
BatchNorm (Flax's statistics and momentum 0.9: ``models.batchnorm``)
or ``ActNorm``, and LeakyReLU 0.2; a 4 x 4 conv to one channel at stride
1.  Every conv pads 1 on each side.  ``train()`` normalises with the
batch's statistics and moves the running ones; ``eval()`` uses the
running ones, as the JAX module's ``train`` flag does.  Submodules carry
the Flax names (``convert.discriminator_state_dict``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.models.batchnorm import BatchNorm


class ActNorm(nn.Module):
    """Per-channel affine ``(x + loc)·scale`` with a data-dependent first
    call: the first forward in training mode normalises with the batch's
    own statistics (loc = −mean, scale = 1/(std + 1e-6) over every dim but
    the channels) and sets ``initialized``.  As in the JAX module those
    statistics shape that call's output only: ``loc`` and ``scale`` keep
    their values (and get no gradient from that call)."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(channels))
        self.scale = nn.Parameter(torch.ones(channels))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        view = (1, -1) + (1,) * (x.ndim - 2)
        loc, scale = self.loc, self.scale
        if self.training and not bool(self.initialized):
            dims = (0, *range(2, x.ndim))
            loc = -x.mean(dims)
            scale = 1.0 / (x.std(dims, correction=0) + 1e-6)
            self.initialized.fill_(True)
        return (x + loc.view(view)) * scale.view(view)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.use_actnorm = use_actnorm
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1)
        c_in = ndf
        for n in range(1, n_layers + 1):
            c = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv{n}", nn.Conv2d(c_in, c, 4, stride=stride, padding=1,
                                                  bias=False))
            if use_actnorm:
                self.add_module(f"an{n}", ActNorm(c))
            else:
                self.add_module(f"bn{n}", BatchNorm(c))
            c_in = c
        self.conv_out = nn.Conv2d(c_in, 1, 4, stride=1, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, H, W) -> patch logits (B, 1, H', W')."""
        h = F.leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            norm = getattr(self, f"an{n}" if self.use_actnorm else f"bn{n}")
            h = F.leaky_relu(norm(getattr(self, f"conv{n}")(h)), 0.2)
        return self.conv_out(h)
