"""The MelGAN vocoder: an 80-band mel -> 22.05 kHz waveform (port of
``MelGANResnetBlock``, ``MelGANGenerator``, ``fold_weight_norm`` and
``Vocoder`` of ``syncfusion_tpu/models/melgan.py``).

The reference's vggsound generator (ngf 32, 3 residual layers, ratios (8,
8, 2, 2)): a reflect-padded 7-wide input conv; four stages of LeakyReLU(0.2),
a transposed conv upsampling by r (kernel 2r, padding r//2 + r%2, output
padding r%2, torch's ``ConvTranspose1d``, which the JAX package reproduces)
and dilated residual blocks (dilation 3^j, reflect padding); LeakyReLU, a
reflect-padded 7-wide conv to one channel, tanh.  256 samples a frame.

Layout (B, C, L).  Submodules carry the JAX module's names.
``melgan_state_dict`` reads the reference's weight-normed ``best_netG.pt``
(a ``model.{i}`` Sequential) in place of the JAX package's
``convert_melgan``: it folds each weight norm into a plain weight.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.models.init import flax_init


class MelGANResnetBlock(nn.Module):
    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.conv_dilated = nn.Conv1d(dim, dim, 3, dilation=dilation)
        self.conv_1x1 = nn.Conv1d(dim, dim, 1)
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        h = F.pad(F.leaky_relu(x, 0.2), (self.dilation, self.dilation), mode="reflect")
        h = self.conv_1x1(F.leaky_relu(self.conv_dilated(h), 0.2))
        return self.shortcut(x) + h


class MelGANGenerator(nn.Module):
    """mel (B, n_mels, frames) -> waveform (B, 256·frames) at the default
    ratios."""

    def __init__(self, n_mels: int = 80, ngf: int = 32, n_residual_layers: int = 3,
                 ratios: Sequence[int] = (8, 8, 2, 2)):
        super().__init__()
        self.ratios, self.n_residual_layers = tuple(ratios), n_residual_layers
        mult = 2 ** len(ratios)
        self.conv_in = nn.Conv1d(n_mels, mult * ngf, 7)
        for i, r in enumerate(ratios):
            out_ch = mult * ngf // 2
            self.add_module(f"up_{i}", nn.ConvTranspose1d(
                mult * ngf, out_ch, 2 * r, stride=r, padding=r // 2 + r % 2,
                output_padding=r % 2))
            for j in range(n_residual_layers):
                self.add_module(f"res_{i}_{j}", MelGANResnetBlock(out_ch, 3 ** j))
            mult //= 2
        self.conv_out = nn.Conv1d(ngf, 1, 7)

    def forward(self, mel):
        x = self.conv_in(F.pad(mel, (3, 3), mode="reflect"))
        for i in range(len(self.ratios)):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, 0.2))
            for j in range(self.n_residual_layers):
                x = getattr(self, f"res_{i}_{j}")(x)
        x = F.pad(F.leaky_relu(x, 0.2), (3, 3), mode="reflect")
        return torch.tanh(self.conv_out(x))[:, 0]


def fold_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """weight_norm's weight: g · v / ‖v‖, the norm over every dim but 0."""
    norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return g.reshape(-1, *([1] * (v.ndim - 1))) * v / norm.clamp_min(1e-12)


def melgan_state_dict(state_dict: Mapping[str, torch.Tensor],
                      n_residual_layers: int = 3,
                      ratios: Sequence[int] = (8, 8, 2, 2)) -> dict[str, torch.Tensor]:
    """The reference generator's weight-normed ``model.{i}`` state dict ->
    this generator's, for ``load_state_dict(strict=True)``.

    The reference's Sequential: 0 reflect pad, 1 conv_in; per ratio a
    LeakyReLU, the transposed conv, ``n_residual_layers`` residual blocks
    (``block.2`` the dilated conv, ``block.4`` the 1 x 1, ``shortcut``);
    then LeakyReLU, reflect pad and conv_out.  torch's layouts are this
    generator's, so only the weight norms are folded."""
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in state_dict.items()}
    out = {}

    def put(dst: str, src: str):
        out[f"{dst}.weight"] = fold_weight_norm(sd[f"{src}.weight_v"], sd[f"{src}.weight_g"])
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    put("conv_in", "model.1")
    idx = 3  # model.2 is the first stage's LeakyReLU
    for i in range(len(ratios)):
        put(f"up_{i}", f"model.{idx}")
        for j in range(n_residual_layers):
            blk = f"model.{idx + 1 + j}"
            put(f"res_{i}_{j}.conv_dilated", f"{blk}.block.2")
            put(f"res_{i}_{j}.conv_1x1", f"{blk}.block.4")
            put(f"res_{i}_{j}.shortcut", f"{blk}.shortcut")
        idx += n_residual_layers + 2  # the up conv, the blocks, the next LeakyReLU
    put("conv_out", f"model.{idx + 1}")
    return out


class Vocoder:
    """Spectrogram in the SpecVQGAN [0, 1] domain -> 22.05 kHz waveform,
    through the reference MelGAN at ``checkpoint_path`` (its
    ``best_netG.pt``), or random weights seeded 0 without one (the JAX
    facade's ``key(0)``)."""

    def __init__(self, checkpoint_path: Optional[str | Path] = None,
                 device: str | torch.device = "cpu"):
        self.net = MelGANGenerator().to(device)
        if checkpoint_path:
            sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
            sd = sd.get("state_dict", sd)
            self.net.load_state_dict(melgan_state_dict(sd), strict=True)
        else:
            flax_init(self.net, 0)
        self.net.eval()

    @torch.no_grad()
    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, 80, T) mel -> (B, 256·T) waveform."""
        return self.net(mel)
