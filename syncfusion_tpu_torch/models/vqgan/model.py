"""SpecVQGAN: the wav -> spectrogram transform and encoder -> quantizer ->
decoder (port of ``wav_to_spec``, ``VQModel`` and the ``SpecVQGAN``
facade of ``syncfusion_tpu/models/vqgan/model.py``; the facade's
``encode_indices``, ``decode_indices`` and ``reconstruct`` are methods of
``VQModel`` here; ``train_forward`` is the JAX module's ``__call__``).

The spectrogram is the reference chain: 22.05 kHz wav -> magnitude STFT
(n_fft 1024, hop 256, power 1) -> mel (80 bands, 125-7600 Hz, htk scale,
slaney norm) -> the [0, 1] log chain -> the first 173 frames -> a centre
crop of 160 frames -> [-1, 1].
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.models.vqgan.autoencoder import Decoder2d, Encoder2d
from syncfusion_tpu_torch.models.vqgan.quantize import VectorQuantizer
from syncfusion_tpu_torch.ops.mel import mel_filterbank, specvqgan_scale
from syncfusion_tpu_torch.ops.stft import spectrogram

MEL_NUM = 80
SPEC_CROP_LEN = 160
SPEC_SR = 22050
TRIM_FRAMES = 173


def wav_to_spec(wav: torch.Tensor) -> torch.Tensor:
    """(B, T) 22.05 kHz audio -> (B, 80, 160) spectrogram in [-1, 1]."""
    spec = spectrogram(wav, n_fft=1024, hop_length=256, power=1.0)
    fb = torch.from_numpy(mel_filterbank(SPEC_SR, 1024, MEL_NUM, 125.0, 7600.0,
                                         scale="htk", norm="slaney").copy())
    mel = torch.einsum("mf,bft->bmt", fb.to(spec.device), spec)
    x = specvqgan_scale(mel)[:, :, :TRIM_FRAMES]
    start = max(0, (x.shape[-1] - SPEC_CROP_LEN) // 2)
    x = x[:, :, start:start + SPEC_CROP_LEN]
    if x.shape[-1] < SPEC_CROP_LEN:
        x = F.pad(x, (0, SPEC_CROP_LEN - x.shape[-1]))
    return 2.0 * x - 1.0


class VQModel(nn.Module):
    """Spectrograms (B, 1, 80, 160) in [-1, 1] <-> token grids (B, 5, 10)."""

    def __init__(self, embed_dim: int = 256, n_embed: int = 1024, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 1, 2, 2, 4), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (10,), resolution: int = 160,
                 z_channels: int = 256):
        super().__init__()
        tower = dict(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                     attn_resolutions=attn_resolutions, resolution=resolution,
                     z_channels=z_channels)
        self.encoder = Encoder2d(**tower)
        self.decoder = Decoder2d(**tower)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv = nn.Conv2d(z_channels, embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, 1, 80, 160) -> (quantized latent (B, embed_dim, 5, 10),
        indices (B, 5, 10))."""
        return self.quantize(self.quant_conv(self.encoder(x)))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(quant))

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quantize.lookup(indices))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x)[0])

    def train_forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """The training forward, JAX ``VQModel.__call__``: (B, 1, 80, 160)
        -> (reconstruction, commitment loss, ``{"perplexity", "indices"}``),
        the gradient through the quantizer's straight-through output."""
        quant, qloss, info = self.quantize.train_forward(self.quant_conv(self.encoder(x)))
        return self.decode(quant), qloss, info

    def encode_indices(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, 1, 80, 160) -> token grid (B, 5, 10)."""
        return self.encode(spec)[1]

    decode_indices = decode_code
    reconstruct = forward
