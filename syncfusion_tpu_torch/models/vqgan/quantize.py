"""The vector quantizer (port of ``VectorQuantizer`` of
``syncfusion_tpu/models/vqgan/quantize.py``): nearest code by the distance
in its expanded form ``|z|² − 2 z·e + |e|²``, as the JAX module computes it,
so that near-ties resolve alike (``torch.cdist`` rounds otherwise).

``forward`` is the inference side (codes and their embeddings);
``train_forward`` adds training's straight-through output, the commitment
loss ``mean((sg(z_q) − z)²) + β·mean((z_q − sg(z))²)`` (β = 0.25) and the
perplexity of the batch's code usage."""

from __future__ import annotations

import torch
from torch import nn


class VectorQuantizer(nn.Module):
    def __init__(self, n_e: int = 1024, e_dim: int = 256, beta: float = 0.25):
        super().__init__()
        self.beta = beta
        # the codebook, under its Flax name (U(-1/n_e, 1/n_e))
        self.embedding = nn.Parameter(torch.empty(n_e, e_dim))

    def distances(self, flat: torch.Tensor) -> torch.Tensor:
        """(N, e_dim) -> (N, n_e) squared distances to every code."""
        e = self.embedding
        return ((flat ** 2).sum(1, keepdim=True) - 2.0 * flat @ e.T
                + (e ** 2).sum(1)[None, :])

    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """z (B, e_dim, H, W) -> (z_q (B, e_dim, H, W), indices (B, H, W))."""
        b, c, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, c)
        indices = self.distances(flat).argmin(dim=1).reshape(b, h, w)
        return self.lookup(indices), indices

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """Code indices (B, h, w) -> their embeddings (B, e_dim, h, w)."""
        return self.embedding[indices].permute(0, 3, 1, 2)

    def train_forward(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """z (B, e_dim, H, W) -> (z + sg(z_q − z), loss, {"perplexity",
        "indices" (B, H, W)}): the gradient reaches z through the
        straight-through output and the first loss term, the codebook
        through the second."""
        z_q, indices = self(z)
        loss = (torch.mean((z_q.detach() - z) ** 2)
                + self.beta * torch.mean((z_q - z.detach()) ** 2))
        z_st = z + (z_q - z).detach()
        # the one-hot mean over the batch's positions, in f32 as JAX takes it
        usage = torch.bincount(indices.reshape(-1), minlength=self.embedding.shape[0])
        p = usage.to(torch.float32) / indices.numel()
        perplexity = torch.exp(-torch.sum(p * torch.log(p + 1e-10)))
        return z_st, loss, {"perplexity": perplexity, "indices": indices}
