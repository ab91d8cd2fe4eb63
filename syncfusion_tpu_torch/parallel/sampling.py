"""Data-parallel batched sampling over a mesh, the serving path (port of
``syncfusion_tpu/parallel/sampling.py``).

The UNet fits one card, so generation scales by pure data parallelism: the
parameters are replicated (every rank builds or restores the same ones),
and each rank samples its own slice of the clip batch.  No collective runs
in steady state: every rank is given the same global conditioning and the
same seed, draws the global noise on its card, and samples its own rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from syncfusion_tpu_torch.core.mesh import Mesh


class DataParallelSampler:
    """Batched sampler over a mesh, ``per_chip_batch`` clips a rank a call;
    callers pass global batches of ``per_chip_batch · data ranks`` onset
    tracks and embeddings.

    The serving default applies CFG only in the sigma band (0.2, 0.8);
    ``guidance_interval=None`` applies it at every step, as the reference
    does.  The operating points of the JAX class:

    * quality default: ``num_steps=150``, the band and
      ``deep_cache_interval=4``;
    * fast point: ``sampler="dpm", num_steps=32, embedding_scale=1.5``, the
      band and ``deep_cache_interval=2``.
    """

    def __init__(self, model, mesh: Optional[Mesh] = None, num_steps: int = 150,
                 embedding_scale: float = 2.0, per_chip_batch: int = 8,
                 length: int = 2**18, guidance_interval=(0.2, 0.8),
                 sampler: str = "ddim", deep_cache_interval: int = 0,
                 deep_split: int = 4, deep_cache_pow: float = 1.0):
        self.model = model
        self.mesh = mesh or Mesh.single()
        self.length = length
        self.batch = per_chip_batch * self.mesh.data
        self.options = dict(
            num_steps=num_steps, embedding_scale=embedding_scale,
            guidance_interval=guidance_interval, sampler=sampler,
            deep_cache_interval=deep_cache_interval, deep_split=deep_split,
            deep_cache_pow=deep_cache_pow)

    def __call__(self, onsets, embedding, generator: torch.Generator) -> torch.Tensor:
        """onsets (B, L, 1) and embedding (B, 1, E) of the global batch
        (numpy or tensors), noise from ``generator`` (on the model's
        device, seeded alike on every rank) -> this rank's waveforms (b, L)
        on its device, the rows ``local_indices()`` names."""
        if onsets.shape[0] != self.batch:
            raise ValueError(f"expected global batch {self.batch}, got {onsets.shape[0]}")
        device = next(self.model.parameters()).device
        noise = torch.randn((self.batch, self.length, 1), generator=generator,
                            device=device)
        rows = self.mesh.rows(self.batch)
        onsets, embedding = (torch.as_tensor(x)[rows].to(device)
                             for x in (onsets, embedding))
        return self.model.sample(noise[rows], onsets, embedding, **self.options)[:, :, 0]

    def local_indices(self) -> np.ndarray:
        """The global row indices this rank samples."""
        rows = self.mesh.rows(self.batch)
        return np.arange(rows.start, rows.stop)
