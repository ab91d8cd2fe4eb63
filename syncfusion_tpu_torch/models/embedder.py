"""Embedders of the conditioning audio and text (port of
``syncfusion_tpu/models/embedder.py``).

Both return (B, 1, E) f32 tensors on their device, which the training feed
passes to the trainer as they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from syncfusion_tpu_torch.core.config import model_configs
from syncfusion_tpu_torch.device import default_device


class ZeroEmbedder:
    """Zero (B, 1, E) embeddings: keeps the pipeline shape-identical
    without CLAP (smoke runs, unconditional ablations)."""

    def __init__(self, embedding_features: int = 512, device=None):
        self.embedding_features = embedding_features
        self.device = default_device(device)

    def _zeros(self, rows: int) -> torch.Tensor:
        return torch.zeros((rows, 1, self.embedding_features), device=self.device)

    def embed_audio(self, wav: np.ndarray) -> torch.Tensor:
        return self._zeros(np.asarray(wav).shape[0])

    def embed_text(self, texts: list[str]) -> torch.Tensor:
        return self._zeros(len(texts))


def build_embedder(amodel: str | None, embedding_features: int = 512, device=None,
                   checkpoint_path: Optional[str] = None,
                   tokenizer_path: Optional[str] = None):
    """``amodel`` of the config's embedder node -> an embedder on ``device``:
    None or ``"none"`` gives ``ZeroEmbedder``; ``"HTSAT-tiny"`` gives CLAP
    with the laion checkpoint ``checkpoint_path`` (random weights without
    one)."""
    if amodel in (None, "none"):
        return ZeroEmbedder(embedding_features, device)
    if amodel != "HTSAT-tiny":
        raise ValueError(f"embedder amodel {amodel!r}: the reference's CLAP is "
                         "'HTSAT-tiny'")
    from syncfusion_tpu_torch.models.clap import ClapEmbedder

    return ClapEmbedder(checkpoint_path, tokenizer_path, device=device)


def embedder_from_config(model_cfg: Optional[dict], device=None,
                         checkpoint_path: Optional[str] = None):
    """The embedder of a diffusion config's model node (the JAX package's
    ``build_embedder(cfg.model)``): ``embedder: null`` or ``amodel: none``
    gives zeros and builds no CLAP; otherwise CLAP with ``checkpoint_path``,
    else the node's ``embedder_checkpoint``.  No node (None, or a node
    without ``embedder``) means the config's default, CLAP HTSAT-tiny."""
    node = (model_cfg or {}).get("embedder", {"amodel": "HTSAT-tiny"})
    return build_embedder(
        node.get("amodel") if node else None,
        model_configs(model_cfg)[0].embedding_features, device,
        checkpoint_path=checkpoint_path or (model_cfg or {}).get("embedder_checkpoint"))
