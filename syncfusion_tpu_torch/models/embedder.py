"""Embedders of the conditioning audio (port of
``syncfusion_tpu/models/embedder.py``).

Only ``ZeroEmbedder`` is ported; CLAP is ROADMAP's port queue item 'CLAP'
and raises rather than being replaced by zeros.
"""

from __future__ import annotations

import numpy as np

CLAP_TODO = ("the CLAP embedder is not ported yet (ROADMAP.md, port queue: "
             "'CLAP'); pass embedder 'none' for zero embeddings")


class ZeroEmbedder:
    """Zero (B, 1, E) embeddings: keeps the pipeline shape-identical
    without CLAP weights (smoke runs, unconditional ablations)."""

    def __init__(self, embedding_features: int = 512):
        self.embedding_features = embedding_features

    def embed_audio(self, wav: np.ndarray) -> np.ndarray:
        return np.zeros((np.asarray(wav).shape[0], 1, self.embedding_features),
                        np.float32)


def build_embedder(amodel: str | None, embedding_features: int = 512):
    """``amodel`` of the config's embedder node -> an embedder: None or
    ``"none"`` gives ``ZeroEmbedder``; a CLAP model raises."""
    if amodel in (None, "none"):
        return ZeroEmbedder(embedding_features)
    raise NotImplementedError(f"embedder amodel {amodel!r}: {CLAP_TODO}")
