"""RoBERTa-base text encoder of the CLAP text tower (port of
``syncfusion_tpu/models/clap/roberta.py``).

Post-LayerNorm BERT layers (eps 1e-5, exact GELU) with RoBERTa's learned
positions, ``cumsum(mask)·mask + pad_id`` (the first token sits at 2), vocab
50265, 12 layers x 12 heads x 768.  Padding enters the attention as a bias of
``(1 - mask)·-1e9`` on the keys.  Submodules carry the Flax names
(``convert.clap_state_dict``).

``tokenize`` keeps the JAX package's chain and its order: transformers'
tokenizer from local files, then ``vocab.json``/``merges.txt`` through the
pure-Python BPE, then the hashed fallback.  ``transformers`` and ``regex``
are imported only where they are used: the card's machine may lack both.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.models.clap import bpe

LN_EPS = 1e-5


class RobertaEmbeddings(nn.Module):
    def __init__(self, vocab_size: int = 50265, hidden: int = 768,
                 max_positions: int = 514, type_vocab: int = 1, pad_token_id: int = 1):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_positions, hidden)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        mask = (input_ids != self.pad_token_id).long()
        positions = torch.cumsum(mask, dim=1) * mask + self.pad_token_id
        x = (self.word_embeddings(input_ids) + self.position_embeddings(positions)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class RobertaLayer(nn.Module):
    def __init__(self, hidden: int = 768, heads: int = 12, intermediate: int = 3072):
        super().__init__()
        self.heads = heads
        self.attention_q = nn.Linear(hidden, hidden)
        self.attention_k = nn.Linear(hidden, hidden)
        self.attention_v = nn.Linear(hidden, hidden)
        self.attention_out = nn.Linear(hidden, hidden)
        self.attention_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.intermediate = nn.Linear(hidden, intermediate)
        self.output = nn.Linear(intermediate, hidden)
        self.output_norm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, length, hidden = x.shape
        hd = hidden // self.heads
        q, k, v = (proj(x).reshape(b, length, self.heads, hd)
                   for proj in (self.attention_q, self.attention_k, self.attention_v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
        probs = (logits + attn_bias[:, None, None, :]).softmax(-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, length, hidden)
        x = self.attention_norm(x + self.attention_out(ctx))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.output_norm(x + h)


class RobertaModel(nn.Module):
    """(input_ids, attention_mask) (B, L) -> last hidden states (B, L, H)."""

    def __init__(self, num_layers: int = 12, hidden: int = 768, heads: int = 12,
                 intermediate: int = 3072, vocab_size: int = 50265,
                 max_positions: int = 514):
        super().__init__()
        self.num_layers = num_layers
        self.embeddings = RobertaEmbeddings(vocab_size, hidden, max_positions)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", RobertaLayer(hidden, heads, intermediate))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids)
        bias = (1.0 - attention_mask.float()) * -1e9
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        return x


# the tokenizer the first call chose, kept for the process as the JAX
# package keeps its own
_TOKENIZER = None


def tokenize(texts: list[str], max_length: int = 77,
             tokenizer_path: Optional[str] = None) -> dict[str, np.ndarray]:
    """RoBERTa tokenization -> ``{"input_ids", "attention_mask"}`` int
    arrays (B, max_length), ``<s> ids </s>`` padded with ``<pad>``.

    The first call picks, in this order: transformers' ``AutoTokenizer``
    (``tokenizer_path``, else roberta-base, from local files only: the port
    downloads nothing, where the JAX package would fetch a hub name); the
    pure-Python BPE on ``vocab.json``/``merges.txt`` beside
    ``tokenizer_path`` (the same ids); the hashed fallback (no files; ids
    that are not roberta's, logged as a warning).
    """
    global _TOKENIZER
    if _TOKENIZER is None:
        try:
            from transformers import AutoTokenizer

            hf = AutoTokenizer.from_pretrained(tokenizer_path or "roberta-base",
                                               local_files_only=True)

            def _hf(texts, max_length):
                enc = hf(texts, padding="max_length", truncation=True,
                         max_length=max_length, return_tensors="np")
                return {"input_ids": np.asarray(enc["input_ids"]),
                        "attention_mask": np.asarray(enc["attention_mask"])}

            _TOKENIZER = _hf
        except Exception as e:  # ImportError, or no local files (OSError, ValueError)
            files = bpe.find_bpe_files(tokenizer_path)
            if files is not None:
                tok = bpe.ByteLevelBPE(*files)
            else:
                logging.getLogger("syncfusion_tpu_torch.clap").warning(
                    "no roberta tokenizer files available (%s): using the hashed "
                    "fallback; text conditioning runs but its token ids are not "
                    "roberta ids (models/clap/bpe.py)", e)
                tok = bpe.HashedFallback()

            def _encode(texts, max_length):
                return bpe.encode_batch(tok, texts, max_length)

            _TOKENIZER = _encode
    return _TOKENIZER(texts, max_length)
