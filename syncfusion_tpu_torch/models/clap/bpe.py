"""Hermetic RoBERTa tokenization: pure-Python byte-level BPE and a hashed
fallback (a copy of ``syncfusion_tpu/models/clap/bpe.py``, so that the port
needs nothing of the JAX package).

The reference tokenizes text prompts with roberta-base's tokenizer
(laion_clap's get_text_embedding).  Two layers below the transformers path,
neither of which downloads anything:

1. :class:`ByteLevelBPE`: the GPT-2/RoBERTa byte-level BPE (bytes-to-unicode
   table, GPT-2 pre-tokenizer regex, rank-greedy merges) from local
   ``vocab.json``/``merges.txt`` files.  With the real roberta-base files it
   gives the reference token ids.  ``regex`` is imported where it is used.
2. :class:`HashedFallback`: deterministic per-token hashing into the vocab
   range, so that the text path runs (special tokens, shapes and mask
   right) with no files at all.  Its ids are not roberta ids.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BOS, PAD, EOS = 0, 1, 2  # roberta-base <s>, <pad>, </s>
VOCAB_SIZE = 50265

_GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class ByteLevelBPE:
    """GPT-2/RoBERTa byte-level BPE from local vocab.json + merges.txt."""

    def __init__(self, vocab_file: str | Path, merges_file: str | Path):
        import regex

        self.encoder: Dict[str, int] = json.loads(
            Path(vocab_file).read_text(encoding="utf-8")
        )
        merges = Path(merges_file).read_text(encoding="utf-8").splitlines()
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        self.ranks: Dict[Tuple[str, str], int] = {
            tuple(m.split()): i for i, m in enumerate(merges) if m and " " in m
        }
        self.byte_map = bytes_to_unicode()
        self.pattern = regex.compile(_GPT2_PATTERN)
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        unk = self.encoder.get("<unk>", 3)
        for chunk in self.pattern.findall(text):
            mapped = "".join(self.byte_map[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder.get(t, unk) for t in self._bpe(mapped))
        return ids


class HashedFallback:
    """Deterministic stand-in when no tokenizer files exist anywhere."""

    def encode_ids(self, text: str) -> List[int]:
        ids = []
        for chunk in text.strip().split():
            h = int.from_bytes(
                hashlib.sha256(chunk.lower().encode()).digest()[:4], "little"
            )
            ids.append(10 + h % (VOCAB_SIZE - 20))
        return ids


def encode_batch(
    tok, texts: List[str], max_length: int
) -> Dict[str, "np.ndarray"]:
    """roberta post-processing: <s> ids </s>, truncate, pad with <pad>=1."""
    import numpy as np

    input_ids = np.full((len(texts), max_length), PAD, np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    for r, text in enumerate(texts):
        ids = [BOS] + tok.encode_ids(text)[: max_length - 2] + [EOS]
        input_ids[r, : len(ids)] = ids
        mask[r, : len(ids)] = 1
    return {"input_ids": input_ids, "attention_mask": mask}


def find_bpe_files(path: Optional[str]) -> Optional[Tuple[Path, Path]]:
    if not path:
        return None
    p = Path(path)
    d = p if p.is_dir() else p.parent
    vocab, merges = d / "vocab.json", d / "merges.txt"
    return (vocab, merges) if vocab.exists() and merges.exists() else None
