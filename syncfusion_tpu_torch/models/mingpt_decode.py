"""KV-cached autoregressive decoding for ``GPTFeats`` (port of
``sample_tokens_cached`` of ``syncfusion_tpu/models/mingpt_decode.py``).

One prefill pass over the features and the prefix fills each layer's key
and value cache, sized ``cond + prefix + steps`` (at most the block size);
then each step runs one token through the layers, attending to the cache's
first ``pos + 1`` entries, at position ``cond + prefix + i``.  The JAX
``lax.scan`` over the steps is a Python loop here.  Draws come from an
explicit ``torch.Generator``; ``greedy`` takes the argmax.
"""

from __future__ import annotations

from typing import Optional

import torch

from syncfusion_tpu_torch.models.mingpt import GPTFeats, attend, heads, sample_from


def _block_prefill(block, x, k_cache, v_cache):
    """Full causal pass of ``block`` over x (B, T, C); writes the keys and
    values into the caches' first T positions."""
    q, k, v = heads(block.attn, block.ln1(x))
    t = x.shape[1]
    k_cache[:, :, :t], v_cache[:, :, :t] = k, v
    out, _ = attend(q, k, v, causal=True)
    return block.feed_forward(x + block.attn.proj(out))


def _block_step(block, x, k_cache, v_cache, pos: int):
    """One token x (B, 1, C) at position ``pos``: its key and value go into
    the caches, its query attends to positions 0..pos."""
    q, k, v = heads(block.attn, block.ln1(x))
    k_cache[:, :, pos:pos + 1], v_cache[:, :, pos:pos + 1] = k, v
    out, _ = attend(q, k_cache[:, :, :pos + 1], v_cache[:, :, :pos + 1], causal=False)
    return block.feed_forward(x + block.attn.proj(out))


@torch.no_grad()
def sample_tokens_cached(gpt: GPTFeats, feats: Optional[torch.Tensor],
                         prefix: torch.Tensor, steps: int,
                         generator: Optional[torch.Generator] = None,
                         temperature: float = 1.0, top_k: Optional[int] = None,
                         greedy: bool = False) -> torch.Tensor:
    """The cached counterpart of ``mingpt.sample_tokens``: prefix (B, P) ->
    (B, P + steps)."""
    cfg = gpt.cfg
    b, pre = prefix.shape
    cond = feats.shape[1] if feats is not None else 0
    total = cond + pre + steps
    if total > cfg.block_size:
        raise ValueError(f"{cond} + {pre} + {steps} positions > block {cfg.block_size}")
    hd = cfg.n_embd // cfg.n_head
    x = gpt.embed(prefix, feats)
    caches = []
    for block in gpt.layers():
        k_cache = x.new_empty(b, cfg.n_head, total, hd)
        v_cache = x.new_empty(b, cfg.n_head, total, hd)
        x = _block_prefill(block, x, k_cache, v_cache)
        caches.append((k_cache, v_cache))

    buf = torch.cat([prefix, prefix.new_zeros(b, steps)], dim=1)
    logits = gpt.head(gpt.ln_f(x[:, -1]))
    buf[:, pre] = sample_from(logits, generator, temperature, top_k, greedy)
    for i in range(steps - 1):
        pos = cond + pre + i
        x = gpt.tok_emb(buf[:, pre + i])[:, None] + gpt.pos_emb[pos]
        for block, (k_cache, v_cache) in zip(gpt.layers(), caches):
            x = _block_step(block, x, k_cache, v_cache, pos)
        logits = gpt.head(gpt.ln_f(x[:, 0]))
        buf[:, pre + i + 1] = sample_from(logits, generator, temperature, top_k, greedy)
    return buf
