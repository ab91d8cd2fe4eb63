"""minGPT conditioned on prepended features, and its uncached sampler
(port of ``syncfusion_tpu/models/mingpt.py``).

The CondFoleyGen stage-2 transformer: a token embedding plus learned
positions, pre-LN blocks (causal multi-head attention, a 4x GELU MLP), a
final LayerNorm and an untied head.  The reference config: vocab 1024,
block 160, 24 layers, 16 heads, width 1024.  ``GPTFeats`` projects the
video features (B, T_c, F) to the width with a Dense (the reference's k=1
Conv1d) and prepends them to the token embeddings; the positions span the
joined sequence.

The attention is plain PyTorch (matmul, the causal mask at -1e10 as the
JAX code writes it, softmax), as the JAX package runs it through XLA: no
hand-written kernel lies on this path.  Submodules carry the Flax names, so
``convert.gpt_state_dict`` of a JAX tree loads with ``strict=True``.
Dropout is 0 in every config and is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from syncfusion_tpu_torch.core.config import GPTConfig

MASKED = -1e10  # the JAX code's mask value, not -inf


def heads(attn: "CausalSelfAttention", x: torch.Tensor):
    """x (B, T, C) -> q, k, v, each (B, H, T, C/H): the qkv Dense's output
    split as (3, H, C/H), as the JAX module splits it."""
    b, t, c = x.shape
    qkv = attn.qkv(x).view(b, t, 3, attn.n_head, c // attn.n_head)
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def attend(q, k, v, causal: bool):
    """softmax(q kᵀ / √d) v over (B, H, Tq, d) x (B, H, Tk, d); ``causal``
    masks key j > query i at -1e10.  Returns (out (B, Tq, H·d), att)."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[-2]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, MASKED)
    att = torch.softmax(logits, dim=-1)
    out = torch.matmul(att, v)
    return out.transpose(1, 2).flatten(2), att


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.n_head = cfg.n_head
        self.qkv = nn.Linear(cfg.n_embd, 3 * cfg.n_embd)
        self.proj = nn.Linear(cfg.n_embd, cfg.n_embd)

    def forward(self, x, return_att: bool = False):
        out, att = attend(*heads(self, x), causal=True)
        out = self.proj(out)
        return (out, att) if return_att else out


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.n_embd, eps=1e-5)
        self.attn = CausalSelfAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.n_embd, eps=1e-5)
        self.mlp_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.mlp_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)

    def feed_forward(self, x):
        """x + MLP(LN2(x)): the second half of the block."""
        return x + self.mlp_proj(F.gelu(self.mlp_fc(self.ln2(x))))

    def forward(self, x, return_att: bool = False):
        h = self.attn(self.ln1(x), return_att=return_att)
        att = None
        if return_att:
            h, att = h
        x = self.feed_forward(x + h)
        return (x, att) if return_att else x


class GPTFeats(nn.Module):
    """GPT conditioned on prepended feature embeddings; ``feat_dim`` is the
    features' width (512, the video net's)."""

    def __init__(self, cfg: GPTConfig = GPTConfig(), feat_dim: int = 512):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.feat_proj = nn.Linear(feat_dim, cfg.n_embd)
        self.pos_emb = nn.Parameter(torch.zeros(cfg.block_size, cfg.n_embd))
        self.blocks = []
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg))
            self.blocks.append(f"h_{i}")
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=1e-5)
        self.head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False)

    def layers(self) -> list[Block]:
        return [getattr(self, name) for name in self.blocks]

    def embed(self, tokens: torch.Tensor, feats: Optional[torch.Tensor]) -> torch.Tensor:
        """The joined (feats ++ tokens) embedding with its positions."""
        x = self.tok_emb(tokens)
        if feats is not None:
            x = torch.cat([self.feat_proj(feats), x], dim=1)
        t = x.shape[1]
        if t > self.cfg.block_size:
            raise ValueError(f"sequence {t} > block {self.cfg.block_size}")
        return x + self.pos_emb[None, :t]

    def forward(self, tokens: torch.Tensor, feats: Optional[torch.Tensor] = None,
                return_att: bool = False):
        """tokens (B, T_z) int, feats (B, T_c, F) -> logits (B, T_c+T_z, V);
        ``return_att`` also returns the last block's attention
        probabilities (B, H, T, T)."""
        x = self.embed(tokens, feats)
        att = None
        layers = self.layers()
        for i, block in enumerate(layers):
            if return_att and i == len(layers) - 1:
                x, att = block(x, return_att=True)
            else:
                x = block(x)
        logits = self.head(self.ln_f(x))
        return (logits, att) if return_att else logits


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Logits below the k-th largest become -inf; every logit tied with the
    k-th stays."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < thresh, float("-inf"))


def gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A categorical draw by the Gumbel-max trick from uniforms ``u`` in
    [0, 1) of the logits' shape: argmax(logits − log(−log u))."""
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def sample_from(logits: torch.Tensor, generator: Optional[torch.Generator],
                temperature: float = 1.0, top_k: Optional[int] = None,
                greedy: bool = False) -> torch.Tensor:
    """One token per row of (B, V) next-token logits: divided by
    ``temperature``, ``top_k``-filtered, then the argmax (``greedy``) or a
    draw from ``generator``."""
    logits = logits / temperature
    if top_k is not None:
        logits = top_k_filter(logits, top_k)
    if greedy:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    return gumbel_argmax(logits, u)


@torch.no_grad()
def sample_tokens(gpt: GPTFeats, feats: Optional[torch.Tensor], prefix: torch.Tensor,
                  steps: int, generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  greedy: bool = False) -> torch.Tensor:
    """Autoregressive sampling with a full causal forward over the whole
    token buffer per step (the reference's loop; ``mingpt_decode`` holds
    the cached one).  prefix (B, P) -> (B, P + steps)."""
    b, p = prefix.shape
    buf = torch.cat([prefix, prefix.new_zeros(b, steps)], dim=1)
    cond = feats.shape[1] if feats is not None else 0
    for i in range(steps):
        logits = gpt(buf, feats)[:, cond + p + i - 1]
        buf[:, p + i] = sample_from(logits, generator, temperature, top_k, greedy)
    return buf
