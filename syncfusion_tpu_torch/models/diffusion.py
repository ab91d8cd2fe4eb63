"""v-objective deterministic sampler (port of
``syncfusion_tpu/models/diffusion.py``: ``v_sample`` without DeepCache).

  * sigmas = linspace(1 -> 0, num_steps + 1); angle = sigma·pi/2,
    alpha = cos, beta = sin
  * per step ``x0 = a_i·x - b_i·v``, ``eps = b_i·x + a_i·v``,
    ``x <- a_{i+1}·x0 + b_{i+1}·eps``
  * CFG: ``v = v_uncond + (v_cond - v_uncond)·scale``, the two branches run
    as ONE forward of batch 2B (the uncond half passes the CFG mask, so the
    net uses its fixed embedding there); with ``guidance_interval=(lo, hi)``
    only steps with lo <= sigma <= hi run the 2B forward, the others the
    conditional branch alone at batch B.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

DEEP_CACHE_TODO = ("DeepCache is not ported yet (ROADMAP.md, port queue: "
                   "'DeepCache split on the plain UNet')")
DPM_TODO = "DPM-Solver++ is not ported yet (ROADMAP.md, port queue: 'DPM++')"


def alpha_beta(sigma):
    angle = sigma * (math.pi / 2)
    return torch.cos(angle), torch.sin(angle)


def guidance_band_mask(num_steps: int, lo: float, hi: float) -> list[bool]:
    """Static CFG-band membership per sampler step (k has sigma = 1 - k/n).

    A band edge landing exactly on a step's sigma includes that step, but
    both ``1 - k/n`` and ``lo*n`` carry float rounding (e.g.
    ``1 - 120/150 < 0.2``), so compare with a tolerance far below 1/n.
    """
    eps = 1e-9
    return [
        lo - eps <= 1.0 - k / num_steps <= hi + eps for k in range(num_steps)
    ]


def band_segments(num_steps: int, lo: float, hi: float) -> list[tuple[int, int, bool]]:
    """Contiguous same-band-membership runs of the sampler's step range:
    ``[(start, end, in_band), ...)`` with ``end`` exclusive."""
    in_band = guidance_band_mask(num_steps, lo, hi)
    segs = []
    start = 0
    while start < num_steps:
        end = start
        while end < num_steps and in_band[end] == in_band[start]:
            end += 1
        segs.append((start, end, in_band[start]))
        start = end
    return segs


def _make_nets(net: Callable, context: Optional[Sequence], embedding,
               embedding_scale: float):
    """``(net_cfg, net_plain, use_cfg)``, each net ``(x, sigma) -> v``.

    ``net_cfg`` runs the conditional and unconditional branches as one
    forward of batch 2B; the doubled context, embedding and mask are built
    once here, not per step.
    """
    use_cfg = embedding is not None and embedding_scale != 1.0

    def net_plain(x, sigma):
        sig = sigma.expand(x.shape[0])
        return net(x, sig, context=context, embedding=embedding)

    if not use_cfg:
        return None, net_plain, False

    b = embedding.shape[0]
    ctx2 = [torch.cat([c, c]) for c in context] if context is not None else None
    emb2 = torch.cat([embedding, torch.zeros_like(embedding)])
    mask = torch.cat([torch.zeros(b, 1, 1), torch.ones(b, 1, 1)]).to(embedding.device)

    def net_cfg(x, sigma):
        x2 = torch.cat([x, x])
        sig2 = sigma.expand(x2.shape[0])
        v2 = net(x2, sig2, context=ctx2, embedding=emb2, embedding_cfg_mask=mask)
        v_cond, v_uncond = v2.chunk(2)
        return v_uncond + (v_cond - v_uncond) * embedding_scale

    return net_cfg, net_plain, True


@torch.no_grad()
def v_sample(net: Callable, noise, num_steps: int, *,
             context: Optional[Sequence] = None, embedding=None,
             embedding_scale: float = 1.0,
             guidance_interval: Optional[tuple[float, float]] = None,
             deep_cache_interval: int = 0):
    """Deterministic v-sampler from pure noise ``(B, L, C)`` (f32).

    ``net(x, sigma, context=, embedding=, embedding_cfg_mask=)`` is the
    UNet.  ``deep_cache_interval > 1`` is not ported yet and raises.
    """
    if deep_cache_interval and deep_cache_interval > 1:
        raise NotImplementedError(DEEP_CACHE_TODO)
    net_cfg, net_plain, use_cfg = _make_nets(net, context, embedding,
                                             embedding_scale)
    sigmas = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32,
                            device=noise.device)

    def run_segment(step_net, x, start, end):
        for i in range(start, end):
            v = step_net(x, sigmas[i])
            a_now, b_now = alpha_beta(sigmas[i])
            a_next, b_next = alpha_beta(sigmas[i + 1])
            x0 = a_now * x - b_now * v
            eps = b_now * x + a_now * v
            x = a_next * x0 + b_next * eps
        return x

    if use_cfg and guidance_interval is not None:
        x = noise
        for start, end, banded in band_segments(num_steps, *guidance_interval):
            x = run_segment(net_cfg if banded else net_plain, x, start, end)
        return x
    return run_segment(net_cfg if use_cfg else net_plain, noise, 0, num_steps)
