"""v-objective diffusion: training loss and deterministic samplers (port of
``syncfusion_tpu/models/diffusion.py``: ``v_diffusion_loss``, ``v_sample``
and ``dpm_sample``, both with DeepCache).

  * loss: ``sigma ~ U(0, 1)`` per row, ``x_noisy = alpha·x + beta·eps``,
    target ``v = alpha·eps - beta·x``, MSE of the net's v against it
  * sigmas = linspace(1 -> 0, num_steps + 1); angle = sigma·pi/2,
    alpha = cos, beta = sin
  * per step ``x0 = a_i·x - b_i·v``, ``eps = b_i·x + a_i·v``,
    ``x <- a_{i+1}·x0 + b_{i+1}·eps``
  * CFG: ``v = v_uncond + (v_cond - v_uncond)·scale``, the two branches run
    as ONE forward of batch 2B (the uncond half passes the CFG mask, so the
    net uses its fixed embedding there); with ``guidance_interval=(lo, hi)``
    only steps with lo <= sigma <= hi run the 2B forward, the others the
    conditional branch alone at batch B.
  * DeepCache (``deep_cache_interval=K > 1`` with ``deep_split``): the
    UNet's deep half runs on the steps of ``deep_cache_refresh_mask`` and
    its feature is reused in between; the cache starts afresh at every band
    segment, where the batch changes between B and 2B.
  * DPM-Solver++(2M) (``dpm_sample``): the same net and CFG, a second-order
    multistep update from host-side float64 coefficients.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def alpha_beta(sigma):
    angle = sigma * (math.pi / 2)
    return torch.cos(angle), torch.sin(angle)


def v_diffusion_loss(net: Callable, x, *, context: Optional[Sequence] = None,
                     embedding=None, embedding_mask_proba: float = 0.0,
                     sigma=None, noise=None, embedding_cfg_mask=None,
                     generator: Optional[torch.Generator] = None):
    """Training loss on waveforms ``x`` (B, L, C), a 0-dim f32 tensor.

    ``sigma`` (B,), ``noise`` (like ``x``) and the CFG-dropout mask
    (B, 1, 1) may be passed in; what is absent is drawn from ``generator``
    (the JAX package draws all three from one key: the numbers differ, the
    distributions do not).
    """
    if sigma is None:
        sigma = torch.rand((x.shape[0],), generator=generator, device=x.device)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
    alpha, beta = alpha_beta(sigma.reshape(-1, *([1] * (x.dim() - 1))))
    x_noisy = alpha * x + beta * noise
    v_target = alpha * noise - beta * x
    v_pred = net(x_noisy, sigma, context=context, embedding=embedding,
                 embedding_cfg_mask=embedding_cfg_mask,
                 embedding_mask_proba=embedding_mask_proba, generator=generator)
    return torch.mean(torch.square(v_pred - v_target))


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
               embedding_scale: float, deep_split: int = 0):
    """``(net_cfg, net_plain, use_cfg)``, each net ``(x, sigma, cache=None,
    want_deep=False) -> (v, deep)``.

    ``net_cfg`` runs the conditional and unconditional branches as one
    forward of batch 2B; the doubled context, embedding and mask are built
    once here, not per step.  With ``deep_split`` set, ``cache`` takes the
    place of the UNet's deep half and ``want_deep`` returns the fresh deep
    feature; otherwise ``deep`` is None.
    """
    use_cfg = embedding is not None and embedding_scale != 1.0

    def deep_kw(cache, want_deep):
        if not deep_split:
            assert cache is None and not want_deep, "deep-cache kwargs require deep_split"
            return {}
        return {"deep_split": deep_split, "deep_cache": cache, "return_deep": want_deep}

    def call(x, sigma, cache, want_deep, **kw):
        out = net(x, sigma.expand(x.shape[0]), **kw, **deep_kw(cache, want_deep))
        return out if want_deep else (out, None)

    def net_plain(x, sigma, cache=None, want_deep=False):
        return call(x, sigma, cache, want_deep, context=context, embedding=embedding)

    if not use_cfg:
        return None, net_plain, False

    b = embedding.shape[0]
    ctx2 = [torch.cat([c, c]) for c in context] if context is not None else None
    emb2 = torch.cat([embedding, torch.zeros_like(embedding)])
    mask = torch.cat([torch.zeros(b, 1, 1), torch.ones(b, 1, 1)]).to(embedding.device)

    def net_cfg(x, sigma, cache=None, want_deep=False):
        v2, deep = call(torch.cat([x, x]), sigma, cache, want_deep, context=ctx2,
                        embedding=emb2, embedding_cfg_mask=mask)
        v_cond, v_uncond = v2.chunk(2)
        return v_uncond + (v_cond - v_uncond) * embedding_scale, deep

    return net_cfg, net_plain, True


def _normalize_deep_cache(deep_cache_interval: int, deep_split: int) -> int:
    """The samplers' enabling rule: K (0 = off; intervals of 0 and 1 turn
    it off); raises when K is set without a split level."""
    K = deep_cache_interval if deep_cache_interval and deep_cache_interval > 1 else 0
    if K and not deep_split:
        raise ValueError("deep_cache_interval requires deep_split")
    return K


def deep_cache_refresh_mask(seg_len: int, K: int, pow: float = 1.0) -> list[bool]:
    """Per-step deep-refresh mask of one sampler segment of ``seg_len``
    steps with DeepCache interval ``K`` (a copy of the JAX package's).

    ``pow=1``: refresh at segment-local j % K == 0.  ``pow != 1`` keeps the
    same refresh count, ceil(seg_len/K), at j_k = floor(seg_len·(k/n)^(1/pow)):
    ``pow > 1`` refreshes densest toward the segment's end (low sigma),
    ``pow < 1`` toward its start.  The segment's first step always
    refreshes.
    """
    n = -(-seg_len // K)
    if pow == 1.0:
        return [j % K == 0 for j in range(seg_len)]
    raw = [int(seg_len * (k / n) ** (1.0 / pow)) for k in range(n)]
    # two clamps keep the n positions distinct (a plain clamp to seg_len-1
    # collides the tail at large pow): backward, leave room for the
    # refreshes after k; forward, strictly increasing
    for k in range(n - 1, -1, -1):
        raw[k] = min(raw[k], seg_len - 1 - (n - 1 - k))
    mask = [False] * seg_len
    prev = -1
    for j in raw:
        j = max(j, prev + 1)
        mask[j] = True
        prev = j
    return mask


def _run_steps(net: Callable, update: Callable, carry: tuple, start: int, end: int,
               K: int = 0, pow: float = 1.0) -> tuple:
    """Sampler steps ``start..end-1`` of one band segment.  ``net(x, i,
    cache, want_deep) -> (v, deep)`` takes the global step index;
    ``update(carry, i, v)`` is the sampler's step; ``carry`` is a tuple whose
    first element is x.  With ``K`` the net runs whole (returning the deep
    feature) on the refresh steps of ``deep_cache_refresh_mask`` and on the
    cached feature otherwise; the first step of a segment always refreshes,
    so no cache crosses a change of batch."""
    refresh = (deep_cache_refresh_mask(end - start, K, pow) if K
               else [False] * (end - start))
    assert not K or refresh[0], "segment start must refresh the deep cache"
    cache = None
    for i, fresh in zip(range(start, end), refresh):
        if not K:
            v, _ = net(carry[0], i, None, False)
        elif fresh:
            v, cache = net(carry[0], i, None, True)
        else:
            v, _ = net(carry[0], i, cache, False)
        carry = update(carry, i, v)
    return carry


def _run(nets: tuple, sigma_of, update: Callable, carry: tuple, num_steps: int,
         guidance_interval, K: int, pow: float) -> tuple:
    """All ``num_steps`` steps: one segment, or the band's segments with
    the CFG net inside the band and the conditional one outside."""
    net_cfg, net_plain, use_cfg = nets

    def stepper(net):
        return lambda x, i, cache, want: net(x, sigma_of(i), cache, want)

    if use_cfg and guidance_interval is not None:
        for start, end, banded in band_segments(num_steps, *guidance_interval):
            carry = _run_steps(stepper(net_cfg if banded else net_plain), update,
                               carry, start, end, K, pow)
        return carry
    return _run_steps(stepper(net_cfg if use_cfg else net_plain), update, carry,
                      0, num_steps, K, pow)


@torch.no_grad()
def v_sample(net: Callable, noise, num_steps: int, *,
             context: Optional[Sequence] = None, embedding=None,
             embedding_scale: float = 1.0,
             guidance_interval: Optional[tuple[float, float]] = None,
             deep_cache_interval: int = 0, deep_split: int = 0,
             deep_cache_pow: float = 1.0):
    """Deterministic v-sampler from pure noise ``(B, L, C)`` (f32).

    ``net(x, sigma, context=, embedding=, embedding_cfg_mask=)`` is the
    UNet, which also takes the deep kwargs when ``deep_cache_interval > 1``
    (with ``deep_split``, refresh cadence ``deep_cache_pow``).
    """
    K = _normalize_deep_cache(deep_cache_interval, deep_split)
    nets = _make_nets(net, context, embedding, embedding_scale,
                      deep_split if K else 0)
    sigmas = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32,
                            device=noise.device)

    def update(carry, i, v):
        (x,) = carry
        a_now, b_now = alpha_beta(sigmas[i])
        a_next, b_next = alpha_beta(sigmas[i + 1])
        x0 = a_now * x - b_now * v
        eps = b_now * x + a_now * v
        return (a_next * x0 + b_next * eps,)

    (x,) = _run(nets, sigmas.__getitem__, update, (noise,), num_steps,
                guidance_interval, K, deep_cache_pow)
    return x


def _dpm_coefficients(num_steps: int, device=None) -> tuple:
    """Per-step DPM-Solver++(2M) coefficients of the trig schedule, computed
    on the host in float64 as the JAX package does (λ = log(α/β) is -inf at
    σ = 1 and +inf at σ = 0, so the first and last steps reduce exactly to
    first order and no infinity reaches the device), then cast to f32.

    Returns f32 tensors of shape (num_steps,): ``sig, a, b`` at each step's
    start, ``c2`` (the extrapolation weight h_k/(2·h_{k-1}), zero where a
    neighbouring h is infinite and on the last step), ``rb`` (β_{k+1}/β_k)
    and ``cD`` (-α_{k+1}(e^{-h_k} - 1)).
    """
    sig = np.linspace(1.0, 0.0, num_steps + 1)
    a = np.where(sig == 1.0, 0.0, np.cos(sig * np.pi / 2))  # cos(π/2) ≈ 6e-17
    b = np.sin(sig * np.pi / 2)                              # sin(0) is exact
    with np.errstate(divide="ignore"):
        lam = np.log(a) - np.log(b)
    h = lam[1:] - lam[:-1]                                   # h[0] = h[-1] = inf
    rb = b[1:] / b[:-1]
    with np.errstate(over="ignore"):
        eh = np.exp(-h)
    cD = -a[1:] * (eh - 1.0)
    c2 = np.zeros(num_steps)
    for k in range(1, num_steps - 1):
        if np.isfinite(h[k - 1]) and np.isfinite(h[k]):
            c2[k] = h[k] / (2.0 * h[k - 1])
    return tuple(torch.tensor(v.astype(np.float32), device=device)
                 for v in (sig[:-1], a[:-1], b[:-1], c2, rb, cD))


@torch.no_grad()
def dpm_sample(net: Callable, noise, num_steps: int, *,
               context: Optional[Sequence] = None, embedding=None,
               embedding_scale: float = 1.0,
               guidance_interval: Optional[tuple[float, float]] = None,
               deep_cache_interval: int = 0, deep_split: int = 0,
               deep_cache_pow: float = 1.0):
    """DPM-Solver++(2M) (Lu et al. 2022, arXiv:2211.01095) on the ODE of
    ``v_sample``, with the same net, CFG, band and DeepCache.

    Per step, with x0_k = α_k·x - β_k·v(x, σ_k) and h = λ_{k+1} - λ_k:
      D_k = (1 + c2_k)·x0_k - c2_k·x0_{k-1}
      x_{k+1} = (β_{k+1}/β_k)·x - α_{k+1}(e^{-h} - 1)·D_k
    The carry (x, x0_prev) threads through band segments and cached steps.
    """
    K = _normalize_deep_cache(deep_cache_interval, deep_split)
    nets = _make_nets(net, context, embedding, embedding_scale,
                      deep_split if K else 0)
    sig, a, b, c2, rb, cD = _dpm_coefficients(num_steps, noise.device)

    def update(carry, i, v):
        x, x0_prev = carry
        x0 = a[i] * x - b[i] * v
        d = (1.0 + c2[i]) * x0 - c2[i] * x0_prev
        return (rb[i] * x + cD[i] * d, x0)

    x, _ = _run(nets, sig.__getitem__, update, (noise, torch.zeros_like(noise)),
                num_steps, guidance_interval, K, deep_cache_pow)
    return x
