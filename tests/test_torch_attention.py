"""The port's attention against the JAX package's.

On the CPU, ``flash_attention`` takes the plain version; it is held against
the Pallas kernel run in interpret mode (``block_q = block_k = 128``, as
tests/test_attention.py runs it) and against ``attention_reference``, O and
the row LSE, causal and not.  Tolerance 2e-5 abs in f32, as
tests/test_attention.py holds the Pallas kernel.  The arithmetic of the
bf16 tensor-core kernel is modelled here in plain PyTorch and held to the
card's bf16 tolerance, and so is its rule on alignment; the f32 kernel's
(3xTF32 products over 64-key tiles) is held to the card's f32 tolerance.
The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from syncfusion_tpu.ops import attention as ja
from syncfusion_tpu_torch.ops import attention as ta
from torch_port_helpers import THREE_TF32, mm_tf32, n, t

TOL = dict(rtol=0, atol=2e-5)


def _qkv(b, l, h, d, seed):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((b, l, h, d))).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,l,h,d", [(1, 512, 2, 64), (2, 256, 4, 32)])
def test_plain_attention_matches_pallas_interpret(b, l, h, d, causal):
    q, k, v = _qkv(b, l, h, d, seed=l + h)
    want = ja.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              block_q=128, block_k=128, interpret=True)
    qf, kf, vf = (ja._fold_heads(jnp.asarray(x)) for x in (q, k, v))
    _, want_lse = ja._flash_fwd(qf, kf, vf, causal, 128, 128,
                                1.0 / math.sqrt(d), True)
    got, got_lse = ta.attention_reference(t(q), t(k), t(v), causal, return_lse=True)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(got_lse), n(want_lse).reshape(b, h, l), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_reference_ragged(causal):
    q, k, v = _qkv(2, 300, 2, 64, seed=7)
    want = ja.attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = ta.attention_reference(t(q), t(k), t(v), causal)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_cpu_tensors_take_the_plain_path():
    q, k, v = map(t, _qkv(1, 64, 2, 64, seed=3))
    before = (ta.flash_attention.kernel_launches, ta.flash_attention.plain_calls)
    o, lse = ta.flash_attention(q, k, v, return_lse=True)
    want, want_lse = ta.attention_reference(q, k, v, return_lse=True)
    assert torch.equal(o, want) and torch.equal(lse, want_lse)
    assert ta.flash_attention.kernel_launches == before[0]
    assert ta.flash_attention.plain_calls == before[1] + 1


# The bf16 tensor-core kernel's arithmetic, in plain PyTorch on the CPU: its
# schedule of 64-query x 64-key tiles (causal tiles past the diagonal
# skipped), S in f32 times scale·log2(e), exp2, the row max and the row sum
# of the f32 P, P into P·V as bf16 (hi + lo, or once rounded), O rounded to
# bf16 once, LSE = (m2 + log2 l)·ln 2.  Held to the card's bf16 tolerances
# (tests/test_torch_cuda.py, chip_smoke.py): O 8e-3, LSE 1e-4.
BF16_TOL = {"o": 8e-3, "lse": 1e-4}
TILE = 64


def _tc_schedule(q, k, v, causal, split_p=True):
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, L, D)
    sl = math.log2(math.e) / math.sqrt(d)
    o = torch.empty(b, h, lq, d)
    lse = torch.empty(b, h, lq)
    for q0 in range(0, lq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, lq))
        m = torch.full((b, h, len(rows)), -math.inf)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        stop = min(lk, q0 + TILE) if causal else lk
        for k0 in range(0, stop, TILE):
            keys = torch.arange(k0, min(k0 + TILE, lk))
            s = (qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)) * sl
            if causal:
                s = s.masked_fill(keys[None, :] > rows[:, None], -math.inf)
            mx = torch.maximum(m, s.amax(-1))
            shift = torch.where(mx == -math.inf, 0.0, mx)
            alpha = torch.exp2(m - shift)
            p = torch.exp2(s - shift[..., None])
            l = l * alpha + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vf[:, :, keys]
            if split_p:
                pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[:, :, keys]
            acc = acc * alpha[..., None] + pv
            m = mx
        ls = l.clamp_min(1e-30)
        o[:, :, rows] = acc / ls[..., None]
        lse[:, :, rows] = (m + torch.log2(ls)) * math.log(2)
    return o.transpose(1, 2).to(torch.bfloat16), lse


def _bf16_qkv(b, l, h, seed):
    rng = np.random.default_rng(seed)
    return [t(rng.standard_normal((b, l, h, 64)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,l,h,block", [(2, 256, 4, 128), (2, 1000, 4, 200),
                                         (1, 2048, 2, 512)])
def test_tensor_core_schedule_within_bf16_tolerance(b, l, h, block, causal):
    """The kernel's arithmetic against ``attention_reference`` and the JAX
    package's Pallas kernel (interpret mode) on the same bf16 inputs."""
    q, k, v = _bf16_qkv(b, l, h, seed=l + int(causal))
    o, lse = _tc_schedule(q, k, v, causal)
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    qf, kf, vf = (ja._fold_heads(jnp.asarray(n(x.float()))) for x in (q, k, v))
    jo, jlse = ja._flash_fwd(qf, kf, vf, causal, block, block, 1.0 / 8, True)
    jo = n(ja._unfold_heads(jo, b, h))
    jlse = n(jlse).reshape(b, h, l)
    for ref_o, ref_lse in ((n(want.float()), n(want_lse)), (jo, jlse)):
        assert np.abs(n(o.float()) - ref_o).max() <= BF16_TOL["o"]
        assert np.abs(n(lse) - ref_lse).max() <= BF16_TOL["lse"]


def test_p_rounded_once_breaks_the_causal_bf16_gate():
    """Why the kernel feeds P to P·V as hi + lo bf16: P rounded to bf16 once
    moves O by up to 2^-9 of |O|, and in a causal head's first rows (|O| of
    2-4) that flips the bf16 O by a whole ulp, 2^-6 > 8e-3.  chip_smoke.py's
    causal shape, BH = 64, T = 512."""
    q, k, v = _bf16_qkv(8, 512, 8, seed=0)
    want = ta.attention_reference(q, k, v, True).float()
    once, _ = _tc_schedule(q, k, v, True, split_p=False)
    split, _ = _tc_schedule(q, k, v, True)
    assert (once.float() - want).abs().max().item() > BF16_TOL["o"]
    assert (split.float() - want).abs().max().item() <= BF16_TOL["o"]


def _views(b=2, l=64, h=8):
    """q, k, v as the UNet makes them: views of one (B, L, 3, H, 64) qkv."""
    return torch.zeros((b, l, 3, h, 64), dtype=torch.bfloat16).unbind(2)


def test_qkv_views_are_aligned_for_cp_async():
    for name, x in zip("qkv", _views()):
        assert ta.cp_async_misalignment(name, x.data_ptr(), x.shape[:3],
                                        x.stride()[:3]) is None
    ta._check_aligned(**dict(zip("qkv", _views())))


@pytest.mark.parametrize("ptr,shape,strides,reason", [
    (8, (2, 64, 8), (98304, 1536, 64), "data_ptr 0x8 is not 16-byte aligned"),
    (16, (2, 64, 8), (98304, 1537, 64), "L stride 1537 is not a multiple of 8"),
    (16, (2, 64, 8), (98304, 1536, 66), "H stride 66 is not a multiple of 8"),
    (16, (2, 64, 8), (98300, 1536, 64), "B stride 98300 is not a multiple of 8"),
    (16, (1, 64, 8), (3, 1536, 64), None),  # a dim of size 1 is never strided
])
def test_cp_async_misalignment_names_the_reason(ptr, shape, strides, reason):
    got = ta.cp_async_misalignment("q", ptr, shape, strides)
    assert got == reason if reason is None else reason in got


def test_misaligned_bf16_input_raises():
    """A bf16 view whose L stride is not a multiple of 8 elements, and one
    whose address is off 16 bytes, raise ValueError with the reason."""
    base = torch.zeros((2, 64, 8 * 64 + 1), dtype=torch.bfloat16)
    q = base[..., :512].unflatten(-1, (8, 64))
    with pytest.raises(ValueError, match="L stride 513"):
        ta._check_aligned(q=q)
    flat = torch.zeros(2 * 64 * 512 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(2, 64, 8, 64)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        ta._check_aligned(q=q)


# The f32 kernel's arithmetic, in plain PyTorch on the CPU: S = q Kᵀ and
# P·V through ``mm_tf32`` (3xTF32, or one TF32 product as a control) over
# 64-key tiles; the online softmax in the log2 domain with the running max
# carried from tile to tile; each tile's P·V terms in a partial sum that
# starts at 0 and is added to O in f32; LSE = (m2 + log2 l)·ln 2.  Causal
# tiles past the diagonal, which the kernel skips, add exact zeros here.
# Held to the card's f32 gate (chip_smoke.TOL, tests/test_torch_cuda.py):
# max |error| <= 1e-4 for O and for the LSE.
F32_TOL = {"o": 1e-4, "lse": 1e-4}


def _tf32_schedule(q, k, v, causal, passes=THREE_TF32):
    lq, lk, d = q.shape[1], k.shape[1], q.shape[-1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, L, D)
    tiles = -(-lk // TILE)
    kf, vf = (F.pad(x, (0, 0, 0, tiles * TILE - lk)) for x in (kf, vf))
    keys = torch.arange(tiles * TILE)
    masked = (keys >= lk)[None, :].expand(lq, -1)
    if causal:
        masked = masked | (keys[None, :] > torch.arange(lq)[:, None])
    s = mm_tf32(qf, kf.transpose(-1, -2), passes).masked_fill(masked, -math.inf)
    s = s.unflatten(-1, (tiles, TILE)).movedim(-2, 2)  # (B, H, tiles, Lq, 64)
    sl = math.log2(math.e) / math.sqrt(d)
    m = torch.cummax(s.amax(-1) * sl, dim=2).values  # running max after a tile
    shift = torch.where(m == -math.inf, 0.0, m)
    p = torch.exp2(s * sl - shift[..., None])
    parts = mm_tf32(p, vf.unflatten(2, (tiles, TILE)), passes)
    acc = torch.zeros_like(parts[:, :, 0])
    l = torch.zeros_like(p[:, :, 0, :, 0])
    m_prev = torch.full_like(l, -math.inf)
    for i in range(tiles):
        alpha = torch.exp2(m_prev - shift[:, :, i])
        acc = acc * alpha[..., None] + parts[:, :, i]
        l = l * alpha + p[:, :, i].sum(-1)
        m_prev = m[:, :, i]
    ls = l.clamp_min(1e-30)
    return (acc / ls[..., None]).transpose(1, 2), (m_prev + torch.log2(ls)) * math.log(2)


def _f32_errors(heads, causal, seed, passes=THREE_TF32):
    """max |model - plain| of O and of the LSE at T = 2048, inputs of unit
    variance as chip_smoke.py draws them."""
    rng = np.random.default_rng(seed)
    q, k, v = (t(rng.standard_normal((1, 2048, heads, 64)).astype(np.float32))
               for _ in range(3))
    o, lse = _tf32_schedule(q, k, v, causal, passes)
    want, want_lse = ta.attention_reference(q, k, v, causal, return_lse=True)
    return (o - want).abs().max().item(), (lse - want_lse).abs().max().item()


@pytest.mark.parametrize("heads,causal", [(2, False), (1, True)])
def test_three_tf32_forward_holds_the_f32_gate(heads, causal):
    """The f32 kernel's arithmetic at the UNet's longest attention level
    (T = 2048, D = 64) stays within the card's f32 gate of the plain
    version, O and LSE."""
    err_o, err_lse = _f32_errors(heads, causal, seed=heads)
    assert err_o <= F32_TOL["o"] and err_lse <= F32_TOL["lse"], (err_o, err_lse)


def test_one_tf32_product_breaks_the_f32_forward_gate():
    """Why the f32 kernel splits its operands: S and P·V on plain TF32 (big
    parts only) miss the f32 gate."""
    err_o, err_lse = _f32_errors(1, False, seed=3, passes=("big_big",))
    assert max(err_o / F32_TOL["o"], err_lse / F32_TOL["lse"]) > 1, (err_o, err_lse)
