"""The algorithms of the sm90 attention kernels against vitx's, on the CPU.

``csrc/flash_attention_sm90.cu`` (B5 without probs) and
``csrc/attention_bwd_sm90.cu`` (B2/B6) run only on the card, in bf16 at
head widths 32, 64 and 128. What they compute differently from the
earlier kernels is held here, at each of those widths, in plain torch
mirrors of their algorithms, against vitx's Pallas kernels in interpret
mode (the CPU backend ``tests/conftest.py`` sets), on inputs from
``numpy.random.default_rng``:

- the forward's online softmax over 64-key tiles (p cast after
  exp(s - running max), l and the o accumulator rescaled as the max
  moves) vs ``vitx.kernels.flash_attention._fwd``;
- the backward from the forward's o and row statistics, delta =
  rowsum(do * o) from the cast o, vs ``_bwd`` (``_bwd_kernel_nq1`` at
  T 197, the q-chunked ``_bwd_kernel`` at T 1025);
- ``attention_stats_plain`` vs the m and l of ``_unnormalized_probs``;
- the probability pass (``csrc/attention_probs_sm90.cuh``) from the
  forward's statistics at D 32 and 128, where it rounds qs = cast(q *
  scale) as the body does, vs ``_fwd(probs_mode=...)``, full and mean;
- the wrappers' new arguments on CPU tensors: ``attention_bwd`` with o,
  stats and ``out`` returns ``attention_bwd_plain``'s values; the route
  and stride rules that decide what reaches the card: the body, the
  probability modes, B7 and the backward at D 32, 64 and 128.

Bars are max |a - b| over max |b|: float32 1e-4, bfloat16 1e-2 (B2's bar
in ``tests/test_torch_grad.py``); probabilities float32 1e-4, bfloat16
1e-3 (both sides compute them in fp32 from the same bf16 q and k), rows
summing to 1 within 1e-5. The measured gaps are printed (run with
``-s``): the cost of the moved rounding points, known before the card runs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.kernels import flash_attention as jflash
from vitx_torch.kernels import (attention_bwd, attention_bwd_plain,
                                attention_stats_plain, flash_attention,
                                flash_attention_fwd_plain)
from vitx_torch.nn.layers import matmul32

tflash = importlib.import_module("vitx_torch.kernels.flash_attention")

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
PROBS_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
LOG2E = 1.4426950408889634   # the kernels' exp is exp2(x * log2 e) in fp32
# statistics from the same logits summed in another fp32 order: exp turns
# an ulp of a logit (|s| up to ~30 here) into ~2e-6 of p
STATS_TOL = 1e-5
KEY_TILE = 64   # the kernels' key tile (forward, launch A)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def f32(t):
    return np.asarray(t.float() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


def inputs(shape, dtype, seed):
    """q, k, v of a projection's scale and do of a gradient's, as (jax,
    torch) pairs in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [(1.5 * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(3)]
    arrs.append((0.1 * rng.standard_normal(shape)).astype(np.float32))
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def online_fwd_mirror(q, k, v):
    """The sm90 forward's algorithm: per 64-key tile, the running max m,
    alpha = exp(m_old - m), p = exp(s - m) cast to q's dtype for the p v
    product, l and the fp32 accumulator rescaled by alpha; o = cast(acc /
    l). Returns (o, stats (2, B, H, T): the final m and 1 / l)."""
    dt = q.dtype
    qs = (q.float() * (1.0 / q.shape[-1] ** 0.5)).to(dt)
    shape = q.shape[:3]
    m = torch.full(shape, -torch.inf)
    l = torch.zeros(shape)
    acc = torch.zeros(q.shape)
    for j in range(0, q.shape[2], KEY_TILE):
        s = matmul32(qs, k[:, :, j:j + KEY_TILE].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + matmul32(p.to(dt),
                                                v[:, :, j:j + KEY_TILE])
        m = m_new
    return (acc / l[..., None]).to(dt), torch.stack((m, 1.0 / l))


def bwd_mirror(q, k, v, do, o, stats):
    """The sm90 backward's algorithm from the forward's o and stats:
    pu = exp(s - m), delta = rowsum(do * o) in fp32 from the cast o,
    e = cast(pu * (dp - delta)); dq = cast(e k * scale * linv), dv =
    cast(pu)^T cast(do * linv), dk = e^T cast(q * scale * linv)."""
    dt = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    m, linv = stats[0][..., None], stats[1][..., None]
    qs = (q.float() * scale).to(dt)
    pu = torch.exp(matmul32(qs, k.transpose(-1, -2)) - m)
    dp = matmul32(do, v.transpose(-1, -2))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    e = (pu * (dp - delta)).to(dt)
    dq = matmul32(e, k) * (scale * linv)
    dv = matmul32(pu.to(dt).transpose(-1, -2), (do.float() * linv).to(dt))
    dk = matmul32(e.transpose(-1, -2), (q.float() * (scale * linv)).to(dt))
    return dq.to(dt), dk.to(dt), dv.to(dt)


# --- the forward: an online softmax -----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 197, 64), (1, 2, 577, 64),
                                   (1, 2, 1025, 64), (1, 2, 197, 32),
                                   (1, 2, 197, 128)],
                         ids=["T197", "T577", "T1025", "T197_D32",
                              "T197_D128"])
def test_online_forward_matches_pallas(shape, dtype):
    jx, tx = inputs(shape, dtype, 11)
    ref = jflash._fwd(*jx[:3])
    o, stats = online_fwd_mirror(*tx[:3])
    err = rel_err(f32(o), f32(ref))
    print(f"online forward {shape} {dtype}: rel err vs vitx {err:.3e}")
    assert err <= TOL[dtype], err
    # the final statistics are those of the whole row
    want = attention_stats_plain(*tx[:2])
    assert rel_err(stats[0], want[0]) <= STATS_TOL
    assert rel_err(stats[1], want[1]) <= STATS_TOL


# --- the probability pass: from the forward's statistics -------------------

def probs_pass_mirror(q, k, v, mode):
    """The probability pass's algorithm -> probs: m and 1 / l from
    ``online_fwd_mirror``, qs = cast(q * scale) (the body's logits), p =
    exp2((qs k^T - m) * log2 e) * linv, every head's for "full", their sum
    in head order divided by H for "mean"."""
    _, stats = online_fwd_mirror(q, k, v)
    m, linv = stats[0][..., None], stats[1][..., None]
    qs = (q.float() * (1.0 / q.shape[-1] ** 0.5)).to(q.dtype)
    s = matmul32(qs, k.transpose(-1, -2))
    p = torch.exp2((s - m) * LOG2E) * linv
    if mode == "full":
        return p
    acc = p[:, 0]
    for h in range(1, p.shape[1]):
        acc = acc + p[:, h]
    return acc / p.shape[1]


@pytest.mark.parametrize("mode", ["full", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 197, 32), (1, 2, 197, 128)],
                         ids=["T197_D32", "T197_D128"])
def test_probs_pass_matches_pallas(shape, dtype, mode):
    """The pass at D 32 and 128 vs vitx's ``_fwd(probs_mode=mode)``
    (``_fwd_kernel``, interpret mode); rows sum to 1."""
    jx, tx = inputs(shape, dtype, 17)
    _, ref = jflash._fwd(*jx[:3], probs_mode=mode)
    probs = probs_pass_mirror(*tx[:3], mode)
    err = rel_err(f32(probs), f32(ref))
    rows = float((probs.double().sum(-1) - 1).abs().max())
    print(f"probability pass {mode} {shape} {dtype}: rel err vs vitx "
          f"{err:.3e}, row sums {rows:.1e}")
    assert probs.dtype == torch.float32
    assert tuple(probs.shape) == tuple(ref.shape)
    assert err <= PROBS_TOL[dtype], err
    assert rows <= 1e-5


# --- the backward: from the forward's o and statistics ----------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 197, 64), (1, 2, 1025, 64),
                                   (1, 2, 197, 32), (1, 2, 197, 128),
                                   (1, 2, 1025, 128)],
                         ids=["T197_nq1", "T1025_q_chunked", "T197_D32_nq1",
                              "T197_D128_nq1", "T1025_D128_q_chunked"])
def test_backward_from_stats_matches_pallas(shape, dtype):
    jx, tx = inputs(shape, dtype, 12)
    ref = jflash._bwd(tuple(jx[:3]), jx[3])
    o, stats = online_fwd_mirror(*tx[:3])
    out = bwd_mirror(*tx, o, stats)
    plain = attention_bwd_plain(*tx)
    for name, a, r, p in zip(("dq", "dk", "dv"), out, ref, plain):
        err = rel_err(f32(a), f32(r))
        before = rel_err(f32(p), f32(r))
        print(f"sm90 backward {shape} {dtype} {name}: rel err vs vitx "
              f"{err:.3e} (attention_bwd_plain's {before:.3e})")
        assert a.dtype == tx[0].dtype and a.shape == tx[0].shape
        assert err <= TOL[dtype], (name, err)


# --- the statistics ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [65, 197])
def test_attention_stats_plain_matches_unnormalized_probs(T, dtype):
    """linv = 1 / l of ``_unnormalized_probs``, and exp(s - m) with the
    port's m is its p: so m is its row max."""
    jx, tx = inputs((2, 3, T, 64), dtype, 13)
    B, H, _, D = tx[0].shape
    scale = 1.0 / D ** 0.5
    p, l = jflash._unnormalized_probs(jx[0].reshape(B * H, T, D),
                                      jx[1].reshape(B * H, T, D), scale,
                                      T, T)
    stats = attention_stats_plain(*tx[:2])
    assert stats.shape == (2, B, H, T) and stats.dtype == torch.float32
    linv = f32(stats[1]).reshape(B * H, T)
    assert rel_err(linv, 1.0 / f32(l)[..., 0]) <= STATS_TOL
    qs = (tx[0].float() * scale).to(tx[0].dtype)
    s = matmul32(qs, tx[1].transpose(-1, -2))
    mine = torch.exp(s - stats[0][..., None]).reshape(B * H, T, T)
    assert rel_err(f32(mine), f32(p)) <= STATS_TOL


# --- the wrappers on CPU tensors --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_with_stats_returns_plain(dtype):
    """o and stats change nothing on the CPU; ``out`` receives the values,
    strided views read and written as they lie (the fused block's do, o
    and dqkv layouts); no launch is counted."""
    B, H, T, D = 2, 3, 65, 64
    _, tx = inputs((B, H, T, D), dtype, 14)
    q, k, v, do = tx
    o, stats = online_fwd_mirror(q, k, v)
    want = attention_bwd_plain(q, k, v, do)
    n, n90 = attention_bwd.launches, attention_bwd.launches_sm90
    got = attention_bwd(q, k, v, do, o, stats)
    for a, r in zip(got, want):
        assert torch.equal(a, r)
    # do and o as (B, T, H, D) buffers seen as (B, H, T, D); out in one
    # (B, T, 3, H, D) buffer
    do_t = do.transpose(1, 2).contiguous().transpose(1, 2)
    o_t = o.transpose(1, 2).contiguous().transpose(1, 2)
    buf = torch.zeros((B, T, 3, H, D), dtype=q.dtype)
    views = tuple(buf[:, :, i].transpose(1, 2) for i in range(3))
    got = attention_bwd(q, k, v, do_t, o_t, stats, out=views)
    assert all(a is b for a, b in zip(got, views))
    for i, r in enumerate(want):
        assert torch.equal(buf[:, :, i].transpose(1, 2), r)
    assert (attention_bwd.launches, attention_bwd.launches_sm90) == (n, n90)


def test_attention_bwd_checks_o_and_stats():
    _, tx = inputs((1, 2, 17, 64), "float32", 15)
    q, k, v, do = tx
    with pytest.raises(ValueError, match="o must be"):
        attention_bwd(q, k, v, do, q[:, :, :5])
    with pytest.raises(ValueError, match="stats must be"):
        attention_bwd(q, k, v, do, q, torch.zeros(2, 1, 2, 16))
    with pytest.raises(ValueError, match="stats must be"):
        attention_bwd(q, k, v, do, q,
                      torch.zeros(2, 1, 2, 17, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grad_with_stats_on_cpu(dtype):
    """``flash_attention``'s backward, now handed o and the statistics,
    still gives the plain backward's gradients on CPU tensors."""
    _, tx = inputs((2, 2, 70, 64), dtype, 16)
    q, k, v, do = tx
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    n = flash_attention.launches_sm90
    out = flash_attention(*ins)
    assert torch.equal(out, flash_attention_fwd_plain(q, k, v))
    grads = torch.autograd.grad(out, ins, do)
    for a, r in zip(grads, attention_bwd_plain(q, k, v, do)):
        assert torch.equal(a, r)
    assert flash_attention.launches_sm90 == n


@pytest.mark.parametrize("dtype,D,want", [("bfloat16", 64, True),
                                          ("float32", 64, False),
                                          ("bfloat16", 32, True),
                                          ("bfloat16", 128, True),
                                          ("bfloat16", 96, False),
                                          ("float32", 128, False)])
def test_sm90_route_is_bf16_at_head_widths_32_64_128(dtype, D, want):
    """The body without probabilities and the backward: bf16 at D 32, 64
    and 128; fp32 and any other D keep the earlier kernels."""
    t = torch.zeros((1, 1, 8, D), dtype=getattr(torch, dtype))
    assert tflash.sm90_route(t) is want


@pytest.mark.parametrize("dtype,D,want", [("bfloat16", 64, True),
                                          ("bfloat16", 32, True),
                                          ("bfloat16", 128, True),
                                          ("float32", 64, False),
                                          ("bfloat16", 96, False),
                                          ("float32", 128, False)])
def test_probs_route_at_head_widths_32_64_128(dtype, D, want):
    """B5's probability modes take the sm90 body and pass at the body's
    widths, on planes the pass can read; fp32 and any other D keep the
    earlier kernel."""
    t = torch.zeros((2, 3, 8, D), dtype=getattr(torch, dtype))
    assert tflash.sm90_route(t) is want
    assert tflash.probs_route(t, t, t) == (tflash.ROUTE_SM90 if want else 0)


@pytest.mark.parametrize("E,H", [(512, 16), (1280, 10), (768, 6)],
                         ids=["D32_mae_decoder", "D128_huge14",
                              "D128_base16_hd128"])
def test_mha_route_at_head_widths_32_and_128(E, H):
    """K1, B7 and B8 (one rule for the three entries) take the sm90
    GEMM and the sm90 attention at D 32 and 128, B7's head-mean pass
    included; fp32 takes neither."""
    tmha = importlib.import_module("vitx_torch.kernels.mha_block")
    both = tmha.ROUTE_GEMM_SM90 | tmha.ROUTE_ATTN_SM90
    assert tmha.mha_route(torch.bfloat16, E, H) == both
    assert tmha.mha_route(torch.float32, E, H) == 0


def test_view_keeps_strided_layouts_and_copies_the_rest():
    B, T, H, D = 2, 9, 3, 64
    base = torch.zeros((B, T, H, D), dtype=torch.bfloat16)
    v = base.transpose(1, 2)              # (B, H, T, D), K1's o_all layout
    t, st = tflash._view(v)
    assert t is v and st == [T * H * D, D, H * D]
    # a size-1 dim takes the T stride, whatever torch reports for it
    one = torch.zeros((1, 1, T, D), dtype=torch.bfloat16)
    t, st = tflash._view(one)
    assert t is one and st == [D, D, D]
    # a last dim that is not contiguous, or an odd stride, is copied
    odd = torch.zeros((B, H, T, D + 1), dtype=torch.bfloat16)[..., :D]
    t, st = tflash._view(odd)
    assert t is not odd and t.is_contiguous() and torch.equal(t, odd)
    assert st == [H * T * D, T * D, D]
