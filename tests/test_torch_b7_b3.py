"""B7's and B3's Hopper algorithms against vitx's kernels, on the CPU.

``fused_mha_block_with_mean_probs`` (B7) in bf16 at head widths 32, 64
and 128 runs its attention on B5's sm90 body, which writes each row's
statistics, and then ``csrc/attention_probs_sm90.cuh``, a second pass that
sums the heads' probabilities from qs k^T and those statistics. ``ln_bwd`` (B3, and B11 on
the 2-D view) runs ``csrc/layer_norm_bwd.cu``'s one-pass route where E is a
multiple of the 16-byte vector. Both run only on the card; what they
compute differently from vitx is held here in plain mirrors of their
algorithms, on inputs from ``numpy.random.default_rng``:

- (a) B7: LN and the QKV product in fp32, cast once; the online softmax
  over 64-key tiles (p cast after exp(s - running max), l and the
  accumulator rescaled as the max moves) giving o and each row's m and
  1 / l; then, per 128-key tile, the heads in order, p = exp(s - m) * linv
  summed and divided by H once, keys past T masked -- against vitx's
  ``_chunked_fwd(mean_probs=True)`` (``_kernel_hchunk`` in Pallas
  interpret mode, one and two heads a chunk) at D 64 with 2 and 4 heads,
  T 197 and 577; with ``mha_block_mean_probs_plain`` at D 128 (qs =
  cast(q * scale) rounded before the products, as the body and the pass
  round it there), T 197.
- (b) B3: the one-pass route's summation order for dscale and dbias (each
  column over a row group's rows in order, the block's groups in order,
  then eight strided runs over the blocks and the runs in order, on the
  grid ``onepass_grid`` gives an H100's 132 SMs) against vitx's ``ln_bwd``
  (``_ln_bwd3_kernel`` in interpret mode) at (2, 197, 768) and ragged row
  counts.
- (c) the route functions: B7 takes ``ROUTE_ATTN_SM90`` only in bf16 at
  D 32, 64 and 128; B3's one-pass route takes exactly the widths and dtypes it says;
  its grid covers every row once.

Bars are max |a - b| over max |b|: float32 1e-4; bfloat16 1e-2 for B7's
out and B3 (``tests/test_torch_grad.py``'s bar) and 1e-3 for B7's
probabilities, which both sides compute in fp32 from bf16 q and k. Rows of
probabilities sum to 1 within 1e-5. ``-s`` prints the measured gaps.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.kernels import layer_norm as jln
from vitx.kernels import mha_block as jmha
from vitx_torch.kernels import (fused_mha_block_with_mean_probs, ln_bwd,
                                ln_bwd_plain, mha_block_mean_probs_plain)
from vitx_torch.nn.layers import layer_norm, matmul32

tmha = importlib.import_module("vitx_torch.kernels.mha_block")
tln = importlib.import_module("vitx_torch.kernels.layer_norm")

torch.set_num_threads(1)

OUT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
PROBS_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
LN_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
EPS = 1e-5
KEY_TILE = 64       # the sm90 body's key tile
PASS_KEYS = 128     # the head-mean pass's key tile (HMP_KEYS)
H100_SMS = 132


def rel_err(a, b):
    a = np.asarray(a.float() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.float() if torch.is_tensor(b) else b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# --- (a) B7: the sm90 body's statistics, then the head-mean pass -------------

def block_inputs(B, T, H, dtype, seed, D=64):
    """B7's inputs at head width D as (jax, torch) lists: x, wqkv and wo
    in ``dtype``; bo, g, b fp32."""
    rng = np.random.default_rng(seed)
    E = D * H

    def n(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    arrs = [n(B, T, E), n(E, 3, H, D, scale=0.1), n(E, E, scale=0.1),
            n(E, scale=0.1), n(E, scale=0.1, shift=1.0), n(E, scale=0.1)]
    low = (0, 1, 2)   # the operands in the compute dtype
    jx = [jnp.asarray(a, getattr(jnp, dtype) if i in low else jnp.float32)
          for i, a in enumerate(arrs)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) if i in low
          else torch.from_numpy(a) for i, a in enumerate(arrs)]
    return jx, tx


def b7_sm90_mirror(x, wqkv, wo, bo, g, b):
    """B7 as the sm90 route computes it -> (out, probs)."""
    B, T, E = x.shape
    H, D = wqkv.shape[2], wqkv.shape[3]
    dt = x.dtype
    qkv = matmul32(layer_norm(x, g, b, eps=EPS), wqkv.reshape(E, 3 * E))
    qkv = qkv.to(dt).reshape(B, T, 3, H, D).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    # qs = cast(q * scale), which the body and the pass round into their q
    # tiles at D 32 and 128; at D 64 (2^-3) it is q * scale exactly
    qs = (q.float() * (1.0 / D ** 0.5)).to(dt)
    # launch 3, the body: the online softmax over 64-key tiles
    m = torch.full((B, H, T), -torch.inf)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, D))
    for j in range(0, T, KEY_TILE):
        s = matmul32(qs, k[:, :, j:j + KEY_TILE].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + matmul32(p.to(dt),
                                                v[:, :, j:j + KEY_TILE])
        m = m_new
    o_all = (acc / l[..., None]).to(dt).transpose(1, 2).reshape(B, T, E)
    out = (matmul32(o_all, wo) + bo).to(dt)
    linv = 1.0 / l
    # launch 3b, the pass: per 128-key tile, the heads in order; the keys
    # of the ragged last tile past T are zeros (TMA's fill) and not stored
    kpad = torch.zeros((B, H, -(-T // PASS_KEYS) * PASS_KEYS, D), dtype=dt)
    kpad[:, :, :T] = k
    probs = torch.empty((B, T, T))
    for j in range(0, T, PASS_KEYS):
        tile = None
        for h in range(H):
            kt = kpad[:, h, j:j + PASS_KEYS]
            s = matmul32(qs[:, h], kt.transpose(-1, -2))
            p = torch.exp(s - m[:, h, :, None]) * linv[:, h, :, None]
            tile = p if tile is None else tile + p
        probs[:, :, j:j + PASS_KEYS] = (tile / H)[:, :, :T - j]
    return out, probs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hc", [1, 2])
@pytest.mark.parametrize("B,T,H", [(2, 197, 2), (2, 197, 4), (1, 577, 2)],
                         ids=["T197_H2", "T197_H4", "T577_H2"])
def test_b7_sm90_mirror_matches_chunked(monkeypatch, B, T, H, hc, dtype):
    """The mirror vs ``_chunked_fwd(mean_probs=True)`` (``_kernel_hchunk``,
    interpret mode) with hc heads a chunk; rows sum to 1."""
    monkeypatch.setattr(jmha, "_chunk_plan", lambda *a, **k: (hc, 0))
    monkeypatch.setattr(jmha, "_use_interpret", lambda: True)
    jx, tx = block_inputs(B, T, H, dtype, 40 + T + H)
    ref_out, ref_probs = jmha._chunked_fwd(*jx, eps=EPS, mean_probs=True)
    out, probs = b7_sm90_mirror(*tx)
    err_out = rel_err(out, f32(ref_out))
    err_p = rel_err(probs, f32(ref_probs))
    rows = float((probs.double().sum(-1) - 1).abs().max())
    print(f"B7 sm90 mirror ({B}, {T}, {64 * H}) hc {hc} {dtype}: out "
          f"{err_out:.3e}, probs {err_p:.3e}, row sums {rows:.1e}")
    assert out.dtype == tx[0].dtype and probs.dtype == torch.float32
    assert tuple(probs.shape) == (B, T, T)
    assert err_out <= OUT_TOL[dtype], err_out
    assert err_p <= PROBS_TOL[dtype], err_p
    assert rows <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b7_at_head_width_128_matches_chunked(monkeypatch, dtype):
    """At D 128, huge14's and base16_hd128's head width ((1, 197, 256),
    2 heads): ``mha_block_mean_probs_plain`` and the mirror vs
    ``_chunked_fwd(mean_probs=True)`` (one head a chunk, interpret mode);
    rows sum to 1."""
    monkeypatch.setattr(jmha, "_chunk_plan", lambda *a, **k: (1, 0))
    monkeypatch.setattr(jmha, "_use_interpret", lambda: True)
    jx, tx = block_inputs(1, 197, 2, dtype, 45, D=128)
    ref_out, ref_probs = jmha._chunked_fwd(*jx, eps=EPS, mean_probs=True)
    for what, (out, probs) in (
            ("plain", mha_block_mean_probs_plain(*tx, eps=EPS)),
            ("sm90 mirror", b7_sm90_mirror(*tx))):
        err_out = rel_err(out, f32(ref_out))
        err_p = rel_err(probs, f32(ref_probs))
        rows = float((probs.double().sum(-1) - 1).abs().max())
        print(f"B7 {what} (1, 197, 256) D 128 {dtype}: out {err_out:.3e}, "
              f"probs {err_p:.3e}, row sums {rows:.1e}")
        assert out.dtype == tx[0].dtype and probs.dtype == torch.float32
        assert tuple(probs.shape) == (1, 197, 197)
        assert err_out <= OUT_TOL[dtype], (what, err_out)
        assert err_p <= PROBS_TOL[dtype], (what, err_p)
        assert rows <= 1e-5, what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b7_sm90_mirror_matches_plain(dtype):
    """The mirror's out is K1's sm90 algorithm and its probabilities the
    plain version's within the bars: at T 129 the pass's second key tile
    holds one key (the ragged tile's mask)."""
    _, tx = block_inputs(2, 129, 2, dtype, 7)
    out, probs = b7_sm90_mirror(*tx)
    ref_out, ref_probs = mha_block_mean_probs_plain(*tx, eps=EPS)
    assert rel_err(out, ref_out) <= OUT_TOL[dtype]
    assert rel_err(probs, ref_probs) <= PROBS_TOL[dtype]


def test_b7_wrapper_on_cpu_counts_nothing():
    _, tx = block_inputs(2, 65, 2, "bfloat16", 8)
    f = fused_mha_block_with_mean_probs
    before = (f.launches, f.launches_sm90, f.launches_attn_sm90)
    for a, r in zip(f(*tx), mha_block_mean_probs_plain(*tx)):
        assert torch.equal(a, r)
    assert (f.launches, f.launches_sm90, f.launches_attn_sm90) == before


# --- (b) B3: the one-pass route's summation order ----------------------------

def onepass_mirror(x, scale, dy, sms=H100_SMS):
    """B3 on the one-pass route -> (dx, dscale, dbias): the row formulas of
    ``ln_bwd_plain``; dscale and dbias summed in the kernel's order on the
    grid ``onepass_grid`` gives ``sms`` SMs."""
    E = x.shape[-1]
    x2, g2 = x.reshape(-1, E).float(), dy.reshape(-1, E).float()
    R = x2.shape[0]
    mean = x2.mean(dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt((x2 - mean).square().mean(dim=-1, keepdim=True)
                           + EPS)
    xhat = (x2 - mean) * inv
    gs = g2 * scale.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (gs - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    grid = tln.onepass_grid(R, E, x.dtype, sms)
    nb, rpb, G = grid["blocks"], grid["rows_per_block"], grid["groups"]
    nr = -(-rpb // G)   # rows of a group at most
    cols = []
    for terms in (g2 * xhat, g2):
        # (blocks, groups, rows of a group, E), zeros where a group has no row
        t = torch.zeros((nb * rpb, E))
        t[:R] = terms
        t = torch.cat([t.reshape(nb, rpb, E),
                       torch.zeros((nb, nr * G - rpb, E))], dim=1)
        t = t.reshape(nb, nr, G, E).transpose(1, 2)
        acc = t[:, :, 0].clone()
        for j in range(1, nr):            # a thread over its group's rows
            acc = acc + t[:, :, j]
        blk = acc[:, 0].clone()
        for gi in range(1, G):            # the block's groups in order
            blk = blk + acc[:, gi]
        runs = []
        for i in range(8):                # part_reduce_kernel
            s = torch.zeros(E)
            for p in range(i, nb, 8):
                s = s + blk[p]
            runs.append(s)
        tot = runs[0]
        for r in runs[1:]:
            tot = tot + r
        cols.append(tot)
    return dx, cols[0], cols[1]


def ln_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (0.5 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    dy = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    sc = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    jx = [jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(sc),
          jnp.asarray(dy, getattr(jnp, dtype))]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(sc),
          torch.from_numpy(dy).to(getattr(torch, dtype))]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 197, 768), (3, 101, 768), (7, 1024),
                                   (9, 3072)],
                         ids=["base16_b2", "ragged_rows", "E1024", "head"])
def test_b3_onepass_mirror_matches_pallas(shape, dtype):
    """The mirror vs vitx's ``ln_bwd`` (``_ln_bwd3_kernel``, interpret
    mode): dx, dscale, dbias."""
    jx, tx = ln_inputs(shape, dtype, 21)
    ref = jln.ln_bwd(*jx, eps=EPS)
    got = onepass_mirror(*tx)
    for name, a, r in zip(("dx", "dscale", "dbias"), got, ref):
        err = rel_err(a, f32(r))
        print(f"B3 one-pass mirror {shape} {dtype} {name}: rel err vs vitx "
              f"{err:.3e}")
        assert tuple(a.shape) == tuple(r.shape)
        assert err <= LN_TOL[dtype], (name, err)
    assert got[0].dtype == tx[0].dtype


def test_b3_onepass_mirror_sums_many_blocks():
    """At the train step's rows (128 x 197 of 768) the grid is 263 blocks
    of 96 rows (12 a warp in bf16, 24 a pair of warps in fp32): the
    mirror's order against ``ln_bwd_plain``."""
    _, tx = ln_inputs((128 * 197, 768), "float32", 22)
    for dt in (torch.bfloat16, torch.float32):
        grid = tln.onepass_grid(128 * 197, 768, dt, H100_SMS)
        assert (grid["blocks"], grid["rows_per_block"]) == (263, 96)
    got = onepass_mirror(*tx)
    for a, r in zip(got, ln_bwd_plain(*tx, eps=EPS)):
        assert rel_err(a, r) <= LN_TOL["float32"]


def test_ln_bwd_wrapper_on_cpu_counts_nothing():
    _, tx = ln_inputs((2, 197, 768), "bfloat16", 23)
    before = (ln_bwd.launches, ln_bwd.launches_onepass)
    for a, r in zip(ln_bwd(*tx), ln_bwd_plain(*tx)):
        assert torch.equal(a, r)
    assert (ln_bwd.launches, ln_bwd.launches_onepass) == before


# --- (c) the routes ----------------------------------------------------------

@pytest.mark.parametrize("dtype,E,H,attn", [
    (torch.bfloat16, 1024, 16, True), (torch.bfloat16, 768, 12, True),
    (torch.bfloat16, 128, 2, True), (torch.float32, 1024, 16, False),
    (torch.bfloat16, 256, 16, False), (torch.bfloat16, 512, 4, True)])
def test_b7_route(dtype, E, H, attn):
    """``mha_route`` (one rule for K1, B7 and B8) grants B7 the sm90
    attention and its head-mean pass in bf16 at D 32, 64 and 128 (here 64
    and 128), not at D 16 nor in fp32."""
    route = tmha.mha_route(dtype, E, H)
    assert bool(route & tmha.ROUTE_ATTN_SM90) == attn
    assert bool(route & tmha.ROUTE_GEMM_SM90) == (dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype,E,onepass", [
    (torch.bfloat16, 768, True), (torch.bfloat16, 1024, True),
    (torch.bfloat16, 3072, True), (torch.bfloat16, 4096, True),
    (torch.bfloat16, 64, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 100, False), (torch.bfloat16, 36, False),
    (torch.bfloat16, 4104, False), (torch.float32, 768, True),
    (torch.float32, 36, True), (torch.float32, 4096, True),
    (torch.float32, 38, False), (torch.float32, 4100, False),
    (torch.float16, 768, False)])
def test_b3_route(dtype, E, onepass):
    assert (tln.ln_bwd_route(dtype, E) == tln.LN_ROUTE_ONEPASS) == onepass


def test_b3_route_needs_aligned_rows():
    buf = torch.zeros(2 * 768 + 1, dtype=torch.bfloat16)
    aligned, shifted = buf[:768 * 2], buf[1:]
    assert tln.ln_bwd_route(torch.bfloat16, 768, (aligned,)) == 1
    assert tln.ln_bwd_route(torch.bfloat16, 768, (shifted,)) == 0


@pytest.mark.parametrize("dtype,E,wpr,nv", [
    (torch.bfloat16, 768, 1, 3), (torch.bfloat16, 1024, 1, 4),
    (torch.bfloat16, 3072, 4, 3), (torch.bfloat16, 4096, 4, 4),
    (torch.float32, 768, 2, 3), (torch.float32, 4096, 8, 4),
    (torch.bfloat16, 64, 1, 1)])
def test_b3_onepass_layout(dtype, E, wpr, nv):
    """A row group's warps and vectors: at most 4 vectors a thread, the
    fewest warps that hold the row."""
    grid = tln.onepass_grid(1000, E, dtype, H100_SMS)
    assert (grid["wpr"], grid["nv"]) == (wpr, nv)
    assert grid["groups"] * 32 * wpr == tln.ONEPASS_THREADS


@pytest.mark.parametrize("R", [1, 2, 7, 8, 9, 263, 264, 2111, 25216, 50432,
                               131 * 197])
@pytest.mark.parametrize("E", [768, 3072])
def test_b3_onepass_grid_covers_rows(R, E):
    """Every row in exactly one block (the entry's own check: blocks *
    rows_per_block >= R > (blocks - 1) * rows_per_block), at most two
    blocks an SM."""
    grid = tln.onepass_grid(R, E, torch.bfloat16, H100_SMS)
    nb, rpb = grid["blocks"], grid["rows_per_block"]
    assert nb * rpb >= R > (nb - 1) * rpb
    assert 1 <= nb <= tln.ONEPASS_BLOCKS_PER_SM * H100_SMS
