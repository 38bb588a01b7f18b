"""K1's and K2's sm90 route on the CPU: the algorithms and the routing.

``csrc/gemm_sm90.cuh`` (the LN-prologue GEMM of K1, K2, B7 and B8) and
K1's attention on B5's sm90 body (``csrc/attention_fwd_sm90.cuh``) run only
on the card. What can be held here, on inputs from
``numpy.random.default_rng``:

- K1's sm90 algorithm in a plain mirror -- LayerNorm, the QKV product in
  fp32 cast once, the online softmax of the sm90 attention
  (``online_fwd_mirror``), the out-projection -- against
  ``vitx.kernels.mha_block._fused_fwd(stash=True)`` in Pallas interpret
  mode (the CPU backend ``tests/conftest.py`` sets): out and o_all, the
  stashed q, k, v, and the statistics against ``attention_stats_plain``;
- the GEMM's LN prologue as the consumer warpgroup computes it: a mirror
  that reads each A fragment out of the 128-byte-swizzled stage with the
  kernel's own offsets, normalises it with the staged g and b (zero past
  K) and places it by the wgmma register layout, bit for bit against
  ``layer_norm`` at a ragged K;
- which GEMM and which attention K1, B7, B8 and K2 take for each preset and
  dtype (``mha_route``, ``mlp_route``): B7's and B8's attention take the
  sm90 body wherever K1's does.

Bars are max |a - b| over max |b|: float32 1e-4, bfloat16 1e-2
(``tests/test_torch_kernels.py``); the statistics 1e-5
(``tests/test_torch_attn_sm90.py``). ``-s`` prints the measured gaps.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx_torch
from test_torch_attn_sm90 import online_fwd_mirror
from vitx.kernels import mha_block as jmha
from vitx_torch.core.config import PRESETS
from vitx_torch.kernels import attention_stats_plain
from vitx_torch.kernels._build import gemm_sm90
from vitx_torch.nn.layers import layer_norm, matmul32

tmha = importlib.import_module("vitx_torch.kernels.mha_block")
tmlp = importlib.import_module("vitx_torch.kernels.mlp_block")

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
STATS_TOL = 1e-5
EPS = 1e-5


def rel_err(a, b):
    a = np.asarray(a.float() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.float() if torch.is_tensor(b) else b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def mha_inputs(B, T, E, H, dtype, seed):
    """K1's inputs as (jax, torch) lists: x and the weights in ``dtype``,
    bo, g, b in fp32."""
    rng = np.random.default_rng(seed)
    D = E // H

    def n(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    arrs = [n(B, T, E), n(E, 3, H, D, scale=0.06), n(E, E, scale=0.06),
            n(E, scale=0.1), n(E, scale=0.1, shift=1.0), n(E, scale=0.1)]
    jx = [jnp.asarray(a, jnp.float32 if a.ndim == 1 else getattr(jnp, dtype))
          for a in arrs]
    tx = [torch.from_numpy(a) if a.ndim == 1
          else torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def k1_sm90_mirror(x, wqkv, wo, bo, g, b):
    """K1 as the sm90 route computes it: h = cast(LN(x)); q|k|v =
    cast(h @ Wqkv) (fp32 sum, the EPI_QKV scatter into (B, H, T, D)
    planes); the online-softmax attention (p cast after exp(s - running
    max)); o_all (B, T, E); out = cast(o_all @ Wo + bo). Returns (out, q,
    k, v, o_all, stats)."""
    B, T, E = x.shape
    H, D = wqkv.shape[2], wqkv.shape[3]
    dt = x.dtype
    h = layer_norm(x, g, b, eps=EPS)
    qkv = matmul32(h, wqkv.reshape(E, 3 * E)).to(dt)
    qkv = qkv.reshape(B, T, 3, H, D).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    o, stats = online_fwd_mirror(q, k, v)
    o_all = o.transpose(1, 2).reshape(B, T, E)
    out = (matmul32(o_all, wo) + bo).to(dt)
    return out, q, k, v, o_all, stats


# --- K1's sm90 algorithm against vitx's _kernel ------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [197, 77], ids=["T197", "T77_ragged"])
def test_k1_sm90_mirror_matches_pallas(T, dtype):
    jx, tx = mha_inputs(2, T, 128, 2, dtype, 21)
    ref = jmha._fused_fwd(*jx, eps=EPS, stash=True)
    out, q, k, v, o_all, stats = k1_sm90_mirror(*tx)
    names = ("out", "q", "k", "v", "o_all")
    for name, a, r in zip(names, (out, q, k, v, o_all), ref):
        err = rel_err(a, f32(r))
        print(f"K1 sm90 mirror (2, {T}, 128) {dtype} {name}: rel err vs "
              f"vitx {err:.3e}")
        assert a.dtype == tx[0].dtype and tuple(a.shape) == r.shape
        assert err <= TOL[dtype], (name, err)
    want = attention_stats_plain(q, k)
    assert stats.shape == (2, 2, 2, T)
    assert rel_err(stats[0], want[0]) <= STATS_TOL
    assert rel_err(stats[1], want[1]) <= STATS_TOL


# --- the LN prologue on the swizzled stage -----------------------------------

BOX = 64          # rows of a TMA box, and bf16 columns of a 128-byte row


def swizzled_stage(tile):
    """A (64, 64) tile as TMA leaves it in shared memory with the 128-byte
    swizzle, one element per 2-byte slot: 16-byte chunk c of row r at chunk
    c ^ (r % 8)."""
    r = np.arange(BOX)[:, None]
    c = np.arange(BOX)[None, :]
    slot = r * BOX + ((c // 8) ^ (r % 8)) * 8 + c % 8
    stage = torch.zeros(BOX * BOX, dtype=tile.dtype)
    stage[torch.from_numpy(slot.reshape(-1))] = tile.reshape(-1)
    return stage


def prologue_mirror(x, g, b, eps):
    """The consumer warpgroups' LN prologue over an (M, K) x, row boxes of
    64 and k-steps of 64: each k-step's stage is loaded as TMA would
    (zeros past M and K), each thread of warp wq, lane l reads its four
    32-bit registers of slice kk at the kernel's byte offsets (rowoff =
    128 r0 + 2 cq, chunk (2kk + j) ^ (r0 % 8), +1024 for row r0 + 8),
    normalises them with its rows' mean / rstd and the staged g, b (zero
    past K), and the values are placed where the wgmma register layout
    says they lie: register j of slice kk holds row r0 + 8 (j % 2), columns
    16 kk + 8 (j // 2) + cq + {0, 1}. Returns the fp32 values before the
    cast, (M, KP) with KP = K rounded up to 64."""
    M, K = x.shape
    nk = -(-K // BOX)
    kp = nk * BOX
    x32 = x.float()
    mean = x32.mean(dim=-1)
    rstd = torch.rsqrt((x32 - mean[:, None]).square().mean(dim=-1) + eps)
    gs = torch.zeros(kp)
    bs = torch.zeros(kp)
    gs[:K], bs[:K] = g, b
    out = torch.full((-(-M // BOX) * BOX, kp), float("nan"))
    lane = np.arange(32)
    for m0 in range(0, M, BOX):
        for kt in range(nk):
            tile = torch.zeros((BOX, BOX), dtype=x.dtype)
            part = x[m0:m0 + BOX, kt * BOX:(kt + 1) * BOX]
            tile[:part.shape[0], :part.shape[1]] = part
            stage = swizzled_stage(tile)
            for wq in range(4):
                r0 = 16 * wq + lane // 4
                cq = 2 * (lane % 4)
                rowoff = r0 * 128 + 2 * cq
                sw = r0 & 7
                for kk in range(4):
                    for j in range(4):
                        chunk = (2 * kk + j // 2) ^ sw
                        byte = rowoff + (chunk << 4) + 1024 * (j % 2)
                        row = r0 + 8 * (j % 2)
                        col = 16 * kk + 8 * (j // 2) + cq
                        grow = m0 + row
                        inside = torch.from_numpy(grow < M)
                        rows_ = torch.from_numpy(np.minimum(grow, M - 1))
                        mu = torch.where(inside, mean[rows_], 0.0)
                        rs = torch.where(inside, rstd[rows_], 0.0)
                        for e in range(2):
                            val = stage[torch.from_numpy(byte // 2 + e)]
                            k = torch.from_numpy(kt * BOX + col + e)
                            h = ((val.float() - mu) * rs) * gs[k] + bs[k]
                            out[torch.from_numpy(grow), k] = h
    return out[:M]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K", [(100, 200), (64, 768)],
                         ids=["ragged", "base16"])
def test_ln_prologue_mirror_is_layer_norm(M, K, dtype):
    """The prologue's values are ``layer_norm``'s, bit for bit: before the
    cast (fp32) and after it (bf16, the A operand the kernel feeds wgmma);
    zero past K."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32) * 2
                         + 0.5).to(torch.bfloat16)
    g = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(K).astype(
        np.float32))
    b = torch.from_numpy(0.1 * rng.standard_normal(K).astype(np.float32))
    h32 = prologue_mirror(x, g, b, EPS)
    assert not torch.isnan(h32).any()
    assert torch.equal(h32[:, K:], torch.zeros_like(h32[:, K:]))
    h32 = h32[:, :K]
    if dtype == "float32":
        want = layer_norm(x.float(), g, b, eps=EPS)
        assert torch.equal(h32, want)
    else:
        want = layer_norm(x, g, b, eps=EPS)
        assert torch.equal(h32.to(torch.bfloat16), want)


# --- the routes --------------------------------------------------------------

def expected_routes(cfg, dtype):
    """(K1, B7, B8, K2) routes by the rule of the source notes: the sm90
    GEMM for bf16 with E (and the MLP's M) a multiple of 8; K1's, B7's and
    B8's attention on the sm90 body for bf16 at D 32, 64 or 128 (B7's
    followed by its head-mean pass)."""
    bf = dtype == torch.bfloat16
    gemm = tmha.ROUTE_GEMM_SM90 if bf and cfg.embed_dim % 8 == 0 else 0
    attn = tmha.ROUTE_ATTN_SM90
    k1 = gemm | (attn if bf and cfg.head_dim in (32, 64, 128) else 0)
    k2 = tmlp.ROUTE_SM90 if gemm and cfg.mlp_dim % 8 == 0 else 0
    return k1, k1, k1, k2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_routes_per_preset(preset, dtype):
    cfg = vitx_torch.get_config(preset)
    E, H, M = cfg.embed_dim, cfg.num_heads, cfg.mlp_dim

    # as _launch asks for it: one rule for the three mha_block.cu entries
    k1 = b7 = b8 = tmha.mha_route(dtype, E, H)
    k2 = tmlp.mlp_route(dtype, E, M)
    assert (k1, b7, b8, k2) == expected_routes(cfg, dtype)
    if dtype == torch.float32:
        assert k1 == b7 == b8 == k2 == 0       # fp32 is never sm90
    if preset in ("base16", "large16_384") and dtype == torch.bfloat16:
        # the models of the main paths: all on the sm90 route, B7's
        # attention (the rollout) and B8's (ToMe) on the sm90 body as K1's
        assert k1 == b7 == b8 == tmha.ROUTE_GEMM_SM90 | tmha.ROUTE_ATTN_SM90
        assert k2 == tmlp.ROUTE_SM90
    if preset == "tiny" and dtype == torch.bfloat16:
        # the sm90 GEMM (N 192 and 256) and the earlier attention (D 16)
        assert (k1, k2) == (tmha.ROUTE_GEMM_SM90, tmlp.ROUTE_SM90)


def test_gemm_route_needs_aligned_operands():
    """A 16-byte row and a 16-byte aligned base are what TMA addresses:
    an operand that starts 2 bytes in takes the earlier GEMM."""
    bf = torch.bfloat16
    buf = torch.zeros(1 + 8 * 64, dtype=bf)
    aligned, off = buf[:8 * 64], buf[1:]
    if aligned.data_ptr() % 16:
        aligned = buf[8:]
    assert gemm_sm90(bf, (64, 256), (aligned,))
    assert not gemm_sm90(bf, (64, 256), (off,))
    assert not gemm_sm90(bf, (36, 256))
    assert not gemm_sm90(torch.float32, (64, 256))
    assert tmha.mha_route(bf, 64, 4, tensors=(off,)) == 0
    assert tmlp.mlp_route(bf, 64, 256, (off,)) == 0
