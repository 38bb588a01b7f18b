"""B8's sm90 route on the CPU: ToMe's attention block on the online softmax.

In bf16 at head width 64 the port's B8 (``fused_mha_block_tome``) runs its
attention on B5's sm90 body in its KBIAS form
(``csrc/attention_fwd_sm90.cuh``), which runs only on the card. What it
computes differently from the earlier kernel is held here, in a plain
mirror of its algorithm, against vitx's ``_kernel_tome`` (``_tome_fwd``)
and ``_kernel_hchunk_tome`` (``_chunked_tome_fwd``, B9, with 1 and 2 heads
a chunk, as ``tests/test_torch_tome.py`` forces them) in Pallas interpret
mode (the CPU backend ``tests/conftest.py`` sets), on inputs from
``numpy.random.default_rng``:

- the QKV product in fp32 plus the fp32 bias, cast once; k_mean the fp32
  head sum of the cast k over H;
- per 64-key tile, the logits s = scale * (q k^T) + log(size) of each
  key, keys past T masked, the running max, p cast after exp(s - running
  max), l and the fp32 accumulator rescaled by alpha as the max moves;
- the out-projection in fp32 plus bo, cast once.

E 128 with 2 heads of 64; T 77 (a ragged second key tile) and T 48 (one
tile); log(size) for sizes 1 to 40, so that a row's max moves between key
tiles. Bars are max |a - b| over max |b|: float32 1e-4, bfloat16 1e-2
(``tests/test_torch_block_sm90.py``); ``-s`` prints the measured gaps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.kernels import mha_block as jmha
from vitx_torch.kernels import mha_block_tome_plain
from vitx_torch.nn.layers import layer_norm, matmul32

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
EPS = 1e-5
KEY_TILE = 64     # the sm90 body's key tile
E, H = 128, 2     # head width 64, the sm90 body's


def rel_err(a, b):
    a = np.asarray(a.float() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.float() if torch.is_tensor(b) else b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def tome_inputs(B, T, dtype, seed):
    """B8's inputs as (jax, torch) lists: x, wqkv and wo in ``dtype``; bqkv,
    bo, g, b and log_size fp32, log_size the log of sizes from 1 to 40."""
    rng = np.random.default_rng(seed)
    D = E // H

    def n(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    arrs = [n(B, T, E), n(E, 3, H, D, scale=0.1), n(3, H, D, scale=0.1),
            n(E, E, scale=0.1), n(E, scale=0.1), n(E, scale=0.1, shift=1.0),
            n(E, scale=0.1),
            np.log(1.0 + 39.0 * rng.random((B, T))).astype(np.float32)]
    low = (0, 1, 3)   # the operands in the compute dtype
    jx = [jnp.asarray(a, getattr(jnp, dtype) if i in low else jnp.float32)
          for i, a in enumerate(arrs)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) if i in low
          else torch.from_numpy(a) for i, a in enumerate(arrs)]
    return jx, tx


def tome_sm90_mirror(x, wqkv, bqkv, wo, bo, g, b, log_size, maxes=None):
    """B8 as the sm90 route computes it -> (out, k_mean). ``maxes``, a
    list, collects each tile's running max (B, H, T)."""
    B, T, _ = x.shape
    D = E // H
    dt = x.dtype
    h = layer_norm(x, g, b, eps=EPS)
    qkv = (matmul32(h, wqkv.reshape(E, 3 * E)) + bqkv.reshape(3 * E)).to(dt)
    qkv = qkv.reshape(B, T, 3, H, D).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    k_sum = k[:, 0].float()
    for i in range(1, H):
        k_sum = k_sum + k[:, i].float()
    k_mean = (k_sum / H).to(dt)
    scale = 1.0 / D ** 0.5
    m = torch.full((B, H, T), -torch.inf)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, D))
    for j in range(0, T, KEY_TILE):
        s = (matmul32(q, k[:, :, j:j + KEY_TILE].transpose(-1, -2)) * scale
             + log_size[:, None, None, j:j + KEY_TILE])
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + matmul32(p.to(dt),
                                                v[:, :, j:j + KEY_TILE])
        m = m_new
        if maxes is not None:
            maxes.append(m)
    o = (acc / l[..., None]).to(dt)
    o_all = o.transpose(1, 2).reshape(B, T, E)
    out = (matmul32(o_all, wo) + bo).to(dt)
    return out, k_mean


def check(what, got, ref, dtype):
    for name, a, r in zip(("out", "k_mean"), got, ref):
        err = rel_err(a, f32(r))
        print(f"{what} {dtype} {name}: rel err vs vitx {err:.3e}")
        assert a.dtype == getattr(torch, dtype)
        assert tuple(a.shape) == r.shape
        assert err <= TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [77, 48], ids=["T77_ragged", "T48_one_tile"])
def test_tome_sm90_mirror_matches_pallas(T, dtype):
    """The mirror vs ``_tome_fwd`` (``_kernel_tome``, interpret mode)."""
    jx, tx = tome_inputs(2, T, dtype, 31)
    ref = jmha._tome_fwd(*jx, eps=EPS)
    check(f"B8 sm90 mirror (2, {T}, {E}) vs _kernel_tome",
          tome_sm90_mirror(*tx), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hc", [1, 2])
@pytest.mark.parametrize("T", [77, 48], ids=["T77_ragged", "T48_one_tile"])
def test_tome_sm90_mirror_matches_chunked(monkeypatch, T, hc, dtype):
    """B9's function: the mirror vs ``_chunked_tome_fwd``
    (``_kernel_hchunk_tome``) with hc heads a chunk."""
    monkeypatch.setattr(jmha, "_chunk_plan", lambda *a, **k: (hc, 0))
    monkeypatch.setattr(jmha, "_use_interpret", lambda: True)
    jx, tx = tome_inputs(2, T, dtype, 32)
    ref = jmha._chunked_tome_fwd(*jx, eps=EPS)
    check(f"B8 sm90 mirror (2, {T}, {E}) vs _kernel_hchunk_tome hc {hc}",
          tome_sm90_mirror(*tx), ref, dtype)


def test_key_bias_moves_the_running_max():
    """The inputs above exercise the rescale: with log(size) up to log 40
    the running max of many rows rises at the second key tile (alpha < 1),
    and the mirror still matches the plain version, which takes the max
    over the whole row."""
    _, tx = tome_inputs(2, 77, "float32", 31)
    maxes = []
    out = tome_sm90_mirror(*tx, maxes=maxes)
    moved = float((maxes[1] > maxes[0]).float().mean())
    print(f"rows whose max moved at the second tile: {moved:.2%}")
    assert moved > 0.1
    ref = mha_block_tome_plain(*tx, eps=EPS)
    for a, r in zip(out, ref):
        assert rel_err(a, r) <= TOL["float32"]
