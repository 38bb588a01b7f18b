"""B5's probability modes and B10's one-pass route against vitx, on the CPU.

``flash_attention_with_probs`` and ``flash_attention_with_mean_probs`` (B5)
in bf16 at head widths 32, 64 and 128 run ``csrc/flash_attention_sm90.cu``:
the online-softmax body, which writes each row's statistics m and 1 / l,
then ``csrc/attention_probs_sm90.cuh``, a second pass that recomputes s =
q k^T per 128-key tile and writes exp(s - m) * linv, every head for the
full mode, summed over the heads in order and divided by H for the mean.
``fused_layer_norm`` and ``fused_add_layer_norm`` (B10) run
``csrc/layer_norm_fwd.cu``'s one-pass route where E is a multiple of the
16-byte vector. Both run only on the card; what they compute differently
from vitx is held here in plain mirrors of their algorithms, on inputs from
``numpy.random.default_rng``:

- (a) B5: the body's statistics (``tests/test_torch_attn_sm90.py``'s
  ``online_fwd_mirror``), then the pass per 128-key tile, keys past T
  TMA's zeros and never stored -- against vitx's ``flash_attention._fwd
  (probs_mode=...)`` (``_fwd_kernel`` in Pallas interpret mode) at
  (1, 2, 197, 64) and (2, 3, 65, 64); the full mode's head mean against
  the mean mode.
- (b) B10: the one-pass route's summation order for the two statistics
  (each thread's 16-byte vectors in order, the warp's butterfly, the row
  group's warps in order, on the layout ``onepass_grid`` gives) against
  vitx's ``fused_layer_norm`` / ``fused_add_layer_norm`` (``_ln_kernel`` in
  interpret mode) at (2, 197, 768) and ragged row counts; the sum equal to
  x + r bit for bit.
- (c) the route functions: the probability modes take sm90 only in bf16 at
  D 32, 64 and 128 with 16-byte-aligned contiguous planes (the pass at D
  32 and 128 is held in ``tests/test_torch_attn_sm90.py``); B10's one-pass route takes
  exactly the widths, dtypes and alignments it says; its grid covers every
  row once; the wrappers on CPU tensors count nothing.

Bars are max |a - b| over max |b|: float32 1e-4; bfloat16 1e-2 for B5's o
and B10, 1e-3 for B5's probabilities, which both sides compute in fp32 from
bf16 q and k. Rows of probabilities sum to 1 within 1e-5. ``-s`` prints
the measured gaps.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attn_sm90 import online_fwd_mirror

from vitx.kernels import flash_attention as jflash
from vitx.kernels import layer_norm as jln
from vitx_torch.kernels import (flash_attention_fwd_plain,
                                flash_attention_with_mean_probs,
                                flash_attention_with_probs,
                                fused_add_layer_norm, fused_layer_norm,
                                layer_norm_fwd_plain)
from vitx_torch.nn.layers import matmul32

tflash = importlib.import_module("vitx_torch.kernels.flash_attention")
tln = importlib.import_module("vitx_torch.kernels.layer_norm")

torch.set_num_threads(1)

OUT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
PROBS_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
LN_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the full mode's head mean against the mean mode: an fp32 rounding of each
# head's product exp(s - m) * linv, which the mean mode fuses into its sum
HEAD_MEAN_TOL = 1e-6
EPS = 1e-5
PASS_KEYS = 128     # the probability pass's key tile (AP_KEYS)
H100_SMS = 132


def rel_err(a, b):
    a = np.asarray(a.float() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.float() if torch.is_tensor(b) else b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def f32(t):
    if torch.is_tensor(t):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# --- (a) B5: the sm90 body's statistics, then the probability pass -----------

def attn_inputs(shape, dtype, seed):
    """q, k, v of a projection's scale as (jax, torch) lists in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [(1.5 * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(3)]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def probs_sm90_mirror(q, k, v, mode):
    """B5's probability mode as the sm90 route computes it -> (o, probs):
    the body's o and statistics, then per 128-key tile p = exp(s * scale -
    m) * linv, each head's for "full", summed in head order and divided by
    H for "mean"; the ragged last tile's keys past T are zeros and not
    stored."""
    B, H, T, D = q.shape
    o, stats = online_fwd_mirror(q, k, v)
    m, linv = stats[0][..., None], stats[1][..., None]
    scale = 1.0 / D ** 0.5   # 2^-3: the scale after the fp32 product is exact
    kpad = torch.zeros((B, H, -(-T // PASS_KEYS) * PASS_KEYS, D),
                       dtype=k.dtype)
    kpad[:, :, :T] = k
    full = torch.empty((B, H, T, T))
    mean = torch.empty((B, T, T))
    for j in range(0, T, PASS_KEYS):
        s = matmul32(q, kpad[:, :, j:j + PASS_KEYS].transpose(-1, -2))
        p = torch.exp(s * scale - m) * linv          # (B, H, T, 128)
        full[..., j:j + PASS_KEYS] = p[..., :T - j]
        tile = p[:, 0]
        for h in range(1, H):
            tile = tile + p[:, h]
        mean[..., j:j + PASS_KEYS] = (tile / H)[..., :T - j]
    return o, (full if mode == "full" else mean)


@pytest.mark.parametrize("mode", ["full", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 197, 64), (2, 3, 65, 64)],
                         ids=["T197", "T65"])
def test_b5_probs_sm90_mirror_matches_pallas(shape, dtype, mode):
    """The mirror vs vitx's ``_fwd(probs_mode=mode)`` (``_fwd_kernel``,
    interpret mode): o and the probabilities; rows sum to 1."""
    jx, tx = attn_inputs(shape, dtype, 60 + shape[2])
    ref_o, ref_p = jflash._fwd(*jx, probs_mode=mode)
    o, probs = probs_sm90_mirror(*tx, mode)
    err_o = rel_err(o, f32(ref_o))
    err_p = rel_err(probs, f32(ref_p))
    rows = float((probs.double().sum(-1) - 1).abs().max())
    print(f"B5 {mode} sm90 mirror {shape} {dtype}: o {err_o:.3e}, probs "
          f"{err_p:.3e}, row sums {rows:.1e}")
    assert o.dtype == tx[0].dtype and probs.dtype == torch.float32
    assert tuple(probs.shape) == tuple(ref_p.shape)
    assert err_o <= OUT_TOL[dtype], err_o
    assert err_p <= PROBS_TOL[dtype], err_p
    assert rows <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b5_full_head_mean_is_the_mean_mode(dtype):
    """The full mode's probabilities summed in head order and divided by H
    against the mean mode's, the check ``chip_smoke.py`` makes on the
    card; both against the plain version."""
    _, tx = attn_inputs((2, 4, 129, 64), dtype, 70)
    o_f, full = probs_sm90_mirror(*tx, "full")
    o_m, mean = probs_sm90_mirror(*tx, "mean")
    assert torch.equal(o_f, o_m)
    acc = full[:, 0]
    for h in range(1, full.shape[1]):
        acc = acc + full[:, h]
    err = rel_err(acc / full.shape[1], mean)
    print(f"B5 full mode's head mean vs mean mode {dtype}: {err:.3e}")
    assert err <= HEAD_MEAN_TOL, err
    for mode, p in (("full", full), ("mean", mean)):
        ref = flash_attention_fwd_plain(*tx, mode)
        assert rel_err(p, ref[1]) <= PROBS_TOL[dtype]


@pytest.mark.parametrize("mode", ["full", "mean"])
def test_b5_probs_wrappers_on_cpu_count_nothing(mode):
    _, tx = attn_inputs((2, 2, 65, 64), "bfloat16", 71)
    fn = {"full": flash_attention_with_probs,
          "mean": flash_attention_with_mean_probs}[mode]
    before = (fn.launches, fn.launches_sm90)
    for a, r in zip(fn(*tx), flash_attention_fwd_plain(*tx, mode)):
        assert torch.equal(a, r)
    assert (fn.launches, fn.launches_sm90) == before


# --- (b) B10: the one-pass route's summation order ----------------------------

def group_sums(terms, E, dtype):
    """Each row of ``terms`` (R, E) fp32 summed as the one-pass kernel sums
    it: every thread its vectors j in order and their elements in order,
    the warp's xor butterfly, then the row group's warps in order."""
    grid = tln.onepass_grid(1, E, dtype, H100_SMS)
    vec = 16 // (torch.finfo(dtype).bits // 8)
    gt, nv = 32 * grid["wpr"], grid["nv"]
    R = terms.shape[0]
    t = torch.zeros((R, nv * gt * vec))
    t[:, :E] = terms                  # vectors past E hold nothing
    t = t.reshape(R, nv, gt, vec)
    acc = torch.zeros((R, gt))
    for j in range(nv):
        for e in range(vec):
            acc = acc + t[:, j, :, e]
    lanes = acc.reshape(R, grid["wpr"], 32)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    tot = lanes[:, 0, 0]
    for w in range(1, grid["wpr"]):
        tot = tot + lanes[:, w, 0]
    return tot


def ln_fwd_mirror(x, scale, bias, r=None):
    """B10 on the one-pass route -> y, or (s, y) with ``r``: s = cast(x +
    r); mean and the mean of squared deviations from ``group_sums``, inv =
    1 / sqrt(var + eps), y = ((v - mean) * inv) * scale + bias cast once."""
    E = x.shape[-1]
    s = None if r is None else (x.float() + r.float()).to(x.dtype)
    v = (x if s is None else s).reshape(-1, E).float()
    mean = group_sums(v, E, x.dtype) / E
    d = v - mean[:, None]
    var = group_sums(d * d, E, x.dtype) / E
    inv = 1.0 / torch.sqrt(var + EPS)
    y = ((d * inv[:, None]) * scale + bias).to(x.dtype).reshape(x.shape)
    return y if s is None else (s, y)


def ln_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    E = shape[-1]
    arrs = [(0.5 + 3.0 * rng.standard_normal(shape)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32),
            (0.1 * rng.standard_normal(E)).astype(np.float32)]
    low = (0, 1)   # x and r in the compute dtype
    jx = [jnp.asarray(a, getattr(jnp, dtype) if i in low else jnp.float32)
          for i, a in enumerate(arrs)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) if i in low
          else torch.from_numpy(a) for i, a in enumerate(arrs)]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 197, 768), (3, 101, 768), (5, 1024),
                                   (3, 3072)],
                         ids=["base16_b2", "ragged_rows", "E1024", "E3072"])
def test_b10_onepass_mirror_matches_pallas(shape, dtype):
    """The mirror vs vitx's ``fused_layer_norm`` and ``fused_add_layer_norm``
    (``_ln_kernel``, interpret mode): y, and the sum bit for bit."""
    jx, tx = ln_inputs(shape, dtype, 30 + shape[0])
    x, r, sc, bi = tx
    ref_y = jln.fused_layer_norm(jx[0], jx[2], jx[3], EPS)
    ref_s, ref_ya = jln.fused_add_layer_norm(*jx, EPS)
    y = ln_fwd_mirror(x, sc, bi)
    s, ya = ln_fwd_mirror(x, sc, bi, r)
    err, err_a = rel_err(y, f32(ref_y)), rel_err(ya, f32(ref_ya))
    print(f"B10 one-pass mirror {shape} {dtype}: y {err:.3e}, add y "
          f"{err_a:.3e}")
    assert y.dtype == ya.dtype == s.dtype == x.dtype
    assert err <= LN_TOL[dtype] and err_a <= LN_TOL[dtype], (err, err_a)
    assert np.array_equal(f32(s), f32(ref_s))
    assert torch.equal(s, x + r)


def test_b10_onepass_mirror_matches_plain():
    """The mirror's statistics, summed in the kernel's order, against the
    plain version's at the reference head's width in fp32 (8 warps a row:
    the cross-warp sum)."""
    _, tx = ln_inputs((4, 4096), "float32", 40)
    assert tln.onepass_grid(4, 4096, torch.float32, H100_SMS)["wpr"] == 8
    x, r, sc, bi = tx
    assert rel_err(ln_fwd_mirror(x, sc, bi),
                   layer_norm_fwd_plain(x, sc, bi)) <= 1e-6
    for a, b in zip(ln_fwd_mirror(x, sc, bi, r),
                    layer_norm_fwd_plain(x, sc, bi, r)):
        assert rel_err(a, b) <= 1e-6


def test_b10_wrappers_on_cpu_count_nothing():
    _, tx = ln_inputs((2, 65, 768), "bfloat16", 41)
    x, r, sc, bi = tx
    before = (fused_layer_norm.launches, fused_layer_norm.launches_onepass,
              fused_add_layer_norm.launches,
              fused_add_layer_norm.launches_onepass)
    assert torch.equal(fused_layer_norm(x, sc, bi),
                       layer_norm_fwd_plain(x, sc, bi))
    for a, b in zip(fused_add_layer_norm(x, r, sc, bi),
                    layer_norm_fwd_plain(x, sc, bi, r)):
        assert torch.equal(a, b)
    assert before == (fused_layer_norm.launches,
                      fused_layer_norm.launches_onepass,
                      fused_add_layer_norm.launches,
                      fused_add_layer_norm.launches_onepass)


# --- (c) the routes ---------------------------------------------------------

@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, 1), (torch.float32, 64, 0),
    (torch.bfloat16, 32, 1), (torch.bfloat16, 128, 1),
    (torch.float16, 64, 0)])
def test_b5_probs_route(dtype, D, route):
    q = torch.zeros((2, 3, 65, D), dtype=dtype)
    assert tflash.probs_route(q, q, q) == route
    assert tflash.ROUTE_SM90 == 1


def test_b5_probs_route_needs_contiguous_aligned_planes():
    buf = torch.zeros(2 * 3 * 65 * 64 + 1, dtype=torch.bfloat16)
    q = buf[:-1].view(2, 3, 65, 64)
    assert tflash.probs_route(q, q, q) == tflash.ROUTE_SM90
    shifted = buf[1:].view(2, 3, 65, 64)         # 2 bytes off a boundary
    assert tflash.probs_route(q, shifted, q) == 0
    strided = torch.zeros((2, 65, 3, 64), dtype=torch.bfloat16).transpose(
        1, 2)
    assert tflash.probs_route(q, q, strided) == 0


def test_b5_probs_launcher_refuses_an_unknown_route():
    _, tx = attn_inputs((1, 2, 65, 64), "bfloat16", 72)
    with pytest.raises(ValueError, match="route must be"):
        tflash._launch_probs(*tx, "mean", route=2)


@pytest.mark.parametrize("dtype,E,onepass", [
    (torch.bfloat16, 768, True), (torch.bfloat16, 1024, True),
    (torch.bfloat16, 3072, True), (torch.bfloat16, 4096, True),
    (torch.bfloat16, 64, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 100, False), (torch.bfloat16, 36, False),
    (torch.bfloat16, 4104, False), (torch.float32, 768, True),
    (torch.float32, 100, True), (torch.float32, 4096, True),
    (torch.float32, 38, False), (torch.float32, 4100, False),
    (torch.float16, 768, False)])
def test_b10_route(dtype, E, onepass):
    assert (tln.ln_fwd_route(dtype, E) == tln.LN_ROUTE_ONEPASS) == onepass


def test_b10_route_needs_aligned_tensors():
    buf = torch.zeros(2 * 768 + 4, dtype=torch.float32)
    aligned, shifted = buf[:768], buf[1:769]
    x = torch.zeros((4, 768), dtype=torch.bfloat16)
    assert tln.ln_fwd_route(torch.bfloat16, 768, (x, aligned)) == 1
    assert tln.ln_fwd_route(torch.bfloat16, 768, (x, shifted)) == 0


@pytest.mark.parametrize("R", [1, 7, 8, 9, 263, 394, 50432, 32 * 1025])
@pytest.mark.parametrize("E,dtype", [(768, torch.bfloat16),
                                     (1024, torch.bfloat16),
                                     (3072, torch.float32)])
def test_b10_onepass_grid_covers_rows(R, E, dtype):
    """Every row in exactly one block (the entry's own check), and every row
    of a block in exactly one row group: group g takes rows g, g + groups,
    ...."""
    grid = tln.onepass_grid(R, E, dtype, H100_SMS)
    nb, rpb, groups = grid["blocks"], grid["rows_per_block"], grid["groups"]
    assert nb * rpb >= R > (nb - 1) * rpb
    seen = np.zeros(R, np.int64)
    for blk in range(nb):
        r0, r1 = blk * rpb, min(R, (blk + 1) * rpb)
        for g in range(groups):
            seen[r0 + g:r1:groups] += 1
    assert (seen == 1).all()


def test_unaligned_inputs_are_copied_to_a_16_byte_boundary():
    """Fault C4 (ROADMAP): a contiguous view whose data starts off a
    16-byte boundary reaches the kernels as a copy on one (``aligned``,
    and ``_view`` for the sm90 attention's TMA maps); aligned tensors pass
    as they are."""
    from vitx_torch.kernels import _build

    buf = torch.arange(2 * 3 * 65 * 64 + 1, dtype=torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        base = buf.to(dt)
        ok, off = base[:-1].view(2, 3, 65, 64), base[1:].view(2, 3, 65, 64)
        assert off.is_contiguous() and off.data_ptr() % 16 != 0
        a, b = _build.aligned(ok, off)
        assert a is ok
        assert b.data_ptr() % 16 == 0 and torch.equal(b, off)
        t, strides = tflash._view(off)
        assert t.data_ptr() % 16 == 0 and torch.equal(t, off)
        assert strides == [3 * 65 * 64, 65 * 64, 64]
