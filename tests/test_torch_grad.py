"""The port's backward kernels and block gradients against vitx's.

On the CPU the wrappers run their plain torch versions; these are held
against vitx's Pallas kernels run in interpret mode (the CPU backend
``tests/conftest.py`` sets), on the same inputs from
``numpy.random.default_rng``:

- B2 ``attention_bwd`` vs ``vitx.kernels.flash_attention._bwd``;
- B3 ``ln_bwd`` vs ``vitx.kernels.layer_norm.ln_bwd``, called directly
  (vitx's own dispatch takes jnp math off the TPU);
- the K1 stash vs ``vitx.kernels.mha_block._fused_fwd(stash=True)``;
- ``torch.autograd.grad`` through ``fused_mha_block`` and
  ``fused_mlp_block`` vs ``jax.vjp`` of vitx's, whose custom VJPs run the
  flash backward in interpret mode;
- B12 ``fused_adamw_`` vs ``vitx.kernels.adamw.fused_adamw``,
  ``adamw_multi_plain`` (what ``fused_adamw_multi_``'s kernel computes) vs
  the same bit for bit over leaves of ragged sizes, and the port's
  ``make_optimizer`` vs vitx's (optax) over 3 steps.

Tolerances are max |a - b| over max |b|: float32 1e-4, the repo's parity
bar. bfloat16 bars, each for one kernel against its Pallas twin:

- B2 and B3: 1e-2. Both sides accumulate in fp32 in another order, so a
  few bf16 roundings (qs, cast(pu), do/l, e, q*scale/l; dx) land one ulp
  (2**-8) apart, and a product of such values moves by a few ulps of its
  largest element.
- block gradients: 2e-2. The chain of five casts (do, dq|dk|dv, dh, dx)
  compounds the one-ulp moves above.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitx.kernels import adamw as jadamw
from vitx.kernels import flash_attention as jflash
from vitx.kernels import layer_norm as jln
from vitx.kernels import mha_block as jmha
from vitx.kernels import mlp_block as jmlp
from vitx.train import step as jstep
from vitx_torch.kernels import (adamw_multi_plain, attention_bwd,
                                fused_adamw_, fused_adamw_multi_,
                                fused_mha_block, fused_mlp_block, ln_bwd)
from vitx_torch.nn.layers import drop_path, dropout
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SHAPES = {"small": (2, 17, 64, 4), "base16": (2, 197, 768, 12)}


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def normal(rng, shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def both(a, dtype):
    """numpy -> (jax array, torch tensor) in ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def f32(t):
    return np.asarray(t.float() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


# --- B2: attention backward -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["small", "base16"])
def test_attention_bwd_matches_pallas(shape, dtype):
    B, T, E, H = SHAPES[shape]
    D = E // H
    rng = np.random.default_rng(0)
    # q, k, v of a projection's scale; do of a gradient's
    arrs = [normal(rng, (B, H, T, D), 1.5) for _ in range(3)]
    arrs.append(normal(rng, (B, H, T, D), 0.1))
    jx, tx = zip(*(both(a, dtype) for a in arrs))
    ref = jflash._bwd(tuple(jx[:3]), jx[3])
    n = attention_bwd.launches
    out = attention_bwd(*tx)
    assert attention_bwd.launches == n      # CPU tensors: no launch
    for o, r in zip(out, ref):
        assert o.dtype == tx[0].dtype and o.shape == tx[0].shape
        err = rel_err(f32(o), f32(r))
        assert err <= TOL[dtype], err


def test_attention_bwd_refuses_long_sequences():
    """Named for the T <= 1024 refusal it once pinned; that refusal is
    gone. Past T = 1024, where vitx's ``_bwd`` takes its q-chunked kernel
    (B6), ``attention_bwd`` refuses nothing and matches it (fp32)."""
    rng = np.random.default_rng(6)
    shape = (1, 1, 1025, 16)
    arrs = [normal(rng, shape, 1.5) for _ in range(3)]
    arrs.append(normal(rng, shape, 0.1))
    jx, tx = zip(*(both(a, "float32") for a in arrs))
    ref = jflash._bwd(tuple(jx[:3]), jx[3])
    for o, r in zip(attention_bwd(*tx), ref):
        assert o.shape == tx[0].shape
        assert rel_err(f32(o), f32(r)) <= TOL["float32"]


# --- B3: LayerNorm backward -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 197, 768), (2, 3072), (3, 5, 48)],
                         ids=["blocks", "head", "ragged"])
def test_ln_bwd_matches_pallas(shape, dtype):
    rng = np.random.default_rng(1)
    E = shape[-1]
    x = normal(rng, shape, 2.0, 0.5)
    dy = normal(rng, shape, 0.1)
    scale = normal(rng, (E,), 0.1, 1.0)
    (jx, tx), (jdy, tdy) = both(x, dtype), both(dy, dtype)
    ref = jln.ln_bwd(jx, jnp.asarray(scale), jdy, eps=1e-5)
    out = ln_bwd(tx, torch.from_numpy(scale), tdy, eps=1e-5)
    assert out[0].dtype == tx.dtype and out[0].shape == tx.shape
    assert out[1].dtype == out[2].dtype == torch.float32
    for o, r in zip(out, ref):
        err = rel_err(f32(o), f32(r))
        assert err <= TOL[dtype], err


# --- K1 stash and the blocks' gradients --------------------------------------

def block_inputs(B, T, E, H, seed=0):
    rng = np.random.default_rng(seed)
    D, M = E // H, 4 * E
    return {"x": normal(rng, (B, T, E)),
            "wqkv": normal(rng, (E, 3, H, D), 0.04),
            "wo": normal(rng, (E, E), 0.04), "bo": normal(rng, (E,), 0.1),
            "g": normal(rng, (E,), 0.1, 1.0), "b": normal(rng, (E,), 0.1),
            "w1": normal(rng, (E, M), 0.04), "b1": normal(rng, (M,), 0.1),
            "w2": normal(rng, (M, E), 0.04), "b2": normal(rng, (E,), 0.1),
            "dout": normal(rng, (B, T, E), 0.1)}


MHA = ("x", "wqkv", "wo", "bo", "g", "b")
MLP = ("x", "w1", "b1", "w2", "b2", "g", "b")


def as_args(arrs, names, dtype):
    """Compute-dtype x and weights, fp32 vectors, for jax and torch."""
    j, t = [], []
    for k in names:
        dt = "float32" if arrs[k].ndim == 1 else dtype
        ja, ta = both(arrs[k], dt)
        j.append(ja)
        t.append(ta.requires_grad_())
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["small", "base16"])
def test_mha_stash_matches_pallas(shape, dtype):
    arrs = block_inputs(*SHAPES[shape])
    j, t = as_args(arrs, MHA, dtype)
    ref = jmha._fused_fwd(*j, eps=1e-5, stash=True)
    out = fused_mha_block(*t, eps=1e-5, stash=True)
    assert len(out) == 5
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        assert not o.requires_grad
        err = rel_err(f32(o), f32(r))
        assert err <= TOL[dtype], err
    # the stashed q is the unscaled projection, not q / sqrt(D)
    D = t[1].shape[3]
    scaled = f32(out[1]) / np.sqrt(D)
    assert rel_err(scaled, f32(ref[1])) > 0.5


@pytest.mark.parametrize("dtype,shape", [("float32", "small"),
                                         ("bfloat16", "small"),
                                         ("float32", "base16")])
def test_mha_grads_match_jax_vjp(shape, dtype):
    arrs = block_inputs(*SHAPES[shape], seed=2)
    j, t = as_args(arrs, MHA, dtype)
    jd, td = both(arrs["dout"], dtype)
    out_j, vjp = jax.vjp(
        functools.partial(jmha.fused_mha_block, eps=1e-5), *j)
    ref = vjp(jd)
    out = fused_mha_block(*t, eps=1e-5)
    assert rel_err(f32(out.detach()), f32(out_j)) <= BLOCK_TOL[dtype]
    grads = torch.autograd.grad(out, t, td)
    for name, g, r in zip(MHA, grads, ref):
        assert g.dtype == t[MHA.index(name)].dtype, name
        err = rel_err(f32(g), f32(r))
        assert err <= BLOCK_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype,act", [("float32", "gelu"),
                                       ("float32", "gelu_tanh"),
                                       ("float32", "relu"),
                                       ("bfloat16", "gelu_tanh")])
def test_mlp_grads_match_jax_vjp(act, dtype):
    arrs = block_inputs(*SHAPES["small"], seed=3)
    j, t = as_args(arrs, MLP, dtype)
    jd, td = both(arrs["dout"], dtype)
    out_j, vjp = jax.vjp(
        functools.partial(jmlp.fused_mlp_block, act=act, eps=1e-5), *j)
    ref = vjp(jd)
    out = fused_mlp_block(*t, act=act, eps=1e-5)
    assert rel_err(f32(out.detach()), f32(out_j)) <= BLOCK_TOL[dtype]
    grads = torch.autograd.grad(out, t, td)
    for name, g, r in zip(MLP, grads, ref):
        err = rel_err(f32(g), f32(r))
        assert err <= BLOCK_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_stash_matches_pallas(dtype):
    arrs = block_inputs(*SHAPES["small"], seed=4)
    j, t = as_args(arrs, MLP, dtype)
    ref = jmlp._fused_fwd(*j, act="gelu_tanh", eps=1e-5, stash=True)
    out = fused_mlp_block(*t, act="gelu_tanh", eps=1e-5, stash=True)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        err = rel_err(f32(o), f32(r))
        assert err <= TOL[dtype], err


# --- B12 and the optimizer ---------------------------------------------------

def optimizer_inputs(shape, seed=5, steps=3):
    rng = np.random.default_rng(seed)
    p = normal(rng, shape, 0.05)
    # gradients of mixed sizes, some far below eps's scale
    gs = [normal(rng, shape, 1e-3) * rng.choice([1e-4, 1.0, 10.0], shape)
          .astype(np.float32) for _ in range(steps)]
    return p, gs


def test_fused_adamw_matches_pallas():
    """One 65536-element leaf: the size vitx's kernel takes."""
    p, gs = optimizer_inputs((64, 1024))
    lr, wd = 1e-3, 1e-4
    tx = jadamw.fused_adamw(lr, weight_decay=wd)
    jp = jnp.asarray(p)
    state = tx.init(jp)
    tp = torch.from_numpy(p.copy())
    mu, nu = torch.zeros_like(tp), torch.zeros_like(tp)
    n = fused_adamw_.launches
    for t, g in enumerate(gs, start=1):
        jp, state = tx.update(jnp.asarray(g), state, jp)
        c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t))
        c2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t))
        fused_adamw_(tp, torch.from_numpy(g), mu, nu, lr=lr, c1=c1, c2=c2,
                     wd=wd)
    assert fused_adamw_.launches == n
    assert rel_err(tp.numpy(), np.asarray(jp)) <= TOL["float32"]
    assert rel_err(mu.numpy(), np.asarray(state.mu)) <= TOL["float32"]
    assert rel_err(nu.numpy(), np.asarray(state.nu)) <= TOL["float32"]


# leaf sizes no (8, 128) tiling takes: vitx's fused_adamw updates them with
# _update_math outside jit, one IEEE rounding an operation. (Its Pallas
# kernel, which a 65536-element leaf takes, runs fused by XLA in interpret
# mode and rounds elsewhere in ~5 % of p's elements, a few ulps:
# test_fused_adamw_matches_pallas holds it at 1e-4.)
RAGGED = (1, 3, 1025, 65536 + 5)


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_adamw_multi_plain_matches_vitx_bitwise(gdtype):
    """``adamw_multi_plain`` over a list of leaves of ragged sizes, 3 steps,
    bit for bit against vitx's ``fused_adamw``, gradients fp32 or bf16;
    ``fused_adamw_multi_`` on the CPU writes the same bits in place and
    launches nothing."""
    rng = np.random.default_rng(8)
    ps = [normal(rng, (n,), 0.05) for n in RAGGED]
    lr, wd = 1e-3, 1e-4
    tx = jadamw.fused_adamw(lr, weight_decay=wd)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(ps)}
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    mu = [torch.zeros_like(t) for t in tp]
    nu = [torch.zeros_like(t) for t in tp]
    wp, wmu, wnu = ([t.clone() for t in ts] for ts in (tp, mu, nu))
    n = fused_adamw_multi_.launches
    for t in range(1, 4):
        gs = [normal(rng, (m,), 1e-3) for m in RAGGED]
        jg = {str(i): jnp.asarray(g, getattr(jnp, gdtype))
              for i, g in enumerate(gs)}
        jp, state = tx.update(jg, state, jp)
        tg = [torch.from_numpy(g).to(getattr(torch, gdtype)) for g in gs]
        kw = dict(lr=lr, c1=float(np.float32(1) - np.float32(0.9)
                                  ** np.float32(t)),
                  c2=float(np.float32(1) - np.float32(0.999)
                           ** np.float32(t)), b1=0.9, b2=0.999, eps=1e-8,
                  wd=wd)
        tp, mu, nu = adamw_multi_plain(tp, tg, mu, nu, **kw)
        fused_adamw_multi_(wp, tg, wmu, wnu, **kw)
    assert fused_adamw_multi_.launches == n
    for i in range(len(RAGGED)):
        for got in (tp[i], wp[i]):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jp[str(i)]))
        for got, want in ((mu[i], state.mu[str(i)]), (wmu[i], state.mu[
                str(i)]), (nu[i], state.nu[str(i)]),
                          (wnu[i], state.nu[str(i)])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_update_keeps_its_bits_on_cpu():
    """``AdamW(fused=True).update`` on the CPU (``fused_adamw_multi_``'s
    plain version) writes what the update wrote leaf by leaf before it
    took one call -- the formula with Python divisors and a float64 root,
    bit for bit -- and the same as ``fused=False``."""
    rng = np.random.default_rng(9)
    shapes = {"a": (256, 33), "b": (300,), "c": {"d": (7,)}}
    params = tstep.tree_map(lambda s: torch.from_numpy(normal(rng, s, 0.05)),
                            shapes)
    grads = [torch.from_numpy(normal(rng, tuple(t.shape), 1e-3))
             for t in tstep.leaves(params)]
    out = {}
    for fused in (True, False):
        opt = tstep.make_optimizer(lr=1e-3, fused=fused)
        p = tstep.tree_map(torch.clone, params)
        state = opt.init(p)
        for _ in range(2):
            p, state = opt.update(list(grads), state, p)
        out[fused] = tstep.leaves(p) + tstep.leaves(state.mu) + \
            tstep.leaves(state.nu)
    # the update as it was written before: Python scalars throughout
    p = [t.clone() for t in tstep.leaves(params)]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    f32 = np.float32
    for count in (1, 2):
        c1 = float(f32(1.0) - f32(0.9) ** f32(count))
        c2 = float(f32(1.0) - f32(0.999) ** f32(count))
        lr = float(f32(1e-3))
        for i, g in enumerate(grads):
            m[i] = 0.9 * m[i] + (1.0 - 0.9) * g
            v[i] = 0.999 * v[i] + (1.0 - 0.999) * g * g
            root = torch.sqrt((v[i] / c2).double()).float()
            p[i] = p[i] - lr * ((m[i] / c1) / (root + 1e-8) + 1e-4 * p[i])
    for a, b, c in zip(out[True], out[False], p + m + v):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("sched", [None, "warmup_cosine"])
@pytest.mark.parametrize("clip", [None, 0.05])
def test_optimizer_matches_vitx(fused, sched, clip):
    """The port's make_optimizer against vitx's (optax's adamw, or the
    Pallas kernel with fused=True) over 3 steps on a two-leaf tree. The
    params agree to fp32 rounding: every step moves each element by about
    lr whatever its gradient, so the moments' rounding shows only in the
    last bits."""
    p1, g1 = optimizer_inputs((256, 256), seed=6)
    p2, g2 = optimizer_inputs((300,), seed=7)
    kw = dict(lr=1e-3, grad_clip=clip, fused=fused)
    jkw, tkw = dict(kw), dict(kw)
    if sched:
        jkw["schedule"] = jstep.warmup_cosine(1e-3, 5, warmup_steps=2)
        tkw["schedule"] = tstep.warmup_cosine(1e-3, 5, warmup_steps=2)
    jopt, topt = jstep.make_optimizer(**jkw), tstep.make_optimizer(**tkw)
    jparams = {"a": jnp.asarray(p1), "b": jnp.asarray(p2)}
    tparams = {"a": torch.from_numpy(p1.copy()),
               "b": torch.from_numpy(p2.copy())}
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for s in range(3):
        jg = {"a": jnp.asarray(g1[s]), "b": jnp.asarray(g2[s])}
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = (upd if getattr(jopt, "returns_new_params", False)
                   else optax.apply_updates(jparams, upd))
        tg = {"a": torch.from_numpy(g1[s]), "b": torch.from_numpy(g2[s])}
        tparams, tstate = topt.update(tg, tstate, tparams)
    assert tstate.count == 3
    for k in ("a", "b"):
        err = rel_err(tparams[k].numpy(), np.asarray(jparams[k]))
        assert err <= 1e-6, (k, err)


def test_warmup_cosine_matches_optax():
    for args in ((1e-3, 10, 3), (3e-4, 7, 0, 0.1)):
        j, t = jstep.warmup_cosine(*args), tstep.warmup_cosine(*args)
        for c in range(12):
            assert np.float32(t(c)) == pytest.approx(float(j(c)), rel=1e-6,
                                                     abs=1e-12)


# --- dropout and drop_path --------------------------------------------------

def test_dropout_and_drop_path_statistics():
    x = torch.ones(400, 50, 8)
    for fn in (dropout, drop_path):
        assert fn(x, 0.3, None, deterministic=True) is x
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.3, gen, deterministic=False)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    y = drop_path(x, 0.25, gen, deterministic=False)
    per_sample = (y != 0).float().mean(dim=(1, 2))
    assert set(per_sample.tolist()) <= {0.0, 1.0}   # whole samples drop
    assert abs(float(per_sample.mean()) - 0.75) < 0.06
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    # the generator is the only source of randomness
    a = dropout(x, 0.5, torch.Generator().manual_seed(3), deterministic=False)
    b = dropout(x, 0.5, torch.Generator().manual_seed(3), deterministic=False)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        dropout(x, 0.5, None, deterministic=False)
