"""The port's attention kernels B5 and B7 against vitx's, on the CPU.

On the CPU the wrappers run their plain torch versions; these are held
against vitx's Pallas kernels run in interpret mode (the CPU backend
``tests/conftest.py`` sets), on the same inputs from
``numpy.random.default_rng``:

- B5 ``flash_attention_fwd_plain`` in its three modes vs
  ``vitx.kernels.flash_attention._fwd`` (T = 65, 160, 197, not multiples
  of 64, and 1100, which vitx pads to 1152 and masks);
- B7 ``mha_block_mean_probs_plain`` and ``mha_block_plain`` vs
  ``vitx.kernels.mha_block._chunked_fwd`` with its head chunk forced to 1
  and 2 heads, so that the chunked accumulation really runs;
- ``multi_head_attention`` with probabilities vs vitx's;
- gradients through ``flash_attention`` (B2 backward), the probs variants
  and B7 (plain reference backwards) vs ``jax.grad`` of vitx's.

Tolerances are max |a - b| over max |b|: float32 1e-4, the repo's parity
bar. bfloat16: 2e-2 on outputs (both sides accumulate in fp32 in another
order, so a few bf16 roundings land one ulp apart) and 1e-3 on B5's
probabilities, which both sides compute in fp32 from the same bf16 q and
k. B7's head mean is sum(p / l) / H where vitx's chunked kernel sums
p / (l * H): the same value up to fp32 rounding, inside 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.kernels import flash_attention as jflash
from vitx.kernels import mha_block as jmha
from vitx.nn import attention as jattn
from vitx_torch.kernels import (flash_attention, flash_attention_fwd_plain,
                                flash_attention_with_mean_probs,
                                flash_attention_with_probs,
                                fused_mha_block_with_mean_probs,
                                mha_block_mean_probs_plain, mha_block_plain)
from vitx_torch.nn.attention import multi_head_attention

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROBS_TOL = {"float32": 1e-4, "bfloat16": 1e-3}


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
    return np.asarray(t.detach().float() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


def qkv(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [normal(rng, shape, 1.5) for _ in range(3)]
    return zip(*(both(a, dtype) for a in arrs))


# --- B5: the forward --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [None, "full", "mean"])
@pytest.mark.parametrize("shape", [(2, 3, 65, 16), (1, 4, 160, 32),
                                   (2, 2, 197, 64), (1, 2, 1100, 16)],
                         ids=["T65", "T160", "T197", "T1100"])
def test_flash_fwd_plain_matches_pallas(shape, mode, dtype):
    (jq, jk, jv), (tq, tk, tv) = qkv(shape, dtype)
    ref = jflash._fwd(jq, jk, jv, probs_mode=mode)
    out = flash_attention_fwd_plain(tq, tk, tv, mode)
    out = out if mode else (out,)
    assert out[0].dtype == tq.dtype and out[0].shape == tq.shape
    assert rel_err(f32(out[0]), f32(ref[0])) <= TOL[dtype]
    if mode:
        B, H, T, _ = shape
        assert out[1].dtype == torch.float32
        assert out[1].shape == ((B, H, T, T) if mode == "full" else (B, T, T))
        assert rel_err(f32(out[1]), f32(ref[1])) <= PROBS_TOL[dtype]


def test_flash_wrappers_run_plain_on_cpu():
    """CPU tensors take the plain version and count no launch; the inputs
    are checked."""
    _, (q, k, v) = qkv((2, 3, 65, 16), "bfloat16")
    fns = (flash_attention, flash_attention_with_probs,
           flash_attention_with_mean_probs)
    before = [f.launches for f in fns]
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_fwd_plain(q, k, v))
    for fn, mode in zip(fns[1:], ("full", "mean")):
        for a, b in zip(fn(q, k, v), flash_attention_fwd_plain(q, k, v,
                                                               mode)):
            assert torch.equal(a, b)
    assert [f.launches for f in fns] == before
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :-1], v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def test_flash_attention_refuses_long_sequences_under_grad():
    """Named for the T <= 1024 refusal under grad it once pinned; that
    refusal is gone. At T = 1025 autograd through ``flash_attention``
    (B2's function, B6's range) matches jax.grad through vitx's, whose
    backward is the q-chunked ``_bwd_kernel`` there (fp32); without grad
    the forward is B5's plain version."""
    shape = (1, 1, 1025, 16)
    rng = np.random.default_rng(7)
    arrs = [normal(rng, shape, 1.5) for _ in range(3)]
    wo = normal(rng, shape)
    ref = jax.grad(lambda q, k, v: jnp.sum(jflash.flash_attention(q, k, v)
                                           * wo),
                   argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    o = flash_attention(*ts)
    grads = torch.autograd.grad((o * torch.from_numpy(wo)).sum(), ts)
    for g, r in zip(grads, ref):
        assert rel_err(f32(g), f32(r)) <= TOL["float32"]
    with torch.no_grad():
        assert torch.equal(flash_attention(*ts),
                           flash_attention_fwd_plain(*ts))


# --- B5: gradients ----------------------------------------------------------

@pytest.mark.parametrize("variant", ["none", "full", "mean"])
def test_flash_grads_match_jax(variant):
    """autograd through B5's wrappers (B2 backward for ``flash_attention``,
    the reference attention for the probs variants) vs jax.grad through
    vitx's custom VJPs, fp32, T = 65."""
    shape = (2, 3, 65, 16)
    rng = np.random.default_rng(3)
    arrs = [normal(rng, shape, 1.5) for _ in range(3)]
    wo = normal(rng, shape)
    wp = normal(rng, (2, 3, 65, 65) if variant == "full" else (2, 65, 65))
    jfn = {"none": lambda q, k, v: (jflash.flash_attention(q, k, v), None),
           "full": jflash.flash_attention_with_probs,
           "mean": jflash.flash_attention_with_mean_probs}[variant]
    tfn = {"none": lambda q, k, v: (flash_attention(q, k, v), None),
           "full": flash_attention_with_probs,
           "mean": flash_attention_with_mean_probs}[variant]

    def jloss(q, k, v):
        o, p = jfn(q, k, v)
        out = jnp.sum(o * wo)
        return out if p is None else out + jnp.sum(p * wp)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    o, p = tfn(*ts)
    loss = (o * torch.from_numpy(wo)).sum()
    if p is not None:
        loss = loss + (p * torch.from_numpy(wp)).sum()
    grads = torch.autograd.grad(loss, ts)
    for g, r in zip(grads, ref):
        assert rel_err(f32(g), f32(r)) <= TOL["float32"]


# --- B7 and K1 against the head-chunked kernel --------------------------------

def block_inputs(B, T, E, H, seed=0):
    rng = np.random.default_rng(seed)
    D = E // H
    return {"x": normal(rng, (B, T, E)),
            "wqkv": normal(rng, (E, 3, H, D), 0.04),
            "wo": normal(rng, (E, E), 0.04), "bo": normal(rng, (E,), 0.1),
            "g": normal(rng, (E,), 0.1, 1.0), "b": normal(rng, (E,), 0.1)}


MHA = ("x", "wqkv", "wo", "bo", "g", "b")


def _as(arrs, dtype, lib):
    out = []
    for k in MHA:
        a = arrs[k]
        if lib == "jax":
            out.append(jnp.asarray(a, jnp.float32 if a.ndim == 1 else dtype))
        else:
            t = torch.from_numpy(a)
            out.append(t if a.ndim == 1 else t.to(getattr(torch, dtype)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hc", [1, 2])
@pytest.mark.parametrize("dims", [(2, 17, 64, 4), (1, 65, 96, 6)],
                         ids=["small", "T65"])
def test_mean_probs_plain_matches_chunked(monkeypatch, dims, hc, dtype):
    """B7's plain version vs ``_chunked_fwd(mean_probs=True)`` and K1's vs
    ``_chunked_fwd(mean_probs=False)`` (its no-probs mode is K1's
    function), with hc heads per chunk."""
    monkeypatch.setattr(jmha, "_chunk_plan", lambda *a, **k: (hc, 0))
    arrs = block_inputs(*dims)
    ref_out, ref_probs = jmha._chunked_fwd(*_as(arrs, dtype, "jax"),
                                           eps=1e-5, mean_probs=True)
    args = _as(arrs, dtype, "torch")
    out, probs = mha_block_mean_probs_plain(*args, eps=1e-5)
    assert out.dtype == args[0].dtype and probs.dtype == torch.float32
    assert rel_err(f32(out), f32(ref_out)) <= TOL[dtype]
    assert rel_err(f32(probs), f32(ref_probs)) <= TOL[dtype]
    ref = jmha._chunked_fwd(*_as(arrs, dtype, "jax"), eps=1e-5)
    assert rel_err(f32(mha_block_plain(*args, eps=1e-5)), f32(ref)) <= \
        TOL[dtype]


def test_mean_probs_wrapper_on_cpu():
    args = _as(block_inputs(2, 17, 64, 4), "bfloat16", "torch")
    n = fused_mha_block_with_mean_probs.launches
    for a, b in zip(fused_mha_block_with_mean_probs(*args),
                    mha_block_mean_probs_plain(*args)):
        assert torch.equal(a, b)
    assert fused_mha_block_with_mean_probs.launches == n
    assert torch.equal(fused_mha_block_with_mean_probs(*args)[0],
                       mha_block_plain(*args))
    with pytest.raises(ValueError):
        fused_mha_block_with_mean_probs(args[0], *args[1:3], args[3][:-1],
                                        *args[4:])


def test_mean_probs_grads_match_jax():
    """autograd through B7's wrapper (the composed backward) vs jax.grad
    of vitx's ``fused_mha_block_with_mean_probs`` (on the CPU its
    composed path, which vitx's chunked kernel differentiates too)."""
    arrs = block_inputs(2, 17, 64, 4, seed=5)
    rng = np.random.default_rng(6)
    wo_ = normal(rng, (2, 17, 64))
    wp = normal(rng, (2, 17, 17))

    def jloss(*a):
        out, p = jmha.fused_mha_block_with_mean_probs(*a, eps=1e-5)
        return jnp.sum(out * wo_) + jnp.sum(p * wp)

    ref = jax.grad(jloss, argnums=tuple(range(6)))(
        *_as(arrs, "float32", "jax"))
    ts = [t.requires_grad_() for t in _as(arrs, "float32", "torch")]
    out, p = fused_mha_block_with_mean_probs(*ts, eps=1e-5)
    loss = (out * torch.from_numpy(wo_)).sum() + (p * torch.from_numpy(
        wp)).sum()
    for g, r in zip(torch.autograd.grad(loss, ts), ref):
        assert rel_err(f32(g), f32(r)) <= TOL["float32"]


# --- multi_head_attention with probabilities ---------------------------------

@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("probs_mode", ["full", "mean"])
def test_multi_head_attention_probs_match_vitx(impl, probs_mode):
    """The composed attention with a QKV bias, both attention routes and
    both probability modes, fp32 (T = 65, 4 heads of D = 16)."""
    B, T, E, H = 2, 65, 64, 4
    rng = np.random.default_rng(7)
    x = normal(rng, (B, T, E))
    wqkv = normal(rng, (E, 3, H, E // H), 0.05)
    bqkv = normal(rng, (3, H, E // H), 0.1)
    wo = normal(rng, (E, E), 0.05)
    bo = normal(rng, (E,), 0.1)
    kw = dict(num_heads=H, impl=impl, return_probs=True,
              probs_mode=probs_mode)
    ref_out, ref_p = jattn.multi_head_attention(
        *map(jnp.asarray, (x, wqkv, bqkv, wo, bo)), **kw)
    out, p = multi_head_attention(
        *map(torch.from_numpy, (x, wqkv, bqkv, wo, bo)), **kw)
    assert p.shape == ref_p.shape
    assert rel_err(f32(out), f32(ref_out)) <= TOL["float32"]
    assert rel_err(f32(p), f32(ref_p)) <= TOL["float32"]
    out2, none = multi_head_attention(
        *map(torch.from_numpy, (x, wqkv, bqkv, wo, bo)), num_heads=H,
        impl=impl)
    assert none is None and torch.equal(out2, out)
