"""The port's ``fused_layer_norm`` entries against vitx's, on the CPU.

On the CPU the entries run their plain version (``layer_norm_fwd_plain``)
and their backward runs B3's plain version on the 2-D view; these are held
against vitx's entries, whose forward is the Pallas kernel ``_ln_kernel``
(B10) and whose backward is ``_ln_bwd_kernel`` (B11), both in interpret
mode (the CPU backend ``tests/conftest.py`` sets), on the same inputs from
``numpy.random.default_rng``, at ranks 2 to 4 and widths that are and are
not multiples of 128.

Bars in float32 are vitx's own (``tests/test_kernels.py:104-126``):
outputs rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-4. In
bfloat16 both sides take the same fp32 statistics of the same bf16 input
in another summation order, which tips an output's rounding by one bf16
ulp (2**-8 relative) now and then: max |a - b| over max |b| within 1e-2,
the repo's bf16 bar. The add variant's sum is cast(fp32(x) + fp32(r)) on
both sides: equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.kernels import layer_norm as jln
from vitx_torch import (fused_add_layer_norm, fused_layer_norm,
                        layer_norm_fwd_plain)
from vitx_torch.kernels import ln_bwd

torch.set_num_threads(1)

SHAPES = {"rank2": (64, 128), "rank3": (3, 17, 96), "rank4": (2, 3, 5, 100)}
DTYPES = ["float32", "bfloat16"]
BF16_TOL = 1e-2


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def f32(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


def close(out, ref, dtype, rtol, atol):
    if dtype == "float32":
        np.testing.assert_allclose(f32(out), f32(ref), rtol=rtol, atol=atol)
    else:
        assert rel_err(f32(out), f32(ref)) <= BF16_TOL


def inputs(shape, dtype, seed=0):
    """x (scale 3, as vitx's test), r, the fp32 scale and bias, and a
    weight for the sum's cotangent: numpy, then (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    E = shape[-1]
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    s, b = (rng.standard_normal(E).astype(np.float32) for _ in range(2))
    w = rng.standard_normal(shape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ((jnp.asarray(x, jd), torch.from_numpy(x).to(td)),
            (jnp.asarray(r, jd), torch.from_numpy(r).to(td)),
            (jnp.asarray(s), torch.from_numpy(s)),
            (jnp.asarray(b), torch.from_numpy(b)), w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_layer_norm_matches_pallas(shape, dtype):
    (jx, tx), _, (js, ts), (jb, tb), _ = inputs(SHAPES[shape], dtype)
    ref = jln.fused_layer_norm(jx, js, jb)
    n = fused_layer_norm.launches
    out = fused_layer_norm(tx, ts, tb)
    assert fused_layer_norm.launches == n          # CPU tensors: no launch
    assert out.dtype == tx.dtype and out.shape == tx.shape
    close(out, ref, dtype, 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_add_layer_norm_matches_pallas(shape, dtype):
    (jx, tx), (jr, tr), (js, ts), (jb, tb), _ = inputs(SHAPES[shape], dtype,
                                                      1)
    ref_sum, ref_y = jln.fused_add_layer_norm(jx, jr, js, jb)
    n = fused_add_layer_norm.launches
    out_sum, out_y = fused_add_layer_norm(tx, tr, ts, tb)
    assert fused_add_layer_norm.launches == n
    assert out_sum.dtype == out_y.dtype == tx.dtype
    np.testing.assert_array_equal(f32(out_sum), f32(ref_sum))
    assert torch.equal(out_sum, tx + tr)
    close(out_y, ref_y, dtype, 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_layer_norm_grads_match_jax(shape, dtype):
    """jax.grad through vitx's custom VJP (B11) vs autograd through the
    port's (B3's plain version on the 2-D view), loss sum(sin(y)) in
    fp32."""
    (jx, tx), _, (js, ts), (jb, tb), _ = inputs(SHAPES[shape], dtype, 2)

    def jloss(x, s, b):
        return jnp.sum(jnp.sin(jln.fused_layer_norm(x, s, b).astype(
            jnp.float32)))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jx, js, jb)
    ts_ = [t.detach().requires_grad_() for t in (tx, ts, tb)]
    n = ln_bwd.launches
    y = fused_layer_norm(*ts_)
    grads = torch.autograd.grad(y.float().sin().sum(), ts_)
    assert ln_bwd.launches == n
    for g, r, t in zip(grads, ref, ts_):
        assert g.dtype == t.dtype and g.shape == t.shape
        close(g, r, dtype, 1e-4, 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_add_layer_norm_grads_match_jax(shape, dtype):
    """As above for the add variant, the loss also weighting the sum, so
    that its cotangent joins dx (the same for x and r)."""
    (jx, tx), (jr, tr), (js, ts), (jb, tb), w = inputs(SHAPES[shape], dtype,
                                                       3)

    def jloss(x, r, s, b):
        summed, y = jln.fused_add_layer_norm(x, r, s, b)
        return (jnp.sum(jnp.sin(y.astype(jnp.float32)))
                + jnp.sum(summed.astype(jnp.float32) * w))

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(jx, jr, js, jb)
    ts_ = [t.detach().requires_grad_() for t in (tx, tr, ts, tb)]
    summed, y = fused_add_layer_norm(*ts_)
    loss = y.float().sin().sum() + (summed.float() * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, ts_)
    assert torch.equal(grads[0], grads[1])
    for g, r, t in zip(grads, ref, ts_):
        assert g.dtype == t.dtype and g.shape == t.shape
        close(g, r, dtype, 1e-4, 1e-4)


def test_plain_version_and_checks():
    """The plain version is what the entries return on the CPU, in both
    variants; a 1-D x is one row; bad inputs raise."""
    (_, x), (_, r), (_, s), (_, b), _ = inputs((4, 100), "bfloat16", 4)
    assert torch.equal(fused_layer_norm(x, s, b),
                       layer_norm_fwd_plain(x, s, b))
    for a, c in zip(fused_add_layer_norm(x, r, s, b),
                    layer_norm_fwd_plain(x, s, b, r)):
        assert torch.equal(a, c)
    assert torch.equal(fused_layer_norm(x[1], s, b),
                       fused_layer_norm(x, s, b)[1])
    row, sr = x[1].detach().requires_grad_(), s.detach().requires_grad_()
    dx, ds = torch.autograd.grad(fused_layer_norm(row, sr, b).float().sum(),
                                 (row, sr))
    assert dx.shape == row.shape and ds.shape == s.shape
    with pytest.raises(ValueError):
        fused_layer_norm(x, s[:-1], b)
    with pytest.raises(ValueError):
        fused_add_layer_norm(x, r[:-1], s, b)
    with pytest.raises(ValueError):
        fused_add_layer_norm(x, r.float(), s, b)
    with pytest.raises(TypeError):
        fused_layer_norm(x.half(), s, b)
    with pytest.raises(ValueError):
        fused_layer_norm(x[:0], s, b)
