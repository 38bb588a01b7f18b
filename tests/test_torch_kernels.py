"""The port's fused block kernels against vitx's Pallas kernels.

On the CPU the wrappers run their plain torch versions; these are held
against ``vitx.kernels.{mha_block,mlp_block}._fused_fwd`` run in Pallas
interpret mode (the CPU backend ``tests/conftest.py`` sets), on the same
inputs from ``numpy.random.default_rng``. Tolerances are max |a - b| over
max |b|:

- float32: 1e-4, the repo's parity bar (``tests/test_parity_torch.py``).
- bfloat16: 1e-2. Both sides accumulate in fp32 but in another order, so
  a few bf16 roundings of the intermediates (h, q|k|v, p, o, hp, ha) land
  one ulp (2**-8 relative) apart; the output stays within a few ulps of
  its largest element.

``tests/test_torch_cuda.py`` holds the CUDA kernels to these plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.kernels import mha_block as jmha
from vitx.kernels import mlp_block as jmlp
from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                mha_block_plain, mlp_block_plain)

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SHAPES = {"small": (2, 17, 64, 4), "base16": (2, 197, 768, 12)}


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def block_inputs(B, T, E, H, seed=0):
    """fp32 numpy inputs of one block (weights scaled like a trained ViT's,
    biases and LN parameters away from their init values)."""
    rng = np.random.default_rng(seed)
    D, M = E // H, 4 * E

    def n(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    return {"x": n(B, T, E), "wqkv": n(E, 3, H, D, scale=0.04),
            "wo": n(E, E, scale=0.04), "bo": n(E, scale=0.1),
            "g": n(E, scale=0.1, shift=1.0), "b": n(E, scale=0.1),
            "w1": n(E, M, scale=0.04), "b1": n(M, scale=0.1),
            "w2": n(M, E, scale=0.04), "b2": n(E, scale=0.1)}


def _as(arrs, names, dtype, lib):
    """Compute-dtype x and weights, fp32 vectors, as jax or torch arrays."""
    out = []
    for k in names:
        a = arrs[k]
        vec = a.ndim == 1
        if lib == "jax":
            out.append(jnp.asarray(a, jnp.float32 if vec else dtype))
        else:
            t = torch.from_numpy(a)
            out.append(t if vec else t.to(getattr(torch, dtype)))
    return out


MHA = ("x", "wqkv", "wo", "bo", "g", "b")
MLP = ("x", "w1", "b1", "w2", "b2", "g", "b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["small", "base16"])
@pytest.mark.parametrize("proj_bias", [True, False])
def test_mha_plain_matches_pallas(shape, dtype, proj_bias):
    arrs = block_inputs(*SHAPES[shape])
    if not proj_bias:
        arrs["bo"] = np.zeros_like(arrs["bo"])   # what vit.py passes
    ref = jmha._fused_fwd(*_as(arrs, MHA, dtype, "jax"), eps=1e-5)
    out = fused_mha_block(*_as(arrs, MHA, dtype, "torch"), eps=1e-5)
    assert out.dtype == getattr(torch, dtype)
    err = rel_err(out.float().numpy(), np.asarray(ref, np.float32))
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("shape", ["small", "base16"])
def test_mlp_plain_matches_pallas(shape, act, dtype):
    arrs = block_inputs(*SHAPES[shape], seed=1)
    ref = jmlp._fused_fwd(*_as(arrs, MLP, dtype, "jax"), act=act, eps=1e-5)
    out = fused_mlp_block(*_as(arrs, MLP, dtype, "torch"), act=act, eps=1e-5)
    assert out.dtype == getattr(torch, dtype)
    err = rel_err(out.float().numpy(), np.asarray(ref, np.float32))
    assert err <= TOL[dtype], err


def test_cpu_wrappers_run_plain_and_count_no_launch():
    """bf16 CPU tensors of a shape the sm90 route would take on the card
    run the plain versions and count nothing, on either route."""
    arrs = block_inputs(*SHAPES["small"])
    wrappers = (fused_mha_block, fused_mlp_block)
    before = [(f.launches, f.launches_sm90) for f in wrappers]
    args = _as(arrs, MHA, "bfloat16", "torch")
    assert torch.equal(fused_mha_block(*args), mha_block_plain(*args))
    args = _as(arrs, MLP, "bfloat16", "torch")
    assert torch.equal(fused_mlp_block(*args, act="relu"),
                       mlp_block_plain(*args, act="relu"))
    assert [(f.launches, f.launches_sm90) for f in wrappers] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "vector", "contiguity"])
def test_wrappers_check_inputs(bad):
    arrs = block_inputs(*SHAPES["small"])
    x, wqkv, wo, bo, g, b = _as(arrs, MHA, "float32", "torch")
    if bad == "dtype":
        x = x.half()
    elif bad == "shape":
        wo = wo[:, :-1]
    elif bad == "vector":
        bo = bo.to(torch.bfloat16)
    else:
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        fused_mha_block(x, wqkv, wo, bo, g, b)
    x, w1, b1, w2, b2, g, b = _as(arrs, MLP, "float32", "torch")
    with pytest.raises(ValueError):
        fused_mlp_block(x, w1, b1, w2, b2, g, b, act="swish")
