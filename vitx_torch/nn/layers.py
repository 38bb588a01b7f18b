"""Small functional building blocks: LayerNorm, activations, the MLP,
dropout.

The torch counterparts of ``vitx/nn/layers.py``. LayerNorm statistics are
taken in fp32 whatever the compute dtype, and every matrix product
accumulates in fp32 (operands upcast, then one cast back), which is what
``preferred_element_type=float32`` gives in the JAX package. The LayerNorm
forward is plain torch and its backward the kernel B3 (``ln_bwd``), as
vitx keeps the forward in XLA and routes the backward through its Pallas
pass (``vitx/nn/layers.py:55-111``).
"""

from __future__ import annotations

import math

import torch

from vitx_torch.core.draws import rand


def _ln_forward(x, scale, bias, eps):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _ln_backward(x, scale, dy, eps):
    """(dx, dscale, dbias) through B3, the scale's grads in its dtype."""
    # imported here: vitx_torch.kernels imports this module
    from vitx_torch.kernels.layer_norm import ln_bwd

    dx, dscale, dbias = ln_bwd(x, scale, dy.contiguous(), eps=eps)
    return dx, dscale.to(scale.dtype), dbias.to(scale.dtype)


def _add_ln_forward(x, r, scale, bias, eps):
    """(s, LN(s)) with s = x + r in x's dtype: torch rounds the fp32 sum of
    two bf16 tensors once, so s is cast(fp32(x) + fp32(r)). The statistics
    are those of the cast s."""
    s = x + r
    return s, _ln_forward(s, scale, bias, eps)


class _LayerNorm(torch.autograd.Function):
    """LayerNorm with B3's backward; ``fwd(x, scale, bias, eps)`` is its
    forward: ``_ln_forward`` for the model, B10 for ``fused_layer_norm``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, fwd):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return (*_ln_backward(x, scale, dy, ctx.eps), None, None)


class _AddLayerNorm(torch.autograd.Function):
    """(x + r, LN(x + r)) with B3's backward on the sum; ``fwd(x, r, scale,
    bias, eps)`` is its forward: ``_add_ln_forward`` for the model, B10's
    add variant for ``fused_add_layer_norm``."""

    @staticmethod
    def forward(ctx, x, r, scale, bias, eps, fwd):
        s, y = fwd(x, r, scale, bias, eps)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        return s, y

    @staticmethod
    def backward(ctx, g_sum, g_y):
        s, scale = ctx.saved_tensors
        dx, dscale, dbias = _ln_backward(s, scale, g_y, ctx.eps)
        dx = dx + g_sum
        return dx, dx, dscale, dbias, None, None


def _records_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 two-pass stats; returns
    ``x.dtype`` (``vitx/nn/layers.py:16-23``). Differentiable: the
    backward is B3 (the autograd Function is entered only where a
    gradient is recorded)."""
    if not _records_grad(x, scale, bias):
        return _ln_forward(x, scale, bias, float(eps))
    return _LayerNorm.apply(x, scale, bias, float(eps), _ln_forward)


def add_layer_norm(x, r, scale, bias, *, eps: float = 1e-5):
    """-> (x + r, LN(x + r)): the pre-LN residual pattern. Its backward
    returns dx + g_sum for both x and r (``vitx/nn/layers.py:96-101``)."""
    if not _records_grad(x, r, scale, bias):
        return _add_ln_forward(x, r, scale, bias, float(eps))
    return _AddLayerNorm.apply(x, r, scale, bias, float(eps),
                               _add_ln_forward)


def activation(x, name: str):
    """``gelu`` is the exact (erf) GELU, ``gelu_tanh`` the tanh form, as in
    ``vitx/nn/layers.py:114-125``; computed in fp32, returned in x.dtype."""
    if name == "gelu":
        return torch.nn.functional.gelu(x.float()).to(x.dtype)
    if name == "gelu_tanh":
        return torch.nn.functional.gelu(x.float(), approximate="tanh").to(
            x.dtype)
    if name == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {name!r}")


def matmul32(a, b):
    """``a @ b`` with both operands upcast to fp32: the product a TPU
    computes for ``preferred_element_type=float32``. Returns fp32."""
    return torch.matmul(a.float(), b.float())


def dot(a, b):
    """``a @ b`` accumulated in fp32 and cast once to ``a.dtype``. On CUDA
    this is one cuBLAS product, which accumulates bf16 operands in fp32
    (reduced-precision reductions are switched off in
    ``vitx_torch/__init__.py``); on the CPU the operands are upcast."""
    if a.is_cuda:
        return torch.matmul(a, b)
    return matmul32(a, b).to(a.dtype)


def einsum_cast(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` accumulated in fp32 and cast once to
    ``a.dtype``, as ``dot``: vitx's ``einsum(...,
    preferred_element_type=float32).astype(...)``."""
    if a.is_cuda:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.float(), b.float()).to(a.dtype)


def mlp(x, w1, b1, w2, b2, *, act: str, w3=None, b3=None):
    """Position-wise MLP Linear -> act -> Linear, with ``act="swiglu"``
    gating by the extra ``w3`` projection (``vitx/nn/layers.py:128-157``).
    Each product accumulates in fp32 and is cast before its bias add."""
    dt = x.dtype
    h = dot(x, w1.to(dt)) + b1.to(dt)
    if act == "swiglu":
        g = dot(x, w3.to(dt)) + b3.to(dt)
        h = torch.nn.functional.silu(h.float()).to(dt) * g
    else:
        h = activation(h, act)
    return dot(h, w2.to(dt)) + b2.to(dt)


def gelu_erf_poly(x):
    """Exact (erf) GELU with the Abramowitz-Stegun 7.1.26 polynomial erf
    (|err| <= 1.5e-7), the form the fused MLP kernel computes
    (``vitx/kernels/mlp_block.py:34-43``). fp32 in and out."""
    xs = x * 0.7071067811865475
    a = xs.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf = torch.sign(xs) * (1.0 - poly * torch.exp(-a * a))
    return 0.5 * x * (1.0 + erf)


def gelu_tanh_exp(x):
    """tanh-GELU with tanh written through exp, as the fused MLP kernel
    computes it (``vitx/kernels/mlp_block.py:46-53``). fp32 in and out."""
    u = math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)
    t = 1.0 - 2.0 / (torch.exp(2.0 * u) + 1.0)
    return 0.5 * x * (1.0 + t)


def dropout(x, rate: float, rng, *, deterministic: bool,
            tokens: tuple | None = None):
    """Inverted dropout (``vitx/nn/layers.py:160-166``): keep each element
    with probability 1 - rate and scale it by 1/keep. Identity when
    deterministic or rate == 0. ``rng`` is a ``torch.Generator`` on x's
    device; vitx's and torch's generators draw different masks. The mask
    is drawn by ``core.draws.rand`` (at the global shape on a sharded
    rank; ``tokens`` as it takes them)."""
    if deterministic or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout needs a torch.Generator when not "
                         "deterministic")
    keep = 1.0 - rate
    mask = rand(x.shape, rng, x.device, tokens=tokens) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x, rate: float, rng, *, deterministic: bool):
    """Stochastic depth (``vitx/nn/layers.py:169-180``): drop a sample's
    whole residual branch with probability ``rate``, scale the kept ones by
    1/keep (keep rounded to x's dtype). Identity when deterministic or
    without a generator."""
    if deterministic or rng is None:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = rand(shape, rng, x.device) < keep
    kept = x / torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, kept, torch.zeros_like(x))
