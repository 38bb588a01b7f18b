"""Small functional building blocks: LayerNorm, activations, the MLP.

The torch counterparts of ``vitx/nn/layers.py`` (forward only). LayerNorm
statistics are taken in fp32 whatever the compute dtype, and every matrix
product accumulates in fp32 (operands upcast, then one cast back), which is
what ``preferred_element_type=float32`` gives in the JAX package.
"""

from __future__ import annotations

import math

import torch


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 two-pass stats; returns
    ``x.dtype`` (``vitx/nn/layers.py:16-23``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def add_layer_norm(x, r, scale, bias, *, eps: float = 1e-5):
    """-> (x + r, LN(x + r)): the pre-LN residual pattern."""
    s = x + r
    return s, layer_norm(s, scale, bias, eps=eps)


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
