"""Fused MLP block: LN -> Linear(E, M) -> activation -> Linear(M, E).

``fused_mlp_block`` launches the Hopper kernel K2 (``csrc/mlp_block.cu``)
on CUDA tensors and runs ``mlp_block_plain``, the same math in plain torch,
on CPU tensors. It replaces ``vitx/kernels/mlp_block.py::_kernel`` (the
no-stash variant of ``_fused_fwd``). The source note in the ``.cu`` file
says what bounds the kernel on the H100 and how it is laid out.
"""

from __future__ import annotations

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels.mha_block import DTYPE_CODES
from vitx_torch.nn.layers import (gelu_erf_poly, gelu_tanh_exp, layer_norm,
                                  matmul32)

ACT_CODES = {"gelu": 0, "gelu_tanh": 1, "relu": 2}


def _act_kernel(x, act: str):
    """The kernel's activations (``vitx/kernels/mlp_block.py:56-64``):
    fp32 math on the compute-dtype input, cast back."""
    if act == "gelu":
        return gelu_erf_poly(x.float()).to(x.dtype)
    if act == "gelu_tanh":
        return gelu_tanh_exp(x.float()).to(x.dtype)
    if act == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {act!r}")


def mlp_block_plain(x, w1, b1, w2, b2, g, b, *, act: str, eps: float = 1e-5):
    """The plain torch version of K2, rounding where the TPU kernel rounds
    (``vitx/kernels/mlp_block.py:67-84``): hp = h @ W1 + b1 in fp32, cast;
    the activation in fp32 on the cast hp, cast; @ W2 + b2 in fp32, one
    cast."""
    dt = x.dtype
    h = layer_norm(x, g, b, eps=eps)
    hp = (matmul32(h, w1) + b1.float()).to(dt)
    ha = _act_kernel(hp, act)
    return (matmul32(ha, w2) + b2.float()).to(dt)


def _check(x, w1, b1, w2, b2, g, b, act):
    if act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r}; have "
                         f"{sorted(ACT_CODES)}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, E), got {tuple(x.shape)}")
    E = x.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_mlp_block takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if w1.dim() != 2 or w1.shape[0] != E:
        raise ValueError(f"w1 must be ({E}, M), got {tuple(w1.shape)}")
    M = w1.shape[1]
    if tuple(w2.shape) != (M, E):
        raise ValueError(f"w2 must be ({M}, {E}), got {tuple(w2.shape)}")
    for name, t in (("w1", w1), ("w2", w2)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} like x, got {t.dtype}")
    for name, t, n in (("b1", b1, M), ("b2", b2, E), ("g", g, E),
                       ("b", b, E)):
        if tuple(t.shape) != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({n},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                    ("g", g), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2), ("g", g), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_mlp_block(x, w1, b1, w2, b2, g, b, *, act: str = "gelu",
                    eps: float = 1e-5):
    """LN(x) -> Linear -> activation -> Linear, fused; the residual add
    happens outside.

    x: (B, T, E) compute dtype; w1 (E, M), w2 (M, E) in x's dtype; b1 (M,),
    b2, g, b (E,) float32. Returns (B, T, E) in x's dtype. CUDA tensors go
    through kernel K2 and add one to ``fused_mlp_block.launches``; CPU
    tensors take the plain version.
    """
    _check(x, w1, b1, w2, b2, g, b, act)
    if x.device.type == "cpu":
        return mlp_block_plain(x, w1, b1, w2, b2, g, b, act=act, eps=eps)
    if not x.is_cuda:
        raise ValueError(f"fused_mlp_block runs on cuda or cpu, "
                         f"not {x.device}")
    B, T, E = x.shape
    M = w1.shape[1]
    fn = _build.entry("mlp_block")
    out = torch.empty_like(x)
    ha = torch.empty((B, T, M), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, B * T), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g.data_ptr(),
                 b.data_ptr(), out.data_ptr(), ha.data_ptr(),
                 stats.data_ptr(), B * T, E, M, ACT_CODES[act], float(eps),
                 torch.cuda.current_stream().cuda_stream)
    _build.check("mlp_block", err)
    fused_mlp_block.launches += 1
    return out


fused_mlp_block.launches = 0
