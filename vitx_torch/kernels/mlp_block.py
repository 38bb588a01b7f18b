"""Fused MLP block: LN -> Linear(E, M) -> activation -> Linear(M, E).

``fused_mlp_block`` launches the Hopper kernel K2 (``csrc/mlp_block.cu``)
on CUDA tensors and runs ``mlp_block_plain``, the same math in plain torch,
on CPU tensors. It replaces ``vitx/kernels/mlp_block.py::_kernel`` with and
without its stash (``_fused_fwd``), and is differentiable: its backward is
plain torch, as ``_fused_op_bwd`` is XLA math (``mlp_block.py:185-208``),
apart from the LayerNorm backward, which is B3 (``ln_bwd``). The source
note in the ``.cu`` file says what bounds the kernel on the H100 and how it
is laid out.

Routes on the card, chosen here in the open and passed to the kernel,
which refuses one the inputs cannot take (``mlp_route``): in bf16 with E
and M multiples of 8 both products run on the Hopper GEMM
``csrc/gemm_sm90.cuh`` (wgmma fed by TMA, the LayerNorm applied to the A
operand in registers); fp32 and other shapes keep ``common.cuh``'s
``gemm_kernel``. ``fused_mlp_block.launches`` counts every CUDA launch,
``launches_sm90`` those on the sm90 GEMM.
"""

from __future__ import annotations

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels._build import DTYPE_CODES
from vitx_torch.kernels.layer_norm import ln_bwd
from vitx_torch.nn.layers import (activation, dot, gelu_erf_poly,
                                  gelu_tanh_exp, layer_norm, matmul32)

ACT_CODES = {"gelu": 0, "gelu_tanh": 1, "relu": 2}
ROUTE_SM90 = 1   # csrc/mlp_block.cu's route: both products on gemm_sm90.cuh


def mlp_route(dtype, E: int, M: int, tensors=()) -> int:
    """``ROUTE_SM90`` where K2's products can take the sm90 GEMM
    (``_build.gemm_sm90``: bf16, E and M multiples of 8, E at most 4096,
    ``tensors`` -- x and the weights -- 16-byte aligned), else 0:
    ``gemm_kernel``."""
    return (ROUTE_SM90 if _build.gemm_sm90(dtype, (E, M), tensors, ln_k=E)
            else 0)


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


def mlp_block_plain(x, w1, b1, w2, b2, g, b, *, act: str, eps: float = 1e-5,
                    stash: bool = False):
    """The plain torch version of K2, rounding where the TPU kernel rounds
    (``vitx/kernels/mlp_block.py:67-84``): hp = h @ W1 + b1 in fp32, cast;
    the activation in fp32 on the cast hp, cast; @ W2 + b2 in fp32, one
    cast. ``stash=True`` also returns hp (B, T, M)."""
    dt = x.dtype
    h = layer_norm(x, g, b, eps=eps)
    hp = (matmul32(h, w1) + b1.float()).to(dt)
    ha = _act_kernel(hp, act)
    out = (matmul32(ha, w2) + b2.float()).to(dt)
    return (out, hp) if stash else out


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


def _launch(x, w1, b1, w2, b2, g, b, act, eps, stash, route=None):
    """``mlp_block.cu`` on CUDA tensors -> (out, hp or None, route);
    ``route`` defaults to ``mlp_route``'s. Counts nothing."""
    if not x.is_cuda:
        raise ValueError(f"fused_mlp_block runs on cuda or cpu, "
                         f"not {x.device}")
    B, T, E = x.shape
    M = w1.shape[1]
    x, w1, b1, w2, b2, g, b = _build.aligned(x, w1, b1, w2, b2, g, b)
    if route is None:
        route = mlp_route(x.dtype, E, M, (x, w1, w2))
    fn = _build.entry("mlp_block")
    out = torch.empty_like(x)
    ha = torch.empty((B, T, M), dtype=x.dtype, device=x.device)
    hp = torch.empty_like(ha) if stash else None
    stats = torch.empty((2, B * T), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], route, x.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g.data_ptr(),
                 b.data_ptr(), out.data_ptr(), ha.data_ptr(),
                 hp.data_ptr() if stash else None, stats.data_ptr(), B * T,
                 E, M, ACT_CODES[act], float(eps),
                 torch.cuda.current_stream().cuda_stream)
    _build.check("mlp_block", err)
    return out, hp, route


def _forward(x, w1, b1, w2, b2, g, b, act, eps, stash):
    """-> out, or (out, hp) with the stash: kernel K2 on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, w1, b1, w2, b2, g, b, act=act, eps=eps,
                               stash=stash)
    out, hp, route = _launch(x, w1, b1, w2, b2, g, b, act, eps, stash)
    fused_mlp_block.launches += 1
    fused_mlp_block.launches_sm90 += route == ROUTE_SM90
    return (out, hp) if stash else out


def _backward(dout, x, w1, w2, g, b, hp, act, eps, need=(True,) * 7):
    """``_fused_op_bwd`` (``vitx/kernels/mlp_block.py:185-208``): the
    activation is differentiated in its true form (``activation``), not
    the kernel's polynomial; every product accumulates in fp32 and is cast
    once; db1 and db2 stay fp32. ``need`` (x, w1, b1, w2, b2, g, b): the
    gradients to compute, None for the rest (a frozen weight's product is
    never formed)."""
    B, T, E = x.shape
    M = hp.shape[-1]
    n_x, n_w1, n_b1, n_w2, n_b2, n_g, n_b = need
    with torch.enable_grad():
        hp_ = hp.detach().requires_grad_()
        ha = activation(hp_, act)
    d2 = dout.reshape(B * T, E)
    dw2 = (dot(ha.detach().reshape(B * T, M).t(), d2).to(w2.dtype)
           if n_w2 else None)
    db2 = dout.float().sum(dim=(0, 1)) if n_b2 else None
    if not (n_x or n_w1 or n_b1 or n_g or n_b):
        return None, None, None, dw2, db2, None, None
    dha = dot(d2, w2.to(dout.dtype).t()).to(hp.dtype).reshape(B, T, M)
    (dhp,) = torch.autograd.grad(ha, hp_, dha)
    dhp2 = dhp.reshape(B * T, M)
    dw1 = None
    if n_w1:
        h = layer_norm(x, g, b, eps=eps)
        dw1 = dot(h.reshape(B * T, E).t(), dhp2).to(w1.dtype)
    db1 = dhp.float().sum(dim=(0, 1)) if n_b1 else None
    if not (n_x or n_g or n_b):
        return None, dw1, db1, dw2, db2, None, None
    dh = dot(dhp2, w1.to(dhp.dtype).t()).to(x.dtype).reshape(B, T, E)
    dx, dg, db = ln_bwd(x, g, dh, eps=eps)
    return (dx if n_x else None, dw1, db1, dw2, db2,
            dg.to(g.dtype) if n_g else None, db.to(b.dtype) if n_b else None)


class _FusedMLP(torch.autograd.Function):
    """K2 forward with its stash; the backward of ``_backward``, for the
    inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, g, b, act, eps):
        out, hp = _forward(x, w1, b1, w2, b2, g, b, act, eps, stash=True)
        ctx.save_for_backward(x, w1, w2, g, b, hp)
        ctx.act, ctx.eps = act, eps
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _backward(dout.contiguous(), *ctx.saved_tensors, ctx.act,
                          ctx.eps, need=ctx.needs_input_grad[:7])
        return (*grads, None, None)


def fused_mlp_block(x, w1, b1, w2, b2, g, b, *, act: str = "gelu",
                    eps: float = 1e-5, stash: bool = False):
    """LN(x) -> Linear -> activation -> Linear, fused; the residual add
    happens outside.

    x: (B, T, E) compute dtype; w1 (E, M), w2 (M, E) in x's dtype; b1 (M,),
    b2, g, b (E,) float32. Returns (B, T, E) in x's dtype, differentiable
    in every input. With ``stash=True`` returns (out, hp), hp the cast
    pre-activation (B, T, M) as vitx's ``_fused_fwd(stash=True)`` does, and
    records no gradient. CUDA tensors go through kernel K2 and add one to
    ``fused_mlp_block.launches`` (and to ``launches_sm90`` on the sm90
    GEMM, ``mlp_route``); CPU tensors take the plain version. Inside a
    ``torch.export`` trace, where nothing needs a gradient, the call is
    the op ``vitx_torch::mlp_block`` (``kernels/ops.py``).
    """
    _check(x, w1, b1, w2, b2, g, b, act)
    if stash:
        with torch.no_grad():
            return _forward(x, w1, b1, w2, b2, g, b, act, eps, stash=True)
    if not _build.needs_grad(x, w1, b1, w2, b2, g, b):
        if _build.tracing():
            return torch.ops.vitx_torch.mlp_block(x, w1, b1, w2, b2, g, b,
                                                  act, float(eps))
        return _forward(x, w1, b1, w2, b2, g, b, act, eps, stash=False)
    return _FusedMLP.apply(x, w1, b1, w2, b2, g, b, act, float(eps))


fused_mlp_block.launches = 0
fused_mlp_block.launches_sm90 = 0
