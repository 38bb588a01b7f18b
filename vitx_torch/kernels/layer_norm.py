"""LayerNorm backward (B3): dx, dscale and dbias from x, the scale and dy.

``ln_bwd`` launches the Hopper kernel ``csrc/layer_norm_bwd.cu`` on CUDA
tensors and runs ``ln_bwd_plain``, the same math in plain torch, on CPU
tensors. It replaces ``vitx/kernels/layer_norm.py::_ln_bwd3_kernel`` (entry
``ln_bwd``), which every LayerNorm backward of vitx's train step runs
through on the TPU. vitx gates it on ``E % 128 == 0`` (``nn/layers.py:48``),
a fact of the TPU's lanes: here every width takes the kernel.
"""

from __future__ import annotations

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels._build import DTYPE_CODES

ROWS_PER_CHUNK = 64   # rows per partial column sum (csrc/layer_norm_bwd.cu)


def ln_bwd_plain(x, scale, dy, *, eps: float = 1e-5):
    """The plain torch version: fp32 two-pass statistics recomputed from x,
    ``dx = inv * (gs - mean(gs) - xhat * mean(gs * xhat))`` with
    ``gs = dy * scale``, cast to x's dtype; dscale and dbias summed over
    every leading axis in fp32 (``vitx/nn/layers.py:26-41``)."""
    x32, g32, s32 = x.float(), dy.float(), scale.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * inv
    gs = g32 * s32
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (gs - m1 - xhat * m2)).to(x.dtype)
    red = tuple(range(x.dim() - 1))
    return dx, (g32 * xhat).sum(dim=red), g32.sum(dim=red)


def _check(x, scale, dy):
    if x.dim() < 2:
        raise ValueError(f"ln_bwd takes (..., E) with a leading axis, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ln_bwd takes float32 or bfloat16, got {x.dtype}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)} like x, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    E = x.shape[-1]
    if tuple(scale.shape) != (E,) or not scale.is_floating_point():
        raise ValueError(f"scale must be a float ({E},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    for name, t in (("scale", scale), ("dy", dy)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ln_bwd(x, scale, dy, *, eps: float = 1e-5):
    """LayerNorm backward over the last axis of (..., E) x and dy (any rank
    >= 2: (B, T, E) for the blocks, (B, 4E) for the reference head).

    Returns (dx in x's dtype, dscale fp32 (E,), dbias fp32 (E,)). CUDA
    tensors go through the kernel and add one to ``ln_bwd.launches``; CPU
    tensors take the plain version.
    """
    _check(x, scale, dy)
    if x.device.type == "cpu":
        return ln_bwd_plain(x, scale, dy, eps=eps)
    if not x.is_cuda:
        raise ValueError(f"ln_bwd runs on cuda or cpu, not {x.device}")
    E = x.shape[-1]
    x2 = x.reshape(-1, E).contiguous()
    dy2 = dy.reshape(-1, E).contiguous()
    s = scale.float().contiguous()
    R = x2.shape[0]
    chunks = -(-R // ROWS_PER_CHUNK)
    dx = torch.empty_like(x2)
    dscale = torch.empty(E, dtype=torch.float32, device=x.device)
    dbias = torch.empty(E, dtype=torch.float32, device=x.device)
    stats = torch.empty(2 * R, dtype=torch.float32, device=x.device)
    part = torch.empty(chunks * 2 * E, dtype=torch.float32, device=x.device)
    fn = _build.entry("layer_norm_bwd")
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], x2.data_ptr(), s.data_ptr(),
                 dy2.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 dbias.data_ptr(), stats.data_ptr(), part.data_ptr(), R, E,
                 float(eps), torch.cuda.current_stream().cuda_stream)
    _build.check("layer_norm_bwd", err)
    ln_bwd.launches += 1
    return dx.reshape(x.shape), dscale, dbias


ln_bwd.launches = 0
