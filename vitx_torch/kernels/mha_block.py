"""Fused MHA block: LN -> QKV projection -> attention -> out-projection.

``fused_mha_block`` launches the Hopper kernel K1 (``csrc/mha_block.cu``)
on CUDA tensors and runs ``mha_block_plain``, the same math in plain torch,
on CPU tensors. It replaces ``vitx/kernels/mha_block.py::_kernel`` (the
no-stash variant of ``_fused_fwd``). The source note in the ``.cu`` file
says what bounds the kernel on the H100 and how it is laid out.
"""

from __future__ import annotations

import torch

from vitx_torch.kernels import _build
from vitx_torch.nn.layers import layer_norm, matmul32

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def mha_block_plain(x, wqkv, wo, bo, g, b, *, eps: float = 1e-5):
    """The plain torch version of K1, rounding where the TPU kernel rounds
    (``vitx/kernels/mha_block.py:46-91``): q|k|v accumulate in fp32 and
    are cast; q is rescaled in fp32 and cast again; l sums the fp32 p while
    the PV product takes p cast to the compute dtype, and the division by l
    follows the product; bo is added to the fp32 out-projection before the
    one cast."""
    B, T, E = x.shape
    H = wqkv.shape[2]
    D = E // H
    dt = x.dtype
    h = layer_norm(x, g, b, eps=eps)
    qkv = matmul32(h, wqkv.reshape(E, 3 * E)).to(dt)
    # column block s*E + h*D of the (E, 3E) flattening is head h of q|k|v
    qkv = qkv.reshape(B, T, 3, H, D).permute(2, 0, 3, 1, 4)
    q = (qkv[0].float() * (1.0 / D ** 0.5)).to(dt)
    k, v = qkv[1], qkv[2]
    s = matmul32(q, k.transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (matmul32(p.to(dt), v) / l).to(dt)
    o_all = o.transpose(1, 2).reshape(B, T, E)
    return (matmul32(o_all, wo) + bo.float()).to(dt)


def _check(x, wqkv, wo, bo, g, b):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, E), got {tuple(x.shape)}")
    B, T, E = x.shape
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_mha_block takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if wqkv.dim() != 4 or wqkv.shape[0] != E or wqkv.shape[1] != 3:
        raise ValueError(f"wqkv must be (E, 3, H, D) with E={E}, "
                         f"got {tuple(wqkv.shape)}")
    H, D = wqkv.shape[2], wqkv.shape[3]
    if H * D != E:
        raise ValueError(f"wqkv heads {H} x {D} do not make E={E}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM} is not supported")
    if tuple(wo.shape) != (E, E):
        raise ValueError(f"wo must be ({E}, {E}), got {tuple(wo.shape)}")
    for name, t in (("wqkv", wqkv), ("wo", wo)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} like x, got {t.dtype}")
    for name, t in (("bo", bo), ("g", g), ("b", b)):
        if tuple(t.shape) != (E,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({E},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("wqkv", wqkv), ("wo", wo), ("bo", bo), ("g", g),
                    ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("wqkv", wqkv), ("wo", wo), ("bo", bo),
                    ("g", g), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_mha_block(x, wqkv, wo, bo, g, b, *, eps: float = 1e-5):
    """LN(x) -> multi-head attention -> output projection, fused.

    x: (B, T, E) compute dtype; wqkv: (E, 3, H, D) and wo: (E, E) in x's
    dtype; bo (zeros when the projection has no bias), g, b: (E,) float32.
    Returns (B, T, E) in x's dtype. CUDA tensors go through kernel K1 and
    add one to ``fused_mha_block.launches``; CPU tensors take the plain
    version.
    """
    _check(x, wqkv, wo, bo, g, b)
    if x.device.type == "cpu":
        return mha_block_plain(x, wqkv, wo, bo, g, b, eps=eps)
    if not x.is_cuda:
        raise ValueError(f"fused_mha_block runs on cuda or cpu, "
                         f"not {x.device}")
    B, T, E = x.shape
    H = wqkv.shape[2]
    fn = _build.entry("mha_block")
    out = torch.empty_like(x)
    qkv = torch.empty((3, B, H, T, E // H), dtype=x.dtype, device=x.device)
    o_all = torch.empty_like(x)
    stats = torch.empty((2, B * T), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], x.data_ptr(), wqkv.data_ptr(),
                 wo.data_ptr(), bo.data_ptr(), g.data_ptr(), b.data_ptr(),
                 out.data_ptr(), qkv.data_ptr(), o_all.data_ptr(),
                 stats.data_ptr(), B, T, E, H, float(eps),
                 torch.cuda.current_stream().cuda_stream)
    _build.check("mha_block", err)
    fused_mha_block.launches += 1
    return out


fused_mha_block.launches = 0
