"""Attention backward (B2): dq, dk, dv from q, k, v and the output's grad.

``attention_bwd`` launches the Hopper kernel ``csrc/flash_attention_bwd.cu``
on CUDA tensors and runs ``attention_bwd_plain``, the same math in plain
torch, on CPU tensors. It replaces
``vitx/kernels/flash_attention.py::_bwd_kernel_nq1``, which vitx's ``_bwd``
picks for T <= 1024 (the ViT regime) and which the fused MHA block's VJP
calls. Longer sequences take vitx's q-chunked ``_bwd_kernel`` (ROADMAP B6),
not ported yet: ``attention_bwd`` refuses them.
"""

from __future__ import annotations

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels._build import DTYPE_CODES
from vitx_torch.nn.layers import matmul32

MAX_T = 1024          # flash_attention.py::_MAX_UNPADDED_T
MAX_HEAD_DIM = 128    # the kernel's shared-memory tiles (csrc note)


def attention_bwd_plain(q, k, v, do):
    """The plain torch version, rounding where ``_bwd_kernel_nq1`` rounds
    (``flash_attention.py:102-116, 297-310``): qs = cast(q * scale);
    pu = exp(s - max) and l in fp32; dv = cast(pu)^T cast(do / l);
    delta = rowsum(pu * dp) / l; e = cast(pu * (dp - delta));
    dq = (e k) * scale / l; dk = e^T cast(q * scale / l); each cast once to
    q's dtype. q is the unscaled q."""
    dt = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    qs = (q.float() * scale).to(dt)
    s = matmul32(qs, k.transpose(-1, -2))
    pu = torch.exp(s - s.amax(dim=-1, keepdim=True))
    linv = 1.0 / pu.sum(dim=-1, keepdim=True)
    do_n = (do.float() * linv).to(dt)
    dv = matmul32(pu.to(dt).transpose(-1, -2), do_n)
    dp = matmul32(do, v.transpose(-1, -2))
    delta = (pu * dp).sum(dim=-1, keepdim=True) * linv
    e = (pu * (dp - delta)).to(dt)
    dq = matmul32(e, k) * (scale * linv)
    q_n = (q.float() * (scale * linv)).to(dt)
    dk = matmul32(e.transpose(-1, -2), q_n)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(q, k, v, do):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"attention_bwd takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} like "
                             f"q, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    T, D = q.shape[2], q.shape[3]
    if T > MAX_T:
        raise NotImplementedError(
            f"attention_bwd covers T <= {MAX_T} (flash_attention.py::"
            f"_bwd_kernel_nq1); T={T} needs the q-chunked backward "
            f"_bwd_kernel, not ported yet (ROADMAP B6)")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM} is not supported")


def attention_bwd(q, k, v, do):
    """The attention backward over (B, H, T, D) q, k, v and do, q unscaled
    (the fused MHA block's stash): returns dq, dk, dv in q's dtype.

    CUDA tensors go through the kernel and add one to
    ``attention_bwd.launches``; CPU tensors take the plain version.
    """
    _check(q, k, v, do)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, do)
    if not q.is_cuda:
        raise ValueError(f"attention_bwd runs on cuda or cpu, not {q.device}")
    B, H, T, D = q.shape
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty(3 * B * H * T, dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), stats.data_ptr(), B * H, T, D,
                 torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention_bwd", err)
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0
