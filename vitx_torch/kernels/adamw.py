"""Fused AdamW (B12): one in-place pass over one fp32 parameter leaf.

``fused_adamw_`` launches the Hopper kernel ``csrc/adamw.cu`` on CUDA
tensors and runs ``adamw_plain``, the same math in plain torch, on CPU
tensors, writing p, mu and nu in place either way. It replaces
``vitx/kernels/adamw.py::_kernel``, which ``make_optimizer(fused=True)``
selects. vitx's rule that only leaves of >= 65536 elements in rows of 1024
take the kernel (``adamw.py:69-90``) is a fact of the TPU's tiling: here
every fp32 leaf takes it.
"""

from __future__ import annotations

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels._build import DTYPE_CODES


def adamw_plain(p, g, mu, nu, *, lr, c1, c2, b1, b2, eps, wd):
    """The update of ``adamw.py:46-53`` in fp32, in its order of operations
    (weight decay reads the old p); returns new (p, mu, nu). ``lr``, ``c1``
    and ``c2`` are fp32 scalars: c1 = 1 - b1^t, c2 = 1 - b2^t."""
    g = g.float()
    mu2 = b1 * mu + (1.0 - b1) * g
    nu2 = b2 * nu + (1.0 - b2) * g * g
    mu_hat = mu2 / c1
    nu_hat = nu2 / c2
    p2 = p - lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * p)
    return p2, mu2, nu2


def _check(p, g, mu, nu):
    for name, t in (("p", p), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adamw_ updates float32 leaves; {name} is "
                            f"{t.dtype}")
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} must be {tuple(p.shape)} on {p.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (it is written in "
                             f"place)")
    if g.dtype not in DTYPE_CODES:
        raise TypeError(f"the gradient must be float32 or bfloat16, got "
                        f"{g.dtype}")
    if g.shape != p.shape or g.device != p.device:
        raise ValueError(f"g must be {tuple(p.shape)} on {p.device}, got "
                         f"{tuple(g.shape)} on {g.device}")


@torch.no_grad()
def fused_adamw_(p, g, mu, nu, *, lr: float, c1: float, c2: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 wd: float = 1e-4) -> None:
    """One AdamW step on one leaf, in place: p, mu, nu fp32; g fp32 or
    bf16 (upcast). CUDA tensors go through the kernel and add one to
    ``fused_adamw_.launches``; CPU tensors take the plain version."""
    _check(p, g, mu, nu)
    if p.device.type == "cpu":
        p2, mu2, nu2 = adamw_plain(p, g, mu, nu, lr=lr, c1=c1, c2=c2, b1=b1,
                                   b2=b2, eps=eps, wd=wd)
        p.copy_(p2)
        mu.copy_(mu2)
        nu.copy_(nu2)
        return
    if not p.is_cuda:
        raise ValueError(f"fused_adamw_ runs on cuda or cpu, not {p.device}")
    g = g.contiguous()
    fn = _build.entry("adamw")
    with torch.cuda.device(p.device):
        err = fn(DTYPE_CODES[g.dtype], p.data_ptr(), g.data_ptr(),
                 mu.data_ptr(), nu.data_ptr(), p.numel(), float(lr),
                 float(c1), float(c2), float(b1), float(1.0 - b1), float(b2),
                 float(1.0 - b2), float(eps), float(wd),
                 torch.cuda.current_stream().cuda_stream)
    _build.check("adamw", err)
    fused_adamw_.launches += 1


fused_adamw_.launches = 0
