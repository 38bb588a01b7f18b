"""Fused AdamW (B12): one in-place pass over fp32 parameter leaves.

``fused_adamw_multi_`` updates a list of leaves with one launch of the
Hopper kernel ``csrc/adamw.cu`` per gradient dtype (``adamw_multi_kernel``:
a table of the leaves, persistent blocks over chunks that cross the
leaves' boundaries); ``AdamW.update`` with ``fused=True`` calls it once a
step. ``fused_adamw_`` updates one leaf a launch (``adamw_kernel``). On CPU
tensors both run the same math in plain torch (``adamw_plain``,
``adamw_multi_plain``), writing p, mu and nu in place either way. They
replace ``vitx/kernels/adamw.py::_kernel``, which
``make_optimizer(fused=True)`` selects. vitx's rule that only leaves of >=
65536 elements in rows of 1024 take the kernel (``adamw.py:69-90``) is a
fact of the TPU's tiling: here every fp32 leaf takes it.
"""

from __future__ import annotations

import ctypes
from collections import defaultdict

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels._build import DTYPE_CODES


def adamw_plain(p, g, mu, nu, *, lr, c1, c2, b1, b2, eps, wd, factor=None):
    """The update of ``adamw.py:46-53`` in fp32, in its order of operations
    (weight decay reads the old p); returns new (p, mu, nu). ``lr``, ``c1``
    and ``c2`` are fp32 scalars: c1 = 1 - b1^t, c2 = 1 - b2^t. ``factor``
    (an fp32 tensor broadcasting against p) scales the whole step before
    it is applied, as layer-wise lr decay does after optax's adamw. Every
    operation rounds once, as IEEE fp32 does (vitx's update outside jit,
    and the kernels): the bias corrections divide by 0-dim fp32 tensors on
    p's device (with a Python divisor torch's CUDA division multiplies by
    the reciprocal), and on the CPU the square root goes through float64
    (torch's CPU sqrt is within 0.5001 ulp, not correctly rounded; the
    card's is, and a double root rounds back to the fp32 one exactly)."""
    g = g.float()
    mu2 = b1 * mu + (1.0 - b1) * g
    nu2 = b2 * nu + (1.0 - b2) * g * g
    mu_hat = mu2 / torch.full((), c1, dtype=torch.float32, device=mu.device)
    nu_hat = nu2 / torch.full((), c2, dtype=torch.float32, device=nu.device)
    root = (torch.sqrt(nu_hat.double()).float() if nu_hat.device.type == "cpu"
            else torch.sqrt(nu_hat))
    step = lr * (mu_hat / (root + eps) + wd * p)
    p2 = p - (step if factor is None else step * factor)
    return p2, mu2, nu2


def adamw_multi_plain(ps, gs, mus, nus, **kw):
    """``adamw_plain`` over matching lists of leaves -> lists of new (p,
    mu, nu); ``kw`` as ``adamw_plain`` takes it."""
    out = [adamw_plain(*leaf, **kw) for leaf in zip(ps, gs, mus, nus)]
    return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out])


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


MULTI_MAX_LEAVES = 64   # csrc/adamw.cu ADAM_MAX_LEAVES: leaves a launch


@torch.no_grad()
def fused_adamw_multi_(ps, gs, mus, nus, *, lr: float, c1: float, c2: float,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                       wd: float = 1e-4) -> None:
    """One AdamW step on every leaf of matching lists, in place: p, mu, nu
    fp32 and contiguous; g fp32 or bf16 (upcast). On CUDA tensors, one
    launch per gradient dtype (per ``MULTI_MAX_LEAVES`` leaves of it),
    each adding one to ``fused_adamw_multi_.launches``; a leaf the kernel
    cannot take raises, before any launch. CPU tensors take the plain
    version."""
    if not (len(ps) == len(gs) == len(mus) == len(nus)):
        raise ValueError(f"fused_adamw_multi_ needs matching lists, got "
                         f"{len(ps)}, {len(gs)}, {len(mus)}, {len(nus)}")
    if not ps:
        return
    dev, f32 = ps[0].device, torch.float32
    for p, g, mu, nu in zip(ps, gs, mus, nus):
        # one pass of cheap tests a step; _check names what is wrong
        if not (p.dtype == mu.dtype == nu.dtype == f32
                and g.dtype in DTYPE_CODES
                and p.shape == g.shape == mu.shape == nu.shape
                and p.device == g.device == mu.device == nu.device
                and p.is_contiguous() and mu.is_contiguous()
                and nu.is_contiguous()):
            _check(p, g, mu, nu)
        if p.device != dev:
            raise ValueError(f"every leaf must be on {dev}, one is on "
                             f"{p.device}")
    kw = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, wd=wd)
    if dev.type == "cpu":   # leaf by leaf, as adamw_multi_plain loops
        for p, g, mu, nu in zip(ps, gs, mus, nus):
            for dst, new in zip((p, mu, nu), adamw_plain(p, g, mu, nu, **kw)):
                dst.copy_(new)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw_multi_ runs on cuda or cpu, not {dev}")
    groups = defaultdict(list)   # gradient dtype -> its leaves, in order
    for p, g, mu, nu in zip(ps, gs, mus, nus):
        if p.numel():
            groups[g.dtype].append((p, g.contiguous(), mu, nu))
    fn = _build.entry("adamw_multi")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for gdt, leaves in groups.items():
            for i in range(0, len(leaves), MULTI_MAX_LEAVES):
                part = leaves[i:i + MULTI_MAX_LEAVES]
                ptrs = (ctypes.c_longlong * (4 * len(part)))(
                    *(t.data_ptr() for leaf in part for t in leaf))
                numels = (ctypes.c_longlong * len(part))(
                    *(leaf[0].numel() for leaf in part))
                err = fn(DTYPE_CODES[gdt], len(part), ctypes.addressof(ptrs),
                         ctypes.addressof(numels), float(lr), float(c1),
                         float(c2), float(b1), float(1.0 - b1), float(b2),
                         float(1.0 - b2), float(eps), float(wd), stream)
                _build.check("adamw_multi", err)
                fused_adamw_multi_.launches += 1


fused_adamw_multi_.launches = 0
