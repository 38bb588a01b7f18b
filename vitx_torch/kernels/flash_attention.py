"""Attention forward (B5) and backward (B2) over (B, H, T, D) q, k, v.

- ``flash_attention`` / ``flash_attention_with_probs`` /
  ``flash_attention_with_mean_probs`` launch a Hopper kernel on CUDA
  tensors and run ``flash_attention_fwd_plain``, the same math in plain
  torch, on CPU tensors. They replace
  ``vitx/kernels/flash_attention.py::_fwd_kernel`` in its three output
  modes (none, full probs, head-mean probs) and are differentiable as
  vitx's entries are: ``flash_attention``'s backward is B2, the probs
  variants differentiate the plain reference attention
  (``flash_attention.py:516-538``). Each keeps its own ``launches`` count.
- Routes on the card, chosen in the open on dtype and head width: bf16
  at D = 32, 64 or 128 (MAE's decoder; the ViT-B/L family; huge14 and
  base16_hd128) takes the Hopper kernels on wgmma and TMA,
  ``csrc/flash_attention_sm90.cu`` for the forward without probabilities
  and ``csrc/attention_bwd_sm90.cu`` for the backward (``sm90_route``);
  the probability modes take them at the same widths (the online-softmax
  body, then the probability pass ``csrc/attention_probs_sm90.cuh``, where
  q, k and v are contiguous 16-byte-aligned planes, ``probs_route``). fp32
  and any other D keep ``csrc/flash_attention_fwd.cu`` and
  ``csrc/flash_attention_bwd.cu``.
  ``launches`` counts every CUDA launch of a wrapper, ``launches_sm90``
  those that took the sm90 route. The sm90 backward consumes the
  forward's o and row statistics (m and 1 / l, ``attention_stats_plain``'s
  function), which the sm90 forward and K1's stash write.
- ``attention_bwd`` launches a backward kernel on CUDA
  tensors and runs ``attention_bwd_plain`` on CPU tensors, at every T. It
  replaces both of vitx's attention backwards, which the fused MHA
  block's VJP and ``flash_attention``'s reach through ``_bwd``:
  ``_bwd_kernel_nq1`` (the whole query block at once) and the q-chunked
  ``_bwd_kernel``, which pads T to a multiple of 128 and accumulates dk
  and dv in fp32 scratch over query chunks. vitx chooses between them by
  a VMEM budget (``flash_attention.py:346-359``): T > 1024 always takes
  ``_bwd_kernel``, and in bf16 at D = 64 so does T above about 868. Both
  compute one function -- the padded queries and keys add exactly 0 --
  and differ only in the order of the fp32 sums of dk and dv. The CUDA
  kernel tiles queries and keys in blocks of 64 with no shared memory
  that grows with T, so one kernel serves every T.
"""

from __future__ import annotations

import ctypes

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels._build import DTYPE_CODES
from vitx_torch.nn.layers import matmul32

# The backward takes every T. vitx's _MAX_UNPADDED_T (1024) and its VMEM
# budget only choose between its two backward kernels, _bwd_kernel_nq1
# and the q-chunked _bwd_kernel (flash_attention.py:346-359); the CUDA
# kernel tiles queries and keys in 64-row blocks at any T.
MAX_HEAD_DIM = 128    # the backward kernel's shared-memory tiles (csrc note)
MAX_FWD_HEAD_DIM = 256
PROBS_MODES = {None: 0, "full": 1, "mean": 2}
# the head widths of the sm90 forward body, the probability pass after it
# and the backward (csrc/sm90.cuh's Tile<D>)
SM90_HEAD_DIMS = (32, 64, 128)


def sm90_route(t) -> bool:
    """Whether the forward (with or without probabilities) and the
    backward can take the sm90 route for ``t`` (q): bf16 at D = 32, 64 or
    128. The caller has checked that t lies on the card."""
    return t.dtype == torch.bfloat16 and t.shape[-1] in SM90_HEAD_DIMS


def attention_stats_plain(q, k):
    """The row statistics the sm90 backward reads, (2, B, H, T) fp32: the
    row max m of the fp32 logits s = cast(q * scale) k^T and 1 / l, l the
    fp32 sum of exp(s - m) -- ``_unnormalized_probs``'s m and l
    (``flash_attention.py:102-116``). q is unscaled."""
    dt = q.dtype
    qs = (q.float() * (1.0 / q.shape[-1] ** 0.5)).to(dt)
    s = matmul32(qs, k.transpose(-1, -2))
    m = s.amax(dim=-1)
    linv = 1.0 / torch.exp(s - m[..., None]).sum(dim=-1)
    return torch.stack((m, linv))


def _view(t):
    """(t, its (sb, sh, st)) for a TMA read or a kernel store: the last dim
    contiguous, the other strides multiples of 8 elements (16 bytes), the
    pointer 16-byte aligned; otherwise a contiguous copy on a 16-byte
    boundary. A dim of size 1 gets the stride of T, which no access
    uses."""
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(st % 8 == 0 or n == 1
                  for st, n in zip(t.stride()[:3], t.shape[:3])))
    if not ok:
        t, = _build.aligned(t.contiguous())
    st = t.stride(2)
    return t, [s if n > 1 else st for s, n in zip(t.stride()[:3], t.shape[:3])]


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
    D = q.shape[3]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM} is not supported")


def _bwd_wmma(q, k, v, do):
    """``csrc/flash_attention_bwd.cu`` on contiguous copies: fp32, or any
    D up to 128. Counts nothing (``attention_bwd`` counts)."""
    B, H, T, D = q.shape
    q, k, v, do = _build.aligned(*(t.contiguous() for t in (q, k, v, do)))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty(3 * B * H * T, dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), stats.data_ptr(), B * H, T, D,
                 torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention_bwd", err)
    return dq, dk, dv


def _bwd_sm90(q, k, v, do, o, stats, out=None):
    """``csrc/attention_bwd_sm90.cu``: bf16 at D = 32, 64 or 128, inputs
    read and outputs written through their strides (``_view``). Counts
    nothing."""
    B, H, T, D = q.shape
    ins = [_view(t) for t in (q, k, v, do, o)]
    if out is None:
        out = tuple(torch.empty_like(q) for _ in range(3))
    outs = [_view(t) for t in out]
    for (t, _), want in zip(outs, out):
        if t is not want:
            raise ValueError("attention_bwd: out must have a contiguous "
                             "last dim and strides of 8-element multiples")
    stats = stats.contiguous()
    delta = torch.empty(B * H * T, dtype=torch.float32, device=q.device)
    views = (ctypes.c_longlong * 24)(*(s for _, st in ins + outs
                                       for s in st))
    fn = _build.entry("attention_bwd_sm90")
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t, _ in ins + outs), stats.data_ptr(),
                 delta.data_ptr(), views, B, H, T, D,
                 torch.cuda.current_stream().cuda_stream)
    _build.check("attention_bwd_sm90", err)
    return out


def attention_bwd(q, k, v, do, o=None, stats=None, *, out=None):
    """The attention backward over (B, H, T, D) q, k, v and do, q unscaled
    (the fused MHA block's stash), any T: returns dq, dk, dv in q's dtype.

    ``o`` is the forward's output and ``stats`` its row statistics
    (``attention_stats_plain``'s (2, B, H, T) fp32); the sm90 route (bf16,
    D = 32, 64 or 128) needs both, the others ignore them. q, k, v, do and
    o may be strided views. ``out``, three (B, H, T, D) tensors (views of one
    buffer, say), receives dq, dk, dv and is returned.

    CUDA tensors go through a kernel, adding one to
    ``attention_bwd.launches`` and, on the sm90 route, to
    ``attention_bwd.launches_sm90``; CPU tensors take the plain version.
    """
    _check(q, k, v, do)
    if o is not None and (o.shape != q.shape or o.dtype != q.dtype):
        raise ValueError(f"o must be {q.dtype} {tuple(q.shape)} like q, got "
                         f"{o.dtype} {tuple(o.shape)}")
    if stats is not None and (tuple(stats.shape) != (2, *q.shape[:3])
                              or stats.dtype != torch.float32):
        raise ValueError(f"stats must be float32 {(2, *q.shape[:3])}, got "
                         f"{stats.dtype} {tuple(stats.shape)}")
    if q.device.type == "cpu":
        return _into(attention_bwd_plain(q, k, v, do), out)
    if not q.is_cuda:
        raise ValueError(f"attention_bwd runs on cuda or cpu, not {q.device}")
    if sm90_route(q):
        if o is None or stats is None:
            raise ValueError("attention_bwd on bf16 at D = 32, 64 or 128 "
                             "(the sm90 route) takes the forward's o and "
                             "stats")
        res = _bwd_sm90(q, k, v, do, o, stats, out)
        attention_bwd.launches_sm90 += 1
    else:
        res = _into(_bwd_wmma(q, k, v, do), out)
    attention_bwd.launches += 1
    return res


def _into(res, out):
    """``res`` copied into the tensors ``out`` (and ``out`` returned), or
    ``res`` when there is no ``out``."""
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return out


attention_bwd.launches = 0
attention_bwd.launches_sm90 = 0


# --- B5: the forward --------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, probs_mode=None):
    """The plain torch version of B5, rounding where ``_fwd_kernel`` rounds
    (``flash_attention.py:102-157``): qs = cast(q * scale); fp32 logits,
    p = exp(s - max) and l in fp32; o = cast(p) v / l, cast once; probs =
    p / l; the head mean sums p / l over the heads in order and divides by
    H. q is unscaled. Returns o, or (o, probs) with probs (B, H, T, T) for
    ``probs_mode="full"`` and (B, T, T) for ``"mean"``, fp32."""
    dt = q.dtype
    qs = (q.float() * (1.0 / q.shape[-1] ** 0.5)).to(dt)
    s = matmul32(qs, k.transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (matmul32(p.to(dt), v) / l).to(dt)
    if probs_mode is None:
        return o
    probs = p / l
    if probs_mode == "full":
        return o, probs
    acc = probs[:, 0]
    for h in range(1, probs.shape[1]):
        acc = acc + probs[:, h]
    return o, acc / probs.shape[1]


def _check_fwd(q, k, v, probs_mode):
    if probs_mode not in PROBS_MODES:
        raise ValueError(f"probs_mode must be None, 'full' or 'mean', got "
                         f"{probs_mode!r}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} like "
                             f"q, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.shape[-1] > MAX_FWD_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_FWD_HEAD_DIM} is "
                         f"not supported")


def _fwd_sm90(q, k, v, want_stats: bool):
    """``csrc/flash_attention_sm90.cu``: bf16 at D = 32, 64 or 128, no
    probs -> (o, stats (2, B, H, T) fp32 or None). Counts nothing."""
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    stats = (torch.empty((2, B, H, T), dtype=torch.float32, device=q.device)
             if want_stats else None)
    ins = [_view(t) for t in (q, k, v, o)]
    views = (ctypes.c_longlong * 12)(*(s for _, st in ins for s in st))
    fn = _build.entry("flash_attention_fwd_sm90")
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t, _ in ins),
                 stats.data_ptr() if stats is not None else None, views,
                 B, H, T, D, torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention_fwd_sm90", err)
    return o, stats


ROUTE_SM90 = 1   # _launch_probs's route: the sm90 body and the probability pass


def probs_route(q, k, v) -> int:
    """The route of a probability-mode launch on CUDA q, k, v: ``ROUTE_SM90``
    for bf16 at D = 32, 64 or 128 (``sm90_route``) with contiguous (B, H,
    T, D) planes on 16-byte boundaries (the pass's TMA maps) and B * H at
    most 65535 (the grids' second and third dimensions); 0,
    ``csrc/flash_attention_fwd.cu``, otherwise."""
    ok = (sm90_route(q) and q.shape[0] * q.shape[1] <= 65535
          and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                  for t in (q, k, v)))
    return ROUTE_SM90 if ok else 0


def _fwd_probs_sm90(q, k, v, probs_mode):
    """``csrc/flash_attention_sm90.cu``'s probability entry -> (o, probs):
    the body with its row statistics in a scratch, then the pass. Counts
    nothing."""
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    stats = torch.empty((2, B, H, T), dtype=torch.float32, device=q.device)
    shape = (B, H, T, T) if probs_mode == "full" else (B, T, T)
    probs = torch.empty(shape, dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_fwd_probs_sm90")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 stats.data_ptr(), probs.data_ptr(), PROBS_MODES[probs_mode],
                 B, H, T, D, torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention_fwd_probs_sm90", err)
    return o, probs


def _launch_probs(q, k, v, probs_mode, route=None):
    """B5's probability modes on CUDA tensors -> (o, probs, route):
    ``route`` defaults to ``probs_route``'s; ``ROUTE_SM90`` runs the sm90
    body and pass, 0 the earlier kernel. Counts nothing."""
    fits = probs_route(q, k, v)
    if route is None:
        route = fits
    if route == ROUTE_SM90:
        if not fits:
            raise ValueError("the sm90 probability route takes bf16 "
                             "contiguous 16-byte-aligned planes at D = 32, "
                             "64 or 128")
        return (*_fwd_probs_sm90(q, k, v, probs_mode), route)
    if route != 0:
        raise ValueError(f"route must be 0 or {ROUTE_SM90}, got {route}")
    return (*_fwd_wmma(q, k, v, probs_mode), route)


def _fwd_wmma(q, k, v, probs_mode):
    """``csrc/flash_attention_fwd.cu`` -> o, or (o, probs): fp32, any D
    up to 256, and the probs modes. Counts nothing."""
    B, H, T, D = q.shape
    q, k, v = _build.aligned(q, k, v)
    o = torch.empty_like(q)
    probs = None
    if probs_mode == "full":
        probs = torch.empty((B, H, T, T), dtype=torch.float32,
                            device=q.device)
    elif probs_mode == "mean":
        probs = torch.empty((B, T, T), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_fwd")
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(),
                 probs.data_ptr() if probs is not None else None,
                 PROBS_MODES[probs_mode], B, H, T, D,
                 torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention_fwd", err)
    return o if probs is None else (o, probs)


def _fwd(q, k, v, probs_mode, counter, want_stats: bool = False):
    """B5 on CUDA (adding one to ``counter.launches``; on the sm90 routes,
    ``sm90_route`` without probs and ``probs_route`` with them, to
    ``counter.launches_sm90`` too), the plain version on the CPU.
    ``want_stats`` (no probs) returns (o, stats), stats None off the sm90
    route."""
    if q.device.type == "cpu":
        o = flash_attention_fwd_plain(q, k, v, probs_mode)
        return (o, None) if want_stats else o
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if probs_mode is not None:
        *res, route = _launch_probs(q, k, v, probs_mode)
        counter.launches_sm90 += int(route == ROUTE_SM90)
        counter.launches += 1
        return tuple(res)
    if sm90_route(q):
        o, stats = _fwd_sm90(q, k, v, want_stats)
        counter.launches_sm90 += 1
    else:
        o, stats = _fwd_wmma(q, k, v, None), None
    counter.launches += 1
    return (o, stats) if want_stats else o


class _Flash(torch.autograd.Function):
    """B5 forward; B2 backward. The residuals are q, k, v, as vitx's
    ``_flash_kernel`` keeps (``flash_attention.py:465-479``), plus o and
    the row statistics that the sm90 backward reads."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, stats = _fwd(q, k, v, None, flash_attention, want_stats=True)
        ctx.save_for_backward(q, k, v, o, stats)
        return o

    @staticmethod
    def backward(ctx, do):
        # unpacked once: activation checkpointing refuses a second unpack
        q, k, v, o, stats = ctx.saved_tensors
        return attention_bwd(q, k, v, do, o, stats)


class _FlashProbs(torch.autograd.Function):
    """B5 with probs forward; the backward differentiates the plain
    reference attention (``flash_attention.py:516-538``)."""

    @staticmethod
    def forward(ctx, q, k, v, probs_mode, counter):
        ctx.save_for_backward(q, k, v)
        ctx.mean = probs_mode == "mean"
        return _fwd(q, k, v, probs_mode, counter)

    @staticmethod
    def backward(ctx, do, dprobs):
        # imported here: vitx_torch.nn.attention imports this module
        from vitx_torch.nn.attention import reference_attention

        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            o, p = reference_attention(*ins, return_probs=True)
            outs = (o, p.mean(dim=1) if ctx.mean else p)
        pairs = [(o, g) for o, g in zip(outs, (do, dprobs)) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    ins, [g for _, g in pairs])
        return (*grads, None, None)


def flash_attention(q, k, v):
    """Non-causal attention over (B, H, T, D) q, k, v, q unscaled -> o
    (B, H, T, D) in q's dtype, differentiable (B2 backward).

    CUDA tensors go through B5 and add one to ``flash_attention.launches``;
    CPU tensors take the plain version. Any T runs, forward and backward.
    Inside a ``torch.export`` trace, where nothing needs a gradient, the
    call is the op ``vitx_torch::attention_fwd`` (``kernels/ops.py``).
    """
    _check_fwd(q, k, v, None)
    if not _build.needs_grad(q, k, v):
        if _build.tracing():
            return torch.ops.vitx_torch.attention_fwd(q, k, v)
        return _fwd(q, k, v, None, flash_attention)
    return _Flash.apply(q, k, v)


def _with_probs(q, k, v, probs_mode, counter):
    _check_fwd(q, k, v, probs_mode)
    if not _build.needs_grad(q, k, v):
        return _fwd(q, k, v, probs_mode, counter)
    return _FlashProbs.apply(q, k, v, probs_mode, counter)


def flash_attention_with_probs(q, k, v):
    """(o, probs (B, H, T, T) fp32): B5 with the full probabilities, the
    attention-map path. CUDA launches count in
    ``flash_attention_with_probs.launches``, those on the sm90 route
    (``probs_route``) in ``launches_sm90`` too."""
    return _with_probs(q, k, v, "full", flash_attention_with_probs)


def flash_attention_with_mean_probs(q, k, v):
    """(o, head-mean probs (B, T, T) fp32): B5 writing H times fewer
    probability bytes, what rollout reads. The head sum has one fixed
    order, so repeated calls agree bit for bit. CUDA launches count in
    ``flash_attention_with_mean_probs.launches``, those on the sm90 route
    (``probs_route``) in ``launches_sm90`` too."""
    return _with_probs(q, k, v, "mean", flash_attention_with_mean_probs)


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention_with_probs.launches = 0
flash_attention_with_probs.launches_sm90 = 0
flash_attention_with_mean_probs.launches = 0
flash_attention_with_mean_probs.launches_sm90 = 0
