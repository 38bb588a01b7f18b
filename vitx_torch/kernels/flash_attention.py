"""Attention forward (B5) and backward (B2) over (B, H, T, D) q, k, v.

- ``flash_attention`` / ``flash_attention_with_probs`` /
  ``flash_attention_with_mean_probs`` launch the Hopper kernel
  ``csrc/flash_attention_fwd.cu`` on CUDA tensors and run
  ``flash_attention_fwd_plain``, the same math in plain torch, on CPU
  tensors. They replace ``vitx/kernels/flash_attention.py::_fwd_kernel``
  in its three output modes (none, full probs, head-mean probs) and are
  differentiable as vitx's entries are: ``flash_attention``'s backward is
  B2, the probs variants differentiate the plain reference attention
  (``flash_attention.py:516-538``). Each keeps its own ``launches`` count.
- ``attention_bwd`` launches ``csrc/flash_attention_bwd.cu`` on CUDA
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


def attention_bwd(q, k, v, do):
    """The attention backward over (B, H, T, D) q, k, v and do, q unscaled
    (the fused MHA block's stash), any T: returns dq, dk, dv in q's dtype.

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


def _fwd(q, k, v, probs_mode, counter):
    """B5 on CUDA (adding one to ``counter.launches``), the plain version
    on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, probs_mode)
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, H, T, D = q.shape
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
    counter.launches += 1
    return o if probs is None else (o, probs)


class _Flash(torch.autograd.Function):
    """B5 forward; B2 backward (residuals q, k, v, as vitx's
    ``_flash_kernel``, ``flash_attention.py:465-479``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _fwd(q, k, v, None, flash_attention)

    @staticmethod
    def backward(ctx, do):
        return attention_bwd(*ctx.saved_tensors, do.contiguous())


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


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v):
    """Non-causal attention over (B, H, T, D) q, k, v, q unscaled -> o
    (B, H, T, D) in q's dtype, differentiable (B2 backward).

    CUDA tensors go through B5 and add one to ``flash_attention.launches``;
    CPU tensors take the plain version. Any T runs, forward and backward.
    """
    _check_fwd(q, k, v, None)
    if not _needs_grad(q, k, v):
        return _fwd(q, k, v, None, flash_attention)
    return _Flash.apply(q, k, v)


def _with_probs(q, k, v, probs_mode, counter):
    _check_fwd(q, k, v, probs_mode)
    if not _needs_grad(q, k, v):
        return _fwd(q, k, v, probs_mode, counter)
    return _FlashProbs.apply(q, k, v, probs_mode, counter)


def flash_attention_with_probs(q, k, v):
    """(o, probs (B, H, T, T) fp32): B5 with the full probabilities, the
    attention-map path. CUDA launches count in
    ``flash_attention_with_probs.launches``."""
    return _with_probs(q, k, v, "full", flash_attention_with_probs)


def flash_attention_with_mean_probs(q, k, v):
    """(o, head-mean probs (B, T, T) fp32): B5 writing H times fewer
    probability bytes, what rollout reads. The head sum has one fixed
    order, so repeated calls agree bit for bit. CUDA launches count in
    ``flash_attention_with_mean_probs.launches``."""
    return _with_probs(q, k, v, "mean", flash_attention_with_mean_probs)


flash_attention.launches = 0
flash_attention_with_probs.launches = 0
flash_attention_with_mean_probs.launches = 0
