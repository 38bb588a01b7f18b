"""Fused MHA block: LN -> QKV projection -> attention -> out-projection.

``fused_mha_block`` launches the Hopper kernel K1 (``csrc/mha_block.cu``)
on CUDA tensors and runs ``mha_block_plain``, the same math in plain torch,
on CPU tensors. It replaces ``vitx/kernels/mha_block.py::_kernel`` with and
without its stash (``_fused_fwd``), and is differentiable: its backward
mirrors ``_fused_op_bwd`` (``mha_block.py:964-1005``) -- torch products for
the projections, the attention backward B2 (``attention_bwd``) and the
LayerNorm backward B3 (``ln_bwd``).

K1 and its stash take every T. Past T = 1024 (ViT-B/16 at 512², T 1025)
the port still runs K1 with its stash, and its backward reaches vitx's
q-chunked backward B6 through ``attention_bwd``. vitx on the TPU routes
that T elsewhere: ``supports_fused_mha`` fails its VMEM budget and
``supports_chunked_mha`` stops at T 1024 (``mha_block.py:387-394,
1011-1035``), so it trains through the composed path (LN, XLA
projections, B5 forward, B6 backward). Both routes compute the same
function; in Pallas interpret mode vitx runs the fused block as the port
does.

Routes on the card, chosen here in the open and passed to the kernel,
which refuses one the inputs cannot take (``mha_route``): in bf16 with E
a multiple of 8 the projections run on the Hopper GEMM
``csrc/gemm_sm90.cuh`` (wgmma fed by TMA, the LayerNorm applied to the A
operand in registers), and K1's, B7's and B8's attention at head width
32, 64 or 128 on B5's sm90 body (``csrc/attention_fwd_sm90.cuh``; B8's
per-key bias is one fp32 add per logit there; B7's head-mean
probabilities a second pass, ``csrc/attention_probs_sm90.cuh``, from the
body's row statistics); fp32 and other shapes keep the earlier kernels
(``common.cuh``'s ``gemm_kernel``, ``attention_fwd.cuh``). ``launches``
counts every CUDA launch of a wrapper, ``launches_sm90`` those whose
projections ran on the sm90 GEMM, and ``launches_attn_sm90`` those whose
attention ran on the sm90 body.

``fused_mha_block_with_mean_probs`` (B7, the same source's second entry)
also returns the head-mean attention probabilities; it replaces
``_kernel_hchunk`` in its mean-probs mode (``_chunked_fwd``,
``fused_mha_block_with_mean_probs``), and its plain version is
``mha_block_mean_probs_plain``. ``_kernel_hchunk``'s no-probs mode
computes ``_kernel``'s function, which vitx takes only where ``_kernel``
does not fit VMEM (``mha_block.py:1046-1054``); K1 serves it at every
shape.

``fused_mha_block_tome`` (B8, the third entry) is ToMe's attention half:
K1 plus an fp32 QKV bias, a per-key fp32 logit bias ``log_size`` and the
head-mean key ``k_mean``, the merge metric. It replaces ``_kernel_tome``
and, at every shape, ``_kernel_hchunk_tome`` (B9): that kernel is
``_kernel_tome`` cut into head chunks where the TPU's VMEM runs out, the
same function. Its plain version is ``mha_block_tome_plain``;
``composed_tome`` is vitx's ``_composed_tome``, which rounds elsewhere and
is what its backward differentiates. The source note in the ``.cu`` file
says what bounds the kernels on the H100 and how they are laid out.
"""

from __future__ import annotations

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels._build import DTYPE_CODES
from vitx_torch.kernels.flash_attention import SM90_HEAD_DIMS, attention_bwd
from vitx_torch.kernels.layer_norm import ln_bwd
from vitx_torch.nn.layers import dot, layer_norm, matmul32

MAX_HEAD_DIM = 256
# the route bits of csrc/mha_block.cu's entries
ROUTE_GEMM_SM90 = 1   # both projections on csrc/gemm_sm90.cuh
# the attention on csrc/attention_fwd_sm90.cuh (B7's probabilities then on
# csrc/attention_probs_sm90.cuh)
ROUTE_ATTN_SM90 = 2


def mha_route(dtype, E: int, H: int, *, tensors=()) -> int:
    """The route of the ``mha_block.cu`` entries (K1, B7 and B8):
    ``ROUTE_GEMM_SM90`` where the projections can take the sm90 GEMM
    (``_build.gemm_sm90``: bf16, E a multiple of 8 and at most 4096,
    ``tensors`` -- x and the weights -- 16-byte aligned), plus
    ``ROUTE_ATTN_SM90`` where the attention can take B5's sm90 body: bf16
    at a head width of ``SM90_HEAD_DIMS`` (32, 64 or 128), B7's head-mean
    probabilities then coming from a second pass over q, k and the body's
    row statistics (``csrc/attention_probs_sm90.cuh``). 0 is the earlier
    kernels throughout."""
    route = (ROUTE_GEMM_SM90 if _build.gemm_sm90(dtype, (E,), tensors, ln_k=E)
             else 0)
    if dtype == torch.bfloat16 and E // H in SM90_HEAD_DIMS:
        route |= ROUTE_ATTN_SM90
    return route


def _plain(x, wqkv, wo, bo, g, b, eps, probs: bool, bqkv=None,
           log_size=None):
    """-> (out, q0, k, v, o_all, mean probs or None), see
    ``mha_block_plain``; with B8's ``bqkv`` and ``log_size``, see
    ``mha_block_tome_plain``."""
    B, T, E = x.shape
    H = wqkv.shape[2]
    D = E // H
    dt = x.dtype
    h = layer_norm(x, g, b, eps=eps)
    qkv = matmul32(h, wqkv.reshape(E, 3 * E))
    if bqkv is not None:    # the bias joins the fp32 sum, before the cast
        qkv = qkv + bqkv.reshape(3 * E).float()
    qkv = qkv.to(dt)
    # column block s*E + h*D of the (E, 3E) flattening is head h of q|k|v
    qkv = qkv.reshape(B, T, 3, H, D).permute(2, 0, 3, 1, 4)
    q0, k, v = qkv[0], qkv[1], qkv[2]
    q = (q0.float() * (1.0 / D ** 0.5)).to(dt)
    s = matmul32(q, k.transpose(-1, -2))
    if log_size is not None:   # one fp32 bias per key, on the fp32 logits
        s = s + log_size.float()[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (matmul32(p.to(dt), v) / l).to(dt)
    o_all = o.transpose(1, 2).reshape(B, T, E)
    out = (matmul32(o_all, wo) + bo.float()).to(dt)
    mean = None
    if probs:   # the head sum in order, then / H (csrc/attention_fwd.cuh)
        pl = p / l
        mean = pl[:, 0]
        for i in range(1, H):
            mean = mean + pl[:, i]
        mean = mean / H
    return out, q0, k, v, o_all, mean


def mha_block_plain(x, wqkv, wo, bo, g, b, *, eps: float = 1e-5,
                    stash: bool = False):
    """The plain torch version of K1, rounding where the TPU kernel rounds
    (``vitx/kernels/mha_block.py:46-91``): q|k|v accumulate in fp32 and
    are cast; q is rescaled in fp32 and cast again; l sums the fp32 p while
    the PV product takes p cast to the compute dtype, and the division by l
    follows the product; bo is added to the fp32 out-projection before the
    one cast. ``stash=True`` also returns the unscaled q, k, v
    ((B, H, T, D) each) and o_all (B, T, E)."""
    out, q0, k, v, o_all, _ = _plain(x, wqkv, wo, bo, g, b, eps, False)
    if stash:
        return (out, q0.contiguous(), k.contiguous(), v.contiguous(),
                o_all.contiguous())
    return out


def mha_block_mean_probs_plain(x, wqkv, wo, bo, g, b, *,
                               eps: float = 1e-5):
    """The plain torch version of B7: (``mha_block_plain``'s out, probs
    (B, T, T) fp32), probs the sum over the heads, in order, of the fp32
    p / l, divided by H. vitx's ``_kernel_hchunk`` sums p / (l * H)
    (``mha_block.py:217-218``): the same value up to fp32 rounding."""
    out, _, _, _, _, mean = _plain(x, wqkv, wo, bo, g, b, eps, True)
    return out, mean


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


def _launch(x, wqkv, wo, bo, g, b, eps, name="mha_block", extra=(),
            route=None):
    """The ``mha_block.cu`` entry ``name`` on CUDA tensors -> (out, q, k,
    v, o_all, route): K1, or B7 with ``extra`` (its (B, T, T) fp32 probs
    output, its (2, B, H, T) fp32 statistics scratch or None; see
    ``_launch_mean_probs``), or B8 with ``extra`` (bqkv, log_size, its (B,
    T, D) k_mean output). K1's ``extra`` is its (2, B, H, T) fp32
    attention statistics output. ``route`` defaults to ``mha_route``'s;
    the caller counts."""
    if not x.is_cuda:
        raise ValueError(f"fused_mha_block runs on cuda or cpu, "
                         f"not {x.device}")
    B, T, E = x.shape
    H = wqkv.shape[2]
    x, wqkv, wo, bo, g, b = _build.aligned(x, wqkv, wo, bo, g, b)
    if route is None:
        route = mha_route(x.dtype, E, H, tensors=(x, wqkv, wo))
    fn = _build.entry(name)
    out = torch.empty_like(x)
    qkv = torch.empty((3, B, H, T, E // H), dtype=x.dtype, device=x.device)
    o_all = torch.empty_like(x)
    stats = torch.empty((2, B * T), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], route, x.data_ptr(), wqkv.data_ptr(),
                 wo.data_ptr(), bo.data_ptr(), g.data_ptr(), b.data_ptr(),
                 out.data_ptr(), qkv.data_ptr(), o_all.data_ptr(),
                 stats.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in extra),
                 B, T, E, H, float(eps),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(name, err)
    return out, qkv[0], qkv[1], qkv[2], o_all, route


def _count(wrapper, route) -> None:
    wrapper.launches += 1
    if route & ROUTE_GEMM_SM90:
        wrapper.launches_sm90 += 1
    if route & ROUTE_ATTN_SM90:
        wrapper.launches_attn_sm90 += 1


def _forward(x, wqkv, wo, bo, g, b, eps):
    """-> (out, q, k, v, o_all, stats): kernel K1 on CUDA, the plain
    version on the CPU (stats None there). The stash is free on the card:
    q|k|v and o_all are the kernel's own intermediates, returned as views;
    stats (2, B, H, T) fp32 holds each attention row's max and 1 / l, what
    the sm90 backward reads."""
    if x.device.type == "cpu":
        return (*mha_block_plain(x, wqkv, wo, bo, g, b, eps=eps,
                                 stash=True), None)
    B, T, _ = x.shape
    stats = torch.empty((2, B, wqkv.shape[2], T), dtype=torch.float32,
                        device=x.device)
    *res, route = _launch(x, wqkv, wo, bo, g, b, eps, extra=(stats,))
    _count(fused_mha_block, route)
    return (*res, stats)


def _infer(x, wqkv, wo, bo, g, b, eps):
    """-> out: K1 without its stash (no attention statistics either) on
    CUDA, the plain version on the CPU; what inference calls, eagerly and
    as the op ``vitx_torch::mha_block`` (``kernels/ops.py``)."""
    if x.device.type == "cpu":
        return mha_block_plain(x, wqkv, wo, bo, g, b, eps=eps)
    out, *_, route = _launch(x, wqkv, wo, bo, g, b, eps, extra=(None,))
    _count(fused_mha_block, route)
    return out


def _backward(dout, x, wqkv, wo, g, b, q, k, v, o_all, stats, eps,
              need=(True,) * 6):
    """``_fused_op_bwd`` (``vitx/kernels/mha_block.py:964-1005``): every
    product accumulates in fp32 and is cast once -- dwo and dwqkv to the
    weights' dtype, do and dh to the activations'; dbo stays fp32.
    ``need`` (x, wqkv, wo, bo, g, b): the gradients to compute, None for
    the rest -- a frozen weight's product is never formed, as vitx's
    ``stop_gradient`` leaves it out of the traced backward."""
    B, T, E = x.shape
    H, D = wqkv.shape[2], wqkv.shape[3]
    n_x, n_wqkv, n_wo, n_bo, n_g, n_b = need
    d2 = dout.reshape(B * T, E)
    dwo = dot(o_all.reshape(B * T, E).t(), d2).to(wo.dtype) if n_wo else None
    dbo = dout.float().sum(dim=(0, 1)) if n_bo else None
    if not (n_x or n_wqkv or n_g or n_b):
        return None, None, dwo, dbo, None, None
    # do and o as (B, H, T, D) views of their (B, T, E) layouts, and dq,
    # dk, dv written into dqkv's (B, T, 3, H, D): the three projections
    # side by side, as the columns of the (E, 3E) flattening of wqkv, so
    # dwqkv is one product and dh one fp32 sum of the three, cast once
    do = dot(d2, wo.to(dout.dtype).t()).reshape(B, T, H, D).transpose(1, 2)
    o = o_all.reshape(B, T, H, D).transpose(1, 2)
    dqkv = torch.empty((B, T, 3, H, D), dtype=q.dtype, device=q.device)
    attention_bwd(q, k, v, do, o, stats,
                  out=tuple(dqkv[:, :, i].transpose(1, 2) for i in range(3)))
    dqkv = dqkv.reshape(B * T, 3 * E)
    dwqkv = None
    if n_wqkv:
        h = layer_norm(x, g, b, eps=eps)
        dwqkv = dot(h.reshape(B * T, E).t(), dqkv).to(wqkv.dtype).reshape(
            E, 3, H, D)
    if not (n_x or n_g or n_b):
        return None, dwqkv, dwo, dbo, None, None
    w = wqkv.reshape(E, 3 * E).to(dqkv.dtype)
    dh = dot(dqkv, w.t()).to(x.dtype).reshape(B, T, E)
    dx, dg, db = ln_bwd(x, g, dh, eps=eps)
    return (dx if n_x else None, dwqkv, dwo, dbo,
            dg.to(g.dtype) if n_g else None, db.to(b.dtype) if n_b else None)


class _FusedMHA(torch.autograd.Function):
    """K1 forward with its stash; the backward of ``_backward``, for the
    inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, wqkv, wo, bo, g, b, eps):
        out, q, k, v, o_all, stats = _forward(x, wqkv, wo, bo, g, b, eps)
        ctx.save_for_backward(x, wqkv, wo, g, b, q, k, v, o_all, stats)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _backward(dout.contiguous(), *ctx.saved_tensors, ctx.eps,
                          need=ctx.needs_input_grad[:6])
        return (*grads, None)


def fused_mha_block(x, wqkv, wo, bo, g, b, *, eps: float = 1e-5,
                    stash: bool = False):
    """LN(x) -> multi-head attention -> output projection, fused.

    x: (B, T, E) compute dtype; wqkv: (E, 3, H, D) and wo: (E, E) in x's
    dtype; bo (zeros when the projection has no bias), g, b: (E,) float32.
    Returns (B, T, E) in x's dtype, differentiable in every input. With
    ``stash=True`` returns (out, q, k, v, o_all) as vitx's
    ``_fused_fwd(stash=True)`` does -- q, k, v (B, H, T, D) with q
    unscaled, o_all (B, T, E) -- and records no gradient. CUDA tensors go
    through kernel K1 and add one to ``fused_mha_block.launches`` (and to
    ``launches_sm90`` on the sm90 GEMM, to ``launches_attn_sm90`` on the
    sm90 attention body, ``mha_route``); CPU tensors take the plain
    version. Where nothing needs a gradient the call is K1
    without its stash, and inside a ``torch.export`` trace it is the op
    ``vitx_torch::mha_block`` (``kernels/ops.py``).
    """
    _check(x, wqkv, wo, bo, g, b)
    if stash:
        with torch.no_grad():
            return _forward(x, wqkv, wo, bo, g, b, eps)[:5]
    if not _build.needs_grad(x, wqkv, wo, bo, g, b):
        if _build.tracing():
            return torch.ops.vitx_torch.mha_block(x, wqkv, wo, bo, g, b,
                                                  float(eps))
        return _infer(x, wqkv, wo, bo, g, b, eps)
    return _FusedMHA.apply(x, wqkv, wo, bo, g, b, float(eps))


fused_mha_block.launches = 0
fused_mha_block.launches_sm90 = 0
fused_mha_block.launches_attn_sm90 = 0


# --- B7: the block with head-mean probabilities ------------------------------

def _launch_mean_probs(x, wqkv, wo, bo, g, b, eps, route=None):
    """B7's entry on CUDA tensors -> (out, probs, q, k, v, route), q, k, v
    the kernel's own (B, H, T, D) planes (q unscaled): ``route`` defaults to
    ``mha_route``'s; on ``ROUTE_ATTN_SM90`` the attention's row statistics
    go to a (2, B, H, T) fp32 scratch, which the head-mean pass reads. The
    caller counts."""
    B, T, E = x.shape
    H = wqkv.shape[2]
    if route is None:
        route = mha_route(x.dtype, E, H, tensors=(x, wqkv, wo))
    probs = torch.empty((B, T, T), dtype=torch.float32, device=x.device)
    scratch = (torch.empty((2, B, H, T), dtype=torch.float32,
                           device=x.device)
               if route & ROUTE_ATTN_SM90 else None)
    out, q, k, v, _, _ = _launch(x, wqkv, wo, bo, g, b, eps,
                                 "mha_block_mean_probs", (probs, scratch),
                                 route)
    return out, probs, q, k, v, route


def _forward_mean_probs(x, wqkv, wo, bo, g, b, eps):
    """-> (out, probs): kernel B7 on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return mha_block_mean_probs_plain(x, wqkv, wo, bo, g, b, eps=eps)
    out, probs, *_, route = _launch_mean_probs(x, wqkv, wo, bo, g, b, eps)
    _count(fused_mha_block_with_mean_probs, route)
    return out, probs


def _composed_with_mean_probs(x, wqkv, wo, bo, g, b, eps):
    """The function B7's backward differentiates, vitx's
    ``_composed_with_mean_probs`` (``mha_block.py:397-416``): LN, then the
    composed reference attention with the head-mean probs."""
    # imported here: vitx_torch.nn.attention imports the kernels
    from vitx_torch.nn.attention import multi_head_attention

    return multi_head_attention(
        layer_norm(x, g, b, eps=eps), wqkv, None, wo, bo,
        num_heads=wqkv.shape[2], impl="reference", return_probs=True,
        probs_mode="mean")


class _FusedMHAMeanProbs(torch.autograd.Function):
    """B7 forward; the backward differentiates the composed path, as
    vitx's ``_make_chunked_probs_op`` does (``mha_block.py:456-474``)."""

    @staticmethod
    def forward(ctx, x, wqkv, wo, bo, g, b, eps):
        ctx.save_for_backward(x, wqkv, wo, bo, g, b)
        ctx.eps = eps
        return _forward_mean_probs(x, wqkv, wo, bo, g, b, eps)

    @staticmethod
    def backward(ctx, dout, dprobs):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = _composed_with_mean_probs(*ins, ctx.eps)
        grads = torch.autograd.grad(outs, ins, (dout, dprobs))
        return (*grads, None)


def fused_mha_block_with_mean_probs(x, wqkv, wo, bo, g, b, *,
                                    eps: float = 1e-5):
    """``fused_mha_block`` that also returns the head-mean attention
    probabilities: (out (B, T, E) in x's dtype, probs (B, T, T) fp32), the
    rollout path's input. The head sum has one fixed order, so repeated
    calls agree bit for bit. CUDA tensors go through kernel B7 and add one
    to ``fused_mha_block_with_mean_probs.launches`` (and to
    ``launches_sm90`` on the sm90 GEMM, to ``launches_attn_sm90`` on the
    sm90 attention and head-mean pass: bf16 at head width 32, 64 or 128,
    where its out is K1's bit for bit; at other widths the earlier
    attention); CPU tensors take the plain version.
    Differentiable through the composed path.
    """
    _check(x, wqkv, wo, bo, g, b)
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in (x, wqkv, wo, bo, g, b)):
        return _forward_mean_probs(x, wqkv, wo, bo, g, b, eps)
    return _FusedMHAMeanProbs.apply(x, wqkv, wo, bo, g, b, float(eps))


fused_mha_block_with_mean_probs.launches = 0
fused_mha_block_with_mean_probs.launches_sm90 = 0
fused_mha_block_with_mean_probs.launches_attn_sm90 = 0


# --- B8: ToMe's attention half (and B9's function) ---------------------------

def mha_block_tome_plain(x, wqkv, bqkv, wo, bo, g, b, log_size, *,
                         eps: float = 1e-5):
    """The plain torch version of B8: (out (B, T, E), k_mean (B, T, D)),
    both in x's dtype, rounding where ``_kernel_tome`` rounds
    (``vitx/kernels/mha_block.py:507-548``): ``mha_block_plain`` with the
    fp32 QKV bias ``bqkv`` (3, H, D) added to the fp32 projection before
    its cast, the fp32 ``log_size`` (B, T) added to every query's fp32
    logits over the keys, and k_mean the fp32 sum over the heads, in order,
    of the cast k, divided by H and cast."""
    out, _, k, _, _, _ = _plain(x, wqkv, wo, bo, g, b, eps, False, bqkv,
                                log_size)
    k_sum = k[:, 0].float()
    for i in range(1, k.shape[1]):
        k_sum = k_sum + k[:, i].float()
    return out, (k_sum / k.shape[1]).to(x.dtype)


def composed_tome(x, wqkv, bqkv, wo, bo, g, b, log_size, *,
                  eps: float = 1e-5):
    """vitx's ``_composed_tome`` (``mha_block.py:593-618``): the same
    function as B8, unfused and rounding as XLA does there -- the QKV bias
    is cast and added after the projection's cast, the logits are divided
    by sqrt(D) after the product, the softmax is cast before the PV
    product, bo is cast and added after the out-projection's cast, and
    k_mean is the mean of the cast k. The kernel-free route on the card,
    the CPU route when the fused rule says no, and what B8's backward
    differentiates. On a tensor-parallel rank ``wqkv``/``bqkv`` hold its
    H/tp heads and ``wo`` their rows: out is the rank's partial
    out-projection and k_mean the mean over its heads."""
    B, T, E = x.shape
    H, D = wqkv.shape[2], wqkv.shape[3]
    h = layer_norm(x, g, b, eps=eps)
    dt = h.dtype
    w, bq = wqkv.to(dt), bqkv.to(dt)

    def proj(s):
        r = dot(h, w[:, s].reshape(E, H * D)).reshape(B, T, H, D)
        return r.transpose(1, 2) + bq[s][None, :, None, :]

    q, k, v = proj(0), proj(1), proj(2)
    logits = matmul32(q, k.transpose(-1, -2)) / (D ** 0.5)
    logits = logits + log_size.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(dt)
    o = dot(probs, v).transpose(1, 2).reshape(B, T, H * D)
    out = dot(o, wo.to(dt)) + bo.to(dt)
    return out, k.float().mean(dim=1).to(dt)


def _check_tome(x, wqkv, bqkv, wo, bo, g, b, log_size):
    _check(x, wqkv, wo, bo, g, b)
    B, T, _ = x.shape
    H, D = wqkv.shape[2], wqkv.shape[3]
    for name, t, shape in (("bqkv", bqkv, (3, H, D)),
                           ("log_size", log_size, (B, T))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _forward_tome(x, wqkv, bqkv, wo, bo, g, b, log_size, eps):
    """-> (out, k_mean): kernel B8 on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return mha_block_tome_plain(x, wqkv, bqkv, wo, bo, g, b, log_size,
                                    eps=eps)
    B, T, _ = x.shape
    k_mean = torch.empty((B, T, wqkv.shape[3]), dtype=x.dtype,
                         device=x.device)
    res = _launch(x, wqkv, wo, bo, g, b, eps, "mha_block_tome",
                  (bqkv, log_size, k_mean))
    _count(fused_mha_block_tome, res[-1])
    return res[0], k_mean


class _FusedMHATome(torch.autograd.Function):
    """B8 forward; the backward differentiates ``composed_tome``, as
    vitx's ``_make_tome_op`` does (``mha_block.py:658-677``), for the
    inputs that need a gradient (in a ToMe-train step ``log_size`` and the
    zero QKV bias need none). ``k_mean`` feeds only the merge's selection,
    so its cotangent arrives as zeros; it is passed on all the same, as
    vitx's VJP takes both. The recompute's LayerNorm backward is B3."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, g, b, log_size, eps):
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, g, b, log_size)
        ctx.eps = eps
        return _forward_tome(x, wqkv, bqkv, wo, bo, g, b, log_size, eps)

    @staticmethod
    def backward(ctx, dout, dk_mean):
        need = ctx.needs_input_grad[:8]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            outs = composed_tome(*ins, eps=ctx.eps)
        wrt = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(outs, wrt, (dout, dk_mean)))
        return (*(next(grads) if n else None for n in need), None)


def fused_mha_block_tome(x, wqkv, bqkv, wo, bo, g, b, log_size, *,
                         eps: float = 1e-5):
    """ToMe's attention half, fused: LN(x) -> QKV + bias -> attention with
    one additive logit bias per key (proportional attention, ``log_size``
    = log of the tokens each key stands for) -> out-projection; also the
    head-mean key, the merge metric.

    x: (B, T, E) compute dtype; wqkv: (E, 3, H, D) and wo: (E, E) in x's
    dtype; bqkv: (3, H, D) float32 (zeros without a QKV bias); bo, g, b:
    (E,) float32; log_size: (B, T) float32. Returns (out (B, T, E),
    k_mean (B, T, D)), both in x's dtype, differentiable in every input
    through ``composed_tome``. CUDA tensors go through kernel B8 (any T;
    it serves B9's head-chunked function too) and add one to
    ``fused_mha_block_tome.launches`` (and to ``launches_sm90`` on the sm90
    GEMM, to ``launches_attn_sm90`` on the sm90 attention); CPU tensors
    take the plain version. Inside a ``torch.export`` trace, where nothing
    needs a gradient, the call is the op ``vitx_torch::mha_block_tome``
    (``kernels/ops.py``).
    """
    _check_tome(x, wqkv, bqkv, wo, bo, g, b, log_size)
    args = (x, wqkv, bqkv, wo, bo, g, b, log_size)
    if not _build.needs_grad(*args):
        if _build.tracing():
            return tuple(torch.ops.vitx_torch.mha_block_tome(*args,
                                                             float(eps)))
        return _forward_tome(*args, eps)
    return _FusedMHATome.apply(*args, float(eps))


fused_mha_block_tome.launches = 0
fused_mha_block_tome.launches_sm90 = 0
fused_mha_block_tome.launches_attn_sm90 = 0
