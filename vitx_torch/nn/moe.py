"""Soft Mixture-of-Experts MLP (Soft-MoE, Puigcerver et al. 2023).

The counterpart of ``vitx/nn/moe.py``: the last ``cfg.moe_block_count``
encoder blocks replace the dense MLP with a soft mixture of
``cfg.moe_experts`` expert MLPs. Every slot is a convex combination of all
tokens (the dispatch softmax, over the tokens) and every token's output a
convex combination of all slot outputs (the combine softmax, over the
slots), so the layer is five batched products and two softmaxes:

    logits  = scale * l2n(x) @ l2n(phi)          (B,T,n,s)
    slots   = softmax_T(logits)^T x              (B,n,s,E)
    y_slots = expert_mlp_n(slots)                per-expert weights
    y       = softmax_{n*s}(logits) @ y_slots    (B,T,E)

vitx leaves these products to XLA, outside any Pallas kernel; here they
are ``torch.einsum`` (cuBLAS batched products on a card). The router runs
in fp32; each product accumulates in fp32 and is cast once to the compute
dtype, and the biases are added in the compute dtype, at vitx's points.

Expert parallelism (``cfg.ep`` on a mesh with an ``expert`` axis,
``vitx/nn/moe.py:96-112``): a rank holds n/ep of the experts
(``ew1/eb1/ew2/eb2`` split on their expert dim) and its rows of the
batch. Its slots cross the expert axis by all-to-all before the experts
(each rank sends every other its experts' slots of the local rows and
gets all the rows' slots of its own experts) and back after them. Under
tensor parallelism the experts' hidden dim is split over ``model``: the
slots enter through ``copy_to`` and the second product leaves through
``reduce_from``, before ``eb2``.
"""

from __future__ import annotations

import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.nn.layers import activation, einsum_cast
from vitx_torch.parallel import comm
from vitx_torch.parallel.mesh import EXPERT_AXIS, MODEL_AXIS


def _l2n(x, dim: int):
    """x over its L2 norm along ``dim``, with 1e-6 inside the rsqrt."""
    return x * torch.rsqrt(x.square().sum(dim=dim, keepdim=True) + 1e-6)


def soft_moe_mlp(h, bp, cfg: ViTConfig, *, mesh=None):
    """Post-LN tokens h (B, T, E) -> the mixture's output (B, T, E) in
    h's dtype (``vitx/nn/moe.py:74-114``). ``bp``: one MoE block's leaves,
    ``phi`` (E, n, s), ``router_scale`` (), ``ew1`` (n, E, M), ``eb1``
    (n, M), ``ew2`` (n, M, E), ``eb2`` (n, E). The dispatch softmax runs
    over every token (prefix and registers too), the combine softmax over
    all n*s slots. ``mesh``: a rank of a sharded step (the module's
    doc)."""
    cdt = h.dtype
    xn = _l2n(h.float(), -1)
    phin = _l2n(bp["phi"].float(), 0)                      # (E, n, s)
    logits = bp["router_scale"].float() * torch.einsum("bte,ens->btns", xn,
                                                       phin)
    B, T, n, s = logits.shape
    disp = torch.softmax(logits, dim=1)                     # over tokens
    comb = torch.softmax(logits.reshape(B, T, n * s), dim=-1).reshape(
        B, T, n, s)                                         # over all slots
    slot_in = einsum_cast("bte,btns->bnse", h, disp.to(cdt))
    ep = cfg.ep and mesh is not None and mesh.ep > 1
    tp = mesh is not None and mesh.tp > 1
    if ep:
        slot_in = comm.all_to_all(slot_in, mesh, EXPERT_AXIS, 1, 0)
    if tp:
        slot_in = comm.copy_to(slot_in, mesh, MODEL_AXIS)
    h1 = einsum_cast("bnse,nem->bnsm", slot_in, bp["ew1"].to(cdt))
    h1 = activation(h1 + bp["eb1"].to(cdt)[:, None, :], cfg.mlp_act)
    ys = einsum_cast("bnsm,nme->bnse", h1, bp["ew2"].to(cdt))
    if tp:
        ys = comm.reduce_from(ys, mesh, MODEL_AXIS)
    ys = ys + bp["eb2"].to(cdt)[:, None, :]
    if ep:
        ys = comm.all_to_all(ys, mesh, EXPERT_AXIS, 0, 1)
    return einsum_cast("bnse,btns->bte", ys, comb.to(cdt))
