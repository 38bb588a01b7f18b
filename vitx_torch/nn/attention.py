"""Multi-head self-attention, composed: projections, then attention.

The counterpart of ``vitx/nn/attention.py``. Dense models on a CUDA device
run their attention half through the fused block kernels
(``vitx_torch.kernels.mha_block``) instead; this composed path serves
what those do not cover (a QKV bias, QK-Norm, a non-standard logit scale,
the full attention probabilities, RoPE, ``fuse_mha="off"``). Its attention is
the flash-attention kernel B5 (``vitx_torch.kernels.flash_attention``) or
the plain reference, by vitx's rule.

Scaling is ``1/sqrt(head_dim)`` unless ``scale`` overrides it.
"""

from __future__ import annotations

import torch

from vitx_torch.core.device import card_routes
from vitx_torch.kernels.flash_attention import (
    flash_attention, flash_attention_with_mean_probs,
    flash_attention_with_probs)
from vitx_torch.nn.layers import dot, matmul32


def reference_attention(q, k, v, *, return_probs: bool = False, scale=None):
    """Plain attention over (B, H, T, D) q/k/v -> (out (B, H, T, D),
    probs (B, H, T, T) fp32 or None).

    fp32 logits and a max-subtracted softmax; the probabilities are cast to
    the compute dtype for the PV product (``vitx/nn/attention.py:22-43``).
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    probs = torch.softmax(matmul32(q, k.transpose(-1, -2)) * scale, dim=-1)
    out = matmul32(probs.to(q.dtype), v).to(q.dtype)
    return out, (probs if return_probs else None)


def _qk_layer_norm(t, scale, eps):
    """Per-head LayerNorm over head_dim with a scale and no bias (QK-Norm).
    t: (B, H, T, D); scale: (H, D). fp32 statistics."""
    tf = t.float()
    mu = tf.mean(dim=-1, keepdim=True)
    var = (tf - mu).square().mean(dim=-1, keepdim=True)
    normed = (tf - mu) * torch.rsqrt(var + eps)
    return (normed * scale.float()[None, :, None, :]).to(t.dtype)


def apply_rope(t, cos, sin):
    """Rotate (B, H, T, D) q or k by the (T, D) tables: pairs (i, i + D/2)
    rotate together, the rotate-half form (``vitx/nn/vit.py:635-640``)."""
    D = t.shape[-1]
    rot = torch.cat([-t[..., D // 2:], t[..., :D // 2]], dim=-1)
    return t * cos + rot * sin


def use_flash(impl: str, x, head_dim: int, scale=None) -> bool:
    """vitx's rule (``vitx/nn/attention.py:102-111``) with "on a TPU" read
    as ``card_routes`` (x on a CUDA device, or an export's trace): B5 for
    ``impl="flash"``, or for ``"auto"`` there with D >= 32 and T >= 128;
    never with a non-standard scale."""
    if scale is not None:
        return False
    if impl == "flash":
        return True
    if impl == "auto":
        return card_routes(x) and head_dim >= 32 and x.shape[1] >= 128
    return False


def multi_head_attention(x, wqkv, bqkv, wo, bo, *, num_heads: int,
                         impl: str = "auto", return_probs: bool = False,
                         probs_mode: str = "full",
                         scale: float | None = None, qk_scales=None,
                         qk_eps: float = 1e-5, rope=None):
    """Composed multi-head self-attention over (B, T, E) tokens.

    wqkv: (E, 3, H, D); bqkv: (3, H, D) or None; wo: (H * D, E); bo:
    (E,) or None (a tensor-parallel rank holds H of the heads and their
    rows of ``wo``); ``qk_scales``: the (H, D) QK-Norm scales of q and k, or None.
    ``impl``: "auto" | "flash" | "reference" (``use_flash``).
    ``return_probs``: also return the attention probabilities, (B, H, T, T)
    fp32, or their head mean (B, T, T) for ``probs_mode="mean"``.
    ``rope``: the (cos, sin) (T, D) tables of 2-D axial RoPE
    (``vitx_torch.nn.vit.rope_tables``), or None; q and k rotate after the
    projection and after QK-Norm (``vitx/nn/attention.py:133-138``).
    Returns (out (B, T, E), probs or None).
    """
    B, T, E = x.shape
    H = num_heads
    D = wqkv.shape[-1]
    w = wqkv.to(x.dtype)

    def proj(s):
        r = dot(x, w[:, s].reshape(E, H * D))
        r = r.reshape(B, T, H, D).transpose(1, 2)            # (B, H, T, D)
        if bqkv is not None:
            r = r + bqkv[s].to(x.dtype)[None, :, None, :]
        return r

    q, k, v = proj(0), proj(1), proj(2)
    if qk_scales is not None:
        q = _qk_layer_norm(q, qk_scales[0], qk_eps)
        k = _qk_layer_norm(k, qk_scales[1], qk_eps)
    if rope is not None:
        cos, sin = (t.to(q.dtype) for t in rope)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if use_flash(impl, x, D, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if not return_probs:
            out, probs = flash_attention(q, k, v), None
        elif probs_mode == "mean":
            out, probs = flash_attention_with_mean_probs(q, k, v)
        else:
            out, probs = flash_attention_with_probs(q, k, v)
    else:
        out, probs = reference_attention(q, k, v, return_probs=return_probs,
                                         scale=scale)
        if probs is not None and probs_mode == "mean":
            probs = probs.mean(dim=1)
    out = out.transpose(1, 2).reshape(B, T, H * D)
    out = dot(out, wo.to(x.dtype))
    if bo is not None:
        out = out + bo.to(x.dtype)
    return out, probs
