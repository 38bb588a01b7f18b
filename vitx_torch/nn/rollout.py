"""Attention rollout: the attention-map analysis API.

The counterpart of ``vitx/nn/rollout.py``: average (or max/min) the heads,
add the identity for the residual path, renormalise the rows, chain the
layers' products, and read the CLS row over the patch columns.
``forward_with_rollout`` (``vitx_torch/nn/vit.py``) computes the same
weights without holding the per-layer stack.
"""

from __future__ import annotations

import torch


def attention_rollout(attn_probs, *, head_fusion: str = "mean",
                      num_prefix_tokens: int = 1, num_registers: int = 0):
    """Chain per-layer attention into an input-attribution map.

    ``attn_probs``: (depth, B, H, T, T) from ``forward_with_attn``, or the
    head-fused (depth, B, T, T) of ``probs_mode="mean"``. ``head_fusion``:
    "mean" | "max" | "min" across heads (ignored for 4-D input).
    ``num_prefix_tokens``: tokens before the patches (CLS, + the distill
    token); ``num_registers``: register tokens after them, whose columns
    are dropped too. Returns (B, N) weights of the CLS token over the N
    patch tokens, each row summing to 1 (``vitx/nn/rollout.py:17-61``).
    """
    if attn_probs.dim() == 4:
        fused = attn_probs
    elif head_fusion == "mean":
        fused = attn_probs.mean(dim=2)
    elif head_fusion == "max":
        fused = attn_probs.amax(dim=2)
    elif head_fusion == "min":
        fused = attn_probs.amin(dim=2)
    else:
        raise ValueError(f"unknown head_fusion {head_fusion!r}")

    depth, B, T, _ = fused.shape
    eye = torch.eye(T, dtype=fused.dtype, device=fused.device)
    aug = 0.5 * fused + 0.5 * eye
    aug = aug / aug.sum(dim=-1, keepdim=True)
    rollout = aug[0]
    for layer in range(1, depth):
        rollout = torch.matmul(aug[layer], rollout)
    cls_to_patches = rollout[:, 0, num_prefix_tokens:T - num_registers]
    denom = cls_to_patches.sum(dim=-1, keepdim=True)
    return cls_to_patches / denom.clamp_min(1e-12)


def rollout_heatmap(rollout_weights, grid_size: int):
    """(B, N) rollout weights -> (B, grid, grid) heatmap."""
    return rollout_weights.reshape(rollout_weights.shape[0], grid_size,
                                   grid_size)
