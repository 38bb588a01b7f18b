"""Class-specific saliency: Grad-CAM over the tokens entering the last
block.

The counterpart of ``vitx/nn/saliency.py``. The head reads only the CLS
token, so the gradient of a class logit with respect to the encoder's
output patches is zero; the last block's attention is what carries patch
evidence into CLS. So blocks 0..L-2 run without autograd, and the last
block (a Soft-MoE model's last MoE block) and the head run under it with respect to its input f: the
per-channel weights are the mean over the patches of d logit / d f, and
the heatmap is ReLU(sum over channels of weight * f). Cost: one forward
plus a one-block backward (on CUDA: K1, K2, and B2 and B3 in their
backwards).
"""

from __future__ import annotations

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.nn.vit import (_encoder_block, _final_norm, block_rope,
                               embed_tokens, encoder_layers, head_logits,
                               on_device, run_blocks)


def _class_index(class_idx, logits, cfg: ViTConfig):
    """(B,) class indices: each row's argmax for None, else ``class_idx``
    (an int or B of them) broadcast, validated against
    ``cfg.num_classes`` (``vitx/nn/saliency.py:95-109``)."""
    B = logits.shape[0]
    if class_idx is None:
        return logits.argmax(dim=-1)
    idx = np.asarray(class_idx.cpu() if torch.is_tensor(class_idx)
                     else class_idx)
    if not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"class_idx must be integer, got {idx.dtype}")
    if np.any(idx < 0) or np.any(idx >= cfg.num_classes):
        raise ValueError(f"class_idx {class_idx} out of range "
                         f"[0, {cfg.num_classes})")
    return torch.from_numpy(np.broadcast_to(idx, (B,)).astype(np.int64)).to(
        logits.device)


def grad_cam(params, images, cfg: ViTConfig, *, class_idx=None,
             device="cuda"):
    """Images (B, H, W, C) -> (heatmap (B, num_patches) fp32, logits
    (B, classes) fp32).

    ``class_idx``: an int, B ints, or None (each image's argmax class). The
    heatmap is non-negative, in patch-raster order (reshape to
    (grid, grid) to overlay). Devices as ``forward``.
    """
    params, images = on_device(params, images, device)
    layers = encoder_layers(params)
    with torch.no_grad():
        x0 = embed_tokens(params, images, cfg)
        f, _ = run_blocks(layers[:-1], x0, cfg)
    last = layers[-1]
    with torch.enable_grad():
        f = f.detach().requires_grad_()
        x, mlp_out, _ = _encoder_block(f, torch.zeros_like(f), last, cfg,
                                       rope=block_rope(cfg, f))
        logits = head_logits(params, _final_norm(params, x + mlp_out, cfg),
                             cfg)
        idx = _class_index(class_idx, logits.detach(), cfg)
        picked = logits.gather(1, idx[:, None]).sum()
        (grads,) = torch.autograd.grad(picked, f)
    s = 0 if cfg.parity == "bug_exact" else cfg.num_prefix_tokens
    g = grads[:, s:s + cfg.num_patches].float()
    fp = f.detach()[:, s:s + cfg.num_patches].float()
    weights = g.mean(dim=1, keepdim=True)
    cam = (weights * fp).sum(dim=-1).clamp_min(0.0)
    return cam, logits.detach()
