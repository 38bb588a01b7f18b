"""Resizing the positional table to fine-tune at another image size.

The counterpart of ``vitx/interop/pretrained.py::resize_pos_embed``
(lines 205-223): the prefix rows (CLS, and the distillation token where
there is one) pass through and the (g, g) grid of patch positions is
resized bilinearly to the new config's grid, the usual way to start a
fine-tune at 384² or 512² from a 224² checkpoint.

``jax.image.resize(..., "bilinear")`` antialiases when it shrinks a grid:
its triangle kernel widens by the scale. ``F.interpolate`` does the same
only with ``antialias=True`` (without it, a 24 -> 14 shrink lands up to
2.1 away from vitx's table); upsampling is plain bilinear with half-pixel
centres in both. The resize runs in fp32. ``resize_bilinear`` is the
same resize on NHWC images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vitx_torch.core.config import ViTConfig


def resize_bilinear(x, size) -> torch.Tensor:
    """(B, H, W, C) -> (B, size[0], size[1], C) as ``jax.image.resize(...,
    "bilinear")`` computes it (antialiased when shrinking), in ``x``'s
    dtype; the positional grid's resize and the eval images' share it."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def resize_pos_embed(params: dict, cfg_from: ViTConfig,
                     cfg_to: ViTConfig) -> dict:
    """A shallow copy of ``params`` whose (1, prefix + g_from², E)
    ``pos_embed`` (a tensor or an array) becomes (1, prefix + g_to², E),
    in the table's dtype and on its device."""
    pe = torch.as_tensor(params["pos_embed"])
    n_prefix = cfg_from.num_prefix_tokens
    g_from, g_to = cfg_from.grid_size, cfg_to.grid_size
    E = pe.shape[-1]
    grid = pe[:, n_prefix:].float().reshape(1, g_from, g_from, E)
    grid = resize_bilinear(grid, (g_to, g_to)).reshape(1, g_to * g_to, E)
    out = dict(params)
    out["pos_embed"] = torch.cat([pe[:, :n_prefix], grid.to(pe.dtype)],
                                 dim=1)
    return out
