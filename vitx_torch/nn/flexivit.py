"""FlexiViT's pseudo-inverse resize of the patchify kernel (Beyer et al.
2023, "FlexiViT: One Model for All Patch Sizes").

The part of ``vitx/nn/flexivit.py`` (lines 30-66) that transfer
fine-tuning needs: a kernel trained at patch size ``p`` becomes one for
``p*`` as ``w* = pinv(Bᵀ) w``, where ``B`` is the bilinear patch resize
``p -> p*``. Upsampling (``p* >= p``) preserves every token on the
correspondingly resized input; downsampling is the least-squares optimum.
``B`` is built by resizing one-hot patches with ``resize_bilinear``, the
resize ``jax.image.resize(..., "bilinear")`` computes (antialiased when it
shrinks). ``resize_patch_embed`` runs a model at another patch size.
"""

from __future__ import annotations

import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.interop.pretrained import resize_bilinear, resize_pos_embed


def _resize_operator_t(old_p: int, new_p: int) -> torch.Tensor:
    """``Bᵀ``, shape (old_p², new_p²), fp32 on the CPU: row i is the
    flattened bilinear resize of the i-th one-hot old patch."""
    basis = torch.eye(old_p * old_p).reshape(old_p * old_p, old_p, old_p, 1)
    resized = resize_bilinear(basis, (new_p, new_p))
    return resized.reshape(old_p * old_p, new_p * new_p)


def pi_resize_patch_kernel(kernel, old_p: int, new_p: int,
                           channels: int) -> torch.Tensor:
    """PI-resize a patchify kernel (old_p·old_p·C, E) -> (new_p·new_p·C,
    E), in the kernel's dtype and on its device.

    The kernel flattens each patch as (P, P, C) row-major, so it reshapes
    to (P², C·E) with the spatial index leading, and one resize operator
    serves every (channel, embed) column."""
    kernel = torch.as_tensor(kernel)
    if old_p == new_p:
        return kernel
    if kernel.shape[0] != old_p * old_p * channels:
        raise ValueError(f"kernel rows {kernel.shape[0]} != old_p²·C = "
                         f"{old_p * old_p * channels}")
    E = kernel.shape[-1]
    w = kernel.detach().to("cpu", torch.float32).reshape(old_p * old_p,
                                                         channels * E)
    # solve Bᵀ w* = w (exact for new_p >= old_p, least squares below)
    w_new = torch.linalg.pinv(_resize_operator_t(old_p, new_p)) @ w
    return w_new.reshape(new_p * new_p * channels, E).to(
        device=kernel.device, dtype=kernel.dtype)


def resize_patch_embed(params: dict, cfg: ViTConfig, *, patch_size: int,
                       image_size: int | None = None):
    """Re-target a trained model to ``patch_size`` -> (params, cfg), the
    patchify kernel PI-resized (``vitx/nn/flexivit.py:68-110``).
    ``image_size=None`` scales the input with the patch, so the token grid
    stays (FlexiViT's protocol); an explicit ``image_size`` changes the
    grid, and a learned positional table is resized bilinearly to it
    (sincos2d and RoPE regenerate theirs from the new grid). The other
    leaves are shared with ``params``."""
    if cfg.stem != "patch":
        raise ValueError("resize_patch_embed needs stem='patch' (the conv "
                         "stem has no patchify kernel to PI-resize)")
    old_p = cfg.patch_size
    if image_size is None:
        image_size = cfg.image_size // old_p * patch_size
    new_cfg = cfg.replace(patch_size=patch_size, image_size=image_size)
    if new_cfg.grid_size != cfg.grid_size and cfg.parity == "bug_exact":
        raise ValueError(
            "bug_exact parity stores pos_embed as [patches..., CLS] "
            "(reference vit.py:41); only grid-preserving patch resizes are "
            "supported -- pass image_size = old_image_size * new_p / old_p")
    out = dict(params)
    out["patch_embed"] = dict(params["patch_embed"], kernel=
                              pi_resize_patch_kernel(
                                  params["patch_embed"]["kernel"], old_p,
                                  patch_size, cfg.num_channels))
    if new_cfg.grid_size != cfg.grid_size and cfg.pos_embed == "learned":
        out = resize_pos_embed(out, cfg, new_cfg)
    return out, new_cfg
