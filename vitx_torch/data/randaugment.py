"""RandAugment and random erasing as torch ops on the device.

The counterpart of ``vitx/data/randaugment.py``. A layer of RandAugment
draws, per image, one of 14 ops, a magnitude ``N(M, 0.5)`` clipped to
[0, 10] and a sign (timm's ``rand-mM-nN`` scale), then applies it to the
whole batch at once: every geometric op (rotate, shear, translate) is a
2x3 affine, all warped in one batched bilinear pass, and every color op is
computed batch-wide and selected per image, so no step branches on the
data.

The warp is vitx's: the two-pass (Catmull-Smith) decomposition, each pass
a linear resample along one axis whose tent weights form a dense (W_in,
W_out) matrix per line, contracted by ``torch.matmul``
(``_line_resample``, ``_warp_mxu``). Out-of-range reads take the fill
value 0.5 with a one-pixel soft edge. It is a different interpolation
model from ``grid_sample``'s direct 2-D bilinear gather, which is why it
is not used here. Products run in fp32 (the package turns TF32 off).

Draws come from an explicit ``torch.Generator``; ``draw_layer`` makes
them and ``augment_layer(x, op, mag_signed)`` applies them, so a test can
inject vitx's draws. Inputs and outputs are float images in [0, 1], NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# op indices: 0..5 geometric, 6..13 color
OPS = ("identity", "rotate", "shear_x", "shear_y", "translate_x",
       "translate_y", "brightness", "saturation", "contrast", "sharpness",
       "posterize", "solarize", "autocontrast", "invert")
N_OPS = len(OPS)
FILL = 0.5
# the tent-weight block of one resample pass stays under this many bytes
_BLOCK_BYTES = 256 << 20


def affine_params(op, mag_signed, height: int, width: int):
    """(B, 2, 3) output->input affines about the image centre for ops
    ``op`` (B,) at signed magnitudes ``mag_signed`` (B,) in [-1, 1]:
    rotation +-30 deg, shear +-0.3, translation +-0.45 * size at full
    magnitude; the identity for the color ops
    (``vitx/data/randaugment.py:41-68``)."""
    theta = mag_signed * (30.0 * math.pi / 180.0)
    shear = mag_signed * 0.3
    tx = mag_signed * 0.45 * width
    ty = mag_signed * 0.45 * height
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)

    def mat(row_x, row_y):
        return torch.stack([torch.stack(row_x, -1), torch.stack(row_y, -1)],
                           -2)

    mats = torch.stack([
        mat([one, zero, zero], [zero, one, zero]),    # identity
        mat([c, -s, zero], [s, c, zero]),             # rotate
        mat([one, shear, zero], [zero, one, zero]),   # shear_x
        mat([one, zero, zero], [shear, one, zero]),   # shear_y
        mat([one, zero, tx], [zero, one, zero]),      # translate_x
        mat([one, zero, zero], [zero, one, ty]),      # translate_y
    ], 1)                                             # (B, 6, 2, 3)
    idx = torch.where(op < 6, op, torch.zeros_like(op)).long()
    return mats[torch.arange(len(op), device=op.device), idx]


def _line_resample(x, scale, off, fill: float = FILL):
    """Linear resample along axis 2 of ``x`` (B, L, W, C) by tent-weight
    products: output j of line (b, l) reads source position
    ``scale[b] * j + off[b, l]``; weights missing at the borders are made
    up with ``fill`` (``vitx/data/randaugment.py:91-128``)."""
    B, L, W, C = x.shape
    rb = L
    while rb > 1 and (L % rb or B * rb * W * W * 4 > _BLOCK_BYTES):
        rb -= 1
    cols = torch.arange(W, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    for r0 in range(0, L, rb):
        rows, o = x[:, r0:r0 + rb], off[:, r0:r0 + rb]
        pos = scale[:, None, None] * cols[None, None, :] + o[:, :, None]
        w = torch.clamp_min(1.0 - torch.abs(
            pos[:, :, None, :] - cols[None, None, :, None]), 0.0)
        res = torch.matmul(w.transpose(-1, -2), rows)     # (B, rb, W, C)
        wsum = w.sum(dim=2)                               # (B, rb, W_out)
        out[:, r0:r0 + rb] = res + (1.0 - wsum)[..., None] * fill
    return out


def warp(x, mats, fill: float = FILL):
    """Batched inverse-affine bilinear warp without gathers: pass 1
    resamples every input row along x, pass 2 every output column along y
    (``vitx/data/randaugment.py:131-161``). ``x`` (B, H, W, C), ``mats``
    (B, 2, 3) in ``affine_params``' convention; valid while |m11| is
    bounded away from 0, as it is for every RandAugment op."""
    B, H, W, C = x.shape
    a, b_, tx = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    c, d, ty = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    alpha = (a * d - b_ * c) / d
    beta = b_ / d
    gamma = tx - b_ * ty / d
    v = torch.arange(H, dtype=torch.float32, device=x.device)
    off1 = (beta[:, None] * (v[None, :] - cy) + gamma[:, None]
            + cx - alpha[:, None] * cx)
    tmp = _line_resample(x, alpha, off1, fill)
    u = torch.arange(W, dtype=torch.float32, device=x.device)
    off2 = (c[:, None] * (u[None, :] - cx) + ty[:, None]
            + cy - d[:, None] * cy)
    out_t = _line_resample(tmp.transpose(1, 2), d, off2, fill)
    return out_t.transpose(1, 2)


def _blend(a, b, factor):
    """PIL.ImageEnhance: factor 0 gives a, 1 gives b."""
    return a + factor * (b - a)


def color_ops(x, op, mag_signed):
    """The selected color op per image (``vitx/data/randaugment.py:
    169-212``): each candidate computed batch-wide, then selected by
    ``op`` (B,); ``mag_signed`` (B,) in [-1, 1]."""
    def sel(i):
        return (op == i)[:, None, None, None]

    factor = (1.0 + 0.9 * mag_signed)[:, None, None, None]
    mag = torch.abs(mag_signed)[:, None, None, None]
    out = x
    out = torch.where(sel(6), _blend(torch.zeros_like(x), x, factor), out)
    gray = x.mean(dim=-1, keepdim=True)
    out = torch.where(sel(7), _blend(gray, x, factor), out)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    out = torch.where(sel(8), _blend(mean, x, factor), out)
    # sharpness: blend with PIL's 3x3 SMOOTH kernel, zero-padded SAME
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0],
                           [1.0, 1.0, 1.0]], device=x.device) / 13.0
    B, H, W, C = x.shape
    planes = x.permute(0, 3, 1, 2).reshape(B * C, 1, H, W)
    blur = F.conv2d(planes, kernel[None, None], padding=1)
    blur = blur.reshape(B, C, H, W).permute(0, 2, 3, 1)
    out = torch.where(sel(9), _blend(blur, x, factor), out)
    # posterize: keep 8 - round(4 m) bits (round half to even, as jnp)
    levels = torch.exp2(torch.round(8.0 - 4.0 * mag))
    out = torch.where(sel(10),
                      torch.floor(x * (levels - 1.0) + 0.5) / (levels - 1.0),
                      out)
    out = torch.where(sel(11), torch.where(x >= 1.0 - mag, 1.0 - x, x), out)
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    stretched = (x - lo) / torch.clamp_min(hi - lo, 1e-6)
    out = torch.where(sel(12), torch.where(hi > lo, stretched, x), out)
    out = torch.where(sel(13), 1.0 - x, out)
    return out.clamp(0.0, 1.0)


def augment_layer(x, op, mag_signed):
    """One RandAugment layer with its draws given: the warp of the
    geometric ops, then the color ops."""
    _, H, W, _ = x.shape
    x = warp(x, affine_params(op, mag_signed, H, W))
    return color_ops(x, op, mag_signed)


def draw_layer(batch: int, gen: torch.Generator, magnitude: float,
               mag_std: float = 0.5):
    """One layer's draws on ``gen``'s device: (op (B,) int64 uniform over
    the 14 ops, mag_signed (B,) fp32)."""
    dev = gen.device
    op = torch.randint(0, N_OPS, (batch,), generator=gen, device=dev)
    mag = torch.clamp(magnitude + mag_std * torch.randn(
        batch, generator=gen, device=dev), 0.0, 10.0) / 10.0
    sign = torch.where(torch.rand(batch, generator=gen, device=dev) < 0.5,
                       1.0, -1.0)
    return op, mag * sign


def rand_augment(x, gen: torch.Generator, *, num_layers: int = 2,
                 magnitude: float = 9.0, mag_std: float = 0.5):
    """RandAugment on a (B, H, W, C) float [0, 1] batch
    (``vitx/data/randaugment.py:215-240``), draws from ``gen``."""
    for _ in range(num_layers):
        op, mag_signed = draw_layer(x.shape[0], gen, magnitude, mag_std)
        x = augment_layer(x, op, mag_signed)
    return x


def erase_rect(x, on, y0, x0, eh, ew, noise):
    """``noise`` where image b has ``on[b]`` and the pixel lies in the
    rectangle [y0, y0 + eh) x [x0, x0 + ew); ``x`` elsewhere."""
    _, H, W, _ = x.shape
    rows = torch.arange(H, dtype=torch.float32, device=x.device)[None, :,
                                                                  None]
    cols = torch.arange(W, dtype=torch.float32, device=x.device)[None, None,
                                                                  :]
    inside = ((rows >= y0[:, None, None])
              & (rows < (y0 + eh)[:, None, None])
              & (cols >= x0[:, None, None])
              & (cols < (x0 + ew)[:, None, None]))
    return torch.where((inside & on[:, None, None])[..., None], noise, x)


def random_erasing(x, gen: torch.Generator, *, prob: float = 0.25,
                   scale=(0.02, 0.33), ratio=(0.3, 3.3)):
    """Per-image random erasing, timm's pixel mode
    (``vitx/data/randaugment.py:243-267``): with probability ``prob`` a
    rectangle of area fraction in ``scale`` and aspect in ``ratio`` becomes
    unit-Gaussian noise. Applied after normalisation."""
    B, H, W, _ = x.shape
    dev = gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(B, generator=gen, device=dev)

    on = torch.rand(B, generator=gen, device=dev) < prob
    area = uniform(scale[0], scale[1]) * (H * W)
    aspect = torch.exp(uniform(math.log(ratio[0]), math.log(ratio[1])))
    eh = torch.clamp(torch.sqrt(area * aspect), 1.0, float(H))
    ew = torch.clamp(torch.sqrt(area / aspect), 1.0, float(W))
    y0 = torch.rand(B, generator=gen, device=dev) * (H - eh)
    x0 = torch.rand(B, generator=gen, device=dev) * (W - ew)
    noise = torch.randn(x.shape, generator=gen, device=dev, dtype=x.dtype)
    return erase_rect(x, on, y0, x0, eh, ew, noise)
