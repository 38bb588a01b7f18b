"""Multi-head self-attention, composed from plain torch operations.

The counterpart of ``vitx/nn/attention.py``. Dense models on a CUDA device
never come here: their attention half runs through the fused block kernel
(``vitx_torch.kernels.mha_block``). This composed path serves what that
kernel does not cover (a QKV bias, QK-Norm, a non-standard logit scale,
attention probabilities) and only on the CPU for now: on a CUDA device it
would stand in for the flash-attention kernel, which is not ported yet.

Scaling is ``1/sqrt(head_dim)`` unless ``scale`` overrides it.
"""

from __future__ import annotations

import torch

from vitx_torch.nn.layers import matmul32

FLASH_NOT_PORTED = (
    "the composed attention path needs the flash-attention kernel "
    "(vitx/kernels/flash_attention.py::_fwd_kernel, ROADMAP B5), which is "
    "not ported to CUDA yet; it runs on the CPU only")


def reference_attention(q, k, v, *, scale=None):
    """Plain attention over (B, H, T, D) q/k/v -> (B, H, T, D).

    fp32 logits and a max-subtracted softmax; the probabilities are cast to
    the compute dtype for the PV product (``vitx/nn/attention.py:22-43``).
    Attention probabilities as an output come with ROADMAP A9.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    probs = torch.softmax(matmul32(q, k.transpose(-1, -2)) * scale, dim=-1)
    return matmul32(probs.to(q.dtype), v).to(q.dtype)


def _qk_layer_norm(t, scale, eps):
    """Per-head LayerNorm over head_dim with a scale and no bias (QK-Norm).
    t: (B, H, T, D); scale: (H, D). fp32 statistics."""
    tf = t.float()
    mu = tf.mean(dim=-1, keepdim=True)
    var = (tf - mu).square().mean(dim=-1, keepdim=True)
    normed = (tf - mu) * torch.rsqrt(var + eps)
    return (normed * scale.float()[None, :, None, :]).to(t.dtype)


def multi_head_attention(x, wqkv, bqkv, wo, bo, *, num_heads: int,
                         scale: float | None = None, qk_scales=None,
                         qk_eps: float = 1e-5):
    """Composed multi-head self-attention over (B, T, E) tokens -> (B, T, E).

    wqkv: (E, 3, H, D); bqkv: (3, H, D) or None; wo: (E, E); bo: (E,) or
    None; ``qk_scales``: the (H, D) QK-Norm scales of q and k, or None.
    """
    if x.is_cuda:
        raise NotImplementedError(FLASH_NOT_PORTED)
    B, T, E = x.shape
    H = num_heads
    D = E // H
    w = wqkv.to(x.dtype)

    def proj(s):
        r = matmul32(x, w[:, s].reshape(E, H * D)).to(x.dtype)
        r = r.reshape(B, T, H, D).transpose(1, 2)            # (B, H, T, D)
        if bqkv is not None:
            r = r + bqkv[s].to(x.dtype)[None, :, None, :]
        return r

    q, k, v = proj(0), proj(1), proj(2)
    if qk_scales is not None:
        q = _qk_layer_norm(q, qk_scales[0], qk_eps)
        k = _qk_layer_norm(k, qk_scales[1], qk_eps)
    out = reference_attention(q, k, v, scale=scale)
    out = out.transpose(1, 2).reshape(B, T, E)
    out = matmul32(out, wo.to(x.dtype)).to(x.dtype)
    if bo is not None:
        out = out + bo.to(x.dtype)
    return out
