"""The Vision Transformer forward in PyTorch.

The counterpart of ``vitx/nn/vit.py``. Parameters are the same nested dict
as vitx's (``init_params``): block leaves stacked on a leading depth axis,
``wqkv`` as (E, 3, H, D), ``wo`` (E, E), fp32. Images are NHWC. The blocks
run as a Python loop; on a CUDA device each block's attention half is
kernel K1 (B7 when head-mean probabilities are asked for; B5 inside the
composed path; B8 in the ToMe encoder, ``vitx_torch/nn/tome.py``) and its
MLP half kernel K2 (``vitx_torch/kernels``).
A Soft-MoE block's MLP half is ``vitx_torch.nn.moe.soft_moe_mlp``; RoPE
and QK-Norm send the attention half to the composed path.
Everything else -- patch embedding (the conv stem: cuDNN's convolutions),
the positions, register tokens, residual adds, the heads (MAP pooling
among them), the rollout chain -- is plain torch, as it is XLA in vitx. ``model_logits`` is the
differentiable forward the train step runs (dropout and drop-path from an
explicit ``torch.Generator``); ``forward``, ``forward_features``,
``forward_with_attn`` and ``forward_with_rollout`` are inference, under
``torch.inference_mode``.
vitx's ``remat`` is activation checkpointing here: where autograd records
the blocks (training, gradients of the input), ``run_blocks`` checkpoints
each block as ``cfg.remat`` says -- "block" recomputes it whole, K1
included, "dots" keeps the 2-D products' outputs, "save_stash" keeps K1's
stash and recomputes the MLP half, "none" keeps everything -- with the
same dropout and drop-path masks on the recompute; ``scan_unroll`` is
accepted and ignored (there is no scan to unroll).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import card_routes, resolve_device
from vitx_torch.kernels.mha_block import (fused_mha_block,
                                          fused_mha_block_with_mean_probs)
from vitx_torch.kernels.mlp_block import fused_mlp_block
from vitx_torch.nn.attention import multi_head_attention
from vitx_torch.nn.lora import lora_spec, merge_block
from vitx_torch.nn.layers import (activation, add_layer_norm, dot,
                                  drop_path, dropout, einsum_cast,
                                  layer_norm, matmul32, mlp)
from vitx_torch.nn.moe import soft_moe_mlp

Params = dict


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def block_spec(cfg: ViTConfig, L: int) -> dict:
    """The leaves of ``L`` stacked dense blocks as (shape, init)
    (``vitx/nn/vit.py:44-97``)."""
    E, H, D, M = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.mlp_dim
    blocks = {
        "ln1_scale": ((L, E), 1.0), "ln1_bias": ((L, E), 0.0),
        "wqkv": ((L, E, 3, H, D), "normal"), "wo": ((L, E, E), "normal"),
        "ln2_scale": ((L, E), 1.0), "ln2_bias": ((L, E), 0.0),
        "w1": ((L, E, M), "normal"), "b1": ((L, M), 0.0),
        "w2": ((L, M, E), "normal"), "b2": ((L, E), 0.0),
    }
    if cfg.mlp_act == "swiglu":
        blocks["w3"] = ((L, E, M), "normal")
        blocks["b3"] = ((L, M), 0.0)
    if cfg.qkv_bias:
        blocks["bqkv"] = ((L, 3, H, D), 0.0)
    if cfg.qk_norm:
        blocks["lnq_scale"] = ((L, H, D), 1.0)
        blocks["lnk_scale"] = ((L, H, D), 1.0)
    if cfg.proj_bias:
        blocks["bo"] = ((L, E), 0.0)
    if cfg.layerscale_init:
        blocks["ls1"] = ((L, E), cfg.layerscale_init)
        blocks["ls2"] = ((L, E), cfg.layerscale_init)
    return blocks


def moe_block_spec(cfg: ViTConfig) -> dict:
    """The trailing Soft-MoE blocks (``vitx/nn/moe.py:44-66``): a dense
    block's attention and LayerNorm leaves, the router ``phi`` (k, E, n,
    s) and ``router_scale`` (k,) and the experts' ``ew1/eb1/ew2/eb2`` in
    place of ``w1/b1/w2/b2``."""
    k, n, s = cfg.moe_block_count, cfg.moe_experts, cfg.moe_slot_count
    E, M = cfg.embed_dim, cfg.mlp_dim
    blocks = block_spec(cfg, k)
    for name in ("w1", "b1", "w2", "b2"):
        del blocks[name]
    blocks.update({
        "phi": ((k, E, n, s), "normal"), "router_scale": ((k,), 1.0),
        "ew1": ((k, n, E, M), "normal"), "eb1": ((k, n, M), 0.0),
        "ew2": ((k, n, M, E), "normal"), "eb2": ((k, n, E), 0.0)})
    return blocks


def stem_spec(cfg: ViTConfig) -> dict:
    """``patch_embed``: the patchify kernel (P*P*C, E), or the conv stem's
    log2(P) 3x3 stride-2 convolutions, widths doubling up to E, and a 1x1
    projection, kernels in HWIO (``vitx/nn/vit.py:110-132``)."""
    E, P, C = cfg.embed_dim, cfg.patch_size, cfg.num_channels
    if cfg.stem != "conv":
        return {"kernel": ((P * P * C, E), "normal"), "bias": ((E,), 0.0)}
    n = P.bit_length() - 1
    stem, in_ch = {}, C
    for i in range(n):
        w = max(E >> (n - 1 - i), 8)
        stem[f"conv{i}"] = {"kernel": ((3, 3, in_ch, w), "normal"),
                            "bias": ((w,), 0.0)}
        in_ch = w
    stem["proj"] = {"kernel": ((1, 1, in_ch, E), "normal"),
                    "bias": ((E,), 0.0)}
    return stem


def head_spec(cfg: ViTConfig) -> dict:
    """The classifier head: the reference's Linear -> GELU -> LN -> Linear,
    the MAP head (probe attention, its MLP residual, then LN -> Linear) or
    the standard LN -> Linear (``vitx/nn/vit.py:179-222``)."""
    E, K = cfg.embed_dim, cfg.num_classes
    if cfg.head_type == "reference":
        return {"w1": ((E, 4 * E), "normal"), "b1": ((4 * E,), 0.0),
                "ln_scale": ((4 * E,), 1.0), "ln_bias": ((4 * E,), 0.0),
                "w2": ((4 * E, K), "normal"), "b2": ((K,), 0.0)}
    head = {}
    if cfg.head_type == "map":
        M = cfg.mlp_dim
        head = {"in_ln_scale": ((E,), 1.0), "in_ln_bias": ((E,), 0.0),
                "probe": ((1, 1, E), "normal"),
                "wq": ((E, E), "normal"), "wk": ((E, E), "normal"),
                "wv": ((E, E), "normal"), "wo_p": ((E, E), "normal"),
                "bo_p": ((E,), 0.0),
                "mlp_ln_scale": ((E,), 1.0), "mlp_ln_bias": ((E,), 0.0),
                "mw1": ((E, M), "normal"), "mb1": ((M,), 0.0),
                "mw2": ((M, E), "normal"), "mb2": ((E,), 0.0)}
    head.update({"ln_scale": ((E,), 1.0), "ln_bias": ((E,), 0.0),
                 "w": ((E, K), 0.0), "b": ((K,), 0.0)})
    return head


def param_spec(cfg: ViTConfig) -> dict:
    """The parameter tree of ``cfg`` as nested dicts of (shape, init) leaves,
    where init is "normal" (trunc-normal, ``cfg.init_std``) or a constant.
    The same tree and shapes as ``vitx/nn/vit.py:100-223``: no
    ``pos_embed`` leaf for the sincos2d and RoPE positions, which are
    functions of the grid; a Soft-MoE model's dense blocks (the first
    ``cfg.dense_block_count``) under ``blocks`` and its MoE blocks under
    ``moe_blocks``."""
    E = cfg.embed_dim
    spec = {"patch_embed": stem_spec(cfg), "cls_token": ((1, 1, E), "normal")}
    if cfg.pos_embed == "learned":
        spec["pos_embed"] = ((1, cfg.pos_len, E), "normal")
    if cfg.num_registers:
        spec["reg_tokens"] = ((1, cfg.num_registers, E), "normal")
    if cfg.distill_token:
        # DeiT: a second learned token (position 1) with its own standard
        # head, trained against the teacher, averaged with CLS at eval
        spec["dist_token"] = ((1, 1, E), "normal")
        spec["dist_head"] = {
            "ln_scale": ((E,), 1.0), "ln_bias": ((E,), 0.0),
            "w": ((E, cfg.num_classes), 0.0), "b": ((cfg.num_classes,), 0.0),
        }
    spec["blocks"] = {**block_spec(cfg, cfg.dense_block_count),
                      **lora_spec(cfg)}
    if cfg.moe_experts:
        spec["moe_blocks"] = moe_block_spec(cfg)
    if cfg.final_norm:
        spec["final_norm"] = {"scale": ((E,), 1.0), "bias": ((E,), 0.0)}
    spec["head"] = head_spec(cfg)
    return spec


def init_leaf(shape, init, cfg: ViTConfig, gen: torch.Generator):
    """One parameter leaf on the CPU in ``cfg.param_dtype``."""
    t = torch.empty(shape, dtype=torch.float32)
    if init == "normal":
        std = cfg.init_std
        torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                    generator=gen)
    else:
        t.fill_(init)
    return t.to(cfg.pdtype())


def init_params(rng, cfg: ViTConfig, *, device="cuda") -> Params:
    """Fresh parameters: trunc-normal (``cfg.init_std``, cut at 2 std)
    weights, zero biases, unit LN scales. ``rng`` is a ``torch.Generator``
    or an int seed; the values are drawn on the CPU, so a seed gives the
    same parameters on every device (but not vitx's: JAX's generator
    differs)."""
    dev = resolve_device(device)
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        shape, init = node
        return init_leaf(shape, init, cfg, gen).to(dev)

    return build(param_spec(cfg))


def params_to(params: Params, device) -> Params:
    """The parameter tree on ``device`` (leaves already there are kept)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(x, w, stride: int):
    """NCHW ``x`` convolved with HWIO ``w`` under XLA's "SAME" padding
    (the extra row and column after, never before: at stride 2 on an even
    size, (0, 1)), accumulated in fp32 and cast once to x's dtype (cuDNN
    accumulates bf16 in fp32; fp32 operands on the CPU)."""
    k = w.shape[0]
    pads = []
    for size in x.shape[:1:-1]:                # W, then H (F.pad's order)
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    wt = w.permute(3, 2, 0, 1)                 # HWIO -> OIHW
    xp = torch.nn.functional.pad(x, pads)
    if x.is_cuda:
        return torch.nn.functional.conv2d(xp, wt.to(x.dtype), stride=stride)
    return torch.nn.functional.conv2d(xp.float(), wt.float(),
                                      stride=stride).to(x.dtype)


def _conv_stem(params: Params, images, cfg: ViTConfig):
    """The conv stem (``cfg.stem="conv"``, ``vitx/nn/vit.py:234-259``):
    log2(P) 3x3 stride-2 convolutions, each rounded to the compute dtype,
    its bias added there and vitx's default (tanh) GELU applied, then a
    1x1 projection and its bias -> (B, N, E) tokens in raster order.
    cuDNN's convolutions on a card, as XLA's in vitx."""
    cdt = cfg.cdtype()
    pe = params["patch_embed"]
    x = images.to(cdt).permute(0, 3, 1, 2)     # NHWC -> NCHW
    for i in range(cfg.patch_size.bit_length() - 1):
        p = pe[f"conv{i}"]
        x = _conv(x, p["kernel"], 2) + p["bias"].to(cdt)[:, None, None]
        x = activation(x, "gelu_tanh")
    x = _conv(x, pe["proj"]["kernel"], 1) + pe["proj"]["bias"].to(cdt)[
        :, None, None]
    B = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(B, cfg.num_patches, cfg.embed_dim)


def patch_embed(params: Params, images, cfg: ViTConfig):
    """(B, H, W, C) images -> (B, N, E) patch tokens: space-to-depth with
    rows ordered (P, P, C), then one matmul (``vitx/nn/vit.py:262-284``),
    or the conv stem."""
    if cfg.stem == "conv":
        return _conv_stem(params, images, cfg)
    B = images.shape[0]
    P, g, C = cfg.patch_size, cfg.grid_size, cfg.num_channels
    x = images.to(cfg.cdtype())
    x = x.reshape(B, g, P, g, P, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, g * g, P * P * C)
    pe = params["patch_embed"]
    return dot(x, pe["kernel"].to(x.dtype)) + pe["bias"].to(x.dtype)


def _join_cls(params: Params, tokens, cfg: ViTConfig, B: int):
    """Prepend the CLS token, and after it the distillation token where
    the config has one; ``parity="bug_exact"`` appends the CLS, honouring
    a per-batch-slot CLS (``vitx/nn/vit.py:555-583``)."""
    cls_p = params["cls_token"].to(cfg.cdtype())
    E = cfg.embed_dim
    if cfg.parity == "bug_exact":
        if cls_p.shape[0] == 1:
            cls = cls_p.expand(B, 1, E)
        elif cls_p.shape[0] == B:
            cls = cls_p
        else:
            raise ValueError(
                f"bug_exact parity: checkpoint carries {cls_p.shape[0]} "
                f"per-slot CLS tokens but the batch has {B} rows")
        return torch.cat([tokens, cls], dim=1)
    prefix = [cls_p.expand(B, 1, E)]
    if cfg.distill_token:
        prefix.append(params["dist_token"].to(cls_p.dtype).expand(B, 1, E))
    return torch.cat([*prefix, tokens], dim=1)


def sincos_pos_embed(cfg: ViTConfig, device=None):
    """The fixed 2-D sine-cosine table of ``pos_embed="sincos2d"`` (MAE):
    (1, pos_len, E) fp32, the prefix rows zero; E/2 dims encode the
    patch's row, E/2 its column, each half [sin, cos] over E/4
    frequencies 1/10000^(4i/E) (``vitx/nn/vit.py:586-606``)."""
    E = cfg.embed_dim
    q = E // 4
    omega = 1.0 / (10000.0 ** (torch.arange(q, dtype=torch.float32,
                                            device=device) / q))
    g = cfg.grid_size
    pos = torch.arange(g, dtype=torch.float32, device=device)
    a = pos[:, None] * omega[None, :]
    axis = torch.cat([torch.sin(a), torch.cos(a)], -1)     # (g, E/2)
    table = torch.cat([axis.repeat_interleave(g, dim=0), axis.repeat(g, 1)],
                      -1)
    prefix = torch.zeros((cfg.num_prefix_tokens, E), device=device)
    return torch.cat([prefix, table], 0)[None]


def rope_tables(cfg: ViTConfig, dtype=torch.float32, device=None):
    """(cos, sin), each (seq_len, head_dim), of 2-D axial RoPE
    (``pos_embed="rope"``; EVA-02, Heo et al. 2024): D/2 angles a token,
    the first quarter's frequencies rope_base^(-4i/D) scaled by the
    patch's row, the second's by its column, duplicated for the
    rotate-half pairs (i, i + D/2); prefix and register tokens get zero
    angles (``vitx/nn/vit.py:609-632``)."""
    D = cfg.head_dim
    q = D // 4
    freqs = cfg.rope_base ** (-torch.arange(q, dtype=torch.float32,
                                            device=device) / q)
    g = cfg.grid_size
    a = torch.arange(g, dtype=torch.float32, device=device)[:, None] * \
        freqs[None, :]                                      # (g, D/4)
    half = torch.cat([a.repeat_interleave(g, dim=0), a.repeat(g, 1)], -1)
    ang = torch.cat([torch.zeros((cfg.num_prefix_tokens, D // 2),
                                 device=device), half,
                     torch.zeros((cfg.num_registers, D // 2),
                                 device=device)], 0)
    ang = torch.cat([ang, ang], -1)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def block_rope(cfg: ViTConfig, x):
    """The (cos, sin) tables every block of a forward over tokens x shares
    under ``pos_embed="rope"``, else None."""
    if cfg.pos_embed != "rope":
        return None
    return rope_tables(cfg, x.dtype, x.device)


def add_pos_embed(params: Params, x, cfg: ViTConfig):
    """Add the positions to the prefix and patch tokens: the learned
    table, the fixed sincos2d table, or nothing for RoPE, which rotates q
    and k in every attention instead (``vitx/nn/vit.py:643-651``)."""
    if cfg.pos_embed == "rope":
        return x
    if cfg.pos_embed == "sincos2d":
        return x + sincos_pos_embed(cfg, x.device).to(x.dtype)
    return x + params["pos_embed"].to(x.dtype)


def _append_registers(params: Params, x, cfg: ViTConfig):
    """The register tokens (Darcet et al. 2023) after the patches, past the
    positional add, so they carry no position (``vitx/nn/vit.py:654-662``)."""
    if not cfg.num_registers:
        return x
    reg = params["reg_tokens"].to(x.dtype).expand(
        x.shape[0], cfg.num_registers, cfg.embed_dim)
    return torch.cat([x, reg], dim=1)


def embed_tokens(params: Params, images, cfg: ViTConfig):
    """Images -> the token sequence the first block reads: [prefix |
    patches | registers]."""
    tokens = patch_embed(params, images, cfg)
    x = _join_cls(params, tokens, cfg, tokens.shape[0])
    return _append_registers(params, add_pos_embed(params, x, cfg), cfg)


def _patch_drop(x, cfg: ViTConfig, gen=None, noise=None):
    """Patch dropout (FLIP; ``vitx/nn/vit.py:665-685``): each row keeps
    ``cfg.patch_keep_count`` of its patch tokens, the first of a per-row
    stable argsort of uniform noise, put back in ascending order so that
    the tokens stay in their positional order. Prefix and register tokens
    pass through. ``noise`` (B, num_patches) replaces the draw from
    ``gen``, so that a test can feed vitx's."""
    p, n = cfg.num_prefix_tokens, cfg.num_patches
    if noise is None:
        noise = torch.rand((x.shape[0], n), generator=gen, device=x.device)
    idx = torch.argsort(noise, dim=1, stable=True)[:, :cfg.patch_keep_count]
    idx = torch.sort(idx, dim=1).values
    kept = x[:, p:p + n].gather(1, idx[..., None].expand(-1, -1, x.shape[2]))
    return torch.cat([x[:, :p], kept, x[:, p + n:]], dim=1)


def _use_fused_mha(cfg: ViTConfig, bp, x,
                   return_probs: bool = False) -> bool:
    """vitx's rule (``vitx/nn/vit.py:287-304``) with "is this a TPU" read
    as ``card_routes``: "are the tensors on a CUDA device, or is an export
    tracing the card's program"."""
    if cfg.parity == "bug_exact":
        return False
    if return_probs or "bqkv" in bp or cfg.fuse_mha == "off":
        return False
    if cfg.qk_norm or cfg.pos_embed == "rope":
        return False
    if cfg.fuse_mha == "on":
        return True
    return cfg.attn_impl in ("auto", "flash") and card_routes(x)


def _use_fused_mlp(cfg: ViTConfig, x) -> bool:
    """vitx's rule (``vitx/nn/vit.py:307-316``), ``card_routes`` in place
    of TPU."""
    if cfg.mlp_act == "swiglu" or cfg.fuse_mlp == "off":
        return False
    if cfg.fuse_mlp == "on":
        return True
    return cfg.attn_impl in ("auto", "flash") and card_routes(x)


def _encoder_block(x, pending, bp, cfg: ViTConfig, *, rng=None,
                   deterministic: bool = True, dp_rate: float = 0.0,
                   return_probs: bool = False, probs_mode: str = "full",
                   rope=None):
    """Pre-LN block: x + MHA(LN1(x)); x + MLP(LN2(x)). The previous block's
    MLP output arrives as ``pending`` and the block returns its own as the
    new pending (``vitx/nn/vit.py:319-436``). Dropout, then drop-path at
    this block's ``dp_rate``, on both branches when training. LoRA
    adapters fold into the dense weights first (``merge_block``), so every
    route below sees dense weights. Returns
    (x, pending, probs): probs (B, H, T, T) fp32, their head mean (B, T, T)
    for ``probs_mode="mean"``, or None without ``return_probs``.

    Head-mean probabilities on the fused path go to B7 on CUDA for every
    shape K1 takes, where vitx sends them to ``_kernel_hchunk`` or, past
    its VMEM limits, to its composed fallback (vit.py:348-377) -- the same
    function; on the CPU, as in vitx's interpret mode, they take the
    composed path. A Soft-MoE block (``"phi" in bp``) runs the same
    attention half and ``soft_moe_mlp`` for its MLP half. ``rope`` is
    ``block_rope``'s tables for the forward."""
    if cfg.lora_rank:
        bp = merge_block(bp, cfg)
    x, attn_out, probs = _attention_half(
        x, pending, bp, cfg, return_probs=return_probs,
        probs_mode=probs_mode, rope=rope)
    x, mlp_out = _mlp_half(x, attn_out, bp, cfg, rng=rng,
                           deterministic=deterministic, dp_rate=dp_rate)
    return x, mlp_out, probs


def _attention_half(x, pending, bp, cfg: ViTConfig, *,
                    return_probs: bool = False, probs_mode: str = "full",
                    rope=None):
    """The block's attention half -> (x + pending, attn_out, probs): K1
    (B7 for head-mean probabilities), or LN1 and the composed attention;
    ``bp`` has its LoRA adapters folded in. It draws nothing: dropout and
    drop-path on ``attn_out`` are the MLP half's first steps."""
    dt = x.dtype
    fused_mean_probs = (return_probs and probs_mode == "mean" and x.is_cuda
                        and _use_fused_mha(cfg, bp, x))
    probs = None
    if _use_fused_mha(cfg, bp, x, return_probs) or fused_mean_probs:
        x = x + pending
        bo = bp.get("bo")
        if bo is None:
            bo = torch.zeros(cfg.embed_dim, dtype=torch.float32,
                             device=x.device)
        args = (x, bp["wqkv"].to(dt), bp["wo"].to(dt), bo.float(),
                bp["ln1_scale"].float(), bp["ln1_bias"].float())
        if fused_mean_probs:
            attn_out, probs = fused_mha_block_with_mean_probs(
                *args, eps=cfg.layer_norm_eps)
        else:
            attn_out = fused_mha_block(*args, eps=cfg.layer_norm_eps)
    else:   # composed: B5 or the reference attention inside
        x, h = add_layer_norm(x, pending, bp["ln1_scale"], bp["ln1_bias"],
                              eps=cfg.layer_norm_eps)
        attn_out, probs = multi_head_attention(
            h, bp["wqkv"], bp.get("bqkv"), bp["wo"], bp.get("bo"),
            num_heads=cfg.num_heads, impl=cfg.attn_impl,
            return_probs=return_probs, probs_mode=probs_mode,
            scale=(float(cfg.head_dim) ** 0.5
                   if cfg.parity == "bug_exact" else None),
            qk_scales=((bp["lnq_scale"], bp["lnk_scale"])
                       if cfg.qk_norm else None),
            qk_eps=cfg.layer_norm_eps,
            rope=rope)
    return x, attn_out, probs


def _mlp_half(x, attn_out, bp, cfg: ViTConfig, *, rng=None,
              deterministic: bool = True, dp_rate: float = 0.0):
    """The rest of the block -> (x + attn_out, mlp_out): LayerScale,
    dropout and drop-path on the attention's output, then LN2 and the MLP
    (K2, a Soft-MoE mixture or the composed products) and the same on
    its output."""
    dt = x.dtype
    if "ls1" in bp:
        attn_out = attn_out * bp["ls1"].to(dt)
    attn_out = dropout(attn_out, cfg.dropout, rng,
                       deterministic=deterministic)
    if cfg.drop_path:
        attn_out = drop_path(attn_out, dp_rate, rng,
                             deterministic=deterministic)

    if "phi" in bp:
        # a Soft-MoE block: the expert mixture in place of the dense MLP
        # (and of K2), after the plain add-LayerNorm
        x, h = add_layer_norm(x, attn_out, bp["ln2_scale"], bp["ln2_bias"],
                              eps=cfg.layer_norm_eps)
        mlp_out = soft_moe_mlp(h, bp, cfg)
    elif _use_fused_mlp(cfg, x):
        x = x + attn_out
        mlp_out = fused_mlp_block(
            x, bp["w1"].to(dt), bp["b1"].float(), bp["w2"].to(dt),
            bp["b2"].float(), bp["ln2_scale"].float(),
            bp["ln2_bias"].float(), act=cfg.mlp_act, eps=cfg.layer_norm_eps)
    else:
        x, h = add_layer_norm(x, attn_out, bp["ln2_scale"], bp["ln2_bias"],
                              eps=cfg.layer_norm_eps)
        mlp_out = mlp(h, bp["w1"], bp["b1"], bp["w2"], bp["b2"],
                      act=cfg.mlp_act, w3=bp.get("w3"), b3=bp.get("b3"))
    if "ls2" in bp:
        mlp_out = mlp_out * bp["ls2"].to(dt)
    mlp_out = dropout(mlp_out, cfg.dropout, rng, deterministic=deterministic)
    if cfg.drop_path:
        mlp_out = drop_path(mlp_out, dp_rate, rng,
                            deterministic=deterministic)
    return x, mlp_out


def unstack(blocks: Params):
    """The stacked block leaves -> one parameter dict per block. Each
    stacked leaf is unbound once, so its gradient is one stack."""
    layers = {k: v.unbind(0) for k, v in blocks.items()}
    depth = len(next(iter(layers.values())))
    return [{k: v[i] for k, v in layers.items()} for i in range(depth)]


def encoder_layers(params: Params) -> list:
    """One parameter dict per encoder block, in order: the dense blocks,
    then a Soft-MoE model's MoE blocks."""
    layers = unstack(params["blocks"])
    if "moe_blocks" in params:
        layers += unstack(params["moe_blocks"])
    return layers


def drop_path_rates(cfg: ViTConfig, n: int, deterministic: bool) -> list:
    """The blocks' drop-path rates, rising linearly from 0 to
    ``cfg.drop_path`` (fp32, as vitx's ``jnp.linspace``); all 0 when
    deterministic, where none is drawn (and an export traces no
    data-dependent value)."""
    if deterministic or not cfg.drop_path:
        return [0.0] * n
    return torch.linspace(0.0, cfg.drop_path, n).tolist()


class _Replay:
    """``fn`` for ``torch.utils.checkpoint``: its first call draws from
    ``rng`` as an unwrapped call would; a re-run (the backward's
    recompute) first sets ``rng`` back to the state the first call
    started from, so dropout and drop-path draw the same masks, then puts
    the stream back where it was, so nothing after it draws twice.
    Checkpointing restores the default generators, never an explicit one."""

    def __init__(self, fn, rng):
        self.fn, self.rng, self.ran = fn, rng, False
        self.start = None if rng is None else rng.get_state()

    def __call__(self, *args):
        if not self.ran or self.rng is None:
            self.ran = True
            return self.fn(*args)
        now = self.rng.get_state()
        self.rng.set_state(self.start)
        try:
            return self.fn(*args)
        finally:
            self.rng.set_state(now)


# vitx's "dots" policy (jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable) as torch's selective checkpointing: the
# outputs of the 2-D products -- the projections and the MLP's -- are
# kept; the attention's batched products and K1, whose products no policy
# sees, are recomputed, as in vitx.
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_mode(cfg: ViTConfig, x, layers: list) -> str:
    """The remat policy ``run_blocks`` applies: ``cfg.remat`` where autograd
    records the blocks (grad enabled, and x or a block leaf requiring
    grad), else "none": inference, ``torch.no_grad`` and exports never
    checkpoint."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return "none"
    if x.requires_grad or any(t.requires_grad for bp in layers
                              for t in bp.values()):
        return cfg.remat
    return "none"


def _checkpointed_block(mode: str, x, pending, bp, cfg: ViTConfig, *,
                        rng=None, deterministic: bool = True,
                        dp_rate: float = 0.0, return_probs: bool = False,
                        probs_mode: str = "full", rope=None):
    """``_encoder_block`` under activation checkpointing
    (``torch.utils.checkpoint``, non-reentrant), vitx's ``remat`` policies
    (``vitx/nn/vit.py:494-515``): "block" recomputes the whole block in
    the backward, K1 included (vitx's remat of a ``custom_vjp`` re-runs
    its forward rule); "dots" keeps the 2-D products' outputs
    (``_dots_policy``) and recomputes the rest, K1 included; "save_stash"
    keeps K1's stash (its output and q, k, v, o_all, vitx's saved names,
    with the attention's statistics) by running K1 outside the
    checkpointed region, which recomputes the MLP half -- a block off the
    fused route saves no stash and recomputes whole, as vitx's names save
    nothing there."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if (mode == "save_stash" and not return_probs
            and _use_fused_mha(cfg, bp, x)):
        if cfg.lora_rank:
            bp = merge_block(bp, cfg)
        x, attn_out, _ = _attention_half(x, pending, bp, cfg)
        half = functools.partial(_mlp_half, bp=bp, cfg=cfg, rng=rng,
                                 deterministic=deterministic,
                                 dp_rate=dp_rate)
        x, mlp_out = checkpoint(_Replay(half, rng), x, attn_out, **kw)
        return x, mlp_out, None
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    block = functools.partial(
        _encoder_block, bp=bp, cfg=cfg, rng=rng, deterministic=deterministic,
        dp_rate=dp_rate, return_probs=return_probs, probs_mode=probs_mode,
        rope=rope)
    return checkpoint(_Replay(block, rng), x, pending, **kw)


def run_blocks(layers: list, x, cfg: ViTConfig, *, rng=None,
               deterministic: bool = True, return_probs: bool = False,
               probs_mode: str = "full"):
    """Run the blocks ``layers`` (``encoder_layers``) over tokens x (B, T,
    E): a Python loop in place of vitx's ``lax.scan``; returns (x +
    pending, probs stacked over the blocks or None) (``vitx/nn/vit.py:
    439-552``). Drop-path rates rise linearly from 0 at the first block to
    ``cfg.drop_path`` at the last, over the dense and MoE blocks alike
    (vit.py:537). vitx scans a MoE model's two stacks apart and hands the
    second ``(x + pending, 0)``: the next block reads only that sum, which
    is the one the carry forms here, so the loop is the same function.
    Where autograd records the blocks, each runs under ``cfg.remat``'s
    activation checkpointing (``remat_mode``, ``_checkpointed_block``):
    the same values, less memory, more compute."""
    rates = drop_path_rates(cfg, len(layers), deterministic)
    pending = torch.zeros_like(x)
    rope = block_rope(cfg, x)
    mode = remat_mode(cfg, x, layers)
    run = (_encoder_block if mode == "none" else
           functools.partial(_checkpointed_block, mode))
    probs = []
    for bp, rate in zip(layers, rates):
        x, pending, p = run(
            x, pending, bp, cfg, rng=rng, deterministic=deterministic,
            dp_rate=rate, return_probs=return_probs, probs_mode=probs_mode,
            rope=rope)
        probs.append(p)
    return x + pending, (torch.stack(probs) if return_probs else None)


def _final_norm(params: Params, x, cfg: ViTConfig):
    if cfg.final_norm:
        fn = params["final_norm"]
        x = layer_norm(x, fn["scale"], fn["bias"], eps=cfg.layer_norm_eps)
    return x


def encode(params: Params, images, cfg: ViTConfig, *, rng=None,
           deterministic: bool = True, return_probs: bool = False,
           probs_mode: str = "full"):
    """Images -> encoder output tokens (B, T, E). With a generator, patch
    dropout (``cfg.patch_drop``, when not deterministic), then dropout on
    the embedded tokens and in every block (``vitx/nn/vit.py:699-722``).
    With ``return_probs``, (tokens, per-block probs): (depth, B, H, T, T)
    fp32, or (depth, B, T, T) for ``probs_mode="mean"``.
    """
    x = embed_tokens(params, images, cfg)
    if rng is not None:
        if cfg.patch_drop and not deterministic:
            x = _patch_drop(x, cfg, rng)
        x = dropout(x, cfg.dropout, rng, deterministic=deterministic)
    x, probs = run_blocks(encoder_layers(params), x, cfg, rng=rng,
                          deterministic=deterministic,
                          return_probs=return_probs, probs_mode=probs_mode)
    x = _final_norm(params, x, cfg)
    return (x, probs) if return_probs else x


def _map_pool(hp: Params, x, cfg: ViTConfig):
    """MAP pooling (Zhai et al. 2022; ``vitx/nn/vit.py:725-764``): the
    tokens without the registers through the head's input LayerNorm, a
    learned probe's single-query attention over them (fp32 logits and
    softmax), the output projection and its bias, then a pre-LN MLP
    residual with the erf GELU. (B, T, E) -> (B, E) in x's dtype."""
    H, D, E = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    dt = x.dtype
    if cfg.num_registers:
        # contiguous: the LayerNorm's backward (B3) reads it
        x = x[:, :x.shape[1] - cfg.num_registers].contiguous()
    x = layer_norm(x, hp["in_ln_scale"], hp["in_ln_bias"],
                   eps=cfg.layer_norm_eps)
    q = dot(hp["probe"][0].to(dt), hp["wq"].to(dt)).reshape(H, D)
    k = einsum_cast("bte,ehd->bhtd", x, hp["wk"].to(dt).reshape(E, H, D))
    v = einsum_cast("bte,ehd->bhtd", x, hp["wv"].to(dt).reshape(E, H, D))
    logits = torch.einsum("hd,bhtd->bht", q.float(), k.float())
    probs = torch.softmax(logits * (1.0 / D ** 0.5), dim=-1)
    pooled = einsum_cast("bht,bhtd->bhd", probs.to(dt), v)
    a = einsum_cast("bhd,hde->be", pooled, hp["wo_p"].to(dt).reshape(H, D, E))
    a = a + hp["bo_p"].to(dt)
    h = layer_norm(a, hp["mlp_ln_scale"], hp["mlp_ln_bias"],
                   eps=cfg.layer_norm_eps)
    return a + mlp(h, hp["mw1"], hp["mb1"], hp["mw2"], hp["mb2"], act="gelu")


def _head_input(params: Params, x, cfg: ViTConfig):
    """The (B, E) vector the head reads (``vitx/nn/vit.py:767-777``): the
    MAP pooling, the mean of the patch tokens (``global_pool="gap"``: the
    tokens between the prefix and the registers, merged ones too), or
    token 0."""
    if cfg.head_type == "map":
        return _map_pool(params["head"], x, cfg)
    if cfg.global_pool == "gap":
        s = cfg.num_prefix_tokens
        return x[:, s:x.shape[1] - cfg.num_registers, :].mean(dim=1)
    return x[:, 0, :]


def classify(params: Params, x, cfg: ViTConfig):
    """Encoder tokens (B, T, E) -> fp32 logits (B, classes): ``_head_input``
    through the reference head (Linear -> erf GELU -> LayerNorm(4E) ->
    Linear) or LN -> Linear (the standard and MAP heads), as at
    ``vitx/nn/vit.py:780-807``."""
    cls = _head_input(params, x, cfg)
    hp = params["head"]
    if cfg.head_type == "reference":
        h = dot(cls, hp["w1"].to(cls.dtype)) + hp["b1"].to(cls.dtype)
        h = activation(h, "gelu")   # the head's GELU is erf in every config
        h = layer_norm(h, hp["ln_scale"], hp["ln_bias"],
                       eps=cfg.layer_norm_eps)
        logits = matmul32(h, hp["w2"].to(h.dtype)) + hp["b2"].float()
    else:
        h = layer_norm(cls, hp["ln_scale"], hp["ln_bias"],
                       eps=cfg.layer_norm_eps)
        logits = matmul32(h, hp["w"].to(h.dtype)) + hp["b"].float()
    return logits.float()


def classify_dist(params: Params, x, cfg: ViTConfig):
    """Encoder tokens -> the distillation head's fp32 logits (B, classes),
    reading token 1, the distillation token (``vitx/nn/vit.py:810-820``):
    always the standard LN -> Linear head."""
    hp = params["dist_head"]
    h = layer_norm(x[:, 1, :], hp["ln_scale"], hp["ln_bias"],
                   eps=cfg.layer_norm_eps)
    return (matmul32(h, hp["w"].to(h.dtype)) + hp["b"].float()).float()


def head_logits(params: Params, x, cfg: ViTConfig):
    """The model's logits from its encoder tokens: ``classify``, averaged
    with ``classify_dist`` for a ``distill_token`` model (DeiT's
    inference, ``vitx/nn/vit.py:854-856``)."""
    logits = classify(params, x, cfg)
    if cfg.distill_token:
        logits = 0.5 * (logits + classify_dist(params, x, cfg))
    return logits


def model_logits(params: Params, images, cfg: ViTConfig, *, rng=None,
                 deterministic: bool = True, heads: bool = False):
    """Images (B, H, W, C) -> fp32 logits on the tensors' own device,
    differentiable: vitx's ``forward`` (``vitx/nn/vit.py:834-856``), what
    its ``loss_fn`` and eval step run. ``rng`` (a ``torch.Generator`` on
    that device) drives dropout and drop-path when ``deterministic`` is
    False. With ``cfg.tome_r``, deterministic calls run the ToMe encoder
    (``vitx_torch.nn.tome.encode_tome``); training runs every token, or,
    with ``cfg.tome_train``, the merging encoder with its stochastic
    pieces (vit.py:845). With ``cfg.distill_token`` the logits are the
    mean of the CLS and distillation heads (DeiT's inference); ``heads``
    returns the two apart, (cls_logits, dist_logits), from every token:
    the training form of the distillation step (vitx's
    ``forward_heads``)."""
    if heads:
        if not cfg.distill_token:
            raise ValueError("heads=True needs cfg.distill_token")
        x = encode(params, images, cfg, rng=rng, deterministic=deterministic)
        return classify(params, x, cfg), classify_dist(params, x, cfg)
    if cfg.tome_r and (deterministic or cfg.tome_train):
        # imported here: vitx_torch.nn.tome imports this module
        from vitx_torch.nn.tome import encode_tome

        x = encode_tome(params, images, cfg, rng=rng,
                        deterministic=deterministic)
    else:
        x = encode(params, images, cfg, rng=rng, deterministic=deterministic)
    return head_logits(params, x, cfg)


def forward_heads(params: Params, images, cfg: ViTConfig, *, rng=None,
                  deterministic: bool = True):
    """(cls_logits, dist_logits) of a ``distill_token`` model, both fp32
    and differentiable (``vitx/nn/vit.py:823-831``): the distillation step
    puts the cross-entropy on the first and the teacher's term on the
    second."""
    return model_logits(params, images, cfg, rng=rng,
                        deterministic=deterministic, heads=True)


def on_device(params: Params, images, device):
    """(params, images) on ``device`` (a CUDA device by default; raises
    when there is none); ``images`` may be a numpy array or a tensor."""
    dev = resolve_device(device)
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(images)
    return params_to(params, dev), images.to(dev)


def forward(params: Params, images, cfg: ViTConfig, *, device="cuda"):
    """Full model: images (B, H, W, C) -> logits (B, classes), fp32.

    ``images`` and the parameters are moved to ``device`` (``on_device``).
    Inference only, under ``torch.inference_mode``: dropout and drop-path
    are identities. With ``cfg.tome_r`` the tokens merge (ToMe); the probs
    paths below always run every token, as vitx's do.
    """
    params, images = on_device(params, images, device)
    with torch.inference_mode():
        return model_logits(params, images, cfg)


def forward_features(params: Params, images, cfg: ViTConfig, *,
                     pool: str = "cls", device="cuda"):
    """Images -> (B, E) fp32 feature embeddings, the representation before
    the head (``vitx/nn/vit.py:859-882``), what ``vitx_torch.cli.probe``
    reads. ``pool="cls"``: token 0 of the encoder output, what
    ``classify`` reads; ``"gap"``: the mean over the patch tokens only
    (``bug_exact`` keeps the reference's layout, the patches first and the
    CLS after them). Always every token: no ToMe merging. Devices as
    ``forward``."""
    if pool not in ("cls", "gap"):
        raise ValueError(f"unknown pool {pool!r} (expected 'cls' or 'gap')")
    params, images = on_device(params, images, device)
    with torch.inference_mode():
        x = encode(params, images, cfg)
        if pool == "cls":
            return x[:, 0, :].float()
        s = 0 if cfg.parity == "bug_exact" else cfg.num_prefix_tokens
        return x[:, s:s + cfg.num_patches, :].float().mean(dim=1)


def forward_with_attn(params: Params, images, cfg: ViTConfig, *,
                      probs_mode: str = "full", device="cuda"):
    """Instrumented forward (``vitx/nn/vit.py:885-900``): (logits,
    attn_probs), attn_probs (depth, B, H, T, T) fp32, or the head mean
    (depth, B, T, T) for ``probs_mode="mean"`` -- what
    ``attention_rollout`` reads. On CUDA the full probabilities come from
    B5 on the composed path, the head mean from B7 on the fused one.
    Devices as ``forward``."""
    if probs_mode not in ("full", "mean"):
        raise ValueError(f"probs_mode must be 'full' or 'mean', got "
                         f"{probs_mode!r}")
    params, images = on_device(params, images, device)
    with torch.inference_mode():
        x, probs = encode(params, images, cfg, return_probs=True,
                          probs_mode=probs_mode)
        return head_logits(params, x, cfg), probs


def forward_with_rollout(params: Params, images, cfg: ViTConfig, *,
                         device="cuda"):
    """Forward + attention rollout in one pass (``vitx/nn/vit.py:903-981``):
    (logits, (B, N) rollout weights of the CLS token over the N patches).

    Each block's head-mean probabilities (B7 on CUDA) update an fp32
    (B, T, T) carry R <- rownorm(0.5 P R + 0.5 R) -- equal to chaining
    rownorm(0.5 P + 0.5 I), since R's rows sum to 1 -- so the
    (depth, B, T, T) stack is never held. The chain is a plain fp32
    ``torch.matmul`` (TF32 off). Matches
    ``attention_rollout(head_fusion="mean")``. Devices as ``forward``."""
    params, images = on_device(params, images, device)
    with torch.inference_mode():
        x = embed_tokens(params, images, cfg)
        B, T = x.shape[0], x.shape[1]
        rollout = torch.eye(T, dtype=torch.float32,
                            device=x.device).expand(B, T, T)
        pending = torch.zeros_like(x)
        rope = block_rope(cfg, x)
        for bp in encoder_layers(params):
            x, pending, probs = _encoder_block(
                x, pending, bp, cfg, return_probs=True, probs_mode="mean",
                rope=rope)
            r2 = 0.5 * torch.matmul(probs, rollout) + 0.5 * rollout
            rollout = r2 / r2.sum(dim=-1, keepdim=True)
        x = _final_norm(params, x + pending, cfg)
        if cfg.parity == "bug_exact":
            # the head reads token 0, the first patch (the CLS is appended);
            # its row over the patch tokens
            cls_to_patches = rollout[:, 0, :-1]
        else:
            p = cfg.num_prefix_tokens
            cls_to_patches = rollout[:, 0, p:p + cfg.num_patches]
        denom = cls_to_patches.sum(dim=-1, keepdim=True)
        weights = cls_to_patches / denom.clamp_min(1e-12)
        return head_logits(params, x, cfg), weights
