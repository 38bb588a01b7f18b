"""The Vision Transformer forward in PyTorch.

The counterpart of ``vitx/nn/vit.py``. Parameters are the same nested dict
as vitx's (``init_params``): block leaves stacked on a leading depth axis,
``wqkv`` as (E, 3, H, D), ``wo`` (E, E), fp32. Images are NHWC. The blocks
run as a Python loop; on a CUDA device each block's attention half is
kernel K1 (B7 when head-mean probabilities are asked for; B5 inside the
composed path; B8 in the ToMe encoder, ``vitx_torch/nn/tome.py``) and its
MLP half kernel K2 (``vitx_torch/kernels``).
Everything else -- patch embedding, residual adds, the head, the rollout
chain -- is plain torch, as it is XLA in vitx. ``model_logits`` is the
differentiable forward the train step runs (dropout and drop-path from an
explicit ``torch.Generator``); ``forward``, ``forward_features``,
``forward_with_attn`` and ``forward_with_rollout`` are inference, under
``torch.inference_mode``.
vitx's ``remat`` is accepted and ignored: autograd keeps the activations.
"""

from __future__ import annotations

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
                                  drop_path, dropout, layer_norm, matmul32,
                                  mlp)

Params = dict


def check_ported(cfg: ViTConfig) -> None:
    """Raise for the model features the port does not have yet, naming the
    ROADMAP item that brings each."""
    missing = (
        (cfg.stem == "conv", "the conv stem (stem='conv')", "A12"),
        (cfg.num_registers, "register tokens", "A12"),
        (cfg.moe_experts, "Soft-MoE blocks", "A12"),
        (cfg.head_type == "map", "the MAP head", "A12"),
        (cfg.pos_embed != "learned", f"pos_embed={cfg.pos_embed!r}", "A12"),
    )
    for cond, what, item in missing:
        if cond:
            raise NotImplementedError(
                f"{what} is not ported to vitx_torch yet (ROADMAP {item})")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def param_spec(cfg: ViTConfig) -> dict:
    """The parameter tree of ``cfg`` as nested dicts of (shape, init) leaves,
    where init is "normal" (trunc-normal, ``cfg.init_std``) or a constant.
    The same tree and shapes as ``vitx/nn/vit.py:44-223`` for the features
    the port has."""
    check_ported(cfg)
    E, H, D, M, L = (cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.mlp_dim,
                     cfg.depth)
    P, C = cfg.patch_size, cfg.num_channels
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
    blocks.update(lora_spec(cfg))
    spec = {
        "patch_embed": {"kernel": ((P * P * C, E), "normal"),
                        "bias": ((E,), 0.0)},
        "cls_token": ((1, 1, E), "normal"),
        "pos_embed": ((1, cfg.pos_len, E), "normal"),
    }
    if cfg.distill_token:
        # DeiT: a second learned token (position 1) with its own standard
        # head, trained against the teacher, averaged with CLS at eval
        spec["dist_token"] = ((1, 1, E), "normal")
        spec["dist_head"] = {
            "ln_scale": ((E,), 1.0), "ln_bias": ((E,), 0.0),
            "w": ((E, cfg.num_classes), 0.0), "b": ((cfg.num_classes,), 0.0),
        }
    spec["blocks"] = blocks
    if cfg.final_norm:
        spec["final_norm"] = {"scale": ((E,), 1.0), "bias": ((E,), 0.0)}
    if cfg.head_type == "reference":
        spec["head"] = {
            "w1": ((E, 4 * E), "normal"), "b1": ((4 * E,), 0.0),
            "ln_scale": ((4 * E,), 1.0), "ln_bias": ((4 * E,), 0.0),
            "w2": ((4 * E, cfg.num_classes), "normal"),
            "b2": ((cfg.num_classes,), 0.0),
        }
    else:
        spec["head"] = {
            "ln_scale": ((E,), 1.0), "ln_bias": ((E,), 0.0),
            "w": ((E, cfg.num_classes), 0.0), "b": ((cfg.num_classes,), 0.0),
        }
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

def patch_embed(params: Params, images, cfg: ViTConfig):
    """(B, H, W, C) images -> (B, N, E) patch tokens: space-to-depth with
    rows ordered (P, P, C), then one matmul (``vitx/nn/vit.py:262-284``)."""
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


def add_pos_embed(params: Params, x, cfg: ViTConfig):
    """Add the learned positional table (the only kind the port has)."""
    return x + params["pos_embed"].to(x.dtype)


def embed_tokens(params: Params, images, cfg: ViTConfig):
    """Images -> the token sequence the first block reads."""
    tokens = patch_embed(params, images, cfg)
    x = _join_cls(params, tokens, cfg, tokens.shape[0])
    return add_pos_embed(params, x, cfg)


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
                   return_probs: bool = False, probs_mode: str = "full"):
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
    composed path."""
    if cfg.lora_rank:
        bp = merge_block(bp, cfg)
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
            qk_eps=cfg.layer_norm_eps)
    if "ls1" in bp:
        attn_out = attn_out * bp["ls1"].to(dt)
    attn_out = dropout(attn_out, cfg.dropout, rng,
                       deterministic=deterministic)
    if cfg.drop_path:
        attn_out = drop_path(attn_out, dp_rate, rng,
                             deterministic=deterministic)

    if _use_fused_mlp(cfg, x):
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
    return x, mlp_out, probs


def unstack(blocks: Params):
    """The stacked block leaves -> one parameter dict per block. Each
    stacked leaf is unbound once, so its gradient is one stack."""
    layers = {k: v.unbind(0) for k, v in blocks.items()}
    depth = len(next(iter(layers.values())))
    return [{k: v[i] for k, v in layers.items()} for i in range(depth)]


def drop_path_rates(cfg: ViTConfig, n: int, deterministic: bool) -> list:
    """The blocks' drop-path rates, rising linearly from 0 to
    ``cfg.drop_path`` (fp32, as vitx's ``jnp.linspace``); all 0 when
    deterministic, where none is drawn (and an export traces no
    data-dependent value)."""
    if deterministic or not cfg.drop_path:
        return [0.0] * n
    return torch.linspace(0.0, cfg.drop_path, n).tolist()


def run_blocks(blocks: Params, x, cfg: ViTConfig, *, rng=None,
               deterministic: bool = True, return_probs: bool = False,
               probs_mode: str = "full"):
    """Run the stacked blocks over tokens x (B, T, E): a Python loop in
    place of vitx's ``lax.scan``; returns (x + pending, probs stacked over
    the blocks or None) (``vitx/nn/vit.py:439-515``). The number of blocks
    is the stack's. Drop-path rates rise linearly from 0 at the first
    block to ``cfg.drop_path`` at the last (vit.py:464-468)."""
    layers = unstack(blocks)
    rates = drop_path_rates(cfg, len(layers), deterministic)
    pending = torch.zeros_like(x)
    probs = []
    for bp, rate in zip(layers, rates):
        x, pending, p = _encoder_block(
            x, pending, bp, cfg, rng=rng, deterministic=deterministic,
            dp_rate=rate, return_probs=return_probs, probs_mode=probs_mode)
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
    check_ported(cfg)
    x = embed_tokens(params, images, cfg)
    if rng is not None:
        if cfg.patch_drop and not deterministic:
            x = _patch_drop(x, cfg, rng)
        x = dropout(x, cfg.dropout, rng, deterministic=deterministic)
    x, probs = run_blocks(params["blocks"], x, cfg, rng=rng,
                          deterministic=deterministic,
                          return_probs=return_probs, probs_mode=probs_mode)
    x = _final_norm(params, x, cfg)
    return (x, probs) if return_probs else x


def classify(params: Params, x, cfg: ViTConfig):
    """Encoder tokens (B, T, E) -> fp32 logits (B, classes): token 0 (or the
    patch mean for ``global_pool="gap"``) through the reference head
    (Linear -> erf GELU -> LayerNorm(4E) -> Linear) or the standard head
    (LN -> Linear), as at ``vitx/nn/vit.py:780-807``."""
    if cfg.global_pool == "gap":
        s = cfg.num_prefix_tokens
        cls = x[:, s:, :].mean(dim=1)
    else:
        cls = x[:, 0, :]
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
    check_ported(cfg)
    params, images = on_device(params, images, device)
    with torch.inference_mode():
        x = embed_tokens(params, images, cfg)
        B, T = x.shape[0], x.shape[1]
        rollout = torch.eye(T, dtype=torch.float32,
                            device=x.device).expand(B, T, T)
        pending = torch.zeros_like(x)
        for bp in unstack(params["blocks"]):
            x, pending, probs = _encoder_block(
                x, pending, bp, cfg, return_probs=True, probs_mode="mean")
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
