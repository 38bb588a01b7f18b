"""LoRA: low-rank adapters for parameter-efficient fine-tuning.

The counterpart of ``vitx/nn/lora.py`` (Hu et al. 2021). Each targeted
block weight ``w`` gains a pair (A, B) with ``w_eff = w + (alpha / rank)
* A @ B``; the adapters and the classifier heads train, the base weights
stay frozen (``make_trainable_mask("lora")``).

As in vitx, the adapters are stacked ``(L, ...)`` leaves inside
``params["blocks"]`` (``lora_wqkv_a`` and so on), and the delta is folded
into the dense weight at the top of each block (``merge_block``, called
by ``_encoder_block`` and the ToMe encoder), so K1, K2, B5 and B8 consume
ordinary dense weights. The fold runs in fp32 and rounds once to the
weight's dtype, where vitx rounds. ``merge_lora_params`` folds every
adapter into a plain checkpoint for serving and export.
"""

from __future__ import annotations

import math

import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device

# target -> (A's trailing shape, B's trailing shape), per layer; A maps the
# base weight's first axis to the rank, B the rank to its other axes
_TARGETS = {
    "wqkv": (lambda c: (c.embed_dim,),
             lambda c: (3, c.num_heads, c.head_dim)),
    "wo": (lambda c: (c.embed_dim,), lambda c: (c.embed_dim,)),
    "w1": (lambda c: (c.embed_dim,), lambda c: (c.mlp_dim,)),
    "w2": (lambda c: (c.mlp_dim,), lambda c: (c.embed_dim,)),
}


def target_names(cfg: ViTConfig) -> tuple:
    """The block weights ``cfg`` adapts: attention always, the MLP with
    ``lora_targets="all"``."""
    return (("wqkv", "wo", "w1", "w2") if cfg.lora_targets == "all"
            else ("wqkv", "wo"))


def lora_spec(cfg: ViTConfig) -> dict:
    """The stacked adapter leaves as ``param_spec`` entries: A
    trunc-normal (``cfg.init_std``), B zero, so that step 0 is the base
    model exactly (``vitx/nn/lora.py:72-92``)."""
    if not cfg.lora_rank:
        return {}
    L, r = cfg.depth, cfg.lora_rank
    spec = {}
    for name in target_names(cfg):
        a_shape, b_shape = _TARGETS[name]
        spec[f"lora_{name}_a"] = ((L,) + a_shape(cfg) + (r,), "normal")
        spec[f"lora_{name}_b"] = ((L, r) + b_shape(cfg), 0.0)
    return spec


def init_lora_leaves(rng, cfg: ViTConfig, *, device="cuda") -> dict:
    """Fresh adapter leaves to insert into ``params["blocks"]`` (``rng`` a
    ``torch.Generator`` or an int seed; the draws differ from vitx's) on
    ``device``: a CUDA device by default, as ``init_params``' leaves,
    raising when there is none (``device="cpu"`` for the CPU)."""
    from vitx_torch.nn.vit import init_leaf

    dev = resolve_device(device)
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    return {k: init_leaf(shape, init, cfg, gen).to(dev)
            for k, (shape, init) in lora_spec(cfg).items()}


def _delta(a, b):
    """A @ B in fp32 over the rank axis: a (..., n, r), b (..., r, *rest)
    -> (..., n, *rest)."""
    lead, rest = a.shape[:-2], b.shape[a.dim() - 1:]
    d = torch.matmul(a.float(), b.float().reshape(*lead, b.shape[len(lead)],
                                                 math.prod(rest)))
    return d.reshape(*a.shape[:-1], *rest)


def merge_block(bp: dict, cfg: ViTConfig) -> dict:
    """Fold the adapters of one block (per-layer slices) or of the stacked
    blocks into the dense weights: ``w + (scale * A @ B)`` with the
    product in fp32, cast to ``w``'s dtype before the add, as
    ``vitx/nn/lora.py:95-114``. Returns a new dict without the ``lora_*``
    keys; one without adapters comes back as it is."""
    if not any(k.startswith("lora_") for k in bp):
        return bp
    out = {k: v for k, v in bp.items() if not k.startswith("lora_")}
    scale = cfg.lora_scale
    for name in _TARGETS:
        a = bp.get(f"lora_{name}_a")
        if a is None:
            continue
        w = out[name]
        out[name] = w + (scale * _delta(a, bp[f"lora_{name}_b"])).to(w.dtype)
    return out


def merge_lora_params(params: dict, cfg: ViTConfig):
    """Fold every adapter into its dense weight -> (plain params, plain
    config): an ordinary checkpoint that serving, int8 artifacts, ``.pt2``
    programs and the reference ``.pt`` take. The merged forward is the
    adapted one: the same fold, once."""
    if not cfg.lora_rank:
        return params, cfg
    out = dict(params)
    out["blocks"] = merge_block(dict(params["blocks"]), cfg)
    return out, cfg.replace(lora_rank=0, lora_alpha=0.0)


def has_lora(params: dict) -> bool:
    return any(k.startswith("lora_") for k in params.get("blocks", {}))
