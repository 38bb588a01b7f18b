"""Public pretrained ViTs (timm and HuggingFace state dicts) into the
port's parameters, and the positional table's resize for fine-tuning at
another image size.

The counterpart of ``vitx/interop/pretrained.py``. Supported layouts,
detected by their keys (``detect_format``):

- **timm** ``vision_transformer``: ``cls_token``, ``pos_embed``,
  ``patch_embed.proj.*``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
  mlp.fc1,mlp.fc2}.*``, ``norm.*``, ``head.*``; a ``deit_*_distilled``
  checkpoint adds ``dist_token`` and ``head_dist.*``.
- **HuggingFace** ``ViTModel`` / ``ViTForImageClassification``:
  ``[vit.]embeddings.*``, ``[vit.]encoder.layer.{i}.*`` (q, k and v as
  three matrices), ``[vit.]layernorm.*``, ``classifier.*``.

Both become vitx's "standard ViT" (``vit_config_for_pretrained``): QKV
biases, erf GELU, the standard LN -> Linear head, and ``final_norm=False``
-- the source's final encoder LayerNorm goes into the head's LN (and the
distillation head's), since the heads read their tokens only. timm's
LayerNorm eps is 1e-6 and HF's 1e-12; the config carries it, and every
LayerNorm of the port (K1's and K2's prologues and B3 among them) takes
it as given. The state dict comes from local files, as torch tensors or
numpy arrays; the leaves are the same numbers as vitx's import, laid out
on ``device`` (the card by default) in the config's parameter dtype.

``resize_pos_embed`` (vitx's lines 205-223): the prefix rows (CLS, and
the distillation token where there is one) pass through and the (g, g)
grid of patch positions is resized bilinearly to the new config's grid,
the usual way to start a fine-tune at 384² or 512² from a 224²
checkpoint. ``jax.image.resize(..., "bilinear")`` antialiases when it
shrinks a grid: its triangle kernel widens by the scale.
``F.interpolate`` does the same only with ``antialias=True`` (without it,
a 24 -> 14 shrink lands up to 2.1 away from vitx's table); upsampling is
plain bilinear with half-pixel centres in both. The resize runs in fp32.
``resize_bilinear`` is the same resize on NHWC images.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device

_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
               "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


def vit_config_for_pretrained(*, image_size: int, patch_size: int,
                              num_classes: int, embed_dim: int, depth: int,
                              num_heads: int, layer_norm_eps: float = 1e-12,
                              **overrides) -> ViTConfig:
    """The config of a timm/HF standard ViT (``vitx/interop/pretrained.py
    :31-45``): QKV biases, erf GELU, the standard head and
    ``final_norm=False`` (the source's final LN is the head's). Pass
    ``layer_norm_eps=1e-6`` for timm, keep 1e-12 for HF."""
    return ViTConfig(
        image_size=image_size, patch_size=patch_size,
        num_classes=num_classes, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, head_type="standard", final_norm=False,
        qkv_bias=True, mlp_act="gelu", layer_norm_eps=layer_norm_eps,
        **overrides)


def _np(t) -> np.ndarray:
    """A state-dict entry (tensor or array) as a float32 numpy array."""
    if torch.is_tensor(t):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def detect_format(sd: dict) -> str:
    """"hf" or "timm" by the state dict's keys; raises ``ValueError`` for
    any other layout."""
    keys = sd.keys()
    if any(k.startswith(("vit.embeddings", "embeddings.patch_embeddings"))
           for k in keys):
        return "hf"
    if "patch_embed.proj.weight" in keys:
        return "timm"
    raise ValueError("unrecognized pretrained state-dict layout")


def _conv_to_kernel(conv_w: np.ndarray) -> np.ndarray:
    """(E, C, P, P) Conv2d weight -> (P·P·C, E) patchify kernel, rows in
    the (P, P, C) order ``patch_embed`` flattens a patch in."""
    E, C, P, _ = conv_w.shape
    return conv_w.transpose(2, 3, 1, 0).reshape(P * P * C, E)


def _qkv_from_rows(wq, wk, wv, bq, bk, bv, H):
    """Three (E, E) out-by-in matrices (HF's query, key, value) and their
    biases -> wqkv (E, 3, H, D) and bqkv (3, H, D)."""
    E = wq.shape[1]
    D = E // H
    wqkv = np.stack([w.T.reshape(E, H, D) for w in (wq, wk, wv)], axis=1)
    bqkv = np.stack([b.reshape(H, D) for b in (bq, bk, bv)], axis=0)
    return wqkv, bqkv


def _head(sd, norm: str, w: str, b: str, cfg: ViTConfig) -> dict:
    """A standard head from the source's final norm and its classifier;
    zeros where the source is a headless backbone."""
    E, C = cfg.embed_dim, cfg.num_classes
    return {"ln_scale": _np(sd[norm + "weight"]),
            "ln_bias": _np(sd[norm + "bias"]),
            "w": _np(sd[w]).T if w in sd else np.zeros((E, C), np.float32),
            "b": _np(sd[b]) if b in sd else np.zeros((C,), np.float32)}


def _to_params(tree, cfg: ViTConfig, device):
    dev = resolve_device(device)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return torch.from_numpy(np.ascontiguousarray(node)).to(
            device=dev, dtype=cfg.pdtype())
    return build(tree)


def import_timm_state_dict(sd: dict, cfg: ViTConfig, *,
                           device="cuda") -> dict:
    """timm ``vision_transformer`` state dict -> the port's params
    (``vitx/interop/pretrained.py:79-138``); with ``cfg.distill_token`` a
    ``deit_*_distilled`` one, whose ``dist_token`` and ``head_dist`` fill
    the distillation token and head (the final norm serves both heads)."""
    L, H, E = cfg.depth, cfg.num_heads, cfg.embed_dim
    D = E // H
    blocks = {k: [] for k in _BLOCK_KEYS}
    for i in range(L):
        p = f"blocks.{i}."
        blocks["wqkv"].append(
            _np(sd[p + "attn.qkv.weight"]).T.reshape(E, 3, H, D))
        blocks["bqkv"].append(_np(sd[p + "attn.qkv.bias"]).reshape(3, H, D))
        blocks["wo"].append(_np(sd[p + "attn.proj.weight"]).T)
        blocks["bo"].append(_np(sd[p + "attn.proj.bias"]))
        blocks["ln1_scale"].append(_np(sd[p + "norm1.weight"]))
        blocks["ln1_bias"].append(_np(sd[p + "norm1.bias"]))
        blocks["ln2_scale"].append(_np(sd[p + "norm2.weight"]))
        blocks["ln2_bias"].append(_np(sd[p + "norm2.bias"]))
        blocks["w1"].append(_np(sd[p + "mlp.fc1.weight"]).T)
        blocks["b1"].append(_np(sd[p + "mlp.fc1.bias"]))
        blocks["w2"].append(_np(sd[p + "mlp.fc2.weight"]).T)
        blocks["b2"].append(_np(sd[p + "mlp.fc2.bias"]))
    params = {
        "patch_embed": {
            "kernel": _conv_to_kernel(_np(sd["patch_embed.proj.weight"])),
            "bias": _np(sd["patch_embed.proj.bias"]),
        },
        "cls_token": _np(sd["cls_token"]),
        "pos_embed": _np(sd["pos_embed"]),
        "blocks": {k: np.stack(v) for k, v in blocks.items()},
        "head": _head(sd, "norm.", "head.weight", "head.bias", cfg),
    }
    if cfg.distill_token:
        if "dist_token" not in sd:
            raise KeyError(
                "cfg.distill_token=True but the state dict has no "
                "'dist_token' (not a deit_*_distilled checkpoint)")
        params["dist_token"] = _np(sd["dist_token"])
        params["dist_head"] = _head(sd, "norm.", "head_dist.weight",
                                    "head_dist.bias", cfg)
    return _to_params(_check_pos_embed(params, cfg), cfg, device)


def import_hf_state_dict(sd: dict, cfg: ViTConfig, *, device="cuda") -> dict:
    """HuggingFace ``ViTModel`` / ``ViTForImageClassification`` state dict
    -> the port's params (``vitx/interop/pretrained.py:141-187``)."""
    pre = "vit." if any(k.startswith("vit.") for k in sd) else ""
    L, H = cfg.depth, cfg.num_heads
    emb = pre + "embeddings."
    blocks = {k: [] for k in _BLOCK_KEYS}
    for i in range(L):
        p = f"{pre}encoder.layer.{i}."
        a = p + "attention.attention."
        wqkv, bqkv = _qkv_from_rows(
            _np(sd[a + "query.weight"]), _np(sd[a + "key.weight"]),
            _np(sd[a + "value.weight"]), _np(sd[a + "query.bias"]),
            _np(sd[a + "key.bias"]), _np(sd[a + "value.bias"]), H)
        blocks["wqkv"].append(wqkv)
        blocks["bqkv"].append(bqkv)
        blocks["wo"].append(_np(sd[p + "attention.output.dense.weight"]).T)
        blocks["bo"].append(_np(sd[p + "attention.output.dense.bias"]))
        blocks["ln1_scale"].append(_np(sd[p + "layernorm_before.weight"]))
        blocks["ln1_bias"].append(_np(sd[p + "layernorm_before.bias"]))
        blocks["ln2_scale"].append(_np(sd[p + "layernorm_after.weight"]))
        blocks["ln2_bias"].append(_np(sd[p + "layernorm_after.bias"]))
        blocks["w1"].append(_np(sd[p + "intermediate.dense.weight"]).T)
        blocks["b1"].append(_np(sd[p + "intermediate.dense.bias"]))
        blocks["w2"].append(_np(sd[p + "output.dense.weight"]).T)
        blocks["b2"].append(_np(sd[p + "output.dense.bias"]))
    params = {
        "patch_embed": {
            "kernel": _conv_to_kernel(_np(
                sd[emb + "patch_embeddings.projection.weight"])),
            "bias": _np(sd[emb + "patch_embeddings.projection.bias"]),
        },
        "cls_token": _np(sd[emb + "cls_token"]),
        "pos_embed": _np(sd[emb + "position_embeddings"]),
        "blocks": {k: np.stack(v) for k, v in blocks.items()},
        "head": _head(sd, pre + "layernorm.", "classifier.weight",
                      "classifier.bias", cfg),
    }
    return _to_params(_check_pos_embed(params, cfg), cfg, device)


def import_pretrained_state_dict(sd: dict, cfg: ViTConfig, *,
                                 device="cuda") -> dict:
    """The timm or HF layout, detected, imported onto ``device``. ``cfg``
    must be a standard-ViT config (``vit_config_for_pretrained``); a
    headless backbone's head is zeros."""
    if cfg.head_type != "standard" or cfg.final_norm or not cfg.qkv_bias:
        raise ValueError(
            "pretrained ViTs need head_type='standard', final_norm=False "
            "(the source's final LN folds into the head), qkv_bias=True -- "
            "build the config with vit_config_for_pretrained")
    fmt = detect_format(sd)
    fn = import_hf_state_dict if fmt == "hf" else import_timm_state_dict
    return fn(sd, cfg, device=device)


def _check_pos_embed(params: dict, cfg: ViTConfig) -> dict:
    have = params["pos_embed"].shape[1]
    if have != cfg.pos_len:
        raise ValueError(
            f"pos_embed has {have} positions but the config needs "
            f"{cfg.pos_len}; use resize_pos_embed for a different "
            f"image size")
    return params


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
