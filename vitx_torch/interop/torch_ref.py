"""The reference model's ``state_dict`` layout, both ways.

The port's copy of ``vitx/interop/torch_ref.py``: maps between the port's
parameter tree and the PyTorch ``state_dict`` of the reference model
(``src/VisionTransformer/vit.py``, ``transformer.py``), so a reference
checkpoint (``torch.save({'model_state_dict': ...})``, ``train.py:107-113``)
loads into the port and the port's params export back. Leaves stay torch
tensors on the device they are given on; every map is a transpose, a slice
or a stack, so fp32 values round-trip bit for bit.

Reference key map (torch's generated names, the misspelt ``emdeddings``
included, ``vit.py:52``)::

  emdeddings.sequence.0.{weight,bias}                       Conv2d (E, C, P, P)
  emdeddings.cls_tkn_embd                                   (batch_size, 1, E)
  emdeddings.pos_embd                                       (1, N+1, E)
  transformer_encoder.blocks.{i}.ln1.{weight,bias}
  transformer_encoder.blocks.{i}.multi_head.heads.{h}.{query,key,value}.weight
  transformer_encoder.blocks.{i}.multi_head.proj.{weight,bias}
  transformer_encoder.blocks.{i}.ln2.{weight,bias}
  transformer_encoder.blocks.{i}.ffwd.mlp.{0,2}.{weight,bias}
  mlp.0.{weight,bias}  mlp.2.{weight,bias} (LayerNorm 4E)  mlp.3.{weight,bias}

The reference sizes its CLS token per batch slot (``vit.py:31-33``):
import under ``parity="corrected"`` takes slot 0 (``"bug_exact"`` keeps
every slot), export tiles one vector to ``batch_size``.
"""

from __future__ import annotations

import warnings

import torch

from vitx_torch.core.config import ViTConfig


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float32)


def import_reference_state_dict(sd: dict, cfg: ViTConfig) -> dict:
    """A reference ``state_dict`` -> the port's param tree (fp32 tensors on
    the state dict's device). Under ``parity="bug_exact"`` the import is
    prediction-exact for checkpoints the reference's ``train.py`` trained
    (every per-slot CLS kept, CLS appended, logits times sqrt(head_dim));
    under ``"corrected"`` the keys map exactly but the port computes the
    corrected model, so it warns, as vitx does."""
    if cfg.parity != "bug_exact":
        warnings.warn(
            "import_reference_state_dict maps keys exactly, but this config "
            "computes the corrected semantics (CLS prepended, "
            "1/sqrt(head_dim) scaling); a checkpoint trained with the "
            "reference's train.py will not reproduce that model's "
            "predictions. Use ViTConfig(parity='bug_exact') for "
            "prediction-exact loading of such checkpoints.", stacklevel=2)
    E, H, L = cfg.embed_dim, cfg.num_heads, cfg.depth
    P, C = cfg.patch_size, cfg.num_channels

    def get(key):
        return _f32(sd[key])

    conv_w = get("emdeddings.sequence.0.weight")              # (E, C, P, P)
    kernel = conv_w.permute(2, 3, 1, 0).reshape(P * P * C, E)
    cls = get("emdeddings.cls_tkn_embd")                      # (B_train, 1, E)
    if cfg.parity != "bug_exact":
        cls = cls[:1]

    blocks = {k: [] for k in ("ln1_scale", "ln1_bias", "wqkv", "wo", "bo",
                              "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")}
    for i in range(L):
        pre = f"transformer_encoder.blocks.{i}."
        # (E, 3, H, D): per head the (D, E) query, key and value weights
        blocks["wqkv"].append(torch.stack([
            torch.stack([get(f"{pre}multi_head.heads.{h}.{n}.weight").t()
                         for h in range(H)], dim=1)
            for n in ("query", "key", "value")], dim=1))
        blocks["wo"].append(get(pre + "multi_head.proj.weight").t())
        blocks["bo"].append(get(pre + "multi_head.proj.bias"))
        blocks["ln1_scale"].append(get(pre + "ln1.weight"))
        blocks["ln1_bias"].append(get(pre + "ln1.bias"))
        blocks["ln2_scale"].append(get(pre + "ln2.weight"))
        blocks["ln2_bias"].append(get(pre + "ln2.bias"))
        blocks["w1"].append(get(pre + "ffwd.mlp.0.weight").t())
        blocks["b1"].append(get(pre + "ffwd.mlp.0.bias"))
        blocks["w2"].append(get(pre + "ffwd.mlp.2.weight").t())
        blocks["b2"].append(get(pre + "ffwd.mlp.2.bias"))

    return {
        "patch_embed": {"kernel": kernel.contiguous(),
                        "bias": get("emdeddings.sequence.0.bias")},
        "cls_token": cls.contiguous(),
        "pos_embed": get("emdeddings.pos_embd"),
        "blocks": {k: torch.stack(v).contiguous()
                   for k, v in blocks.items()},
        "head": {
            "w1": get("mlp.0.weight").t().contiguous(),
            "b1": get("mlp.0.bias"),
            "ln_scale": get("mlp.2.weight"),
            "ln_bias": get("mlp.2.bias"),
            "w2": get("mlp.3.weight").t().contiguous(),
            "b2": get("mlp.3.bias"),
        },
    }


def export_reference_state_dict(params: dict, cfg: ViTConfig,
                                batch_size: int = 1) -> dict:
    """The port's param tree -> a reference ``state_dict`` (contiguous
    fp32 tensors on the params' device). A single CLS vector is tiled to
    ``batch_size`` slots; a per-slot CLS (a ``bug_exact`` import) goes back
    untiled. Raises ``ValueError`` for params the reference layout has no
    slot for."""
    E, H, D, L = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.depth
    P, C = cfg.patch_size, cfg.num_channels
    if "w1" not in params.get("head", {}):
        raise ValueError("export requires head_type='reference' params")
    if cfg.distill_token:
        raise ValueError("the reference layout has no distillation token; "
                         "export requires distill_token=False")
    if cfg.pos_embed != "learned":
        raise ValueError("the reference layout stores a learned positional "
                         "table; sincos2d/rope models have none to export")
    if "kernel" not in params["patch_embed"]:
        raise ValueError("export requires stem='patch' params (the "
                         "reference has no conv-stem equivalent)")
    if "reg_tokens" in params:
        raise ValueError("export requires num_registers=0 params (the "
                         "reference has no register tokens)")
    if "moe_blocks" in params:
        raise ValueError("the reference layout has no Soft-MoE blocks; "
                         "export requires moe_experts=0")
    b = params["blocks"]
    for key, why in (("w3", "swiglu gate weights have no export slot (the "
                            "reference FeedForward is Linear->act->Linear)"),
                     ("bqkv", "the reference's query/key/value have no bias "
                              "(export requires qkv_bias=False)"),
                     ("lnq_scale", "the reference layout has no QK-Norm "
                                   "scales"),
                     ("ls1", "the reference layout has no LayerScale "
                             "gains")):
        if key in b:
            raise ValueError(why)
    if "bo" not in b:
        raise ValueError("export requires proj_bias=True params (the "
                         "reference projection always has a bias, "
                         "transformer.py:38)")
    if "final_norm" in params:
        raise ValueError("the reference layout has no final norm; export "
                         "requires final_norm=False")

    kernel = _f32(params["patch_embed"]["kernel"])
    cls = _f32(params["cls_token"])
    sd = {
        "emdeddings.sequence.0.weight":
            kernel.reshape(P, P, C, E).permute(3, 2, 0, 1),
        "emdeddings.sequence.0.bias": _f32(params["patch_embed"]["bias"]),
        "emdeddings.cls_tkn_embd":
            cls if cls.shape[0] > 1 else cls.expand(batch_size, 1, E),
        "emdeddings.pos_embd": _f32(params["pos_embed"]),
    }
    for i in range(L):
        pre = f"transformer_encoder.blocks.{i}."
        wqkv = _f32(b["wqkv"][i])                               # (E, 3, H, D)
        for h in range(H):
            hp = f"{pre}multi_head.heads.{h}."
            for j, n in enumerate(("query", "key", "value")):
                sd[f"{hp}{n}.weight"] = wqkv[:, j, h, :].t()
        sd[pre + "multi_head.proj.weight"] = _f32(b["wo"][i]).t()
        sd[pre + "multi_head.proj.bias"] = _f32(b["bo"][i])
        sd[pre + "ln1.weight"] = _f32(b["ln1_scale"][i])
        sd[pre + "ln1.bias"] = _f32(b["ln1_bias"][i])
        sd[pre + "ln2.weight"] = _f32(b["ln2_scale"][i])
        sd[pre + "ln2.bias"] = _f32(b["ln2_bias"][i])
        sd[pre + "ffwd.mlp.0.weight"] = _f32(b["w1"][i]).t()
        sd[pre + "ffwd.mlp.0.bias"] = _f32(b["b1"][i])
        sd[pre + "ffwd.mlp.2.weight"] = _f32(b["w2"][i]).t()
        sd[pre + "ffwd.mlp.2.bias"] = _f32(b["b2"][i])
    hp = params["head"]
    sd["mlp.0.weight"] = _f32(hp["w1"]).t()
    sd["mlp.0.bias"] = _f32(hp["b1"])
    sd["mlp.2.weight"] = _f32(hp["ln_scale"])
    sd["mlp.2.bias"] = _f32(hp["ln_bias"])
    sd["mlp.3.weight"] = _f32(hp["w2"]).t()
    sd["mlp.3.bias"] = _f32(hp["b2"])
    # own, contiguous storage: torch.save writes a view's whole storage
    return {k: v.contiguous().clone() for k, v in sd.items()}


def reference_parameter_order(cfg: ViTConfig) -> list[str]:
    """The state-dict keys in the reference model's ``parameters()``
    order, which numbers ``torch.optim.AdamW``'s state (``train.py:66``):
    a module's own parameters before its children's, so CLS and the
    positional table first, then the patch conv; each head registers key,
    query, value; each block its attention, feed-forward, then ln1, ln2."""
    keys = ["emdeddings.cls_tkn_embd", "emdeddings.pos_embd",
            "emdeddings.sequence.0.weight", "emdeddings.sequence.0.bias"]
    for i in range(cfg.depth):
        pre = f"transformer_encoder.blocks.{i}."
        for h in range(cfg.num_heads):
            hp = f"{pre}multi_head.heads.{h}."
            keys += [hp + "key.weight", hp + "query.weight",
                     hp + "value.weight"]
        keys += [pre + "multi_head.proj.weight", pre + "multi_head.proj.bias",
                 pre + "ffwd.mlp.0.weight", pre + "ffwd.mlp.0.bias",
                 pre + "ffwd.mlp.2.weight", pre + "ffwd.mlp.2.bias",
                 pre + "ln1.weight", pre + "ln1.bias",
                 pre + "ln2.weight", pre + "ln2.bias"]
    keys += ["mlp.0.weight", "mlp.0.bias", "mlp.2.weight", "mlp.2.bias",
             "mlp.3.weight", "mlp.3.bias"]
    return keys


def optimizer_param_groups(cfg: ViTConfig, *, lr: float = 1e-4,
                           weight_decay: float = 1e-4, betas=(0.9, 0.999),
                           eps: float = 1e-8) -> list:
    """The one ``param_groups`` entry of the reference's AdamW state
    dict."""
    return [{
        "lr": lr, "betas": tuple(betas), "eps": eps,
        "weight_decay": weight_decay, "amsgrad": False, "maximize": False,
        "foreach": None, "capturable": False, "differentiable": False,
        "fused": None, "decoupled_weight_decay": True,
        "params": list(range(len(reference_parameter_order(cfg)))),
    }]


def export_reference_optimizer_state(opt_state, cfg: ViTConfig, *,
                                     lr: float = 1e-4,
                                     weight_decay: float = 1e-4,
                                     betas=(0.9, 0.999), eps: float = 1e-8,
                                     batch_size: int = 1) -> dict:
    """The port's ``AdamWState`` -> a ``torch.optim.AdamW`` state dict for
    the reference model, which its resume (``train.py:73``) loads to go on
    with the same moments. The moments are trees of the params' shapes, so
    the weight export's relayouts carry them over (each is elementwise
    Adam's own layout change)."""
    mu = export_reference_state_dict(opt_state.mu, cfg, batch_size)
    nu = export_reference_state_dict(opt_state.nu, cfg, batch_size)
    step = torch.tensor(float(opt_state.count))
    state = {i: {"step": step.clone(), "exp_avg": mu[key],
                 "exp_avg_sq": nu[key]}
             for i, key in enumerate(reference_parameter_order(cfg))}
    return {"state": state,
            "param_groups": optimizer_param_groups(
                cfg, lr=lr, weight_decay=weight_decay, betas=betas,
                eps=eps)}
