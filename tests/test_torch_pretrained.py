"""Public pretrained ViTs into the port (``vitx_torch.interop.pretrained``)
against vitx's importer, on the CPU.

The state dicts are built here from a seed with numpy, in timm's layout
(``vit_base_patch16_224``'s keys: one fused qkv matrix), HF's (query, key
and value apart; with and without the ``vit.`` prefix) and a
``deit_*_distilled`` one (``dist_token``, ``head_dist``, T = patches + 2),
at depth 2, E 64, 4 heads, 32² images in 8² patches. Each import is held
to vitx's leaf for leaf, bit for bit; the imported models' fp32 forwards
to vitx's at 1e-4 (max |a - b| over max |b|, the repo's bar), with timm's
LayerNorm eps 1e-6 and HF's 1e-12. ``tests/test_torch_hf_oracle.py``
holds the HF route to ``transformers`` itself.
"""

import jax
import numpy as np
import pytest
import torch

from vitx import forward as jforward
from vitx.interop import pretrained as jpre
from vitx_torch import forward
from vitx_torch.interop import pretrained as tpre
from vitx_torch.train.step import leaf_paths, leaves

torch.set_num_threads(1)

E, L, H, P, S, C = 64, 2, 4, 8, 32, 5


def cfgs(distill=False, eps=1e-6):
    kw = dict(image_size=S, patch_size=P, num_classes=C, embed_dim=E,
              depth=L, num_heads=H, layer_norm_eps=eps,
              compute_dtype="float32", distill_token=distill)
    return (jpre.vit_config_for_pretrained(**kw),
            tpre.vit_config_for_pretrained(**kw))


def timm_sd(seed=0, distill=False, head=True):
    """A timm ``vision_transformer`` state dict of numpy arrays; with
    ``distill`` the ``deit_*_distilled`` extras."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    T = (S // P) ** 2 + (2 if distill else 1)
    sd = {"cls_token": r(1, 1, E), "pos_embed": r(1, T, E),
          "patch_embed.proj.weight": r(E, 3, P, P),
          "patch_embed.proj.bias": r(E),
          "norm.weight": 1 + r(E), "norm.bias": r(E)}
    if head:
        sd.update({"head.weight": r(C, E), "head.bias": r(C)})
    for i in range(L):
        t = f"blocks.{i}."
        sd.update({t + "attn.qkv.weight": r(3 * E, E),
                   t + "attn.qkv.bias": r(3 * E),
                   t + "attn.proj.weight": r(E, E),
                   t + "attn.proj.bias": r(E),
                   t + "norm1.weight": 1 + r(E), t + "norm1.bias": r(E),
                   t + "norm2.weight": 1 + r(E), t + "norm2.bias": r(E),
                   t + "mlp.fc1.weight": r(4 * E, E),
                   t + "mlp.fc1.bias": r(4 * E),
                   t + "mlp.fc2.weight": r(E, 4 * E),
                   t + "mlp.fc2.bias": r(E)})
    if distill:
        sd.update({"dist_token": r(1, 1, E), "head_dist.weight": r(C, E),
                   "head_dist.bias": r(C)})
    return sd


def hf_sd(timm: dict, prefix="vit."):
    """The same weights in HF ``ViTForImageClassification``'s layout."""
    emb = prefix + "embeddings."
    sd = {emb + "cls_token": timm["cls_token"],
          emb + "position_embeddings": timm["pos_embed"],
          emb + "patch_embeddings.projection.weight":
              timm["patch_embed.proj.weight"],
          emb + "patch_embeddings.projection.bias":
              timm["patch_embed.proj.bias"],
          prefix + "layernorm.weight": timm["norm.weight"],
          prefix + "layernorm.bias": timm["norm.bias"],
          "classifier.weight": timm["head.weight"],
          "classifier.bias": timm["head.bias"]}
    for i in range(L):
        t, h = f"blocks.{i}.", f"{prefix}encoder.layer.{i}."
        a = h + "attention.attention."
        for j, m in enumerate(("query", "key", "value")):
            sd[a + m + ".weight"] = timm[t + "attn.qkv.weight"][
                j * E:(j + 1) * E]
            sd[a + m + ".bias"] = timm[t + "attn.qkv.bias"][j * E:(j + 1) * E]
        for src, dst in (("attn.proj", "attention.output.dense"),
                         ("norm1", "layernorm_before"),
                         ("norm2", "layernorm_after"),
                         ("mlp.fc1", "intermediate.dense"),
                         ("mlp.fc2", "output.dense")):
            sd[h + dst + ".weight"] = timm[t + src + ".weight"]
            sd[h + dst + ".bias"] = timm[t + src + ".bias"]
    return sd


def assert_bit_equal(got: dict, want: dict):
    names = ["/".join(p) for p in leaf_paths(got)]
    jleaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert names == ["/".join(str(k.key) for k in p) for p, _ in jleaves]
    for name, a, (_, b) in zip(names, leaves(got), jleaves):
        assert a.dtype == torch.float32, name
        assert np.array_equal(a.numpy(), np.asarray(b)), name


def images(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, S, S, 3)).astype(np.float32)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


@pytest.mark.parametrize("layout", ["timm", "timm_as_torch", "timm_headless",
                                    "hf", "hf_bare", "deit_distilled"])
def test_import_bit_equal_to_vitx(layout):
    """Every leaf the port imports is vitx's, bit for bit, from numpy
    arrays and from torch tensors; a headless backbone gets zero heads."""
    distill = layout == "deit_distilled"
    jcfg, tcfg = cfgs(distill, eps=1e-12 if layout.startswith("hf")
                      else 1e-6)
    sd = timm_sd(distill=distill, head=layout != "timm_headless")
    if layout == "timm_as_torch":
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    elif layout.startswith("hf"):
        sd = hf_sd(sd, "" if layout == "hf_bare" else "vit.")
    fmt = "hf" if layout.startswith("hf") else "timm"
    assert tpre.detect_format(sd) == jpre.detect_format(sd) == fmt
    got = tpre.import_pretrained_state_dict(sd, tcfg, device="cpu")
    assert_bit_equal(got, jpre.import_pretrained_state_dict(sd, jcfg))
    if layout == "timm_headless":
        assert not got["head"]["w"].any() and not got["head"]["b"].any()


@pytest.mark.parametrize("layout", ["timm", "hf", "deit_distilled"])
def test_imported_forward_matches_vitx(layout):
    """The imported model's fp32 forward (QKV biases: the composed
    attention; erf GELU; the final norm in the head, and for DeiT in both
    heads, whose logits average) against vitx's on the same import."""
    distill = layout == "deit_distilled"
    jcfg, tcfg = cfgs(distill, eps=1e-12 if layout == "hf" else 1e-6)
    sd = timm_sd(distill=distill)
    if layout == "hf":
        sd = hf_sd(sd)
    x = images()
    want = np.asarray(jforward(jpre.import_pretrained_state_dict(sd, jcfg),
                               x, jcfg))
    got = forward(tpre.import_pretrained_state_dict(sd, tcfg, device="cpu"),
                  x, tcfg, device="cpu").numpy()
    assert rel_err(got, want) <= 1e-4


def test_import_refusals():
    _, tcfg = cfgs()
    sd = timm_sd()
    with pytest.raises(ValueError, match="vit_config_for_pretrained"):
        tpre.import_pretrained_state_dict(
            sd, tcfg.replace(head_type="reference"), device="cpu")
    with pytest.raises(ValueError, match="unrecognized"):
        tpre.detect_format({"foo": np.zeros(1)})
    with pytest.raises(ValueError, match="resize_pos_embed"):
        tpre.import_pretrained_state_dict(
            sd, tcfg.replace(image_size=2 * S), device="cpu")
    with pytest.raises(KeyError, match="dist_token"):
        tpre.import_timm_state_dict(sd, tcfg.replace(distill_token=True),
                                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpre.import_pretrained_state_dict(sd, tcfg)
