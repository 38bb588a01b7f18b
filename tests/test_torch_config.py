"""vitx_torch.core.config against vitx.core.config: the same presets, JSON
form, defaults and validation."""

import dataclasses
import json

import pytest

import vitx.core.config as jcfg
import vitx_torch.core.config as tcfg


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_json_matches_vitx(name):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    assert tcfg.get_config(name).to_json() == jcfg.get_config(name).to_json()


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_json_round_trip_across_packages(name):
    """A config written by either package loads in the other unchanged."""
    jc = jcfg.get_config(name, compute_dtype="float32", scan_unroll=3,
                         remat="dots", tome_r=(2, 1))
    tc = tcfg.ViTConfig.from_json(jc.to_json())
    assert tc == tcfg.ViTConfig.from_json(tc.to_json())
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    assert tc.tome_r == (2, 1) + (0,) * (tc.depth - 2)


def test_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.ViTConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.ViTConfig)}
    assert tf == jf


@pytest.mark.parametrize("kw", [
    {"image_size": 30, "patch_size": 8},
    {"embed_dim": 10, "num_heads": 3},
    {"mlp_act": "silu"},
    {"pos_embed": "rope", "fuse_mha": "on"},
    {"head_type": "map", "parity": "bug_exact"},
    {"tome_r": 100},
])
def test_post_init_rejects_like_vitx(kw):
    with pytest.raises(ValueError):
        jcfg.ViTConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.ViTConfig(**kw)


def test_dtypes_are_torch():
    import torch

    cfg = tcfg.get_config("base16")
    assert cfg.cdtype() is torch.bfloat16 and cfg.pdtype() is torch.float32
    assert (cfg.seq_len, cfg.head_dim, cfg.mlp_dim) == (197, 64, 3072)
