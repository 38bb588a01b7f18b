"""The port against the C oracle (``csrc/vitc.c``, ``csrc/trainc.c``), on
the CPU, through ``vitx_torch.interop.cbin``.

As ``tests/test_c_oracle.py`` holds vitx: ``write_model_bin`` writes the
bytes vitx's writes for the same weights and refuses what vitc cannot
run; the port's fp32 forward on a model vitc runs (reference head, erf
GELU and ReLU MLPs, 2 and 4 heads) within 1e-4 of vitc's logits (max
|a - b| over max |b|); and the port's train steps follow trainc's
trajectory: per-step losses within 5e-4 and the final params within
5e-3 relative + 2e-5 absolute, the bars that file uses. Skipped without
``gcc``. The sources are compiled from where they are, into a
temporary directory.
"""

import pathlib
import shutil

import jax
import numpy as np
import pytest
import torch

import vitx_torch
from tests.test_torch_finetune_knobs import init
from vitx.interop import cbin as jcbin
from vitx_torch.core.config import ViTConfig
from vitx_torch.interop import cbin
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).parent.parent / "csrc"

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None,
                                reason="gcc not available")


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    out = tmp_path_factory.mktemp("cbin")
    return (cbin.build_vitc(CSRC / "vitc.c", out / "vitc"),
            cbin.build_vitc(CSRC / "trainc.c", out / "trainc"))


def case(cfg, seed=0, batch=2):
    params = vitx_torch.params_from_jax(init(cfg, seed), cfg, "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch, cfg.image_size, cfg.image_size, cfg.num_channels)).astype(
            np.float32)
    return params, x


@pytest.mark.parametrize("geom", [
    dict(image_size=16, patch_size=4, num_classes=4, embed_dim=32, depth=2,
         num_heads=2, mlp_act="gelu"),
    dict(image_size=32, patch_size=8, num_classes=7, embed_dim=48, depth=3,
         num_heads=4, mlp_act="relu")], ids=["gelu_2heads", "relu_4heads"])
def test_forward_matches_vitc(binaries, tmp_path, geom):
    cfg = ViTConfig(compute_dtype="float32", **geom)
    params, x = case(cfg, seed=3)
    m, i, o = tmp_path / "m.bin", tmp_path / "i.bin", tmp_path / "o.bin"
    cbin.write_model_bin(m, params, cfg)
    ref = tmp_path / "ref.bin"
    jcbin.write_model_bin(ref, jax.tree.map(
        np.asarray, tstep.tree_map(lambda t: t.numpy(), params)), cfg)
    assert m.read_bytes() == ref.read_bytes()
    cbin.write_input_bin(i, torch.from_numpy(x))
    assert "logits[0]:" in cbin.run_vitc(binaries[0], m, i, o)
    c_logits = cbin.read_output_bin(o, 2, cfg.num_classes)
    got = vitx_torch.forward(params, x, cfg, device="cpu").numpy()
    rel = np.abs(got - c_logits).max() / np.abs(c_logits).max()
    assert rel <= 1e-4, rel


def test_train_steps_follow_trainc(binaries, tmp_path):
    """Three AdamW steps of the port's ``train_step`` on one batch against
    trainc's (``tests/test_c_oracle.py``'s case: 16² images, E 16, depth
    2, 2 heads, lr 1e-3, weight decay 1e-4)."""
    cfg = ViTConfig(image_size=16, patch_size=4, num_classes=4, embed_dim=16,
                    depth=2, num_heads=2, compute_dtype="float32",
                    mlp_act="gelu")
    B, steps, lr, wd = 4, 3, 1e-3, 1e-4
    params, x = case(cfg, seed=3, batch=B)
    labels = np.random.default_rng(9).integers(0, 4, B).astype(np.int32)
    m_in, d_bin, m_out = (tmp_path / n for n in ("m.bin", "d.bin", "o.bin"))
    cbin.write_model_bin(m_in, params, cfg)
    cbin.write_train_bin(d_bin, x, labels)
    c_losses = cbin.run_trainc(binaries[1], m_in, d_bin, steps, lr, wd,
                               m_out)
    opt = tstep.make_optimizer(lr=lr, weight_decay=wd)
    state = tstep.TrainState(0, params, opt.init(params))
    losses = []
    for _ in range(steps):
        state, metrics = tstep.train_step(state, {"image": x,
                                                  "label": labels},
                                          cfg=cfg, optimizer=opt,
                                          device="cpu")
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, c_losses, rtol=5e-4)
    ours = tmp_path / "ours.bin"
    cbin.write_model_bin(ours, state.params, cfg)
    np.testing.assert_allclose(cbin.read_model_bin(ours, cfg),
                               cbin.read_model_bin(m_out, cfg),
                               rtol=5e-3, atol=2e-5)


@pytest.mark.parametrize("over,what", [
    ({"head_type": "standard"}, "reference head"),
    ({"qkv_bias": True}, "qkv bias"), ({"final_norm": True}, "final norm"),
    ({"mlp_ratio": 2}, "mlp_ratio"), ({"proj_bias": False}, "projection"),
    ({"qk_norm": True}, "QK-Norm"), ({"mlp_act": "swiglu"}, "MLPs only")])
def test_model_bin_refusals(tmp_path, over, what):
    cfg = ViTConfig(image_size=16, patch_size=4, num_classes=4, embed_dim=32,
                    depth=2, num_heads=2, **over)
    with pytest.raises(ValueError, match=what):
        cbin.write_model_bin(tmp_path / "m.bin", {}, cfg)
