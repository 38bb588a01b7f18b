"""The port's Grad-CAM (``vitx_torch.grad_cam``) against vitx's, on the
CPU: the default (argmax) class, one class, a class per image, bug_exact
parity and a final norm with a standard head, and out-of-range classes.
Weights and images as in ``tests/test_torch_explain.py``; bar: fp32, 1e-4
relative on logits and heatmaps, on ``tiny`` and on ``large16_384`` cut to
depth 2 at batch 1.
"""

import jax.numpy as jnp
import pytest
import torch

import vitx
import vitx_torch
from tests.test_torch_explain import BAR, CASES, rel_err, setup

torch.set_num_threads(1)


@pytest.mark.parametrize("class_idx", [None, 1, [3, 0]],
                         ids=["argmax", "int", "per_image"])
@pytest.mark.parametrize("case", ["tiny", "large16_384_d2"])
def test_grad_cam_matches_vitx(case, class_idx):
    preset, batch, over = CASES[case]
    if case == "large16_384_d2" and isinstance(class_idx, list):
        class_idx = class_idx[:1]
    jcfg, tcfg, jp, tp, x = setup(preset, batch, seed=4, **over)
    ref_cam, ref_logits = vitx.grad_cam(jp, jnp.asarray(x), jcfg,
                                        class_idx=class_idx)
    cam, logits = vitx_torch.grad_cam(tp, x, tcfg, class_idx=class_idx,
                                      device="cpu")
    assert cam.shape == (batch, tcfg.num_patches)
    assert float(cam.min()) >= 0.0
    assert rel_err(logits.numpy(), ref_logits) <= BAR
    assert rel_err(cam.numpy(), ref_cam) <= BAR


def test_grad_cam_variants_and_bad_class():
    """bug_exact parity (patches first) and a final norm with a standard
    head match vitx; a class out of range raises in both."""
    for over in ({"parity": "bug_exact", "depth": 2},
                 {"final_norm": True, "head_type": "standard", "depth": 1}):
        jcfg, tcfg, jp, tp, x = setup("tiny", 2, seed=5, **over)
        ref_cam, _ = vitx.grad_cam(jp, jnp.asarray(x), jcfg, class_idx=2)
        cam, _ = vitx_torch.grad_cam(tp, x, tcfg, class_idx=2, device="cpu")
        assert rel_err(cam.numpy(), ref_cam) <= BAR
    for bad in (4, -1, [0, 7]):
        with pytest.raises(ValueError):
            vitx.grad_cam(jp, jnp.asarray(x), jcfg, class_idx=bad)
        with pytest.raises(ValueError, match="out of range"):
            vitx_torch.grad_cam(tp, x, tcfg, class_idx=bad, device="cpu")
