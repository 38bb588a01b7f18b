"""The port's explain path against vitx's, on the CPU: ``forward_with_attn``
(full and head-mean probabilities), ``forward_with_rollout`` and
``attention_rollout`` (``grad_cam``: ``tests/test_torch_saliency.py``).

Weights come from ``vitx.init_params``, nudged off their init values with
``numpy.random.default_rng``, and are carried across with
``params_from_jax``. ``attn_impl="flash"`` routes both packages through
the flash-attention forward (vitx's Pallas kernel in interpret mode, the
port's B5 wrappers on their plain versions). Bars: fp32, 1e-4 relative
(``tests/test_parity_torch.py:58``) on logits, probabilities, rollout
weights and heatmaps, on ``tiny`` and on ``large16_384`` (ViT-L/16 at
384², T = 577) cut to depth 2 at batch 1, without and with QKV biases
(with them every block takes the composed path, where the head-mean
probabilities are B5's mean mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch

torch.set_num_threads(1)

BAR = 1e-4


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def setup(preset, batch, seed=0, **over):
    """(vitx cfg, port cfg, vitx params (jax), port params, images)."""
    kw = dict(over, compute_dtype="float32")
    jcfg = vitx.get_config(preset, **kw)
    tcfg = vitx_torch.get_config(preset, **kw)
    rng = np.random.default_rng(seed)
    pn = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.02 *
                      rng.standard_normal(a.shape).astype(np.float32),
                      vitx.init_params(jax.random.PRNGKey(seed), jcfg))
    x = rng.standard_normal((batch, jcfg.image_size, jcfg.image_size,
                             jcfg.num_channels)).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, pn),
            vitx_torch.params_from_jax(pn, tcfg, "cpu"), x)


CASES = {"tiny": ("tiny", 2, {}),
         "large16_384_d2": ("large16_384", 1, {"depth": 2}),
         # the original ViT-L/16's QKV biases: every block takes the
         # composed path, its head-mean probabilities B5's mean mode
         "large16_384_d2_qkv_bias": ("large16_384", 1,
                                     {"depth": 2, "qkv_bias": True})}


@pytest.mark.parametrize("probs_mode", ["full", "mean"])
@pytest.mark.parametrize("case,impl", [("tiny", "auto"), ("tiny", "flash"),
                                       ("large16_384_d2", "flash"),
                                       ("large16_384_d2_qkv_bias", "flash")])
def test_forward_with_attn_matches_vitx(case, impl, probs_mode):
    preset, batch, over = CASES[case]
    jcfg, tcfg, jp, tp, x = setup(preset, batch, attn_impl=impl, **over)
    ref_logits, ref_p = vitx.forward_with_attn(jp, jnp.asarray(x), jcfg,
                                               probs_mode=probs_mode)
    logits, p = vitx_torch.forward_with_attn(tp, x, tcfg,
                                             probs_mode=probs_mode,
                                             device="cpu")
    assert p.shape == ref_p.shape and p.dtype == torch.float32
    assert rel_err(logits.numpy(), ref_logits) <= BAR
    assert rel_err(p.numpy(), ref_p) <= BAR


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("case", ["tiny", "large16_384_d2",
                                  "large16_384_d2_qkv_bias"])
def test_forward_with_rollout_matches_vitx(case, impl):
    preset, batch, over = CASES[case]
    jcfg, tcfg, jp, tp, x = setup(preset, batch, seed=1, attn_impl=impl,
                                  **over)
    ref_logits, ref_w = vitx.forward_with_rollout(jp, jnp.asarray(x), jcfg)
    logits, w = vitx_torch.forward_with_rollout(tp, x, tcfg, device="cpu")
    assert w.shape == (batch, tcfg.num_patches)
    assert rel_err(logits.numpy(), ref_logits) <= BAR
    assert rel_err(w.numpy(), ref_w) <= BAR
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_rollout_bug_exact_and_fused_path_match_vitx():
    """bug_exact parity (the CLS appended, its column dropped) and the
    fused route on the CPU (fuse_mha="on": both packages take the composed
    path for head-mean probabilities, as vitx's interpret mode does)."""
    for over in ({"parity": "bug_exact", "depth": 2},
                 {"fuse_mha": "on", "fuse_mlp": "on", "depth": 2}):
        jcfg, tcfg, jp, tp, x = setup("tiny", 2, seed=2, **over)
        ref_logits, ref_w = vitx.forward_with_rollout(jp, jnp.asarray(x),
                                                      jcfg)
        logits, w = vitx_torch.forward_with_rollout(tp, x, tcfg,
                                                    device="cpu")
        assert rel_err(logits.numpy(), ref_logits) <= BAR
        assert rel_err(w.numpy(), ref_w) <= BAR


@pytest.mark.parametrize("fusion", ["mean", "max", "min"])
@pytest.mark.parametrize("prefix,registers", [(1, 0), (2, 0), (1, 2)])
def test_attention_rollout_matches_vitx(fusion, prefix, registers):
    """The same (depth, B, H, T, T) probabilities into both, and their
    head means as 4-D input."""
    rng = np.random.default_rng(3)
    T = 16 + prefix + registers
    logits = rng.standard_normal((3, 2, 4, T, T)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    kw = dict(head_fusion=fusion, num_prefix_tokens=prefix,
              num_registers=registers)
    ref = vitx.attention_rollout(jnp.asarray(probs), **kw)
    out = vitx_torch.attention_rollout(torch.from_numpy(probs), **kw)
    assert out.shape == (2, 16)
    assert rel_err(out.numpy(), ref) <= BAR
    mean = probs.mean(axis=2)
    assert rel_err(vitx_torch.attention_rollout(torch.from_numpy(mean),
                                                **kw).numpy(),
                   vitx.attention_rollout(jnp.asarray(mean), **kw)) <= BAR
    heat = vitx_torch.nn.rollout.rollout_heatmap(out, 4)
    assert heat.shape == (2, 4, 4) and torch.equal(heat.reshape(2, 16), out)
    with pytest.raises(ValueError):
        vitx_torch.attention_rollout(torch.from_numpy(probs),
                                     head_fusion="median")
