"""The port's forward (vitx_torch) against vitx's, on the CPU.

vitx runs with ``fuse_mha="on", fuse_mlp="on"``, so its Pallas kernels run
in interpret mode; the port runs the same config, where its kernels'
plain versions run, and with both off (the composed path). Weights come
from ``vitx.init_params``, nudged off their init values with
``numpy.random.default_rng`` so that biases and LayerNorm parameters take
part, and are carried across with ``params_from_jax``. Bars: fp32 logits
within 1e-4 relative (``tests/test_parity_torch.py:58``), bf16 within 0.05
(``tests/test_parity_torch.py:80``).
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx_torch.nn.vit import params_to

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
BAR = {"float32": 1e-4, "bfloat16": 0.05}


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def vitx_params(cfg, seed=0):
    """vitx's init, every leaf nudged by N(0, 0.02) noise, as numpy."""
    rng = np.random.default_rng(seed)
    params = vitx.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.02 *
                        rng.standard_normal(a.shape).astype(np.float32),
                        params)


def images(cfg, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, cfg.image_size, cfg.image_size, cfg.num_channels)
    ).astype(np.float32)


CASES = [("tiny", {}), ("base16", {"depth": 2})]


@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset,over", CASES, ids=["tiny", "base16_d2"])
def test_forward_matches_vitx(preset, over, dtype, fuse):
    kw = dict(over, compute_dtype=dtype, fuse_mha=fuse, fuse_mlp=fuse)
    jcfg = vitx.get_config(preset, **kw)
    tcfg = vitx_torch.get_config(preset, **kw)
    pn = vitx_params(jcfg)
    x = images(jcfg)
    ref = np.asarray(vitx.forward(jax.tree.map(jnp.asarray, pn),
                                  jnp.asarray(x), jcfg))
    out = vitx_torch.forward(vitx_torch.params_from_jax(pn, tcfg, "cpu"), x,
                             tcfg, device="cpu")
    assert out.dtype == torch.float32
    assert out.shape == (2, tcfg.num_classes)
    assert rel_err(out.numpy(), ref) < BAR[dtype]


@pytest.mark.parametrize("over", [
    {"proj_bias": False, "mlp_act": "gelu"},
    {"qkv_bias": True, "qk_norm": True, "mlp_act": "relu"},
    {"head_type": "standard", "final_norm": True, "global_pool": "gap"},
    {"mlp_act": "swiglu", "layerscale_init": 0.1},
    {"parity": "bug_exact", "mlp_act": "relu"},
])
def test_forward_variants_match_vitx(over):
    """Features on and off the fused path, fp32, tiny geometry."""
    jcfg = vitx.get_config("tiny", compute_dtype="float32", depth=2, **over)
    tcfg = vitx_torch.get_config("tiny", compute_dtype="float32", depth=2,
                                 **over)
    pn = vitx_params(jcfg, seed=3)
    x = images(jcfg, seed=4)
    ref = np.asarray(vitx.forward(jax.tree.map(jnp.asarray, pn),
                                  jnp.asarray(x), jcfg))
    out = vitx_torch.forward(vitx_torch.params_from_jax(pn, tcfg, "cpu"), x,
                             tcfg, device="cpu")
    assert rel_err(out.numpy(), ref) < BAR["float32"]


def test_forward_matches_torch_reference():
    """The corrected torch reference model (tests/torch_reference.py)
    exported through vitx's layout into the port."""
    from tests.torch_reference import TorchViT, export_to_vitx

    torch.manual_seed(0)
    model = TorchViT(image_size=32, patch_size=8, num_channels=3,
                     num_classes=10, embed_dim=32, depth=2,
                     num_heads=2).eval()
    cfg = vitx_torch.ViTConfig(image_size=32, patch_size=8, num_classes=10,
                               embed_dim=32, depth=2, num_heads=2,
                               mlp_act="relu", compute_dtype="float32")
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        ref = model(x).numpy()
    params = vitx_torch.params_from_jax(export_to_vitx(model, 8, 2), cfg,
                                        "cpu")
    out = vitx_torch.forward(params, x.permute(0, 2, 3, 1).contiguous(),
                             cfg, device="cpu")
    assert rel_err(out.numpy(), ref) < BAR["float32"]


def test_params_from_export_vit_npz(tmp_path):
    """A bare params .npz of flat "a/b/c" keys, as ``vitx.cli.pretrain
    --export-vit`` writes it, gives the logits of the in-memory tree."""
    from vitx.cli.pretrain import _flatten_strs

    jcfg = vitx.get_config("tiny", compute_dtype="float32")
    tcfg = vitx_torch.get_config("tiny", compute_dtype="float32")
    pn = vitx_params(jcfg, seed=5)
    path = tmp_path / "vit.npz"
    np.savez(path, **{"/".join(k): v for k, v in _flatten_strs(pn)})
    x = images(jcfg)
    a = vitx_torch.forward(vitx_torch.params_from_jax(pn, tcfg, "cpu"), x,
                           tcfg, device="cpu")
    b = vitx_torch.forward(vitx_torch.params_from_jax(str(path), tcfg,
                                                      "cpu"),
                           x, tcfg, device="cpu")
    assert torch.equal(a, b)


def test_params_from_jax_checks_the_tree():
    jcfg = vitx.get_config("tiny")
    pn = vitx_params(jcfg)
    with pytest.raises(ValueError):       # a leaf the config lacks
        vitx_torch.params_from_jax(pn, vitx_torch.get_config(
            "tiny", proj_bias=False), "cpu")
    with pytest.raises(ValueError):       # a shape the config does not have
        vitx_torch.params_from_jax(pn, vitx_torch.get_config(
            "tiny", num_classes=5), "cpu")


def test_init_params_tree_matches_vitx():
    jcfg = vitx.get_config("tiny", qkv_bias=True, mlp_act="swiglu")
    tcfg = vitx_torch.get_config("tiny", qkv_bias=True, mlp_act="swiglu")
    jp = vitx.init_params(jax.random.PRNGKey(0), jcfg)
    tp = vitx_torch.init_params(7, tcfg, device="cpu")
    jshapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_leaves_with_path(jp)}
    tshapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_leaves_with_path(params_to(tp, "cpu"))}
    assert tshapes == jshapes
    again = vitx_torch.init_params(torch.Generator().manual_seed(7), tcfg,
                                   device="cpu")
    assert torch.equal(tp["blocks"]["wqkv"], again["blocks"]["wqkv"])
    w = tp["blocks"]["w1"]
    assert float(w.abs().max()) <= 2 * tcfg.init_std
    assert abs(float(w.std()) - 0.88 * tcfg.init_std) < 0.1 * tcfg.init_std


@pytest.mark.parametrize("over,item", [
    ({"stem": "conv"}, "A12"),
    ({"num_registers": 4}, "A12"),
    ({"pos_embed": "rope"}, "A12"),
    ({"moe_experts": 2}, "A12"),
    ({"num_registers": 1, "head_type": "standard"}, "A12"),
    ({"head_type": "map"}, "A12"),
    ({"pos_embed": "sincos2d"}, "A12"),
])
def test_unported_features_raise(over, item):
    """The features the port refused until ROADMAP ``item`` brought them
    now initialise and run: tiny's forward gives finite logits, and a
    depth-2 fp32 train step gives vitx's loss and gradients within 1e-4
    (``test_torch_families.grads_match``)."""
    from test_torch_families import grads_match

    cfg = vitx_torch.get_config("tiny", **over)
    params = vitx_torch.init_params(0, cfg, device="cpu")
    logits = vitx_torch.forward(params, images(cfg), cfg, device="cpu")
    assert logits.shape == (2, 4) and bool(torch.isfinite(logits).all())
    assert item == "A12"
    grads_match(over)


def test_default_device_is_cuda():
    """Entry points default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from vitx_torch.serve import InferenceServer, load_server

    cfg = vitx_torch.get_config("tiny")
    params = vitx_torch.init_params(0, cfg, device="cpu")
    x = images(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        vitx_torch.forward(params, x, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        vitx_torch.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_server(None, cfg)


def test_imports_without_jax():
    """vitx_torch imports with jax made unimportable, and pulls in no part
    of the vitx package; the stratified split runs with scikit-learn made
    unimportable too."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "sys.modules['sklearn'] = None\n"
            "import vitx_torch, vitx_torch.serve, vitx_torch.cli.serve\n"
            "import vitx_torch.train, vitx_torch.data, vitx_torch.metrics\n"
            "import vitx_torch.kernels._build\n"
            "import vitx_torch.data.folder, vitx_torch.data.cifar\n"
            "import vitx_torch.data.shards, vitx_torch.cli.pack\n"
            "import vitx_torch.interop.torch_ref, vitx_torch.nn.flexivit\n"
            "from vitx_torch.data.folder import split_indices\n"
            "labels = [0] * 6 + [1] * 4\n"
            "te = split_indices(labels, train=False, test_size=0.2, "
            "random_state=42)\n"
            "assert len(te) == 2 and sorted(labels[i] for i in te) == "
            "[0, 1], te\n"
            "bad = [m for m in sys.modules if m == 'vitx' or "
            "m.startswith('vitx.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_no_source_imports_jax_or_vitx():
    import ast

    for path in sorted((REPO / "vitx_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "vitx", "flax",
                                    "optax"), f"{path}: imports {name}"
