"""High-resolution fine-tuning in the port against vitx, on the CPU.

The recipe: a checkpoint exported at one image size is read into a config
of a larger one, its positional grid resized bilinearly, and trained
there. At T > 1024 vitx's attention backward is its q-chunked kernel
``_bwd_kernel`` (B6); the port's ``attention_bwd`` takes every T. Held
here, on the same inputs from ``numpy.random.default_rng``, with vitx's
Pallas kernels in interpret mode (the CPU backend ``tests/conftest.py``
sets) and the port's plain versions:

- ``attention_bwd`` against vitx's ``_bwd`` at T 1025 and 1100, which it
  sends to B6 (T padded to 1152, dk and dv accumulated over query chunks);
- ``resize_pos_embed`` against vitx's ``interop.pretrained`` one, growing
  and shrinking the grid (``jax.image.resize`` antialiases a shrink);
- ``params_from_jax`` of an exported ``.npz`` against vitx's
  ``load_vit_init``: the same leaves, the same resized table, the same
  fresh-init leaves and warnings;
- one fine-tune step of a T = 1025 model (256² in patches of 8, E 64, two
  heads of D 32, depth 2, fp32) from a 128² export, on both of vitx's
  routes: ``fuse_mha="on"`` (the fused block, whose VJP runs B6) and
  ``attn_impl="flash", fuse_mha="off"`` (the composed path: B5 forward,
  B6 backward).

Bars, as max |a - b| over max |b|: fp32 1e-4 (the repo's parity bar) for
the backward, losses and gradients; bf16 1e-2, as in
``tests/test_torch_grad.py``. The resized tables agree within 1e-5
(measured ~8e-7: both resize in fp32, in another order). Params after a
step within 5 % of lr, as in ``tests/test_torch_train.py``.
"""

import functools
import importlib
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.cli.pretrain import _flatten_strs, load_vit_init
from vitx.interop import pretrained as jpretrained
from vitx.kernels import flash_attention as jflash
from vitx.train import step as jstep
from vitx_torch import params_from_jax, resize_pos_embed
from vitx_torch.data import SyntheticDataset
from vitx_torch.kernels import attention_bwd
from vitx_torch.train import step as tstep

# the module (the package's attribute of that name is the function)
tflash = importlib.import_module("vitx_torch.kernels.flash_attention")

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
LR = 1e-3
PARAM_BAR = 0.05 * LR
# the T = 1025 model and its 128² export (T 257)
MODEL = dict(patch_size=8, embed_dim=64, num_heads=2, depth=2,
             num_classes=4, compute_dtype="float32")
ROUTES = {"fused": dict(fuse_mha="on"),
          "flash": dict(attn_impl="flash", fuse_mha="off")}


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def f32(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


def flat(tree, prefix=""):
    """{"a/b": float32 numpy} of a nested dict of arrays or tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = f32(v)
    return out


def export(cfg, path, seed=0, **override):
    """vitx params of ``cfg`` written as ``--export-vit`` writes them,
    with ``override`` replacing leaves by flat key."""
    params = vitx.init_params(jax.random.PRNGKey(seed), cfg)
    leaves = {"/".join(p): np.asarray(a) for p, a in _flatten_strs(params)}
    np.savez(path, **dict(leaves, **override))
    return leaves


def load_both(path, jcfg, tcfg):
    """(vitx's load_vit_init, the port's params_from_jax) of ``path``,
    each with its warnings' messages."""
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jp = load_vit_init(str(path), jcfg, jax.random.PRNGKey(1))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tp = params_from_jax(str(path), tcfg, device="cpu")
    return (jp, [str(w.message) for w in jw]), (tp, [str(w.message)
                                                     for w in tw])


def fresh_keys(messages):
    for m in messages:
        found = re.search(r"fresh init kept for \[(.*?)\]", m)
        if found:
            return sorted(re.findall(r"'([^']+)'", found.group(1)))
    return []


def resized(messages):
    return [re.search(r"pos_embed resized from \d+ to \d+ positions "
                      r"\(grid \d+x\d+\)", m).group(0)
            for m in messages if "resized" in m]


# --- B6: the attention backward past T = 1024 -------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 1025, 32), (1, 2, 1100, 16)],
                         ids=["T1025", "T1100"])
def test_attention_bwd_matches_q_chunked_pallas(shape, dtype):
    rng = np.random.default_rng(5)
    arrs = [(1.5 * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(3)]
    arrs.append((0.1 * rng.standard_normal(shape)).astype(np.float32))
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    ref = jflash._bwd(tuple(jx[:3]), jx[3])
    n = attention_bwd.launches
    out = attention_bwd(*tx)
    assert attention_bwd.launches == n        # CPU tensors: no launch
    for o, r in zip(out, ref):
        assert o.dtype == tx[0].dtype and o.shape == tx[0].shape
        assert rel_err(f32(o), f32(r)) <= TOL[dtype]


# --- the positional table ---------------------------------------------------

@pytest.mark.parametrize("grids,distill", [((16, 32), False),
                                           ((14, 32), False),
                                           ((24, 14), False),
                                           ((14, 32), True)],
                         ids=["16to32", "14to32", "24to14",
                              "14to32_distill"])
def test_resize_pos_embed_matches_vitx(grids, distill):
    """The grid grows (plain bilinear) or shrinks (antialiased); the
    prefix rows, CLS and with ``distill_token`` DIST, pass through."""
    cfgs = [(vitx.get_config("tiny", image_size=8 * g, distill_token=distill),
             vitx_torch.get_config("tiny", image_size=8 * g,
                                   distill_token=distill)) for g in grids]
    (jfrom, tfrom), (jto, tto) = cfgs
    rng = np.random.default_rng(sum(grids))
    pe = rng.standard_normal((1, jfrom.pos_len, jfrom.embed_dim)).astype(
        np.float32)
    ref = jpretrained.resize_pos_embed({"pos_embed": pe, "x": 1}, jfrom,
                                       jto)
    out = resize_pos_embed({"pos_embed": torch.from_numpy(pe), "x": 1},
                           tfrom, tto)
    assert out["x"] == 1 and out["pos_embed"].dtype == torch.float32
    assert out["pos_embed"].shape == ref["pos_embed"].shape == (
        1, tto.pos_len, tto.embed_dim)
    n = tto.num_prefix_tokens
    assert torch.equal(out["pos_embed"][:, :n], torch.from_numpy(pe[:, :n]))
    assert rel_err(f32(out["pos_embed"]), ref["pos_embed"]) <= 1e-5


@pytest.mark.parametrize("case", ["grid", "bug_exact", "non_square",
                                  "width"])
def test_params_from_npz_match_load_vit_init(case, tmp_path):
    """A 64² tiny export read into a 128² config with 10 classes: every
    leaf read from the file equal, pos_embed resized as vitx resizes it
    (``grid``) or kept fresh (``bug_exact``, a ``non_square`` table, a
    table of another ``width``), the head's fresh leaves and the warnings
    alike."""
    kw = dict(parity="bug_exact") if case == "bug_exact" else {}
    jsrc = vitx.get_config("tiny", **kw)
    path = tmp_path / "vit64.npz"
    pe = None
    if case == "non_square":
        pe = np.zeros((1, 1 + 50, jsrc.embed_dim), np.float32)
    elif case == "width":
        pe = np.zeros((1, jsrc.pos_len, 2 * jsrc.embed_dim), np.float32)
    saved = export(jsrc, path, **({} if pe is None else {"pos_embed": pe}))
    jcfg = vitx.get_config("tiny", image_size=128, num_classes=10, **kw)
    tcfg = vitx_torch.get_config("tiny", image_size=128, num_classes=10,
                                 **kw)
    (jp, jw), (tp, tw) = load_both(path, jcfg, tcfg)
    jflat, tflat = flat(jp), flat(tp)
    assert sorted(jflat) == sorted(tflat)
    fresh = fresh_keys(tw)
    assert fresh == fresh_keys(jw)
    assert resized(tw) == resized(jw)
    assert ("pos_embed" in fresh) == (case != "grid")
    assert {"head/w2", "head/b2"} <= set(fresh)
    for key, leaf in tflat.items():
        assert leaf.shape == jflat[key].shape, key
        if key == "pos_embed" and case == "grid":
            assert resized(tw) == [f"pos_embed resized from 65 to 257 "
                                   f"positions (grid 16x16)"]
            assert rel_err(leaf, jflat[key]) <= 1e-5
        elif key not in fresh:
            np.testing.assert_array_equal(leaf, saved[key], err_msg=key)
            np.testing.assert_array_equal(leaf, jflat[key], err_msg=key)


# --- the fine-tune step at T = 1025 -----------------------------------------

@pytest.fixture(scope="module")
def export_128(tmp_path_factory):
    path = tmp_path_factory.mktemp("finetune") / "vit128.npz"
    export(vitx.get_config("tiny", image_size=128, **MODEL), path)
    return path


@pytest.fixture(scope="module", params=list(ROUTES))
def finetune(request, export_128):
    """The 128² export read into the 256² model by each package; vitx's
    loss and gradients on one batch, and its state after one step."""
    kw = dict(MODEL, image_size=256, **ROUTES[request.param])
    jcfg = vitx.get_config("tiny", **kw)
    tcfg = vitx_torch.get_config("tiny", **kw)
    assert jcfg.seq_len == tcfg.seq_len == 1025
    (jp, _), (tp, tw) = load_both(export_128, jcfg, tcfg)
    assert resized(tw) == ["pos_embed resized from 257 to 1025 positions "
                           "(grid 32x32)"] and fresh_keys(tw) == []
    ds = SyntheticDataset(num_examples=2, image_size=256, num_classes=4)
    ex = [ds.get_example(i) for i in range(2)]
    batch = {"image": np.stack([e[0] for e in ex]),
             "label": np.array([e[1] for e in ex], np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        functools.partial(jstep.loss_fn, cfg=jcfg, rng=None),
        has_aux=True))(jp, jb)
    opt = jstep.make_optimizer(lr=LR)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                             opt_state=opt.init(jp))
    state, m = jax.jit(functools.partial(jstep.train_step, cfg=jcfg,
                                         optimizer=opt))(state, jb, None)
    return dict(cfg=tcfg, params=tp, batch=batch, loss=float(loss),
                grads=flat(grads), step_metrics={k: float(v) for k, v in
                                                 m.items()},
                step_params=flat(state.params))


def test_finetune_grads_match_vitx(finetune, monkeypatch):
    """The loss and every gradient at T = 1025; the backward reaches the
    attention backward once a block (its plain version, on the CPU)."""
    calls = []
    plain = tflash.attention_bwd_plain
    monkeypatch.setattr(tflash, "attention_bwd_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    cfg = finetune["cfg"]
    p = tstep.tree_map(lambda t: t.detach().clone().requires_grad_(),
                       finetune["params"])
    tb = {k: torch.from_numpy(v) for k, v in finetune["batch"].items()}
    loss, _ = tstep.loss_fn(p, tb, cfg)
    grads = torch.autograd.grad(loss, tstep.leaves(p))
    assert calls == [(2, 2, 1025, 32)] * cfg.depth
    assert rel_err(float(loss.detach()), finetune["loss"]) <= 1e-4
    ref = finetune["grads"]
    keys = list(flat(p))          # sorted at every level: leaves' order
    assert sorted(keys) == sorted(ref)
    for key, g in zip(keys, grads):
        assert rel_err(f32(g), ref[key]) <= 1e-4, key


def test_finetune_step_matches_vitx(finetune):
    """One train_step of the port from the same export: loss and
    grad_norm within 1e-4, every param within 5 % of lr of vitx's."""
    cfg = finetune["cfg"]
    params = tstep.tree_map(lambda t: t.detach().clone(), finetune["params"])
    opt = tstep.make_optimizer(lr=LR)
    state, m = tstep.train_step(tstep.TrainState(0, params, opt.init(params)),
                                finetune["batch"], cfg=cfg, optimizer=opt,
                                device="cpu")
    assert state.step == 1
    for k in ("loss", "grad_norm"):
        assert rel_err(float(m[k]), finetune["step_metrics"][k]) <= 1e-4, k
    ref = finetune["step_params"]
    for key, v in flat(state.params).items():
        assert np.abs(v - ref[key]).max() <= PARAM_BAR, key
