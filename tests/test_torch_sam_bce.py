"""Sharpness-aware minimization, the multi-label loss and class weights in
the port, on the CPU, against vitx.

SAM (``train_step(sam_rho=...)``): a depth-2 fp32 step against vitx's
jitted step, with and without a freeze policy, and, with dropout and
drop-path on, against the manual two-pass of ``tests/test_sam.py:29-63``
(clean gradients, the ascent point, the second gradients drawn with the
clean pass's masks, the optimizer) bit for bit. The multi-label pieces:
``sigmoid_bce_loss``, ``multilabel_metrics`` and
``SyntheticMultiLabelDataset`` against vitx's (the data bit for bit), both
loaders carrying (B, C) labels, the BCE loss with vitx's mixup draws fed
in and its gradients, a BCE train step's loss and multi-label accuracy,
the refusals vitx makes; the train CLI on ``--data synthetic-ml --loss
bce`` and the eval CLIs' multi-label report on its checkpoint; and
``--class-weights`` parsed as vitx parses it. Bars: fp32 1e-4 (the
repo's), 1e-6 for the loss alone.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.data.synthetic import SyntheticMultiLabelDataset as JMulti
from vitx.metrics.multilabel import multilabel_metrics as jmetrics
from vitx.train import step as jstep
from vitx_torch.data import (BatchLoader, DeviceBatchLoader,
                             SyntheticMultiLabelDataset)
from vitx_torch.metrics import multilabel_metrics
from vitx_torch.nn.vit import param_spec
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

BAR = 1e-4
RHO = 0.05
KW = dict(depth=2, compute_dtype="float32", image_size=32, fuse_mha="off",
          num_classes=5)
JCFG = vitx.get_config("tiny", **KW)
TCFG = vitx_torch.get_config("tiny", **KW)


def model_params(seed=0):
    """vitx-layout weights drawn with numpy from ``param_spec``."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        shape, init = node
        base = (0.02 * rng.standard_normal(shape) if init == "normal"
                else np.full(shape, init))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    return draw(param_spec(TCFG))


def batch(n=4, seed=3, multi=False):
    rng = np.random.default_rng(seed)
    label = (rng.integers(0, 2, (n, 5)) if multi else rng.integers(0, 5, n))
    return {"image": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            "label": label.astype(np.int32)}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


@functools.lru_cache(maxsize=None)
def vitx_step(kind, train_filter=None):
    """vitx's jitted step from ``model_params()`` on ``batch``: SAM, or
    the BCE loss -> (params, metrics) as numpy."""
    opt = jstep.make_optimizer(lr=1e-3, trainable=train_filter)
    params = jax.tree.map(jnp.asarray, model_params())
    state = jstep.TrainState(jnp.int32(0), params, opt.init(params))
    kw = ({"sam_rho": RHO, "train_filter": train_filter} if kind == "sam"
          else {"loss": "bce"})
    b = jax.tree.map(jnp.asarray, batch(multi=kind == "bce"))
    new, m = jax.jit(functools.partial(jstep.train_step, cfg=JCFG,
                                       optimizer=opt, **kw))(state, b, None)
    return (jax.tree.map(np.asarray, new.params),
            {k: float(v) for k, v in m.items()})


def port_step(kind, train_filter=None):
    opt = tstep.make_optimizer(lr=1e-3, trainable=train_filter)
    params = vitx_torch.params_from_jax(model_params(), TCFG, device="cpu")
    state = tstep.TrainState(0, params, opt.init(params))
    kw = ({"sam_rho": RHO, "train_filter": train_filter} if kind == "sam"
          else {"loss": "bce"})
    state, m = tstep.train_step(state, batch(multi=kind == "bce"), cfg=TCFG,
                                optimizer=opt, device="cpu", **kw)
    return (jax.tree.map(lambda t: t.numpy(), state.params),
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("kind,train_filter", [
    ("sam", None), ("sam", "head"), ("bce", None)])
def test_step_matches_vitx(kind, train_filter):
    """One SAM step (clean-pass loss and grad_norm, the update from the
    ascent point's gradients; frozen leaves unchanged under "head") or
    one BCE step (its multi-label accuracy) against vitx's."""
    want, wm = vitx_step(kind, train_filter)
    got, gm = port_step(kind, train_filter)
    for k in ("loss", "grad_norm", "accuracy"):
        assert abs(gm[k] - wm[k]) <= BAR * max(abs(wm[k]), 1e-12), k
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert rel(b, a) <= BAR


def test_sam_two_pass_with_dropout():
    """With dropout and drop-path on, the SAM step equals the manual two
    passes (``tests/test_sam.py:29-63``) bit for bit: the second gradients
    at p + rho g/(|g| + 1e-12) drawn with the clean pass's masks (the
    generator set back), the optimizer fed those, loss and grad_norm the
    clean pass's; the generator ends where the clean pass left it."""
    cfg = TCFG.replace(dropout=0.1, drop_path=0.1)
    opt = tstep.make_optimizer(lr=1e-3)
    b = {k: torch.from_numpy(v) for k, v in batch().items()}

    def fresh():
        p = vitx_torch.params_from_jax(model_params(), cfg, device="cpu")
        return tstep.TrainState(0, p, opt.init(p))

    gen = torch.Generator().manual_seed(11)
    start = gen.get_state()
    state = fresh()
    req = tstep.tree_map(lambda t: t.detach().requires_grad_(),
                         state.params)
    loss, _ = tstep.loss_fn(req, b, cfg, gen)
    g1 = torch.autograd.grad(loss, tstep.leaves(req))
    after_clean = gen.get_state()
    gn = tstep.global_norm(g1)
    scale = RHO / (gn + 1e-12)
    moved = iter([(p + scale * g).requires_grad_()
                  for p, g in zip(tstep.leaves(state.params), g1)])

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        return next(moved)
    adv = rebuild(state.params)
    gen.set_state(start)
    loss2, _ = tstep.loss_fn(adv, b, cfg, gen)
    g2 = torch.autograd.grad(loss2, tstep.leaves(adv))
    manual, _ = opt.update(list(g2), state.opt_state, state.params)

    gen.set_state(start)
    stepped, m = tstep.train_step(fresh(), b, gen, cfg=cfg, optimizer=opt,
                                  device="cpu", sam_rho=RHO)
    assert float(m["loss"]) == float(loss)
    assert float(m["grad_norm"]) == float(gn)
    for x, y in zip(tstep.leaves(stepped.params), tstep.leaves(manual)):
        assert torch.equal(x, y)
    assert torch.equal(gen.get_state(), after_clean)


@pytest.mark.parametrize("masked", [False, True])
def test_sigmoid_bce_matches_vitx(masked):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((6, 7))).astype(np.float32)
    t = rng.random((6, 7)).astype(np.float32)          # soft, as mixed
    mask = np.array([1, 1, 0, 1, 0, 1], np.int32) if masked else None
    want = float(jstep.sigmoid_bce_loss(
        jnp.asarray(logits), jnp.asarray(t),
        None if mask is None else jnp.asarray(mask)))
    got = float(tstep.sigmoid_bce_loss(
        torch.from_numpy(logits), torch.from_numpy(t),
        None if mask is None else torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_multilabel_metrics_match_vitx(seed):
    """Every key, with a class that has no positive (its AP NaN, left out
    of mAP) and tied scores."""
    rng = np.random.default_rng(seed)
    scores = np.round(rng.standard_normal((40, 6)), 1).astype(np.float32)
    targets = (rng.random((40, 6)) < 0.4).astype(np.int32)
    targets[:, 3] = 0
    want, got = jmetrics(scores, targets), multilabel_metrics(scores,
                                                               targets)
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))


def test_multilabel_data_bit_equal_and_loaders():
    """``SyntheticMultiLabelDataset`` equals vitx's bit for bit; both
    loaders give (B, C) labels, the ragged batch's padding rows zero."""
    kw = dict(num_examples=10, image_size=16, num_classes=5, seed=3)
    ds, jds = SyntheticMultiLabelDataset(**kw), JMulti(**kw)
    assert np.array_equal(ds.labels, jds.labels)
    for i in range(len(ds)):
        (a, la), (b, lb) = ds.get_example(i), jds.get_example(i)
        assert np.array_equal(a, b) and np.array_equal(la, lb)
    host = list(BatchLoader(ds, 4))
    dev = list(DeviceBatchLoader(ds, 4, device="cpu"))
    for h, d in zip(host, dev):
        assert h["label"].shape == (4, 5)
        assert np.array_equal(h["label"], d["label"].numpy())
        assert np.array_equal(h["mask"], d["mask"].numpy())
    assert not host[-1]["label"][2:].any() and not dev[-1]["label"][2:].any()


@pytest.mark.parametrize("mode", ["plain", "mixup"])
def test_bce_loss_and_grads_match_vitx(mode):
    """``loss_fn(loss="bce")`` and its gradients against vitx's: mixup
    mixes the multi-hot targets (vitx's permutation and map fed in)."""
    b = batch(multi=True)
    params = model_params()
    key = jax.random.PRNGKey(7)
    kw = {"loss": "bce"}
    mix = None
    if mode == "mixup":
        kw["mixup_alpha"] = 0.4
        _, k_perm, k_mix = jax.random.split(key, 3)
        mix = (np.asarray(jax.random.permutation(k_perm, 4)),
               np.asarray(jstep._mix_weight_map(k_mix, (4, 32, 32, 3), 0.4,
                                                None)))

    def jloss(p):
        return jstep.loss_fn(p, jax.tree.map(jnp.asarray, b), JCFG,
                             key if mix is not None else None, **kw)[0]
    want, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    req = tstep.tree_map(lambda t: t.requires_grad_(),
                         vitx_torch.params_from_jax(params, TCFG, "cpu"))
    got = tstep.loss_fn(req, {k: torch.from_numpy(v) for k, v in b.items()},
                        TCFG, mix=mix, **kw)[0]
    tg = torch.autograd.grad(got, tstep.leaves(req))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    for a, g in zip(jax.tree.leaves(jg), tg):
        assert rel(g.numpy(), a) <= BAR


@pytest.mark.parametrize("kw", [{"label_smoothing": 0.1},
                                {"class_weights": (1.0,) * 5}])
def test_bce_refuses_single_label_knobs(kw):
    b = {k: torch.from_numpy(v) for k, v in batch(multi=True).items()}
    p = vitx_torch.params_from_jax(model_params(), TCFG, "cpu")
    with pytest.raises(ValueError) as te:
        tstep.loss_fn(p, b, TCFG, loss="bce", **kw)
    with pytest.raises(ValueError) as je:
        jstep.loss_fn(jax.tree.map(jnp.asarray, model_params()),
                      jax.tree.map(jnp.asarray, batch(multi=True)), JCFG,
                      None, loss="bce", **kw)
    assert str(te.value) == str(je.value)


def test_multilabel_cli_and_eval(tmp_path, capsys):
    """``train --data synthetic-ml --loss bce`` one epoch at tiny (image
    32): the meta's ``loss_type``, the val mAP logged; both eval CLIs give
    the same multi-label report on its checkpoint (the loss within 1e-4;
    the ranks and the 0.5 decisions alike but for scores within rounding
    of each other or of 0), and refuse the single-label surfaces."""
    from vitx.cli import eval as jeval
    from vitx_torch.cli import eval as teval
    from vitx_torch.cli import train as ttrain
    from vitx_torch.train.checkpoint import peek_meta

    ck = tmp_path / "ck"
    assert ttrain.main(["--data", "synthetic-ml", "--loss", "bce",
                        "--image-size", "32", "--epochs", "1",
                        "--checkpoint-dir", str(ck), "--device", "cpu",
                        "--optimizer", "lion", "--lr", "1e-4"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert 0.0 <= out["val_mAP"] <= 1.0
    meta = peek_meta(ck)
    assert meta["loss_type"] == "bce" and meta["optimizer"] == "lion"
    argv = ["--checkpoint", str(ck), "--data", "synthetic-ml",
            "--batch-size", "128"]
    reports = []
    for main, extra in ((jeval.main, []), (teval.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        reports.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    want, got = reports
    assert sorted(want) == sorted(got)
    assert got["num_examples"] == want["num_examples"] == 512
    assert abs(got["loss"] - want["loss"]) <= BAR * want["loss"]
    # two scores within rounding of each other may swap ranks (AP), and a
    # logit within rounding of 0 take the other 0.5 decision: allow mAP
    # 1e-3 and three of the 512 x 5 decisions to differ
    assert abs(got["mAP"] - want["mAP"]) <= 1e-3
    n = 512 * 5
    assert abs(got["accuracy"] - want["accuracy"]) <= 3 / n + 1e-6
    for k in ("f1_micro", "f1_macro"):
        assert abs(got[k] - want[k]) <= 5e-3, k
    assert got["mAP"] == pytest.approx(out["val_mAP"], abs=1e-6)
    assert teval.main(argv + ["--device", "cpu", "--tta"]) == 1
    assert "--loss bce" in capsys.readouterr().err


def test_class_weights_flag():
    """``--class-weights``: a list, or "balanced" as scikit-learn computes
    it from the train split (vitx's formula); a list of the wrong length
    and ``--loss bce`` with weights refused."""
    from vitx_torch.cli import train as ttrain

    p = ttrain.build_argparser()
    tr, train_loader, _ = ttrain.build_trainer(p.parse_args(
        ["--class-weights", "balanced", "--device", "cpu"]), p)
    labels = train_loader.dataset.labels
    counts = np.bincount(labels, minlength=4)
    want = len(labels) / (4 * np.maximum(counts, 1)).astype(np.float64)
    assert tr.tcfg.class_weights == tuple(float(x) for x in want)
    tr, _, _ = ttrain.build_trainer(p.parse_args(
        ["--class-weights", "1,2,3,4", "--device", "cpu"]), p)
    assert tr.tcfg.class_weights == (1.0, 2.0, 3.0, 4.0)
    with pytest.raises(SystemExit, match="needs 4 comma-separated"):
        ttrain.build_trainer(p.parse_args(
            ["--class-weights", "1,2", "--device", "cpu"]), p)
    with pytest.raises(SystemExit, match="does not compose"):
        ttrain.build_trainer(p.parse_args(
            ["--class-weights", "1,2,3,4", "--loss", "bce", "--device",
             "cpu"]), p)
