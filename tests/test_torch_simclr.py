"""SimCLR pretraining in the port (``vitx_torch/nn/simclr.py``) against
vitx's (``vitx/nn/simclr.py``) on the CPU.

At tiny's widths cut to image 32, depth 2, fp32, a projection head of 24
hidden and 12 out: the two views with vitx's draws injected, NT-Xent's
loss and accuracy, the forward (1e-4), every leaf's gradient and the loss
and accuracy through vitx's own step, one step from vitx's AdamW state,
``simclr_to_vit_params``, ``.ckpt`` files both ways and the pretrain CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.nn import simclr as jsim
from vitx.train import checkpoint as jckpt
from vitx.train import step as jstep
from vitx_torch.interop.jax_params import (opt_state_from_jax,
                                           simclr_params_from_jax)
from vitx_torch.nn import simclr as tsim
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import step as tstep

from tests.torch_pretrain_helpers import (LR, TOL, VIEW_TOL, GradCapture,
                                          TagRecorder, adam_step_gap,
                                          adamw_update, configs, draw, flat,
                                          grads_close, images, jtree,
                                          load_vit_init_tree, rel_err, shapes,
                                          t, vitx_view_draws, write_config,
                                          zeros_init)

torch.set_num_threads(1)

HEAD = dict(proj_hidden=24, proj_dim=12)
B = 4


@pytest.fixture(scope="module")
def setup():
    vcfg, tcfg = configs()
    js = jsim.SimCLRConfig(encoder=vcfg, **HEAD)
    ts = tsim.SimCLRConfig(encoder=tcfg, **HEAD)
    params = draw(tsim.simclr_param_spec(ts))
    x = images(B)
    rng = jax.random.PRNGKey(9)
    opt = jstep.make_optimizer(lr=LR, weight_decay=0.05)
    k_view, _ = jax.random.split(jax.random.fold_in(rng, 0))
    views = jax.jit(jsim.simclr_views, static_argnums=2)(
        jnp.asarray(x), k_view, js)
    # vitx's step once, its new params the gradients (GradCapture)
    cap, metrics = jsim.make_simclr_train_step(js, GradCapture())(
        jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jtree(params),
                         opt_state=()), {"image": jnp.asarray(x)}, rng)
    k0, k1 = jax.random.split(k_view)
    draws = [vitx_view_draws(k, js, B, 32, 32, scale=js.crop_scale,
                             solarize=False) for k in (k0, k1)]
    return dict(js=js, ts=ts, params=params, x=x, rng=rng, opt=opt,
                views=np.asarray(views), grads=cap.params, metrics=metrics,
                draws=draws)


def jstate(s):
    jp = jtree(s["params"])
    return jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                            opt_state=s["opt"].init(jp))


def port_params(s):
    return simclr_params_from_jax(s["params"], s["ts"], device="cpu")


def test_config_checks_match_vitx():
    vcfg, tcfg = configs()
    for kw in (dict(temperature=0.0), dict(proj_dim=0)):
        with pytest.raises(ValueError) as jerr:
            jsim.SimCLRConfig(encoder=vcfg, **kw)
        with pytest.raises(ValueError) as terr:
            tsim.SimCLRConfig(encoder=tcfg, **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jsim.SimCLRConfig(encoder=vcfg.replace(num_registers=1))
    with pytest.raises(ValueError) as terr:
        tsim.SimCLRConfig(encoder=tcfg.replace(num_registers=1))
    assert str(terr.value) == str(jerr.value)
    assert tsim.SimCLRConfig(encoder=tcfg).solarize_prob == 0.0


def test_param_tree_is_vitx_tree(setup):
    j = jax.eval_shape(lambda: jsim.init_simclr_params(
        jax.random.PRNGKey(0), setup["js"]))
    assert shapes(tsim.init_simclr_params(0, setup["ts"], device="cpu")) \
        == shapes(j)


def test_views_match_vitx_with_its_draws(setup):
    got = tsim.simclr_views(t(setup["x"]), setup["ts"],
                            draws=setup["draws"])
    assert got.shape == (2 * B, 32, 32, 3)
    assert np.abs(got.numpy() - setup["views"]).max() <= VIEW_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_nt_xent_matches_vitx(seed):
    z = np.random.default_rng(seed).standard_normal((8, 6)).astype(
        np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    if seed:
        z[4:] = z[:4]            # every positive scores highest
    jl, jacc = jsim.nt_xent_loss(jnp.asarray(z), 0.1)
    tl, tacc = tsim.nt_xent_loss(t(z), 0.1)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    assert float(tacc) == float(jacc)
    if seed:
        assert float(tacc) == 1.0


def test_forward_gradients_and_step_match_vitx(setup):
    """The forward on vitx's views (1e-4); the loss, the accuracy and
    every leaf's gradient against vitx's step's (1e-4); one step of the
    port from vitx's AdamW state against vitx's AdamW on its gradients."""
    jp = jtree(setup["params"])
    jz = jax.jit(lambda p, v: jsim.simclr_forward(p, v, setup["js"]))(
        jp, jnp.asarray(setup["views"]))
    tp = port_params(setup)
    with torch.no_grad():
        tz = tsim.simclr_forward(tp, t(setup["views"]), setup["ts"])
    assert rel_err(tz.numpy(), jz) <= TOL

    p = tstep.tree_map(lambda a: a.detach().requires_grad_(), tp)
    z = tsim.simclr_forward(p, tsim.simclr_views(
        t(setup["x"]), setup["ts"], draws=setup["draws"]), setup["ts"])
    loss, acc = tsim.nt_xent_loss(z, setup["ts"].temperature)
    g = torch.autograd.grad(loss, tstep.leaves(p))
    jm = setup["metrics"]
    assert abs(float(loss.detach()) - float(jm["loss"])) <= TOL
    assert float(acc) == float(jm["contrast_acc"])
    tg = dict(zip(flat(p), [x.numpy() for x in g]))
    grads_close(tg, setup["grads"],
                zero=("encoder/final_norm/bias", "head/fc1/bias"))

    js = jstate(setup)
    jparams, _ = adamw_update(setup["opt"])(setup["grads"], js.opt_state,
                                            js.params)
    opt = tstep.make_optimizer(lr=LR, weight_decay=0.05)
    state = tstep.TrainState(0, port_params(setup), opt_state_from_jax(
        js.opt_state, setup["ts"].encoder, "cpu",
        spec=tsim.simclr_param_spec(setup["ts"])))
    state, m = tsim.make_simclr_train_step(setup["ts"], opt, device="cpu")(
        state, {"image": setup["x"]}, draws=setup["draws"])
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL
    assert float(m["contrast_acc"]) == float(jm["contrast_acc"])
    assert rel_err(float(m["grad_norm"]), float(jm["grad_norm"])) <= TOL
    gap = adam_step_gap(tg, flat(setup["grads"]), flat(state.params),
                        flat(jparams))
    assert gap <= 1.0, gap
    assert state.step == 1


def test_to_vit_params_drops_the_projection(setup, monkeypatch):
    zeros_init(monkeypatch)
    vcfg, tcfg = configs()
    jout = jsim.simclr_to_vit_params(jtree(setup["params"]), vcfg,
                                     jax.random.PRNGKey(0))
    tout = tsim.simclr_to_vit_params(port_params(setup), tcfg, 0,
                                     device="cpu")
    jf, tf = flat(jout), flat(tout)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        if not k.startswith("head/"):
            assert np.array_equal(tf[k], jf[k]), k
    assert "fc1" not in tout["head"]


def test_ckpt_both_ways(setup, tmp_path):
    js = jstate(setup)
    jparams, jopt = adamw_update(setup["opt"])(setup["grads"], js.opt_state,
                                               js.params)
    js = js._replace(step=js.step + 1, params=jparams, opt_state=jopt)
    jckpt.save_checkpoint(tmp_path / "j", js, 0, meta={"kind": "simclr"})
    template = tsim.create_simclr_train_state(
        0, setup["ts"], tstep.make_optimizer(), device="cpu")
    state, meta = tckpt.restore_latest(tmp_path / "j", template, False)
    saved = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    ours = tckpt.snapshot(state, False)
    assert len(ours) == len(saved) and meta["kind"] == "simclr"
    for a, b in zip(ours, saved):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tckpt.save_checkpoint(tmp_path / "t", ours, 0, meta={"kind": "simclr"})
    back, _ = jckpt.restore_latest(tmp_path / "t", jstate(setup))
    for a, b in zip(jax.tree_util.tree_leaves(back), saved):
        assert np.array_equal(np.asarray(a), b)


def test_pretrain_cli_simclr(setup, tmp_path, monkeypatch, capsys):
    from vitx_torch.cli import pretrain

    zeros_init(monkeypatch)
    monkeypatch.setattr("vitx_torch.train.logging.ScalarWriter",
                        TagRecorder)
    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    _, tcfg = configs()
    argv = ["--method", "simclr", "--config-json",
            write_config(tmp_path / "cfg.json", tcfg), "--data",
            "procedural:16,8", "--batch-size", "8", "--simclr-dim", "12",
            "--simclr-hidden", "24", "--checkpoint-dir",
            str(tmp_path / "ck"), "--device", "cpu", "--log-dir",
            str(tmp_path / "logs")]
    assert pretrain.main(argv + ["--epochs", "1"]) == 0
    assert pretrain.main(argv + ["--epochs", "2", "--export-vit",
                                 str(tmp_path / "v.npz")]) == 0
    out = capsys.readouterr().out
    assert "resumed SIMCLR pretraining at epoch 1" in out
    assert "epoch 1: simclr_loss" in out and "contrast_acc" in out
    assert ("SimCLR/contrast_acc", 1) in TagRecorder.tags
    tree = load_vit_init_tree(str(tmp_path / "v.npz"), setup["js"].encoder)
    with np.load(tmp_path / "v.npz") as z:
        for k, v in flat(tree).items():
            assert np.array_equal(z[k], v), k
