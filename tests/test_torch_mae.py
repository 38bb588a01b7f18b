"""MAE pretraining in the port (``vitx_torch/nn/mae.py``) against vitx's
(``vitx/nn/mae.py``) on the CPU.

At tiny's widths cut to image 32 (16 patches, 4 visible), depth 2, fp32,
decoder 96 wide x 2 blocks x 3 heads (D 32, the base16 decoder's head
width): the masking with vitx's noise injected (integer outputs exactly
equal), patchify, the forward and loss (1e-4), every leaf's gradient, one
train step from vitx's AdamW state, ``mae_to_vit_params``, ``.ckpt``
files both ways, and the pretrain CLI (resume, ``--export-vit`` read by
vitx's ``load_vit_init``, ``--dp`` refused). Weights are drawn with numpy
in vitx's layout and carried across with ``mae_params_from_jax``.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.nn import mae as jmae
from vitx.train import checkpoint as jckpt
from vitx.train import step as jstep
from vitx_torch.interop.jax_params import (mae_params_from_jax,
                                           opt_state_from_jax)
from vitx_torch.nn import mae as tmae
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import step as tstep

from tests.torch_pretrain_helpers import (LR, TOL, GradCapture, TagRecorder,
                                          adam_step_gap, adamw_update, configs,
                                          draw, zeros_init, flat, grads_close,
                                          images, load_vit_init_tree, rel_err,
                                          shapes, t, jtree, write_config)

torch.set_num_threads(1)

DEC = dict(decoder_dim=96, decoder_depth=2, decoder_heads=3)
B = 4


@pytest.fixture(scope="module")
def setup():
    vcfg, tcfg = configs()
    jm = jmae.MAEConfig(encoder=vcfg, **DEC)
    tm = tmae.MAEConfig(encoder=tcfg, **DEC)
    params = draw(tmae.mae_param_spec(tm))
    jp = jtree(params)
    opt = jstep.make_optimizer(lr=LR, weight_decay=0.05)
    x = images(B)
    rng = jax.random.PRNGKey(7)
    # the key vitx's step gives the forward at step 0, and the masking
    # noise mae_forward draws from it
    fwd = jax.random.fold_in(rng, 0)
    r_mask, _ = jax.random.split(jax.random.fold_in(fwd, 0))
    noise = np.asarray(jax.random.uniform(r_mask, (B, tm.num_patches)))
    # vitx's step once: its loss, grad_norm and gradients
    grad_step = jmae.make_mae_train_step(jm, GradCapture())
    grads, metrics = grad_step(jstep.TrainState(
        step=jnp.zeros((), jnp.int32), params=jtree(params), opt_state=()),
        {"image": jnp.asarray(x)}, rng)
    return dict(jm=jm, tm=tm, params=params, opt=opt, x=x,
                rng=rng, fwd=fwd, noise=noise, metrics=metrics,
                grads=grads.params)


def jstate(s):
    """A fresh vitx state (vitx's jitted step donates its argument)."""
    jp = jtree(s["params"])
    return jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                            opt_state=s["opt"].init(jp))


def port_params(s):
    return mae_params_from_jax(s["params"], s["tm"], device="cpu")


def test_config_checks_match_vitx():
    vcfg, tcfg = configs()
    bad = [dict(mask_ratio=1.0), dict(decoder_dim=100, decoder_heads=3)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            jmae.MAEConfig(encoder=vcfg, **kw)
        with pytest.raises(ValueError) as terr:
            tmae.MAEConfig(encoder=tcfg, **kw)
        assert str(terr.value) == str(jerr.value)
    m = tmae.MAEConfig(encoder=tcfg, **DEC)
    j = jmae.MAEConfig(encoder=vcfg, **DEC)
    assert (m.num_patches, m.num_visible, m.patch_dim) == (
        j.num_patches, j.num_visible, j.patch_dim)
    assert m.decoder_cfg.to_json() == j.decoder_cfg.to_json()
    with pytest.raises(ValueError, match="learned"):
        tmae.init_mae_params(0, tmae.MAEConfig(
            encoder=tcfg.replace(pos_embed="sincos2d")), device="cpu")


def test_param_tree_is_vitx_tree(setup):
    j = jax.eval_shape(lambda: jmae.init_mae_params(jax.random.PRNGKey(0),
                                                    setup["jm"]))
    got = tmae.init_mae_params(0, setup["tm"], device="cpu")
    assert shapes(got) == shapes(j)


def test_masking_equals_vitx_with_its_noise(setup):
    rng = jax.random.PRNGKey(3)
    jk, jr, jmask = jmae.random_masking(rng, B, setup["jm"])
    noise = jax.random.uniform(rng, (B, setup["tm"].num_patches))
    tk, tr, tmask = tmae.random_masking(None, B, setup["tm"], t(noise))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask.sum(dim=1).tolist() == [setup["tm"].num_masked] * B


def test_patchify_round_trip(setup):
    enc = setup["tm"].encoder
    x = images(2)
    p = tmae.patchify_pixels(t(x), enc)
    assert np.array_equal(p.numpy(), np.asarray(
        jmae.patchify_pixels(jnp.asarray(x), setup["jm"].encoder)))
    assert torch.equal(tmae.unpatchify_pixels(p, enc), t(x))


@pytest.mark.parametrize("norm_pix", [True, False])
def test_forward_and_loss_match_vitx(setup, norm_pix):
    jm = dataclasses.replace(setup["jm"], norm_pix_loss=norm_pix)
    tm = dataclasses.replace(setup["tm"], norm_pix_loss=norm_pix)
    jl, jpred, jmask = jax.jit(functools.partial(
        jmae.mae_forward, mcfg=jm, deterministic=True))(
        jtree(setup["params"]), jnp.asarray(setup["x"]), rng=setup["fwd"])
    with torch.no_grad():
        tl, tpred, tmask = tmae.mae_forward(
            port_params(setup), t(setup["x"]), tm, deterministic=True,
            noise=t(setup["noise"]))
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    assert rel_err(tpred.numpy(), jpred) <= TOL
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))


def test_gradients_and_step_match_vitx(setup):
    """Every leaf's gradient (1e-4 of the leaf's largest), then one step
    from vitx's AdamW state, held to the Adam step's allowance, and the
    state's moments and count."""
    jl, jg = setup["metrics"]["loss"], setup["grads"]
    p = tstep.tree_map(lambda a: a.detach().requires_grad_(),
                       port_params(setup))
    tl, _ = tmae.mae_loss_fn(p, {"image": t(setup["x"])}, setup["tm"],
                             noise=t(setup["noise"]))
    g = torch.autograd.grad(tl, tstep.leaves(p))
    tg = dict(zip(flat(p), [x.numpy() for x in g]))
    assert abs(float(tl.detach()) - float(jl)) <= TOL * abs(float(jl))
    grads_close(tg, jg)

    # the step: vitx's AdamW on those gradients against the port's step
    # from vitx's state
    js = jstate(setup)
    jparams, jopt = adamw_update(setup["opt"])(jg, js.opt_state, js.params)
    js, jm = js._replace(step=js.step + 1, params=jparams,
                         opt_state=jopt), setup["metrics"]
    opt = tstep.make_optimizer(lr=LR, weight_decay=0.05)
    tparams = port_params(setup)
    state = tstep.TrainState(0, tparams, opt_state_from_jax(
        setup["opt"].init(jtree(setup["params"])), setup["tm"].encoder,
        "cpu", spec=tmae.mae_param_spec(setup["tm"])))
    state, m = tmae.make_mae_train_step(setup["tm"], opt, device="cpu")(
        state, {"image": setup["x"]}, noise=t(setup["noise"]))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL
    assert rel_err(float(m["grad_norm"]), float(jm["grad_norm"])) <= TOL
    gap = adam_step_gap(tg, flat(jg), flat(state.params), flat(js.params))
    assert gap <= 1.0, gap
    assert state.step == int(js.step) == 1
    assert state.opt_state.count == 1


def test_to_vit_params_carries_the_encoder(setup, monkeypatch):
    zeros_init(monkeypatch)
    vcfg, tcfg = configs()
    jout = jmae.mae_to_vit_params(jtree(setup["params"]), vcfg,
                                  jax.random.PRNGKey(0))
    tout = tmae.mae_to_vit_params(port_params(setup), tcfg, 0, device="cpu")
    jf, tf = flat(jout), flat(tout)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        if not k.startswith("head/"):
            assert np.array_equal(tf[k], jf[k]), k
        assert tf[k].shape == jf[k].shape
    with pytest.raises(ValueError, match="final_norm"):
        tmae.mae_to_vit_params(port_params(setup),
                               tcfg.replace(final_norm=False), 0,
                               device="cpu")


def test_ckpt_both_ways(setup, tmp_path):
    """vitx's MAE ``.ckpt`` read by the port, leaf for leaf, and the
    port's written back bit for bit and read by vitx."""
    js = jstate(setup)
    jparams, jopt = adamw_update(setup["opt"])(setup["grads"], js.opt_state,
                                               js.params)
    js = js._replace(step=js.step + 1, params=jparams, opt_state=jopt)
    jckpt.save_checkpoint(tmp_path / "j", js, 0,
                          meta={"epoch": 0, "kind": "mae"})
    opt = tstep.make_optimizer(lr=LR, weight_decay=0.05)
    template = tmae.create_mae_train_state(0, setup["tm"], opt,
                                           device="cpu")
    state, meta = tckpt.restore_latest(tmp_path / "j", template, False)
    assert meta["kind"] == "mae" and state.step == 1
    saved = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    ours = tckpt.snapshot(state, False)
    assert len(ours) == len(saved)
    for a, b in zip(ours, saved):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tckpt.save_checkpoint(tmp_path / "t", ours, 0, meta={"kind": "mae"})
    back, _ = jckpt.restore_latest(tmp_path / "t", jstate(setup))
    for a, b in zip(jax.tree_util.tree_leaves(back), saved):
        assert np.array_equal(np.asarray(a), b)


def test_pretrain_cli_mae(setup, tmp_path, monkeypatch, capsys):
    """Two epochs, a resume to a third, the export read by vitx's
    ``load_vit_init`` (every leaf from the file); ``--dp`` refused."""
    from vitx_torch.cli import pretrain

    zeros_init(monkeypatch)
    monkeypatch.setattr("vitx_torch.train.logging.ScalarWriter",
                        TagRecorder)
    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    _, tcfg = configs()
    conf = write_config(tmp_path / "cfg.json", tcfg)
    argv = ["--config-json", conf, "--data", "procedural:32,8",
            "--batch-size", "8", "--log-every", "4", "--decoder-dim", "96", "--decoder-depth",
            "2", "--decoder-heads", "3", "--checkpoint-dir",
            str(tmp_path / "ck"), "--device", "cpu", "--log-dir",
            str(tmp_path / "logs")]
    assert pretrain.main(argv + ["--epochs", "2"]) == 0
    assert pretrain.main(argv + ["--epochs", "3", "--export-vit",
                                 str(tmp_path / "v.npz")]) == 0
    out = capsys.readouterr().out
    assert "resumed MAE pretraining at epoch 2" in out
    assert "epoch 2: mae_loss" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert sorted(last) == ["epoch", "images_per_sec", "loss"]
    assert last["epoch"] == 2 and np.isfinite(last["loss"])
    assert TagRecorder.tags == [("Loss/pretrain_batch", 12),
                                ("Loss/pretrain_epoch", 2)]
    assert tckpt.list_checkpoints(tmp_path / "ck") == [0, 1, 2]
    assert tckpt.peek_meta(tmp_path / "ck")["kind"] == "mae"
    tree = load_vit_init_tree(str(tmp_path / "v.npz"),
                              setup["jm"].encoder)
    with np.load(tmp_path / "v.npz") as z:
        for k, v in flat(tree).items():
            assert np.array_equal(z[k], v), k
    with pytest.raises(SystemExit, match="divisible by --dp 3"):
        pretrain.main(argv + ["--dp", "3"])
