"""DINO pretraining in the port (``vitx_torch/nn/dino.py``) against
vitx's (``vitx/nn/dino.py``) on the CPU.

At tiny's widths cut to image 32, depth 2, fp32, locals of 16 (the 4 x 4
grid resized to 2 x 2), 2 local crops, a head of 32 hidden, 16
bottleneck, 32 prototypes: the in-graph positional resize and its
gradient at 8 -> 4 and 8 -> 3 (1e-6), the blur and the multi-crop views
with vitx's draws injected, the forwards (1e-4), every leaf's gradient
on vitx's crops, two steps from vitx's state (the first with the
prototypes frozen: gradient zeroed and weights pinned), the teacher's
EMA, the centre and the entropy monitor, ``dino_to_vit_params``,
``.ckpt`` files of the ``DINOState`` both ways, and the pretrain CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.nn import dino as jdino
from vitx.train import checkpoint as jckpt
from vitx.train import step as jstep
from vitx_torch.interop.jax_params import (dino_params_from_jax,
                                           dino_state_from_jax)
from vitx_torch.nn import dino as tdino
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import step as tstep

from tests.torch_pretrain_helpers import (LR, TOL, VIEW_TOL, TagRecorder,
                                          adam_step_gap, configs, draw, flat,
                                          grads_close, images, jtree,
                                          load_vit_init_tree, rel_err, shapes,
                                          t, vitx_view_draws, write_config,
                                          zeros_init)

torch.set_num_threads(1)

HEAD = dict(local_size=16, n_local=2, out_dim=32, head_hidden=32,
            head_bottleneck=16)
B = 2
TOTAL = 4          # the momentum schedule's horizon


@pytest.fixture(scope="module")
def setup():
    vcfg, tcfg = configs()
    jd = jdino.DINOConfig(encoder=vcfg, **HEAD)
    td = tdino.DINOConfig(encoder=tcfg, **HEAD)
    spec = tdino.dino_param_spec(td)
    params, teacher = draw(spec, 0), draw(spec, 1)
    center = (0.1 * np.random.default_rng(2).standard_normal(
        HEAD["out_dim"])).astype(np.float32)
    x = images(B)
    rng = jax.random.PRNGKey(5)
    opt = jstep.make_optimizer(lr=LR, weight_decay=0.05, grad_clip=3.0)

    def state(o):
        jp = jtree(params)
        return jdino.DINOState(step=jnp.zeros((), jnp.int32), params=jp,
                               opt_state=o.init(jp), teacher=jtree(teacher),
                               center=jnp.asarray(center))

    # vitx's crops of step 0, and its loss's value and gradients on them
    k_crop, k_drop = jax.random.split(jax.random.fold_in(rng, 0))
    crops = jax.jit(jdino.multi_crop, static_argnums=2)(
        jnp.asarray(x), k_crop, jd)

    def loss(p, g, l):
        s_all = jnp.concatenate([
            jdino.dino_forward(p, g, jd).reshape(2, B, -1),
            jdino.dino_forward(p, l, jd).reshape(jd.n_local, B, -1)])
        t_g = jdino.dino_forward(jtree(teacher), g, jd).reshape(2, B, -1)
        return jdino.dino_loss(s_all, t_g, jnp.asarray(center), jd)

    (jl, jprobs), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jtree(params), *crops)
    # vitx's real step twice: the prototypes frozen for the first
    step = jdino.make_dino_train_step(jd, opt, TOTAL, freeze_last_steps=1)
    s0, m0 = step(state(opt), {"image": jnp.asarray(x)}, rng)
    host0 = jax.tree.map(np.asarray, s0)
    s1, m1 = step(s0, {"image": jnp.asarray(x)}, rng)
    return dict(jd=jd, td=td, params=params, teacher=teacher,
                center=center, x=x, rng=rng, opt=opt, state=state,
                crops=[np.asarray(c) for c in crops], loss=float(jl),
                probs=np.asarray(jprobs), grads=jgrads, s0=host0, m0=m0,
                s1=jax.tree.map(np.asarray, s1), m1=m1)


def step_draws(s, step):
    """The draws of vitx's step ``step``'s views, from its key tree."""
    k_crop, _ = jax.random.split(jax.random.fold_in(s["rng"], step))
    keys = jax.random.split(k_crop, s["jd"].n_views)
    jd = s["jd"]
    return [vitx_view_draws(keys[v], jd, B, 32, 32,
                            scale=jd.global_scale if v < 2 else
                            jd.local_scale, solarize=v == 1)
            for v in range(jd.n_views)]


def test_config_checks_match_vitx():
    vcfg, tcfg = configs()
    bad = [dict(local_size=20), dict(local_size=32), dict(teacher_temp=0.0),
           dict(momentum=1.5), dict(local_size=16, out_dim=0)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            jdino.DINOConfig(encoder=vcfg, **kw)
        with pytest.raises(ValueError) as terr:
            tdino.DINOConfig(encoder=tcfg, **kw)
        assert str(terr.value) == str(jerr.value)
    for over in (dict(num_registers=2), dict(parity="bug_exact")):
        with pytest.raises(ValueError) as jerr:
            jdino.DINOConfig(encoder=vcfg.replace(**over), local_size=16)
        with pytest.raises(ValueError) as terr:
            tdino.DINOConfig(encoder=tcfg.replace(**over), local_size=16)
        assert str(terr.value) == str(jerr.value)


def test_param_tree_is_vitx_tree(setup):
    j = jax.eval_shape(lambda: jdino.init_dino_params(
        jax.random.PRNGKey(0), setup["jd"]))
    got = tdino.init_dino_params(0, setup["td"], device="cpu")
    assert shapes(got) == shapes(j)
    state = tdino.create_dino_train_state(0, setup["td"],
                                          tstep.make_optimizer(),
                                          device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tstep.leaves(state.teacher), tstep.leaves(state.params)))
    assert state.center.shape == (32,) and not state.center.any()


@pytest.mark.parametrize("grid_to", [4, 3])
def test_resized_pos_embed_and_its_gradient(grid_to):
    """The antialiased bilinear shrink of an 8 x 8 grid and its VJP
    against ``jax.image.resize``'s (1e-6)."""
    rng = np.random.default_rng(grid_to)
    pos = rng.standard_normal((1, 65, 6)).astype(np.float32)
    cot = rng.standard_normal((1, grid_to ** 2 + 1, 6)).astype(np.float32)
    jout, vjp = jax.vjp(lambda p: jdino._resized_pos_embed(p, 8, grid_to),
                        jnp.asarray(pos))
    (jgrad,) = vjp(jnp.asarray(cot))
    p = t(pos).requires_grad_()
    out = tdino._resized_pos_embed(p, 8, grid_to)
    (grad,) = torch.autograd.grad(out, p, t(cot))
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() <= 1e-6
    assert np.abs(grad.numpy() - np.asarray(jgrad)).max() <= 1e-6
    assert tdino._resized_pos_embed(p, 8, 8) is p


def test_blur_and_views_match_vitx_with_its_draws(setup):
    x = images(B, seed=3)
    key = jax.random.PRNGKey(11)
    jblur = jdino._gaussian_blur(jnp.asarray(x), key)
    (k1,) = jax.random.split(key, 1)
    sigma = jax.random.uniform(k1, (B,), minval=0.1, maxval=2.0)
    got = tdino._gaussian_blur(t(x), t(sigma))
    assert np.abs(got.numpy() - np.asarray(jblur)).max() <= VIEW_TOL

    jg, jl = setup["crops"]
    tg, tl = tdino.multi_crop(t(setup["x"]), setup["td"],
                              draws=step_draws(setup, 0))
    assert tg.shape == (2 * B, 32, 32, 3) and tl.shape == (2 * B, 16, 16, 3)
    assert np.abs(tg.numpy() - np.asarray(jg)).max() <= VIEW_TOL
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= VIEW_TOL


def port_loss(s, params, draws):
    g, l = tdino.multi_crop(t(s["x"]), s["td"], draws=draws)
    sg = tdino.dino_forward(params, g, s["td"]).reshape(2, B, -1)
    sl = tdino.dino_forward(params, l, s["td"]).reshape(2, B, -1)
    with torch.no_grad():
        tg = tdino.dino_forward(dino_params_from_jax(
            s["teacher"], s["td"], "cpu"), g, s["td"]).reshape(2, B, -1)
    return tdino.dino_loss(torch.cat([sg, sl]), tg, t(s["center"]),
                           s["td"])


def test_forward_loss_and_gradients_match_vitx(setup):
    """The student's forwards at both sizes, the loss, the teacher's
    targets and every leaf's gradient against vitx's on vitx's crops of
    step 0 (1e-4)."""
    draws = step_draws(setup, 0)
    g, l = tdino.multi_crop(t(setup["x"]), setup["td"], draws=draws)
    jp = jtree(setup["params"])
    tp = dino_params_from_jax(setup["params"], setup["td"], "cpu")
    for crops in (g, l):
        jout = jax.jit(lambda p, c: jdino.dino_forward(p, c, setup["jd"]))(
            jp, jnp.asarray(crops.numpy()))
        with torch.no_grad():
            tout = tdino.dino_forward(tp, crops, setup["td"])
        assert rel_err(tout.numpy(), jout) <= TOL
    p = tstep.tree_map(lambda a: a.detach().requires_grad_(), tp)
    loss, probs = port_loss(setup, p, draws)
    grads = torch.autograd.grad(loss, tstep.leaves(p))
    assert abs(float(loss.detach()) - setup["loss"]) <= \
        TOL * abs(setup["loss"])
    assert rel_err(probs.numpy(), setup["probs"]) <= TOL
    grads_close(dict(zip(flat(p), [x.numpy() for x in grads])),
                setup["grads"])


def test_two_steps_match_vitx(setup):
    """Two steps of the port from vitx's state with vitx's draws: the
    first with the prototypes frozen (gradient zeroed, weights pinned),
    the params within the Adam step's allowance; the teacher's EMA, the
    centre, the entropy, the momentum and the loss after each (1e-4)."""
    td = setup["td"]
    state = dino_state_from_jax(setup["state"](setup["opt"]), td, "cpu")
    opt = tstep.make_optimizer(lr=LR, weight_decay=0.05, grad_clip=3.0)
    step = tdino.make_dino_train_step(td, opt, TOTAL, freeze_last_steps=1,
                                      device="cpu")
    last0 = state.params["head"]["last"].clone()
    p = tstep.tree_map(lambda a: a.detach().requires_grad_(), dino_params_from_jax(
        setup["params"], td, "cpu"))
    g = torch.autograd.grad(port_loss(setup, p, step_draws(setup, 0))[0],
                            tstep.leaves(p))
    tgrads = dict(zip(flat(p), [x.numpy() for x in g]))
    jgrads = flat(setup["grads"])
    tgrads["head/last"] = 0.0 * tgrads["head/last"]
    jgrads["head/last"] = 0.0 * jgrads["head/last"]
    for i, (js, jm) in enumerate(((setup["s0"], setup["m0"]),
                                  (setup["s1"], setup["m1"]))):
        state, m = step(state, {"image": setup["x"]},
                        draws=step_draws(setup, i))
        for k in ("loss", "teacher_entropy", "ema_momentum", "grad_norm"):
            assert rel_err(float(m[k]), float(jm[k])) <= TOL, k
        assert rel_err(state.center.numpy(), js.center) <= TOL
        tf, jf = flat(state.teacher), flat(js.teacher)
        assert max(rel_err(tf[k], jf[k]) for k in jf) <= TOL
        if i == 0:
            assert torch.equal(state.params["head"]["last"], last0)
            # clipping to norm 3 scales the gradients by c: Adam's eps
            # acts as eps / c on the unclipped ones
            c = min(1.0, 3.0 / float(jm["grad_norm"]))
            gap = adam_step_gap(tgrads, jgrads, flat(state.params),
                                flat(js.params), eps=1e-8 / c)
            assert gap <= 1.0, gap
    assert state.step == 2 and state.opt_state.count == 2
    assert not torch.equal(state.params["head"]["last"], last0)


def test_to_vit_params_carries_the_teacher(setup, monkeypatch):
    zeros_init(monkeypatch)
    vcfg, tcfg = configs()
    jout = jdino.dino_to_vit_params(jtree(setup["teacher"]), vcfg,
                                    jax.random.PRNGKey(0))
    tout = tdino.dino_to_vit_params(dino_params_from_jax(
        setup["teacher"], setup["td"], "cpu"), tcfg, 0, device="cpu")
    jf, tf = flat(jout), flat(tout)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        if not k.startswith("head/"):
            assert np.array_equal(tf[k], jf[k]), k


def test_ckpt_both_ways(setup, tmp_path):
    """vitx's ``DINOState`` ``.ckpt`` read by the port (teacher and
    centre after the optimizer's leaves), written back bit for bit and
    read by vitx."""
    js = jax.tree.map(jnp.asarray, setup["s1"])
    jckpt.save_checkpoint(tmp_path / "j", js, 1, meta={"kind": "dino"})
    template = tdino.create_dino_train_state(
        0, setup["td"], tstep.make_optimizer(grad_clip=3.0), device="cpu")
    state, meta = tckpt.restore_latest(tmp_path / "j", template, False)
    assert isinstance(state, tdino.DINOState) and state.step == 2
    saved = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    ours = tckpt.snapshot(state, False)
    assert len(ours) == len(saved)
    for a, b in zip(ours, saved):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(state.center.numpy(), setup["s1"].center)
    tckpt.save_checkpoint(tmp_path / "t", ours, 1, meta={"kind": "dino"})
    back, _ = jckpt.restore_latest(tmp_path / "t", setup["state"](
        setup["opt"]))
    for a, b in zip(jax.tree_util.tree_leaves(back), saved):
        assert np.array_equal(np.asarray(a), b)


def test_pretrain_cli_dino(setup, tmp_path, monkeypatch, capsys):
    """One epoch, a resume to a second (the prototypes frozen for the
    first epoch's steps), the teacher exported and read by vitx's
    ``load_vit_init``."""
    from vitx_torch.cli import pretrain

    zeros_init(monkeypatch)
    monkeypatch.setattr("vitx_torch.train.logging.ScalarWriter",
                        TagRecorder)
    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    _, tcfg = configs()
    argv = ["--method", "dino", "--config-json",
            write_config(tmp_path / "cfg.json", tcfg), "--data",
            "procedural:16,8", "--batch-size", "8", "--n-local", "2",
            "--dino-dim", "32", "--dino-hidden", "32", "--dino-bottleneck",
            "16", "--checkpoint-dir", str(tmp_path / "ck"), "--device",
            "cpu", "--log-dir", str(tmp_path / "logs")]
    assert pretrain.main(argv + ["--epochs", "1"]) == 0
    before = tckpt.restore_latest(tmp_path / "ck", tdino.create_dino_train_state(
        0, tdino.DINOConfig(encoder=tcfg, **HEAD), tstep.make_optimizer(
            grad_clip=3.0), device="cpu"), False)[0]
    assert pretrain.main(argv + ["--epochs", "2", "--export-vit",
                                 str(tmp_path / "v.npz")]) == 0
    out = capsys.readouterr().out
    assert "resumed DINO pretraining at epoch 1" in out
    assert "epoch 1: dino_loss" in out and "teacher_H" in out
    assert ("DINO/teacher_entropy", 1) in TagRecorder.tags
    after = tckpt.restore_latest(tmp_path / "ck", before, False)[0]
    # local crops of 16 (32 // 2), the prototypes pinned in epoch 0 only
    assert not torch.equal(after.params["head"]["last"],
                           before.params["head"]["last"])
    tree = load_vit_init_tree(str(tmp_path / "v.npz"), setup["jd"].encoder)
    teacher = flat(after.teacher["encoder"])
    with np.load(tmp_path / "v.npz") as z:
        for k, v in flat(tree).items():
            assert np.array_equal(z[k], v), k
            if k in teacher:
                assert np.array_equal(z[k], teacher[k]), k
