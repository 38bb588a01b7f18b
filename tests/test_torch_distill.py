"""DeiT distillation in the port (``vitx_torch.train.distill``), on the CPU,
against vitx.

The student is ``tiny`` at depth 2 in fp32 (with ``distill_token``: T 66,
two heads), the teacher a ``tiny`` of its own weights at depth 1; batch 4
with a padding row masked out. ``distill_loss`` (soft KL·τ², hard argmax
CE, the mask) within 1e-6 of vitx's; then one distillation step each of
head distillation soft and hard, and of the token (CE on the CLS head,
the teacher's term on the distillation head): the loss and gradients
within 1e-4 of vitx's (max |a - b| over max |b|), composed from vitx's own
``forward``, ``forward_heads`` and ``distill_loss`` as
``vitx/train/distill.py::distill_train_step`` composes them; the params
after the update in lr units (``tests/test_torch_finetune_knobs.py``'s
allowance); and, for the token form, the metrics of vitx's jitted
``make_distill_train_step`` itself. Then the train CLI's
``--distill-from`` end to end, and its refusal of a teacher of another
class count.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx_torch
from tests.test_torch_finetune_knobs import (LR, allowance, batch,
                                             check_grads, check_params,
                                             configs, init, jnp_tree, names,
                                             vitx_update)
from vitx.nn.vit import forward as jforward
from vitx.nn.vit import forward_heads as jforward_heads
from vitx.train import distill as jdistill
from vitx.train import step as jstep
from vitx_torch.train import distill as tdistill
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

ALPHA, TAU = 0.5, 2.0


def masked_batch():
    b = batch()
    b["mask"] = np.array([1, 1, 1, 0], np.int32)
    return b


@pytest.mark.parametrize("hard", [False, True])
def test_distill_loss_matches_vitx(hard):
    rng = np.random.default_rng(0)
    s, t = (rng.standard_normal((6, 5)).astype(np.float32) for _ in range(2))
    y = rng.integers(0, 5, 6).astype(np.int32)
    m = np.array([1, 1, 0, 1, 1, 0], np.int32)
    for mask in (None, m):
        kw = dict(alpha=0.3, tau=TAU, hard=hard, label_smoothing=0.1)
        want = float(jdistill.distill_loss(
            jnp.asarray(s), jnp.asarray(t), jnp.asarray(y),
            None if mask is None else jnp.asarray(mask), **kw))
        got = float(tdistill.distill_loss(
            torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(y),
            None if mask is None else torch.from_numpy(mask), **kw))
        assert abs(got - want) <= 1e-6 * abs(want)


def vitx_distill_grads(jcfg, params, b, teacher_logits, hard):
    """vitx's distillation loss and gradients, composed as
    ``distill_train_step``'s ``_loss`` composes them."""
    def f(p, b, tl):
        if jcfg.distill_token:
            cls, dist = jforward_heads(p, b["image"], jcfg)
            ce = jstep.cross_entropy_loss(cls, b["label"], b["mask"])
            kd = jdistill.distill_loss(dist, tl, b["label"], b["mask"],
                                       alpha=1.0, tau=TAU, hard=hard)
            return (1.0 - ALPHA) * ce + ALPHA * kd
        logits = jforward(p, b["image"], jcfg)
        return jdistill.distill_loss(logits, tl, b["label"], b["mask"],
                                     alpha=ALPHA, tau=TAU, hard=hard)
    loss, grads = jax.jit(jax.value_and_grad(f))(
        jnp_tree(params), jnp_tree(b), teacher_logits)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def teacher():
    jcfg, tcfg = configs(depth=1)
    p = init(tcfg, seed=7)
    return jcfg, tcfg, p


@pytest.mark.parametrize("form", ["soft", "hard", "token"])
def test_distill_step_matches_vitx(teacher, form, monkeypatch):
    jt_cfg, tt_cfg, tp = teacher
    hard = form == "hard"
    jcfg, tcfg = configs(distill_token=form == "token")
    p, b = init(tcfg), masked_batch()
    tl = jax.jit(lambda q, x: jforward(q, x, jt_cfg))(
        jnp_tree(tp), jnp.asarray(b["image"]))
    jl, jg = vitx_distill_grads(jcfg, p, b, tl, hard)
    opt = tstep.make_optimizer(lr=LR)
    state = tstep.create_train_state(0, tcfg, opt, device="cpu")
    state = state._replace(params=vitx_torch.params_from_jax(p, tcfg, "cpu"),
                           opt_state=opt.init(vitx_torch.params_from_jax(
                               p, tcfg, "cpu")))
    teacher_params = vitx_torch.params_from_jax(tp, tt_cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        t_logits = vitx_torch.nn.vit.model_logits(teacher_params, tb["image"],
                                                  tt_cfg)
    assert np.abs(t_logits.numpy() - np.asarray(tl)).max() <= 1e-4 * \
        np.abs(np.asarray(tl)).max()
    step = tdistill.make_distill_train_step(
        tcfg, tt_cfg, opt, alpha=ALPHA, tau=TAU, hard=hard, device="cpu")
    captured = {}
    orig = tdistill.apply_gradients

    def spy(state, optimizer, loss, logits, params, wrt, batch, extra=None):
        # the gradients the step's own loss gives, before its update
        captured["grads"] = torch.autograd.grad(
            loss, tstep.leaves(params), retain_graph=True)
        return orig(state, optimizer, loss, logits, params, wrt, batch,
                    extra)
    monkeypatch.setattr(tdistill, "apply_gradients", spy)
    new, m = step(state, b, teacher_params)
    tg = [g.numpy() for g in captured["grads"]]
    check_grads(jl, jg, float(m["loss"]), tg, names(p))
    jp, _ = vitx_update(jstep.make_optimizer(lr=LR), p, jg)
    check_params(new, jp, allowance(tg, jg))
    assert new.step == 1 and 0.0 <= float(m["teacher_agreement"]) <= 1.0
    if form == "token":
        jopt = jstep.make_optimizer(lr=LR)
        jstate = jstep.TrainState(jnp.zeros((), jnp.int32), jnp_tree(p),
                                  jopt.init(jnp_tree(p)))
        jstep_fn = jdistill.make_distill_train_step(
            jcfg, jt_cfg, jopt, alpha=ALPHA, tau=TAU, hard=hard)
        _, jm = jstep_fn(jstate, jnp_tree(b), jnp_tree(tp), None)
        for k in ("loss", "accuracy", "teacher_agreement", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * max(
                abs(float(jm[k])), 1e-6), k


def test_cli_distill_from_checkpoint(tmp_path, monkeypatch):
    """``--distill-from`` a teacher ``.ckpt``: its geometry from the meta
    (a depth-1 teacher for a depth-2 student with the token), one epoch
    through the distillation step; a teacher of another class count is
    refused."""
    from vitx_torch.cli import train as ttrain
    from vitx_torch.train import checkpoint as tckpt

    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    common = ["--preset", "tiny", "--compute-dtype", "float32", "--data",
              "procedural:32,16", "--epochs", "1", "--batch-size", "16",
              "--device", "cpu", "--log-every", "1"]
    cfg_path = tmp_path / "teacher.json"
    cfg_path.write_text(vitx_torch.get_config("tiny", depth=1).to_json())
    assert ttrain.main(common + ["--config-json", str(cfg_path),
                                 "--checkpoint-dir",
                                 str(tmp_path / "t")]) == 0
    assert ttrain.main(common + ["--distill-from", str(tmp_path / "t"),
                                 "--distill-token", "--distill-hard",
                                 "--checkpoint-dir",
                                 str(tmp_path / "s")]) == 0
    meta = tckpt.peek_meta(tmp_path / "s")
    assert meta["config"]["distill_token"] and meta["config"]["depth"] == 4
    # a teacher checkpoint of 7 classes (the data has 10)
    from vitx_torch.train import checkpoint as tckpt

    cfg7 = vitx_torch.get_config("tiny", depth=1, num_classes=7)
    opt = tstep.make_optimizer()
    state = tstep.create_train_state(0, cfg7, opt, device="cpu")
    tckpt.save_checkpoint(tmp_path / "b", tckpt.snapshot(state, False), 0,
                          meta={"config": json.loads(cfg7.to_json())})
    with pytest.raises(SystemExit, match="7 classes"):
        ttrain.main(common + ["--distill-from", str(tmp_path / "b")])
