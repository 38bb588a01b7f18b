"""The port's pipeline parallelism (``vitx_torch/parallel/pipeline.py``)
against vitx's on the CPU.

vitx's tiny pipeline config (``tests/test_pipeline.py``: image 16, patch
4, E 32, depth 4, 4 heads, fp32) from numpy-drawn weights, three steps on
numpy-drawn batches of 16. The port's cases run in one world of four gloo
rank processes (``vitx_torch.parallel.spawn``, a ``file://`` rendezvous
under a temporary directory), each case's mesh after the other's; vitx's
run ``make_pp_train_step`` / ``make_pp_eval_step`` on the conftest's
8-device CPU mesh. Held to vitx: each rank's placed state (the part of
vitx's placed state its mesh position holds), the loss, accuracy and
grad_norm of every step at 1e-4, the params after three steps at vitx's
own tolerance against single-device training, the eval step's confusion
matrix exactly and its loss at 1e-4; GPipe and 1F1B at dp 2 x pp 2 and
pp 4, pp 2 x tp 2, ZeRO-1, a ragged masked batch, label smoothing and
layer-wise lr decay (each stage's factors its blocks' slice).
Besides: the stochastic regularisers under both schedules against the
single-process replay of the seed rule, the schedules' accounting and
the inputs they hold, the spec tables at base16 and vitx's refusals (the
train CLI's ``--pp`` end to end is in ``test_torch_pipeline_serve.py``,
which xdist runs beside this file).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.parallel import pipeline as jpl
from vitx.parallel.sharded import shard_batch as jshard_batch
from vitx.train import step as jstep
from vitx_torch.interop.jax_params import _opt_node, local_state_from_jax
from vitx_torch.nn.vit import param_spec
from vitx_torch.parallel import Mesh, spawn
from vitx_torch.parallel import pipeline as tpl
from vitx_torch.train import step as tstep

from tests import torch_pipeline_helpers as H
from tests.torch_pretrain_helpers import draw, flat, jtree, rel_err

TOL = 1e-4
KW = dict(image_size=16, patch_size=4, num_classes=4, embed_dim=32,
          depth=4, num_heads=4, compute_dtype="float32")
STOCH = dict(dropout=0.1, drop_path=0.2, patch_drop=0.25)
B = 16
MASK = np.array([1] * 10 + [0] * 6, np.int32)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")


@functools.lru_cache(maxsize=None)
def payload() -> dict:
    cfg = vitx_torch.ViTConfig(**KW)
    batches = []
    for i in range(H.STEPS):
        rng = np.random.default_rng(10 + i)
        batches.append({"image": rng.standard_normal(
            (B, 16, 16, 3)).astype(np.float32),
            "label": rng.integers(0, 4, B).astype(np.int32)})
    return {"cfg": cfg.to_json(), "stoch_cfg": cfg.replace(**STOCH).to_json(),
            "params": draw(param_spec(cfg), 0), "batches": batches,
            "mask": MASK, "seed": 7}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    return spawn(H.run_world, 4, (payload(),), device="cpu",
                 init_method=f"file://{rdv}")


def _jmesh(case):
    return jpl.make_pp_mesh(dp=case["dp"], pp=case["pp"],
                            tp=case.get("tp", 1),
                            devices=jax.devices()[:4])


def _jbatch(i, mesh, masked=False):
    b = {k: jnp.asarray(v) for k, v in payload()["batches"][i].items()}
    if masked:
        b["mask"] = jnp.asarray(MASK)
    return jshard_batch(b, mesh)


def _jstate(cfg, opt):
    jp = jtree(payload()["params"])
    return jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                            opt_state=opt.init(jp))


@functools.lru_cache(maxsize=None)
def vitx_case(name: str) -> dict:
    """vitx's three pipeline steps of a case: each device's placed parts,
    the metrics of every step and the params after them."""
    case = H.CASES[name]
    cfg = vitx.ViTConfig(**KW)
    mesh = _jmesh(case)
    opt = jstep.make_optimizer(lr=H.LR, **case.get("opt", {}))
    flags = dict(zero1=bool(case.get("zero1")), tp=case.get("tp", 1) > 1)
    placed = jpl.place_pp_state(_jstate(cfg, opt), cfg, mesh, **flags)
    parts = [local_state_from_jax(placed, d, to="cpu")
             for d in mesh.devices.reshape(-1)]
    step = jpl.make_pp_train_step(
        cfg, opt, mesh, n_micro=case["n_micro"],
        state_shardings=jpl.pp_state_sharding(placed, cfg, mesh, **flags),
        label_smoothing=case.get("label_smoothing", 0.0),
        schedule=case["schedule"])
    hist, state = [], placed
    for i in range(H.STEPS):
        state, m = step(state, _jbatch(i, mesh, case.get("mask")), None)
        hist.append([float(m[k]) for k in ("loss", "accuracy",
                                          "grad_norm")])
    return {"parts": parts, "hist": hist,
            "params": flat(jax.tree.map(np.asarray, state.params))}


@pytest.mark.parametrize("name", list(H.CASES))
def test_case_matches_vitx_pipeline(name, world):
    """Three steps of a case against vitx's ``make_pp_train_step``: every
    rank's placed parts are vitx's, the metrics at 1e-4 (accuracy
    exactly), the params after at vitx's tolerance against one device."""
    ref = vitx_case(name)
    for r, rank in enumerate(world):
        mine, theirs = rank[name]["placed"], ref["parts"][r]
        want = flat(theirs.params)
        assert sorted(mine["params"]) == sorted(want)
        for k in want:
            assert np.array_equal(mine["params"][k], want[k]), (r, k)
        slots = {f"{n}/{k}": v.shape for n in theirs.opt_state.SLOTS
                 for k, v in flat(getattr(theirs.opt_state, n)).items()}
        assert mine["slots"] == slots, r
    got = np.array(world[0][name]["hist"])
    want = np.array(ref["hist"])
    for j, key in ((0, "loss"), (2, "grad_norm")):
        assert rel_err(got[:, j], want[:, j]) <= TOL, (key, got, want)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-6)
    params_close(world[0][name]["params"], ref["params"])


def params_close(got: dict, want: dict, steps: int = H.STEPS) -> None:
    """The params after ``steps`` AdamW steps within vitx's tolerance
    against one device (rtol 1e-4, atol 1e-5), but for the elements whose
    gradient is as small as the two implementations' rounding: Adam's
    normalised step moves those by up to lr either way, so they may differ
    by 2 lr a step. At most 1 in 1000 elements of a leaf may be such."""
    for k, v in want.items():
        a, b = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
        off = np.abs(a - b) > TOL * np.abs(b) + 1e-5
        assert off.mean() <= 1e-3, (k, int(off.sum()), off.size)
        assert np.all(np.abs(a - b) <= 2 * H.LR * steps), k


@pytest.mark.parametrize("name", list(H.EVAL_CASES))
def test_eval_matches_vitx_pipeline(name, world):
    """The eval step's confusion matrix (exactly; a ragged batch's padded
    rows excluded) and loss (1e-4) against vitx's ``make_pp_eval_step``."""
    case = H.EVAL_CASES[name]
    cfg = vitx.ViTConfig(**KW)
    mesh = _jmesh(case)
    opt = jstep.make_optimizer(lr=H.LR)
    placed = jpl.place_pp_state(_jstate(cfg, opt), cfg, mesh,
                                tp=case.get("tp", 1) > 1)
    cm, loss = jpl.make_pp_eval_step(cfg, mesh, n_micro=case["n_micro"])(
        placed.params, _jbatch(0, mesh, case.get("mask")))
    got = world[0][name]
    assert np.array_equal(got["cm"], np.asarray(cm))
    assert got["cm"].sum() == (MASK.sum() if case.get("mask") else B)
    assert rel_err(got["loss"], float(loss)) <= TOL


def test_stochastic_schedules_match_emulation(world):
    """Dropout, drop-path and patch dropout under GPipe and 1F1B (dp 2 x
    pp 2) equal the single-process replay of the seed rule over three
    steps (losses and grad norms at 1e-4, params at 1e-5): 1F1B's
    recompute draws its forward slot's masks again."""
    cfg = vitx_torch.ViTConfig(**KW, **STOCH)
    opt = tstep.make_optimizer(lr=H.LR)
    params = H.to_torch(payload()["params"])
    state = tstep.TrainState(0, params, opt.init(params))
    gen = torch.Generator().manual_seed(payload()["seed"])
    hist = []
    for i in range(H.STEPS):
        state, loss, norm = H.emulate_step(state, payload()["batches"][i],
                                           gen, cfg, opt, 2, 2, 2)
        hist.append((loss, norm))
    want = H.flat(state.params)
    for name in H.STOCH_CASES:
        got = np.array(world[0][name]["hist"])
        assert rel_err(got[:, 0], [h[0] for h in hist]) <= TOL, name
        assert rel_err(got[:, 2], [h[1] for h in hist]) <= TOL, name
        for k in want:
            np.testing.assert_allclose(world[0][name]["params"][k], want[k],
                                       rtol=0, atol=1e-5, err_msg=k)


def test_schedules_hold(world):
    """GPipe holds every microbatch's graph; 1F1B at most its ring's 2S - 1
    stage inputs, whatever the microbatch count."""
    for (schedule, pp, m), held in world[0]["held"].items():
        want = m if schedule == "gpipe" else min(m, 2 * pp - 1)
        assert held == want, (schedule, pp, m, held)


def test_schedule_accounting_matches_vitx():
    """``pp_schedule_ticks`` and ``pp_bubble_fraction`` are vitx's over a
    grid; an unknown schedule is refused with vitx's message."""
    for schedule in ("gpipe", "1f1b"):
        for stages in (1, 2, 4, 8):
            for m in (1, 2, 4, 8, 64):
                args = (schedule, stages, m)
                assert tpl.pp_schedule_ticks(*args) == \
                    jpl.pp_schedule_ticks(*args)
                assert tpl.pp_bubble_fraction(*args) == \
                    jpl.pp_bubble_fraction(*args)
    msgs = []
    for mod in (tpl, jpl):
        with pytest.raises(ValueError) as e:
            mod.pp_schedule_ticks("interleaved", 4, 8)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _specs(tree) -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update({f"{k}/{q}": s for q, s in _specs(v).items()})
        else:
            s = tuple(getattr(v, "spec", v))
            while s and s[-1] is None:
                s = s[:-1]
            out[k] = s
    return out


@pytest.mark.parametrize("tp,zero1", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_spec_tables_match_vitx(tp, zero1):
    """``pp_param_pspecs`` and ``pp_state_sharding`` (the moments of every
    leaf) equal vitx's at base16 on a 2 data x 2 stage (x 2 model) mesh."""
    jcfg, tcfg = vitx.get_config("base16"), vitx_torch.get_config("base16")
    jmesh = jpl.make_pp_mesh(dp=2, pp=2, tp=2 if tp else 1,
                             devices=jax.devices()[:8 if tp else 4])
    tmesh = Mesh({"data": 2, "stage": 2, **({"model": 2} if tp else {})},
                 0, "cpu", "gloo")
    assert _specs(tpl.pp_param_pspecs(tcfg, tp)) == \
        _specs(jpl.pp_param_pspecs(jcfg, tp))
    opt_j, opt_t = jstep.make_optimizer(), tstep.make_optimizer()
    jstate = jax.eval_shape(lambda: jstep.create_train_state(
        jax.random.PRNGKey(0), jcfg, opt_j))

    def meta(spec):
        return {k: meta(v) if isinstance(v, dict) else
                torch.empty(v[0], device="meta") for k, v in spec.items()}
    p = meta(param_spec(tcfg))
    ts = tpl.pp_state_sharding(tstep.TrainState(0, p, opt_t.init(p)), tcfg,
                               tmesh, zero1=zero1, tp=tp)
    js = jpl.pp_state_sharding(jstate, jcfg, jmesh, zero1=zero1, tp=tp)
    assert _specs(ts.params) == _specs(js.params)
    _, node = _opt_node(js.opt_state)
    for slot in ("mu", "nu"):
        assert _specs(getattr(ts.opt_state, slot)) == \
            _specs(getattr(node, slot)), slot


def _same_error(mine, theirs):
    with pytest.raises(ValueError) as a:
        mine()
    with pytest.raises(ValueError) as b:
        theirs()
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("over,pp,tp,for_train", [
    (dict(depth=3), 4, 1, True), (dict(distill_token=True), 2, 1, True),
    (dict(num_heads=3, embed_dim=48), 2, 2, True),
    (dict(lora_rank=2), 2, 2, True), (dict(parity="bug_exact"), 2, 2, False),
    (dict(tome_r=2), 2, 2, False), (dict(dropout=0.1), 2, 2, True),
    (dict(drop_path=0.1, patch_drop=0.25), 2, 2, True)])
def test_check_pp_cfg_refusals_match_vitx(over, pp, tp, for_train):
    """Each of vitx's ``_check_pp_cfg`` refusals, with vitx's message."""
    kw = dict(KW, **over)
    _same_error(
        lambda: tpl._check_pp_cfg(vitx_torch.ViTConfig(**kw), pp, for_train,
                                  tp),
        lambda: jpl._check_pp_cfg(vitx.ViTConfig(**kw), pp, for_train, tp))


def test_step_and_trainer_refusals_match_vitx():
    """vitx's other refusals, with its messages: Soft-MoE placement, ToMe
    in the eval step, a stochastic step without an rng, ZeRO-2/3 and the
    recipe knobs in the Trainer; the port's train CLI checks the flags
    as vitx's does."""
    from vitx.train.loop import Trainer as JTrainer
    from vitx.train.loop import TrainerConfig as JTrainerConfig
    from vitx_torch.cli import train as ttrain
    from vitx_torch.train import loop as tloop

    _same_error(lambda: tpl.pp_param_pspecs(vitx_torch.ViTConfig(
        **KW, moe_experts=2, moe_blocks=1)), lambda: jpl.pp_param_pspecs(
            vitx.ViTConfig(**KW, moe_experts=2, moe_blocks=1)))
    jmesh = jpl.make_pp_mesh(dp=2, pp=2, devices=jax.devices()[:4])
    tmesh = Mesh({"data": 2, "stage": 2}, 0, "cpu", "gloo")
    _same_error(
        lambda: tpl.make_pp_eval_step(vitx_torch.ViTConfig(**KW, tome_r=2),
                                      tmesh),
        lambda: jpl.make_pp_eval_step(vitx.ViTConfig(**KW, tome_r=2), jmesh))
    tcfg = vitx_torch.ViTConfig(**KW, **STOCH)
    opt = tstep.make_optimizer(lr=H.LR)
    state = tstep.create_train_state(0, tcfg, opt, device="cpu")
    jcfg = vitx.ViTConfig(**KW, **STOCH)
    jopt = jstep.make_optimizer(lr=H.LR)
    jstate = jpl.place_pp_state(jstep.create_train_state(
        jax.random.PRNGKey(0), jcfg, jopt), jcfg, jmesh)
    _same_error(
        lambda: tpl.make_pp_train_step(tcfg, opt, tmesh, 2)(
            state, payload()["batches"][0]),
        lambda: jpl.make_pp_train_step(jcfg, jopt, jmesh, 2)(
            jstate, _jbatch(0, jmesh), None))
    cfg_t, cfg_j = vitx_torch.ViTConfig(**KW), vitx.ViTConfig(**KW)
    for tkw, flags in ((dict(mixup_alpha=0.2, cutmix_alpha=1.0,
                             sam_rho=0.05, class_weights=(1.0,) * 4,
                             train_filter="head"), {}),
                       ({}, dict(zero3=True)), ({}, dict(zero2=True))):
        _same_error(
            lambda: tloop.Trainer(cfg_t, tloop.TrainerConfig(lr=1e-3, **tkw),
                                  mesh=tmesh, **flags),
            lambda: JTrainer(cfg_j, JTrainerConfig(lr=1e-3, **tkw),
                             mesh=jmesh, **flags))
    for argv, match in (
            (["--pp", "2", "--ep", "2", "--moe-experts", "2"],
             "--ep does not compose with --pp"),
            (["--pp", "2", "--tp", "2", "--sp"],
             "--sp does not compose with --pp"),
            (["--pp", "2", "--dp", "2", "--batch-size", "12",
              "--pp-microbatches", "4"],
             "--batch-size 12 must be divisible by --dp 2 x "
             "--pp-microbatches 4")):
        with pytest.raises(SystemExit, match=re.escape(match)):
            ttrain.main(argv + ["--device", "cpu"])
