"""The port's sharded steps (``vitx_torch/parallel``) against vitx's on
the CPU.

Each case is one train step of a depth-2 fp32 model (tiny's widths cut
to image 32; a Soft-MoE copy with two experts for ep) on a global batch
of 8, in gloo rank processes (``vitx_torch.parallel.spawn``, a
``file://`` rendezvous under ``tmp_path``; the cases of one world share
one spawn), held to vitx's ``make_parallel_train_step`` on the
conftest's 8-device CPU mesh from the same weights: each rank's placed
state equals the part of vitx's placed state its mesh position holds
(``interop.jax_params.local_state_from_jax``), the loss, grad_norm and
every leaf's gradient at 1e-4, the params after the step within the Adam
step's allowance, the eval step's confusion matrix exactly and its loss
at 1e-4. The cases cover the merging encoder at tp2 (``tome_train``, its
split route and B8/K2 over gathered weights; the merges the same on
every rank and equal to the one-process port's) and fused blocks under
sp and tp x ep. Besides: the shard tables against vitx's for base16,
LoRA and Soft-MoE configs; random draws under dp, and through the
merging encoder under tp, against the single-process port;
a sharded Trainer's ``.ckpt`` resume; the train CLI and the dryrun; the
refusals; and that the port imports no JAX.
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.parallel import sharded as jsh
from vitx.parallel.mesh import make_mesh as jmake_mesh
from vitx.train import step as jstep
from vitx_torch.interop.jax_params import _opt_node, local_state_from_jax
from vitx_torch.nn.vit import param_spec
from vitx_torch.parallel import Mesh, sharded, spawn
from vitx_torch.train import step as tstep

from tests import torch_parallel_helpers as H
from tests.torch_pretrain_helpers import (GradCapture, adam_step_gap,
                                          draw, flat, grads_close, jtree,
                                          rel_err)

TOL = 1e-4
KW = dict(image_size=32, depth=2, compute_dtype="float32")
MOE = dict(KW, moe_experts=2, moe_blocks=1)
B = 8
WORLD2 = ["dp2", "zero1", "zero2", "zero3", "tp2", "tp2_sp", "ep2",
          "tp2_tome", "tp2_tome_fused", "tp2_sp_fused"]
WORLD4 = ["dp4", "dp2_tp2", "tp2_ep2_fused"]
# run in the world-2 spawn beside WORLD2, held by a test of their own
DRAWS2 = ["tp2_tome_draws"]


def payload() -> dict:
    tcfg, mcfg = (vitx_torch.get_config("tiny", **k) for k in (KW, MOE))
    rng = np.random.default_rng(3)
    return {"cfg": tcfg.to_json(), "moe_cfg": mcfg.to_json(),
            "params": draw(param_spec(tcfg), 0),
            "moe_params": draw(param_spec(mcfg), 1), "seed": 7,
            "batch": {"image": rng.standard_normal(
                (B, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, 4, B).astype(np.int32)}}


@functools.lru_cache(maxsize=None)
def vitx_case(name: str) -> dict:
    """vitx's sharded step of a case: the placed state's parts by device,
    the gradients (one step through ``GradCapture``), the metrics and
    params after one AdamW step, the eval step's outputs."""
    case, pl = H.CASES[name], payload()
    moe = case.get("moe")
    cfg = vitx.get_config("tiny", **(MOE if moe else KW),
                          **case.get("over", {}))
    params = pl["moe_params" if moe else "params"]
    tp, sp, ep = case.get("tp", 1) > 1, bool(case.get("sp")), \
        case.get("ep", 1) > 1
    zero = case.get("zero", 0)
    mesh = jmake_mesh(dp=case["dp"], tp=case.get("tp", 1),
                      ep=case.get("ep", 1),
                      devices=jax.devices()[:case["world"]])
    batch = jsh.shard_batch({k: jnp.asarray(v)
                             for k, v in pl["batch"].items()}, mesh)
    opt = jstep.make_optimizer(lr=H.LR, weight_decay=H.WD)

    def state(o):
        jp = jtree(params)
        return jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                opt_state=() if isinstance(o, GradCapture)
                                else o.init(jp))
    flags = dict(tp=tp, zero1=zero in (1, 2), zero3=zero == 3, ep=ep)
    placed = jsh.place_state(state(opt), cfg, mesh, **flags)
    parts = [local_state_from_jax(placed, d, to="cpu")
             for d in mesh.devices.reshape(-1)]
    shardings = jsh.state_sharding(placed, cfg, mesh, tp, flags["zero1"],
                                   flags["zero3"], ep=ep)
    gshard = (jsh.grad_sharding(placed.params, cfg, mesh, tp, ep)
              if zero == 2 else None)
    step = jsh.make_parallel_train_step(
        cfg, opt, mesh, tp=tp, zero1=flags["zero1"], zero3=flags["zero3"],
        state_shardings=shardings, grad_shardings=gshard, sp=sp, ep=ep)
    new, m = step(placed, batch, None)
    cm, eloss = jsh.make_parallel_eval_step(cfg, mesh, tp=tp, sp=sp, ep=ep)(
        new.params, batch)
    cap = jsh.make_parallel_train_step(cfg, GradCapture(), mesh, tp=tp,
                                       sp=sp, ep=ep)
    grads, _ = cap(jsh.place_state(state(GradCapture()), cfg, mesh, tp=tp,
                                   ep=ep), batch, None)
    return {"parts": parts, "grads": jax.tree.map(np.asarray, grads.params),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "accuracy": float(m["accuracy"]),
            "params": flat(jax.tree.map(np.asarray, new.params)),
            "cm": np.asarray(cm), "eval_loss": float(eloss)}


def _spawn(world, names, tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    return spawn(H.run_cases, world, (names, payload()), device="cpu",
                 init_method=f"file://{rdv}")


@pytest.fixture(scope="module")
def port2(tmp_path_factory):
    return _spawn(2, WORLD2 + DRAWS2, tmp_path_factory)


@pytest.fixture(scope="module")
def port4(tmp_path_factory):
    return _spawn(4, WORLD4, tmp_path_factory)


@pytest.mark.parametrize("name", WORLD2 + WORLD4)
def test_case_matches_vitx_sharded_step(name, request):
    """One case against vitx's sharded step (the module's doc)."""
    ranks = request.getfixturevalue("port4" if name in WORLD4 else "port2")
    ref = vitx_case(name)
    # shard against shard: every rank's placed parts are vitx's
    for r, rank in enumerate(ranks):
        mine, theirs = rank[name]["placed"], ref["parts"][r]
        want = flat(theirs.params)
        assert sorted(mine["params"]) == sorted(want)
        for k in want:
            assert np.array_equal(mine["params"][k], want[k]), (r, k)
        slots = {f"{n}/{k}": v.shape for n in theirs.opt_state.SLOTS
                 for k, v in flat(getattr(theirs.opt_state, n)).items()}
        assert mine["slots"] == slots, r
    got = ranks[0][name]
    for k in ("loss", "grad_norm"):
        assert rel_err(got[k], ref[k]) <= TOL, (k, got[k], ref[k])
    assert got["accuracy"] == ref["accuracy"]
    grads_close(got["grads"], ref["grads"])
    gap = adam_step_gap(got["grads"], flat(ref["grads"]), got["params"],
                        ref["params"])
    assert gap <= 1.0, gap
    assert np.array_equal(got["cm"], ref["cm"]) and got["cm"].sum() == B
    assert rel_err(got["eval_loss"], ref["eval_loss"]) <= TOL
    if "tome_r" in H.CASES[name].get("over", {}):
        # the merges: the same bytes on every model rank, and those of the
        # one-process port
        for r, rank in enumerate(ranks):
            assert np.array_equal(rank[name]["sources"], got["sources"]), r
        cfg = vitx_torch.get_config("tiny", **KW, **H.CASES[name]["over"])
        with torch.no_grad():
            _, one = vitx_torch.encode_tome(
                H.to_torch(payload()["params"]),
                torch.from_numpy(payload()["batch"]["image"]), cfg,
                return_sources=True)
        assert np.array_equal(got["sources"], one.numpy())


def _norm(spec) -> tuple:
    s = tuple(spec)
    while s and s[-1] is None:
        s = s[:-1]
    return s


def _specs(tree) -> dict:
    """{"a/b": normalised spec} of a tree of specs or NamedShardings."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update({f"{k}/{q}": s for q, s in _specs(v).items()})
        else:
            out[k] = _norm(getattr(v, "spec", v))
    return out


@pytest.mark.parametrize("name,over", [
    ("base16", {}), ("lora", dict(lora_rank=8, lora_targets="all")),
    ("moe", dict(moe_experts=8, moe_blocks=6))])
def test_shard_tables_match_vitx(name, over):
    """``param_pspecs`` and ``state_sharding`` (zero1, zero3) of the port
    equal vitx's at base16 on a 2 x 2 (x 2 expert) mesh, for the plain,
    a LoRA and a Soft-MoE config (the moments of every leaf)."""
    ep = "moe_experts" in over
    jcfg = vitx.get_config("base16", **over)
    tcfg = vitx_torch.get_config("base16", **over)
    jmesh = jmake_mesh(dp=2, tp=2, ep=2 if ep else 1,
                       devices=jax.devices()[:8 if ep else 4])
    shape = {"data": 2, "model": 2, **({"expert": 2} if ep else {})}
    tmesh = Mesh(shape, 0, "cpu", "gloo")
    assert _specs(sharded.param_pspecs(tcfg, True, ep)) == \
        _specs(jsh.param_pspecs(jcfg, True, ep))
    opt_j, opt_t = jstep.make_optimizer(), tstep.make_optimizer()
    jstate = jax.eval_shape(lambda: jstep.create_train_state(
        jax.random.PRNGKey(0), jcfg, opt_j))

    def meta(spec):
        return {k: meta(v) if isinstance(v, dict) else
                torch.empty(v[0], device="meta") for k, v in spec.items()}
    p = meta(param_spec(tcfg))
    tstate = tstep.TrainState(0, p, opt_t.init(p))
    for flags in (dict(zero1=True), dict(zero3=True)):
        js = jsh.state_sharding(jstate, jcfg, jmesh, tp=True, ep=ep, **flags)
        ts = sharded.state_sharding(tstate, tcfg, tmesh, tp=True, ep=ep,
                                    **flags)
        assert _specs(ts.params) == _specs(js.params), flags
        _, node = _opt_node(js.opt_state)
        for slot in ("mu", "nu"):
            assert _specs(getattr(ts.opt_state, slot)) == \
                _specs(getattr(node, slot)), (flags, slot)
    assert _specs(sharded.grad_sharding(p, tcfg, tmesh, True, ep)) == \
        _specs(jsh.grad_sharding(jstate.params, jcfg, jmesh, True, ep))


def test_draws_under_dp_match_one_process(tmp_path):
    """dp=2 with dropout, drop-path, patch dropout, mixup, cutmix and SAM
    from a generator seeded alike on both ranks: two steps equal the
    single-process port's with that seed (the masks drawn at the global
    shape, the permutation of the global batch)."""
    cfg = vitx_torch.get_config("tiny", dropout=0.1, drop_path=0.2,
                                patch_drop=0.5, **KW)
    pl = payload()
    knobs = dict(mixup_alpha=0.8, cutmix_alpha=1.0, sam_rho=0.05)
    pl.update(cfg=cfg.to_json(), knobs=knobs, seed=7)
    got = spawn(H.run_draws, 2, (pl,), device="cpu",
                init_method=f"file://{tmp_path / 'rdv'}")[0]
    opt = tstep.make_optimizer(lr=H.LR, weight_decay=H.WD)
    params = H.to_torch(pl["params"])
    state = tstep.TrainState(0, params, opt.init(params))
    gen = torch.Generator().manual_seed(7)
    hist = []
    for _ in range(2):
        state, m = tstep.train_step(state, pl["batch"], gen, cfg=cfg,
                                    optimizer=opt, device="cpu", **knobs)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got["hist"], hist, rtol=TOL)
    want = H.flat(state.params)
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], atol=1e-5)


def test_tome_train_draws_under_tp_match_one_process(port2):
    """tp2 through the merging encoder with dropout and drop-path, from a
    generator seeded alike on both ranks (run in the world-2 spawn): two
    steps equal the single-process port's with that seed (the masks on
    the replicated stream drawn alike on every model rank)."""
    got = port2[0]["tp2_tome_draws"]
    cfg = vitx_torch.get_config("tiny", **KW,
                                **H.CASES["tp2_tome_draws"]["over"])
    pl = payload()
    opt = tstep.make_optimizer(lr=H.LR, weight_decay=H.WD)
    params = H.to_torch(pl["params"])
    state = tstep.TrainState(0, params, opt.init(params))
    gen = torch.Generator().manual_seed(pl["seed"])
    hist = []
    for _ in range(H.CASES["tp2_tome_draws"]["draws"]):
        state, m = tstep.train_step(state, pl["batch"], gen, cfg=cfg,
                                    optimizer=opt, device="cpu")
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got["hist"], hist, rtol=TOL)
    want = H.flat(state.params)
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], atol=1e-5)


def test_sharded_trainer_resume(tmp_path):
    """The Trainer on dp 1 x tp 2 with sp and ZeRO-3: an uninterrupted
    2-epoch run and a 1-epoch run resumed to 2 from its sharded ``.ckpt``
    (written by rank 0 from the gathered state) end with the same params,
    bit for bit; the file reads back in one process."""
    from vitx_torch.train.checkpoint import restore_latest

    cfg = vitx_torch.get_config("tiny", **KW)
    pl = dict(cfg=cfg.to_json(), dp=1, tp=2, epochs=2,
              a=str(tmp_path / "a"), b=str(tmp_path / "b"))
    got = spawn(H.run_trainer, 2, (pl,), device="cpu",
                init_method=f"file://{tmp_path / 'rdv'}")[0]
    for k in got["a"]:
        assert np.array_equal(got["a"][k], got["b"][k]), k
    assert got["meta"]["epoch"] == 1 and got["history"][0]["epoch"] == 1
    opt = tstep.make_optimizer(lr=1e-3)
    template = tstep.create_train_state(0, cfg, opt, device="cpu")
    restored, _ = restore_latest(pl["b"], template, False)
    for k, v in H.flat(restored.params).items():
        assert np.array_equal(v, got["b"][k]), k


def test_train_cli_dp_zero3_and_dryrun(tmp_path, capsys, monkeypatch):
    """``cli.train --dp 2 --zero 3`` spawns its ranks, trains an epoch and
    writes a ``.ckpt`` that ``cli.eval`` reads; the dryrun's paths run on
    four CPU ranks and print vitx's summary line, its pipeline part
    included (pp x tp, which takes 8 ranks, ``nan`` as vitx prints it)."""
    from vitx_torch.cli import eval as teval
    from vitx_torch.cli import train as ttrain
    from vitx_torch.parallel import dryrun

    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    argv = ["--preset", "tiny", "--image-size", "32", "--data",
            "procedural:32,16", "--batch-size", "8", "--epochs", "1",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck")]
    assert ttrain.main(argv + ["--dp", "2", "--zero", "3"]) == 0
    assert teval.main(["--checkpoint", str(tmp_path / "ck"), "--data",
                       "procedural:32,16", "--device", "cpu"]) == 0
    assert dryrun.main(["4", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.match(r"dryrun_multichip ok: mesh=\(2 data x 2 model\), "
                    r"loss=\d", line), line
    assert "moe 1 data x 2 model x 2 expert" in line
    assert re.search(r"pp_loss=\d\.\d{4} \(pipeline 2 data x 2 stage; "
                     r"1f1b_loss=\d\.\d{4}; pp_x_tp_1f1b_loss=nan at 2 "
                     r"data x 2 stage x 2 model\)", line), line
    assert "nan" not in line.replace("pp_x_tp_1f1b_loss=nan", "")


@pytest.mark.parametrize("argv,match", [
    (["--sp", "--dp", "1"], "--sp requires --tp > 1"),
    (["--ep", "2"], "--ep > 1 requires --moe-experts"),
    (["--dp", "3", "--batch-size", "8"], "divisible by --dp 3"),
    pytest.param(["--pp", "2", "--ep", "2", "--moe-experts", "2"],
                 "--ep does not compose with --pp", id="argv3-A13.2"),
    pytest.param(["--pp-schedule", "1f1b", "--pp", "2", "--batch-size",
                  "12", "--pp-microbatches", "8"],
                 "--batch-size 12 must be divisible by --dp 1 x "
                 "--pp-microbatches 8", id="argv4-A13.2"),
])
def test_cli_refusals(argv, match):
    """vitx's checks of the parallel flags, with its messages; the
    pipeline's (ported since the case ids were named): ``--ep`` beside
    ``--pp``, a batch that the data ranks' microbatches do not divide."""
    from vitx_torch.cli import train as ttrain

    with pytest.raises(SystemExit, match=re.escape(match)):
        ttrain.main(argv + ["--device", "cpu"])


def test_trainer_and_step_refusals():
    """vitx's refusals: steps_per_dispatch > 1 on a mesh (its message),
    ZeRO-3 on a pipeline mesh (its message: the pipeline fields, once
    refused, are ported), sp without tp, ep without a MoE config or an
    expert axis, a tp flag that disagrees with the mesh."""
    from vitx_torch.train import loop as tloop

    cfg = vitx_torch.get_config("tiny", **KW)
    mesh = Mesh({"data": 2, "model": 1}, 0, "cpu", "gloo")
    with pytest.raises(ValueError) as got:
        tloop.Trainer(cfg, tloop.TrainerConfig(steps_per_dispatch=2),
                      mesh=mesh)
    assert "steps_per_dispatch > 1 is a single-device" in str(got.value)
    pp_mesh = Mesh({"data": 1, "stage": 2}, 0, "cpu", "gloo")
    with pytest.raises(ValueError, match="composes with dp, tp and zero1"):
        tloop.Trainer(cfg, tloop.TrainerConfig(pp_microbatches=2),
                      mesh=pp_mesh, zero3=True)
    for fn, want in [
            (lambda: sharded.sp_cfg(cfg, False, True),
             lambda: jsh.sp_cfg(vitx.get_config("tiny"), False, True)),
            (lambda: sharded.ep_cfg(cfg, mesh, True),
             lambda: jsh.ep_cfg(vitx.get_config("tiny"), None, True))]:
        with pytest.raises(ValueError) as mine:
            fn()
        with pytest.raises(ValueError) as theirs:
            want()
        assert str(mine.value) == str(theirs.value)
    moe = cfg.replace(moe_experts=2, moe_blocks=1)
    with pytest.raises(ValueError, match="requires an expert mesh axis"):
        sharded.ep_cfg(moe, mesh, True)
    with pytest.raises(ValueError, match="tp=True on a mesh"):
        sharded.make_parallel_train_step(cfg, tstep.make_optimizer(), mesh,
                                         tp=True)


def test_port_imports_no_jax():
    """No module of the port imports JAX or the JAX package."""
    root = pathlib.Path(vitx_torch.__file__).parent
    bad = re.compile(r"^\s*(import|from)\s+(jax|vitx)(\.|\s|$)", re.M)
    hits = [str(p) for p in root.rglob("*.py") if bad.search(p.read_text())]
    assert hits == []
