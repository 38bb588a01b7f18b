"""The port's optimizers against vitx's optax chains, on the CPU.

SGD with momentum, Lion, Adafactor and AdamW with a bf16 first moment
(``vitx_torch.train.step``) against ``vitx.train.step.make_optimizer``:
the whole state -- params and every slot, in vitx's flatten order
(``state_leaves``) -- after 3 updates of numpy trees (4 with
accumulation), within 1e-6 of each leaf's largest magnitude, with
Adafactor's factored shapes (a (2, 128, 256) leaf, a (128, 128) tie), the
bf16 moment bit for bit but for a few elements one bf16 ulp apart, and
Lion's sign flips counted; then one depth-2
fp32 train step of a model per optimizer against vitx's ``train_step``
(the repo's 1e-4 bar, ``tests/test_torch_train.py``); the optax states
carried across (``opt_state_from_jax``); ``.ckpt`` files of every chain
both ways (vitx writes, the port reads; the port writes, vitx reads --
except the bf16 moment, which vitx's ``restore_checkpoint`` cannot cast
back from numpy's void: its bytes are held to vitx's own file's); and
``soup_params`` bit-equal to vitx's soup of the same files.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vitx
import vitx_torch
from vitx.train import checkpoint as jckpt
from vitx.train import step as jstep
from vitx_torch.nn.vit import param_spec
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

TREE_BAR = 1e-6          # relative to each leaf's largest magnitude
STEP_BAR = 1e-4          # the repo's fp32 bar


def sched(count):
    return 1e-2 * (0.5 + 0.1 * count)


# chain id -> (optimizer, make_optimizer knobs); "schedule" True is sched
CHAINS = {
    "sgd": ("sgd", {}),
    "lion": ("lion", {}),
    "adafactor": ("adafactor", {}),
    "adamw_mu_bf16": ("adamw", {"mu_dtype": "bfloat16"}),
    "adamw_mu_f32": ("adamw", {"mu_dtype": "float32"}),
    "sgd_wdx_sched_head_clip": ("sgd", {"wd_exclude": True,
                                        "schedule": True,
                                        "trainable": "head",
                                        "grad_clip": 1.0}),
    "lion_wdx_accum": ("lion", {"wd_exclude": True, "accum_steps": 2}),
    "adafactor_sched_ema_accum_llrd": ("adafactor", {
        "schedule": True, "ema_decay": 0.9, "accum_steps": 2,
        "llrd": 0.5, "llrd_depth": 2}),
    "adafactor_wdx": ("adafactor", {"wd_exclude": True}),
    "adamw_mu_bf16_sched_ema": ("adamw", {"mu_dtype": "bfloat16",
                                          "schedule": True,
                                          "ema_decay": 0.9}),
}


def optimizers(chain, lr=1e-2, weight_decay=0.05):
    name, kw = CHAINS[chain]
    kw = dict(kw, optimizer=name, lr=lr, weight_decay=weight_decay)
    has_sched = kw.pop("schedule", False)
    if has_sched:
        kw["schedule"] = sched
    return jstep.make_optimizer(**kw), tstep.make_optimizer(**kw), has_sched


def numpy_tree(seed=0):
    """A small params tree of vitx's key names: a factored (2, 128, 256)
    block leaf, a (128, 128) one (equal axes), unfactored vectors and a
    head matrix whose second axis is below 128."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"blocks": {"w1": n(2, 128, 256), "b1": n(2, 256),
                       "ln1_scale": n(2, 32)},
            "head": {"w": n(130, 5), "b": n(5)},
            "patch_embed": {"kernel": n(128, 128)},
            "pos_embed": n(1, 4, 8)}


def as_port(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def host(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(np.asarray(x), np.float32)


@functools.lru_cache(maxsize=None)
def run_both(chain, steps):
    """``steps`` updates of the same gradient trees by both packages ->
    (vitx's TrainState leaves, the port's state_leaves, the two states,
    the schedule flag)."""
    jopt, topt, has_sched = optimizers(chain)
    params = numpy_tree()
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape))
                          .astype(np.float32), params) for _ in range(steps)]
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = as_port(params)
    ts = topt.init(tp)
    update = jax.jit(jopt.update)
    for g in grads:
        u, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = topt.update(as_port(g), ts, tp)
    jstate = jstep.TrainState(jnp.int32(steps), jp, js)
    tstate = tstep.TrainState(steps, tp, ts)
    return (jax.tree.leaves(jstate), tckpt.state_leaves(tstate, has_sched),
            jstate, tstate, has_sched)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_update_matches_optax(chain):
    """The state after 3 updates (4 with accumulation: two real ones) in
    vitx's flatten order: same leaf count and shapes, every leaf within
    TREE_BAR of its largest magnitude; a bf16 first moment bit for bit but
    for at most 1e-4 of its elements one bf16 ulp apart (3 of 83k here,
    printed)."""
    steps = 4 if "accum" in chain else 3
    want, got, *_ = run_both(chain, steps)
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        a_np = np.asarray(a)
        assert tuple(a_np.shape) == tuple(np.shape(host(b))), i
        if torch.is_tensor(b) and b.dtype == torch.bfloat16:
            # the fp32 moment before its rounding differs by an fp32 ulp
            # now and then (XLA fuses the multiply-add), which moves a
            # few elements across a bf16 rounding boundary
            assert a_np.dtype.name == "bfloat16"
            ulps = np.abs(a_np.view(np.uint16).astype(np.int32)
                          - b.view(torch.int16).numpy().view(np.uint16)
                          .astype(np.int32))
            print(f"{chain} leaf {i}: {int((ulps > 0).sum())} of "
                  f"{ulps.size} bf16 elements one ulp apart")
            assert ulps.max() <= 1 and (ulps > 0).mean() <= 1e-4, i
            continue
        a32, b32 = host(a), host(b)
        scale = max(float(np.max(np.abs(a32))), 1e-30)
        assert float(np.max(np.abs(a32 - b32))) <= TREE_BAR * scale, (
            chain, i, float(np.max(np.abs(a32 - b32))) / scale)


def test_lion_sign_flips():
    """Lion's update is a sign: an element whose interpolated momentum is
    near 0 could take the other sign on a rounding difference. Over 3
    steps on the tree no element flips here; the count is printed."""
    jopt, topt, _ = optimizers("lion")
    params = numpy_tree()
    rng = np.random.default_rng(2)
    jp, tp = jax.tree.map(jnp.asarray, params), as_port(params)
    js, ts = jopt.init(jp), topt.init(tp)
    flips = total = 0
    for _ in range(3):
        g = jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape))
                         .astype(np.float32), params)
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        before = jax.tree.map(lambda t: t.clone(), tp)
        tp, ts = topt.update(as_port(g), ts, tp)
        for du, b, a in zip(jax.tree.leaves(u), jax.tree.leaves(before),
                            jax.tree.leaves(tp)):
            flips += int(np.sum(np.sign(np.asarray(du))
                                != np.sign((a - b).numpy())))
            total += a.numel()
        jp = optax.apply_updates(jp, u)
    print(f"lion: {flips} of {total} update signs flipped over 3 steps")
    assert flips == 0


def test_factored_shapes_are_optax():
    """Adafactor's slot shapes per leaf are optax's ``FactoredState``'s."""
    jopt, topt, _ = optimizers("adafactor")
    params = numpy_tree()
    js = jopt.init(jax.tree.map(jnp.asarray, params))
    node = [s for s in jax.tree.leaves(
        js, is_leaf=lambda s: hasattr(s, "v_row")) if hasattr(s, "v_row")][0]
    ts = topt.init(as_port(params))
    for field in ("v_row", "v_col", "v"):
        want = jax.tree.map(lambda a: tuple(a.shape), getattr(node, field))
        got = jax.tree.map(lambda t: tuple(t.shape), getattr(ts, field))
        assert want == got, field


# --- a model step per optimizer ----------------------------------------------

KW = dict(depth=2, compute_dtype="float32", image_size=32, fuse_mha="off")
JCFG = vitx.get_config("tiny", **KW)
TCFG = vitx_torch.get_config("tiny", **KW)


def model_params(seed=0):
    """vitx-layout weights drawn with numpy from ``param_spec`` (each
    leaf's init value plus N(0, 0.02) noise, so the zero biases take
    part)."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        shape, init = node
        base = (0.02 * rng.standard_normal(shape) if init == "normal"
                else np.full(shape, init))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    return draw(param_spec(TCFG))


def model_batch(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 4, n).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def vitx_step(chain):
    jopt, _, _ = optimizers(chain, lr=1e-3)
    params = jax.tree.map(jnp.asarray, model_params())
    state = jstep.TrainState(jnp.int32(0), params, jopt.init(params))
    batch = jax.tree.map(jnp.asarray, model_batch())
    new, m = jax.jit(functools.partial(jstep.train_step, cfg=JCFG,
                                       optimizer=jopt))(state, batch, None)
    return jax.tree.map(np.asarray, new.params), float(m["loss"])


@pytest.mark.parametrize("chain", ["sgd", "lion", "adafactor",
                                   "adamw_mu_bf16"])
def test_model_step_matches_vitx(chain):
    """One depth-2 fp32 train step: loss and params within 1e-4 (relative
    to each leaf's largest) of vitx's jitted step."""
    want, want_loss = vitx_step(chain)
    _, topt, _ = optimizers(chain, lr=1e-3)
    params = vitx_torch.params_from_jax(model_params(), TCFG, device="cpu")
    state = tstep.TrainState(0, params, topt.init(params))
    state, m = tstep.train_step(state, model_batch(), cfg=TCFG,
                                optimizer=topt, device="cpu")
    assert abs(float(m["loss"]) - want_loss) <= STEP_BAR * abs(want_loss)
    got = jax.tree.map(lambda t: t.numpy(), state.params)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert np.max(np.abs(a - b)) <= STEP_BAR * max(np.max(np.abs(a)),
                                                       1e-12)


# --- states and files --------------------------------------------------------

@pytest.mark.parametrize("chain", ["sgd", "lion", "adafactor",
                                   "adamw_mu_bf16"])
def test_opt_state_from_jax(chain):
    """``opt_state_from_jax`` on a model's state (shapes from the
    config's ``param_spec``): the slots equal vitx's bit for bit, the
    count carried (none for SGD)."""
    jopt, _, _ = optimizers(chain)
    params = jax.tree.map(jnp.asarray, model_params())
    rng = np.random.default_rng(4)
    g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                           .astype(np.float32)), params)
    _, js = jax.jit(jopt.update)(g, jopt.init(params), params)
    got = vitx_torch.opt_state_from_jax(js, TCFG, device="cpu")
    assert got.count == (0 if chain == "sgd" else 1)
    from vitx_torch.interop.jax_params import _opt_node
    _, node = _opt_node(js)
    for field in got.SLOTS:
        for a, b in zip(jax.tree.leaves(getattr(node, field)),
                        tstep.leaves(getattr(got, field))):
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                assert b.dtype == torch.bfloat16
                assert np.array_equal(a.view(np.uint16), b.view(
                    torch.int16).numpy().view(np.uint16))
            else:
                assert np.array_equal(a, b.numpy())


def npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("leaf_")}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_ckpt_both_ways(chain, tmp_path):
    """vitx's ``.ckpt`` of the state after the updates: the port reads it
    into a template of its own chain, every leaf bit for bit, and writes
    it back byte for byte; vitx reads the port's file into its own
    template bit for bit (the bf16 moment's file, which vitx cannot cast
    back, is held byte for byte instead)."""
    steps = 4 if "accum" in chain else 3
    want, got, jstate, tstate, has_sched = run_both(chain, steps)
    jckpt.save_checkpoint(tmp_path / "jax", jstate, 3)
    restored, _ = tckpt.restore_checkpoint(tmp_path / "jax" / "3.ckpt",
                                           tstate, has_sched)
    for a, b in zip(want, tckpt.state_leaves(restored, has_sched)):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            assert np.array_equal(a.view(np.uint16), b.view(
                torch.int16).numpy().view(np.uint16))
        else:
            assert np.array_equal(a, host(b) if torch.is_tensor(b)
                                  else np.asarray(b))
    tckpt.save_checkpoint(tmp_path / "port",
                          tckpt.snapshot(restored, has_sched), 3)
    mine = npz_arrays(tmp_path / "port" / "3.ckpt")
    theirs = npz_arrays(tmp_path / "jax" / "3.ckpt")
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype, k
        assert mine[k].tobytes() == theirs[k].tobytes(), k
    if "mu_bf16" in chain:
        return
    back, _ = jckpt.restore_checkpoint(tmp_path / "port" / "3.ckpt", jstate)
    for a, b in zip(jax.tree.leaves(back), want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("optimizer", ["sgd", "lion", "adafactor"])
def test_eval_params_from_each_chain(optimizer, tmp_path):
    """A run's ``.ckpt`` with meta ``optimizer`` (vitx's): both packages'
    ``restore_eval_params`` give the same params."""
    jopt = jstep.make_optimizer(optimizer=optimizer)
    params = jax.tree.map(jnp.asarray, model_params())
    state = jstep.TrainState(jnp.int32(0), params, jopt.init(params))
    meta = {"optimizer": optimizer,
            "config": json.loads(JCFG.to_json())}
    jckpt.save_checkpoint(tmp_path, state, 0, meta=meta)
    got, _ = tckpt.restore_eval_params(tmp_path, TCFG, device="cpu")
    want, _ = jckpt.restore_eval_params(tmp_path, JCFG)
    for a, b in zip(jax.tree.leaves(want), tstep.leaves(got)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_soup_matches_vitx(tmp_path, capsys):
    """``soup_params`` of three ``.ckpt`` files equals vitx's bit for bit
    (fp32 sum in order, over n, cast back); an ingredient of another
    geometry is refused with vitx's message; ``eval --soup`` through both
    CLIs reports the same."""
    from vitx.cli import eval as jeval
    from vitx_torch.cli import eval as teval

    cfg_j = vitx.get_config("tiny", compute_dtype="float32")
    cfg_t = vitx_torch.get_config("tiny", compute_dtype="float32")
    meta = {"config": json.loads(cfg_j.to_json())}
    opt = jstep.make_optimizer()
    dirs = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        p = {k: v for k, v in jax.tree.map(
            lambda s: (0.02 * rng.standard_normal(s[0])).astype(np.float32),
            param_spec(cfg_t), is_leaf=lambda x: isinstance(x, tuple))
            .items()}
        p = jax.tree.map(jnp.asarray, p)
        d = tmp_path / f"m{seed}"
        jckpt.save_checkpoint(d, jstep.TrainState(jnp.int32(0), p,
                                                  opt.init(p)), 0, meta=meta)
        dirs.append(d)
    base_j, _ = jckpt.load_artifact_params(dirs[0], cfg_j)
    want = jckpt.soup_params(base_j, cfg_j, [str(d) for d in dirs[1:]])
    base_t, _ = tckpt.load_artifact_params(dirs[0], cfg_t, device="cpu")
    got = tckpt.soup_params(base_t, cfg_t, dirs[1:], device="cpu")
    for a, b in zip(jax.tree.leaves(want), tstep.leaves(got)):
        assert np.array_equal(np.asarray(a), b.numpy())
    other = tmp_path / "other"
    cfg_o = cfg_j.replace(depth=2)
    po = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda s: np.zeros(s[0], np.float32), param_spec(
            cfg_t.replace(depth=2)), is_leaf=lambda x: isinstance(x, tuple)))
    jckpt.save_checkpoint(other, jstep.TrainState(
        jnp.int32(0), po, opt.init(po)), 0,
        meta={"config": json.loads(cfg_o.to_json())})
    with pytest.raises(ValueError) as je:
        jckpt.soup_params(base_j, cfg_j, [str(other)])
    with pytest.raises(ValueError) as te:
        tckpt.soup_params(base_t, cfg_t, [other], device="cpu")
    assert str(te.value) == str(je.value)
    argv = ["--checkpoint", str(dirs[0]), "--soup", *map(str, dirs[1:]),
            "--batch-size", "32", "--data", "synthetic"]
    outs = []
    for main, extra in ((jeval.main, []), (teval.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        outs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert outs[0]["accuracy"] == outs[1]["accuracy"]
    assert outs[0]["confusion_matrix"] == outs[1]["confusion_matrix"]
