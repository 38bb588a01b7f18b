"""vitx's ``.ckpt`` format in the port (vitx_torch.train.checkpoint), on the
CPU, against vitx's own reader and writer.

For each optimizer chain the recipe can build -- a constant lr, a cosine
schedule, the schedule with the EMA, and that with ``wd_exclude`` and
clipping -- the leaf order is taken from vitx's ``tree_flatten`` of its
``TrainState``, and files cross both ways bit for bit: vitx writes, the
port reads (``restore_checkpoint``, ``restore_eval_params``); the port
writes, vitx reads. Then pruning, quarantine, the async writer, the
leaf-count probe, the refusals, and a server built from a ``.ckpt``.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vitx
import vitx_torch
from vitx.serve import load_server as jload_server
from vitx.train import checkpoint as jckpt
from vitx.train import step as jstep
from vitx_torch.serve import load_server
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

KW = dict(compute_dtype="float32")
JCFG = vitx.get_config("tiny", **KW)
TCFG = vitx_torch.get_config("tiny", **KW)
CHAINS = {
    "const": {},
    "cosine": {"schedule": True},
    "cosine_ema": {"schedule": True, "ema_decay": 0.99},
    "cosine_ema_wdx_clip": {"schedule": True, "ema_decay": 0.99,
                            "wd_exclude": True, "grad_clip": 1.0},
}


def optimizers(chain):
    kw = dict(CHAINS[chain])
    sched = kw.pop("schedule", False)
    jopt = jstep.make_optimizer(
        lr=1e-3, weight_decay=0.05,
        schedule=jstep.warmup_cosine(1e-3, 10, 2) if sched else None, **kw)
    topt = tstep.make_optimizer(
        lr=1e-3, weight_decay=0.05,
        schedule=tstep.warmup_cosine(1e-3, 10, 2) if sched else None, **kw)
    return jopt, topt, sched


def vitx_names(state):
    """Each leaf of vitx's flatten named by what it holds: 'step',
    'params/a/b', 'count' (Adam's or the schedule's), 'mu/..', 'nu/..',
    'ema/..'."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(state)[0]:
        node, keys = state, []
        for k in path[:-1]:
            node = (getattr(node, k.name) if hasattr(k, "name")
                    else node[getattr(k, "key", getattr(k, "idx", None))])
        last = path[-1]
        if isinstance(node, (optax.ScaleByAdamState,
                             optax.ScaleByScheduleState)) and \
                getattr(last, "name", None) == "count":
            out.append("count")
            continue
        for k in path:
            if hasattr(k, "name") and k.name in ("step", "params", "mu",
                                                 "nu", "ema"):
                keys.append(k.name)
            elif hasattr(k, "key"):
                keys.append(str(k.key))
        out.append("/".join(keys))
    return out


def port_names(state, schedule):
    """The same names for the port's ``state_leaves``, by identity."""
    named = {id(state.step): "step", id(state.opt_state.count): "count"}
    for prefix, tree in (("params", state.params),
                         ("mu", state.opt_state.mu),
                         ("nu", state.opt_state.nu),
                         ("ema", state.opt_state.ema)):
        if tree is None:
            continue
        for name, leaf in zip(_paths(tree), tstep.leaves(tree)):
            named[id(leaf)] = f"{prefix}/{name}"
    return [named[id(x)] for x in tckpt.state_leaves(state, schedule)]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), params)


@pytest.fixture(scope="module")
def init_params():
    return jax.tree.map(np.asarray,
                        vitx.init_params(jax.random.PRNGKey(0), JCFG))


def vitx_state(init_params, jopt, updates=2):
    params = jax.tree.map(jnp.asarray, init_params)
    state = jstep.TrainState(jnp.asarray(5, jnp.int32), params,
                             jopt.init(params))
    upd = jax.jit(jopt.update)
    for i in range(updates):
        u, opt_state = upd(random_grads(params, i), state.opt_state, params)
        params = optax.apply_updates(params, u)
        state = jstep.TrainState(state.step + 1, params, opt_state)
    return state


def port_state(init_params, topt, updates=2):
    p = vitx_torch.params_from_jax(init_params, TCFG, "cpu")
    state = tstep.TrainState(5, p, topt.init(p))
    for i in range(updates):
        grads = [torch.from_numpy(np.asarray(g)) for g in
                 jax.tree_util.tree_leaves(random_grads(init_params, i))]
        state = tstep.TrainState(state.step + 1, *topt.update(
            grads, state.opt_state, state.params))
    return state


def flat_arrays(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


@pytest.mark.parametrize("chain", list(CHAINS))
def test_leaf_order_is_vitx_flatten(init_params, chain):
    jopt, topt, sched = optimizers(chain)
    jst = jstep.create_train_state(jax.random.PRNGKey(0), JCFG, jopt)
    tst = tstep.create_train_state(0, TCFG, topt, device="cpu")
    tst = tst._replace(step=10**6 + 3, opt_state=tst.opt_state._replace(
        count=10**6 + 4))
    assert port_names(tst, sched) == vitx_names(jst)
    arrays = tckpt.snapshot(tst, sched)
    for got, want in zip(arrays, jax.tree_util.tree_leaves(jst)):
        assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("chain", list(CHAINS))
def test_vitx_written_read_by_port(tmp_path, init_params, chain):
    jopt, topt, sched = optimizers(chain)
    jst = vitx_state(init_params, jopt)
    meta = {"schedule": True} if sched else {}
    if CHAINS[chain].get("ema_decay"):
        meta["ema_decay"] = CHAINS[chain]["ema_decay"]
    jckpt.save_checkpoint(tmp_path, jax.device_get(jst), 3, meta=meta)
    template = tstep.create_train_state(1, TCFG, topt, device="cpu")
    got, gmeta = tckpt.restore_checkpoint(tmp_path / "3.ckpt", template,
                                          sched)
    assert gmeta["epoch"] == 3 and got.step == 7 and got.opt_state.count == 2
    for a, b in zip(tckpt.snapshot(got, sched), flat_arrays(jst)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    params, _ = tckpt.restore_eval_params(tmp_path, TCFG, device="cpu")
    want, _ = jckpt.restore_eval_params(tmp_path, JCFG)
    for a, b in zip(tstep.leaves(params), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("chain", list(CHAINS))
def test_port_written_read_by_vitx(tmp_path, init_params, chain):
    jopt, topt, sched = optimizers(chain)
    tst = port_state(init_params, topt)
    meta = {"schedule": True} if sched else {}
    if CHAINS[chain].get("ema_decay"):
        meta["ema_decay"] = CHAINS[chain]["ema_decay"]
    tckpt.save_checkpoint(tmp_path, tckpt.snapshot(tst, sched), 4, meta=meta)
    template = jstep.create_train_state(jax.random.PRNGKey(1), JCFG, jopt)
    got, gmeta = jckpt.restore_checkpoint(tmp_path / "4.ckpt", template)
    assert gmeta["epoch"] == 4
    for a, b in zip(flat_arrays(got), tckpt.snapshot(tst, sched)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ema = jstep.get_ema_params(got.opt_state)
    want = tst.opt_state.ema if ema is not None else tst.params
    params, _ = jckpt.restore_eval_params(tmp_path, JCFG)
    for a, b in zip(jax.tree_util.tree_leaves(params), tstep.leaves(want)):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("chain", ["cosine", "cosine_ema_wdx_clip"])
def test_eval_params_probe_leaf_count(tmp_path, init_params, chain):
    """A meta without ``ema_decay`` and ``schedule``: the leaf count tells
    the chain, as in vitx."""
    _, topt, sched = optimizers(chain)
    tst = port_state(init_params, topt, updates=1)
    tckpt.save_checkpoint(tmp_path, tckpt.snapshot(tst, sched), 0)
    params, _ = tckpt.restore_eval_params(tmp_path / "0.ckpt", TCFG,
                                          device="cpu")
    want = tst.opt_state.ema if tst.opt_state.ema is not None else tst.params
    for a, b in zip(tstep.leaves(params), tstep.leaves(want)):
        assert torch.equal(a, b)


def test_keep_protect_and_listing(tmp_path, init_params):
    _, topt, _ = optimizers("const")
    arrays = tckpt.snapshot(port_state(init_params, topt, 0), False)
    for epoch in range(5):
        tckpt.save_checkpoint(tmp_path, arrays, epoch, keep=2, protect=1)
    assert tckpt.list_checkpoints(tmp_path) == [1, 3, 4]
    assert jckpt.list_checkpoints(tmp_path) == [1, 3, 4]
    assert tckpt.find_latest(tmp_path) == 4
    assert not list(tmp_path.glob("*.tmp.npz"))
    assert tckpt.peek_meta(tmp_path)["epoch"] == 4


def test_quarantine_and_async_bytes(tmp_path, init_params):
    _, topt, sched = optimizers("cosine_ema")
    tst = port_state(init_params, topt, 1)
    arrays = tckpt.snapshot(tst, sched)
    sync, asyn = tmp_path / "sync", tmp_path / "async"
    for epoch in (0, 1):
        tckpt.save_checkpoint(sync, arrays, epoch, meta={"schedule": True})
    writer = tckpt.AsyncCheckpointWriter()
    writer.save(asyn, arrays, 1, meta={"schedule": True})
    writer.wait()
    assert (asyn / "1.ckpt").read_bytes() == (sync / "1.ckpt").read_bytes()
    (tmp_path / "afile").write_text("")
    writer.save(tmp_path / "afile", arrays, 0)
    with pytest.raises(OSError):
        writer.wait()
    data = (sync / "1.ckpt").read_bytes()
    (sync / "1.ckpt").write_bytes(data[: len(data) // 2])
    template = tstep.create_train_state(1, TCFG, topt, device="cpu")
    with pytest.warns(UserWarning, match="quarantined"):
        got, meta = tckpt.restore_latest(sync, template, sched)
    assert meta["epoch"] == 0 and (sync / "1.ckpt.corrupt").exists()
    assert tckpt.list_checkpoints(sync) == [0]
    for a, b in zip(tckpt.snapshot(got, sched), arrays):
        assert np.array_equal(a, b)
    # a file of another chain raises instead of being quarantined
    _, plain, _ = optimizers("const")
    other = tstep.create_train_state(1, TCFG, plain, device="cpu")
    with pytest.raises(KeyError, match="leaves"):
        tckpt.restore_latest(sync, other, False)


def test_orbax_and_unported_artifacts_refused(tmp_path):
    (tmp_path / "3.orbax").mkdir()
    with pytest.raises(NotImplementedError, match="JAX stack"):
        tckpt.restore_eval_params(tmp_path / "3.orbax", TCFG, device="cpu")
    with pytest.raises(NotImplementedError, match="JAX stack"):
        tckpt.restore_eval_params(tmp_path, TCFG, device="cpu")
    with pytest.raises(NotImplementedError, match=r"\.pt2"):
        tckpt.load_artifact_params(tmp_path / "m.stablehlo", TCFG, "cpu")
    with pytest.raises(ValueError, match="no parameters"):
        tckpt.load_artifact_params(tmp_path / "m.pt2", TCFG, "cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.load_artifact_params(tmp_path / "none", TCFG, "cpu")
    (tmp_path / "0.ckpt").write_text("{}")
    meta = {"optimizer": "sgd", "epoch": 0}
    tckpt.save_checkpoint(tmp_path / "sgd", [], 0, meta=meta)
    with pytest.raises(NotImplementedError, match="A12"):
        tckpt.restore_eval_params(tmp_path / "sgd", TCFG, device="cpu")


def test_artifact_config_from_meta(tmp_path, init_params):
    _, topt, _ = optimizers("const")
    cfg = TCFG.replace(num_classes=7, tome_r=3)
    meta = {"config": json.loads(cfg.to_json())}
    p = vitx_torch.init_params(0, cfg, device="cpu")
    st = tstep.TrainState(0, p, topt.init(p))
    tckpt.save_checkpoint(tmp_path, tckpt.snapshot(st, False), 2, meta=meta)
    got = tckpt.resolve_artifact_config(tmp_path, None, "base16")
    assert got == cfg.replace(tome_r=0)
    want = jckpt.resolve_artifact_config(str(tmp_path), None, "base16")
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert tckpt.resolve_artifact_config(tmp_path, None, "base16",
                                         tome_r=2).tome_r == 2


def test_load_server_ckpt_matches_vitx(tmp_path, init_params):
    """A ``.ckpt`` with an EMA served by both packages: the EMA shadow, the
    same probabilities within 1e-4."""
    jopt, topt, sched = optimizers("cosine_ema")
    jst = vitx_state(init_params, jopt)
    jckpt.save_checkpoint(tmp_path, jax.device_get(jst), 1,
                          meta={"schedule": True, "ema_decay": 0.99})
    imgs = np.random.default_rng(3).standard_normal(
        (3, 64, 64, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsrv = jload_server(str(tmp_path / "1.ckpt"), JCFG, batch_size=4,
                            top_k=4)
    try:
        want = [jsrv.predict(x) for x in imgs]
    finally:
        jsrv.close()
    with load_server(tmp_path, TCFG, batch_size=4, top_k=4,
                     device="cpu") as srv:
        got = [srv.predict(x) for x in imgs]
        ema = jstep.get_ema_params(jst.opt_state)
        for a, b in zip(tstep.leaves(srv._params),
                        jax.tree_util.tree_leaves(ema)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    for g, w in zip(got, want):
        assert g["classes"] == list(w["classes"])
        assert np.abs(np.array(g["probs"]) - np.array(w["probs"])).max() \
            <= 1e-4
