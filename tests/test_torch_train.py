"""The port's train and eval steps against vitx's, on the CPU.

vitx's steps run jitted on the CPU backend ``tests/conftest.py`` sets, with
``fuse_mha="on"`` so that its fused MHA block (stash and VJP, the flash
backward) runs in Pallas interpret mode; the port runs the same config,
where the kernels' plain versions run. Weights come from
``vitx.init_params`` carried across with ``params_from_jax``; the batches
come from ``SyntheticDataset(seed=0)`` of each package, which must agree.
Dropout is 0 and the steps are deterministic (no generator). Bars, as
max |a - b| over max |b|: fp32 1e-4 (the repo's parity bar) for losses and
gradients; bf16 losses within 0.05 (``tests/test_parity_torch.py:80``).
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.data.synthetic import SyntheticDataset as JSynthetic
from vitx.train import step as jstep
from vitx_torch.data import SyntheticDataset
from vitx_torch.metrics import confusion_matrix
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

LR = 1e-3
PARAM_BAR = 0.05 * LR   # see test_train_trajectory_matches_vitx


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def batches(n_batches, size, **ds_kw):
    """The same batches from both packages' SyntheticDataset."""
    ds, jds = SyntheticDataset(**ds_kw), JSynthetic(**ds_kw)
    out = []
    for i in range(n_batches):
        ex = [ds.get_example(j) for j in range(i * size, (i + 1) * size)]
        jex = [jds.get_example(j) for j in range(i * size, (i + 1) * size)]
        for (a, la), (b, lb) in zip(ex, jex):
            assert la == lb and np.array_equal(a, b)
        out.append({"image": np.stack([e[0] for e in ex]),
                    "label": np.array([e[1] for e in ex], np.int32)})
    return out


def tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict of arrays or tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach().float()
                                         if torch.is_tensor(v) else v,
                                         np.float32)
    return out


def vitx_run(cfg, params, data, steps):
    """vitx's jitted train_step over ``steps`` batches -> (losses, states
    after each step)."""
    opt = jstep.make_optimizer(lr=LR)
    step = jax.jit(functools.partial(jstep.train_step, cfg=cfg,
                                     optimizer=opt))
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             params=jax.tree.map(jnp.asarray, params),
                             opt_state=opt.init(params))
    losses, states = [], []
    for b in data[:steps]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        None)
        losses.append(float(m["loss"]))
        states.append(state)
    return losses, states


def port_state(params, cfg):
    opt = tstep.make_optimizer(lr=LR)
    p = vitx_torch.params_from_jax(params, cfg, "cpu")
    return opt, tstep.TrainState(0, p, opt.init(p))


@pytest.fixture(scope="module")
def tiny_fp32():
    kw = dict(compute_dtype="float32", fuse_mha="on")
    jcfg = vitx.get_config("tiny", **kw)
    tcfg = vitx_torch.get_config("tiny", **kw)
    params = tree_np(vitx.init_params(jax.random.PRNGKey(0), jcfg))
    data = batches(3, 8, seed=0)
    losses, states = vitx_run(jcfg, params, data, 3)
    return jcfg, tcfg, params, data, losses, states


def test_train_trajectory_matches_vitx(tiny_fp32):
    """3 steps on tiny, fp32: the losses, and the params after 3 steps.
    Adam moves each element by about lr per step whatever the size of its
    gradient, so a parameter's error is a fraction of lr rather than of the
    parameter: where |g| is small against the moments' own noise, a
    last-bit change in g moves that element's step by up to a few percent
    of lr (measured: 1.4 % of lr for one element of 65,536 in blocks/w2,
    under 0.3 % elsewhere). The bar is 5 % of one step, PARAM_BAR."""
    jcfg, tcfg, params, data, losses, states = tiny_fp32
    opt, state = port_state(params, tcfg)
    got = []
    for b in data:
        state, m = tstep.train_step(state, b, cfg=tcfg, optimizer=opt,
                                    device="cpu")
        got.append(float(m["loss"]))
        assert m["grad_norm"].dtype == torch.float32
    assert state.step == 3 and state.opt_state.count == 3
    assert rel_err(got, losses) <= 1e-4, (got, losses)
    ref = flat(tree_np(states[-1].params))
    for k, v in flat(state.params).items():
        assert np.abs(v - ref[k]).max() <= PARAM_BAR, k


def test_step1_grads_match_vitx(tiny_fp32):
    jcfg, tcfg, params, data, _, _ = tiny_fp32
    b = data[0]
    (loss, _), grads = jax.jit(jax.value_and_grad(
        functools.partial(jstep.loss_fn, cfg=jcfg, rng=None),
        has_aux=True))(jax.tree.map(jnp.asarray, params),
                       {k: jnp.asarray(v) for k, v in b.items()})
    p = vitx_torch.params_from_jax(params, tcfg, "cpu")
    pr = tstep.tree_map(lambda t: t.requires_grad_(), p)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tloss, _ = tstep.loss_fn(pr, tb, tcfg)
    tgrads = torch.autograd.grad(tloss, tstep.leaves(pr))
    assert abs(float(tloss) - float(loss)) <= 1e-4 * abs(float(loss))
    ref = flat(tree_np(grads))
    names = sorted(ref)
    assert len(names) == len(tgrads)
    for name, g in zip(names, tgrads):
        err = rel_err(g.numpy(), ref[name])
        assert err <= 1e-4, (name, err)


def test_carry_vitx_state_mid_run(tiny_fp32):
    """vitx's state after 2 steps (params and AdamW moments) carried over:
    the port's 3rd step gives vitx's 3rd loss and params."""
    jcfg, tcfg, params, data, losses, states = tiny_fp32
    two = states[1]
    opt = tstep.make_optimizer(lr=LR)
    state = tstep.TrainState(
        int(two.step), vitx_torch.params_from_jax(tree_np(two.params), tcfg,
                                                  "cpu"),
        vitx_torch.adamw_state_from_jax(two.opt_state, tcfg, "cpu"))
    assert state.opt_state.count == 2
    state, m = tstep.train_step(state, data[2], cfg=tcfg, optimizer=opt,
                                device="cpu")
    assert abs(float(m["loss"]) - losses[2]) <= 1e-4 * abs(losses[2])
    ref = flat(tree_np(states[2].params))
    for k, v in flat(state.params).items():
        assert np.abs(v - ref[k]).max() <= PARAM_BAR, k


def test_train_losses_bf16_match_vitx():
    kw = dict(compute_dtype="bfloat16", fuse_mha="on")
    jcfg = vitx.get_config("tiny", **kw)
    tcfg = vitx_torch.get_config("tiny", **kw)
    params = tree_np(vitx.init_params(jax.random.PRNGKey(1), jcfg))
    data = batches(3, 8, seed=0)
    losses, _ = vitx_run(jcfg, params, data, 3)
    opt, state = port_state(params, tcfg)
    got = []
    for b in data:
        state, m = tstep.train_step(state, b, cfg=tcfg, optimizer=opt,
                                    device="cpu")
        got.append(float(m["loss"]))
    assert rel_err(got, losses) < 0.05, (got, losses)


def test_base16_depth2_grads_match_vitx():
    """The base16 geometry at depth 2 in fp32, default routing (composed
    attention on the CPU in both): the loss and the gradients of the patch
    embedding, the QKV projections and the reference head."""
    jcfg = vitx.get_config("base16", depth=2, compute_dtype="float32")
    tcfg = vitx_torch.get_config("base16", depth=2, compute_dtype="float32")
    params = tree_np(vitx.init_params(jax.random.PRNGKey(2), jcfg))
    b = batches(1, 2, image_size=224, num_classes=1000, seed=0,
                num_examples=2)[0]
    (loss, _), grads = jax.jit(jax.value_and_grad(
        functools.partial(jstep.loss_fn, cfg=jcfg, rng=None),
        has_aux=True))(jax.tree.map(jnp.asarray, params),
                       {k: jnp.asarray(v) for k, v in b.items()})
    p = tstep.tree_map(lambda t: t.requires_grad_(),
                   vitx_torch.params_from_jax(params, tcfg, "cpu"))
    tloss, _ = tstep.loss_fn(p, {k: torch.from_numpy(v)
                                 for k, v in b.items()}, tcfg)
    tloss.backward()
    assert abs(float(tloss) - float(loss)) <= 1e-4 * abs(float(loss))
    ref = flat(tree_np(grads))
    got = flat(tstep.tree_map(lambda t: t.grad, p))
    for name in ("patch_embed/kernel", "patch_embed/bias", "blocks/wqkv",
                 "head/w1", "head/b1", "head/ln_scale", "head/ln_bias",
                 "head/w2", "head/b2"):
        err = rel_err(got[name], ref[name])
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("masked", [False, True])
def test_eval_step_matches_vitx(tiny_fp32, masked):
    jcfg, tcfg, params, data, _, _ = tiny_fp32
    b = dict(data[0])
    if masked:
        b["mask"] = np.array([1, 1, 1, 0, 1, 0, 1, 1], np.int32)
    cm_j, loss_j = jstep.eval_step(jax.tree.map(jnp.asarray, params),
                                   {k: jnp.asarray(v) for k, v in b.items()},
                                   cfg=jcfg)
    step = tstep.make_eval_step(tcfg, device="cpu")
    cm, loss = step(vitx_torch.params_from_jax(params, tcfg, "cpu"), b)
    assert cm.dtype == torch.int32
    assert np.array_equal(cm.numpy(), np.asarray(cm_j))
    assert abs(float(loss) - float(loss_j)) <= 1e-4 * abs(float(loss_j))


def test_make_train_step_overfits_one_batch():
    """The closure trains: the tiny model memorises one repeated batch of
    noise images (vitx's verify recipe) with the fused update, a schedule,
    clipping, and a generator driving dropout and drop-path."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32",
                                dropout=0.1, drop_path=0.1)
    opt = tstep.make_optimizer(lr=3e-3, schedule=tstep.warmup_cosine(
        3e-3, 20, warmup_steps=2), grad_clip=1.0, fused=True)
    state = tstep.create_train_state(0, cfg, opt, device="cpu")
    step = tstep.make_train_step(cfg, opt, device="cpu")
    rng = np.random.default_rng(2)
    b = {"image": rng.standard_normal((8, 64, 64, 3)).astype(np.float32),
         "label": rng.integers(0, 4, 8).astype(np.int32)}
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(20):
        state, m = step(state, b, gen)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.2 * losses[0], losses
    assert float(m["accuracy"]) == 1.0


def test_cross_entropy_matches_vitx():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 6).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 1, 0], np.int32)
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    for kw in ({}, {"mask": mask}, {"label_smoothing": 0.1},
               {"class_weights": w}, {"class_weights": w, "mask": mask,
                                      "label_smoothing": 0.2}):
        ref = jstep.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        got = tstep.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            **{k: (torch.from_numpy(v) if k == "mask" else v)
               for k, v in kw.items()})
        assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref)), kw


def test_confusion_matrix_matches_vitx():
    from vitx.metrics import confusion_matrix as jcm

    rng = np.random.default_rng(4)
    p, t = rng.integers(0, 7, 50), rng.integers(0, 7, 50)
    ref = np.asarray(jcm(jnp.asarray(p), jnp.asarray(t), 7))
    got = confusion_matrix(torch.from_numpy(p), torch.from_numpy(t), 7)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("call,item", [
    ("optimizer=sgd", "A12"), ("optimizer=lion", "A12"),
    ("accum_steps", "ValueError"), ("llrd", "ValueError"),
    ("trainable", "ValueError"), ("mu_dtype", "A12"),
    ("loss=bce", "A12"), ("mixup", "ported"), ("cutmix", "ported"),
    ("sam", "A12"), ("train_filter", "ValueError"), ("grad_shardings", "A13"),
])
def test_unported_knobs_raise(call, item):
    """The knobs that waited for ROADMAP A12 are ported (their parity is
    ``tests/test_torch_optim.py``'s and ``tests/test_torch_sam_bce.py``'s):
    here the optimizers and ``mu_dtype`` build their states, and one step
    with ``loss="bce"`` or ``sam_rho`` runs, its loss the clean pass's.
    Sharded gradients still raise naming A13. Accumulation, LLRD, the
    freeze policies and mixup / cutmix are ported too: their invalid forms
    raise ``ValueError``, and a mixing step without a generator or a map
    is the plain step, as vitx's ``loss_fn`` without an rng is."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32")
    opt_kw = {"optimizer=sgd": {"optimizer": "sgd"},
              "optimizer=lion": {"optimizer": "lion"},
              "accum_steps": {"accum_steps": 0},
              "llrd": {"llrd": 0.75},
              "trainable": {"trainable": "backbone"},
              "mu_dtype": {"mu_dtype": "bfloat16"}}
    if call in opt_kw:
        if item == "ValueError":
            with pytest.raises(ValueError):
                tstep.make_optimizer(**opt_kw[call])
            return
        opt = tstep.make_optimizer(**opt_kw[call])
        state = tstep.create_train_state(0, cfg, opt, device="cpu")
        slot = state.opt_state._asdict()[state.opt_state.SLOTS[0]]
        want = torch.bfloat16 if call == "mu_dtype" else torch.float32
        assert slot["pos_embed"].dtype == want, call
        before = state.params["pos_embed"].clone()
        state, m = tstep.train_step(state, batches(1, 2, seed=0)[0],
                                    cfg=cfg, optimizer=opt, device="cpu")
        assert np.isfinite(float(m["loss"]))
        assert not torch.equal(state.params["pos_embed"], before), call
        return
    step_kw = {"loss=bce": {"loss": "bce"}, "mixup": {"mixup_alpha": 0.2},
               "cutmix": {"cutmix_alpha": 1.0}, "sam": {"sam_rho": 0.05},
               "train_filter": {"train_filter": "backbone"},
               "grad_shardings": {"grad_shardings": object()}}
    opt = tstep.make_optimizer()
    state = tstep.create_train_state(0, cfg, opt, device="cpu")
    b = batches(1, 2, seed=0)[0]
    if call == "loss=bce":
        b = dict(b, label=np.eye(cfg.num_classes, dtype=np.int32)[
            b["label"]])
    if item in ("ported", "A12"):
        plain = tstep.loss_fn(state.params, {k: torch.from_numpy(v) for k, v
                                             in b.items()}, cfg,
                              loss=step_kw[call].get("loss", "ce"))[0]
        _, m = tstep.train_step(state, b, cfg=cfg, optimizer=opt,
                                device="cpu", **step_kw[call])
        assert float(m["loss"]) == float(plain)
        return
    exc = ValueError if item == "ValueError" else NotImplementedError
    with pytest.raises(exc, match=None if item == "ValueError" else item):
        tstep.train_step(state, b, cfg=cfg, optimizer=opt, device="cpu",
                         **step_kw[call])


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = vitx_torch.get_config("tiny")
    opt = tstep.make_optimizer()
    with pytest.raises(RuntimeError, match="CUDA"):
        tstep.create_train_state(0, cfg, opt)
    state = tstep.create_train_state(0, cfg, opt, device="cpu")
    b = batches(1, 2, seed=0)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        tstep.train_step(state, b, cfg=cfg, optimizer=opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstep.eval_step(state.params, b, cfg=cfg)
    with pytest.raises(ValueError, match="lives on"):
        tstep.train_step(state._replace(params=tstep.tree_map(
            lambda t: t.to("meta"), state.params)), b, cfg=cfg,
            optimizer=opt, device="cpu")


@pytest.mark.parametrize("kw", [{"fused": True},
                                {"grad_clip": 1.0, "schedule": "cosine"}],
                         ids=["fused", "clip_schedule"])
def test_adamw_state_from_jax(tiny_fp32, kw):
    """vitx's AdamW state after one update in the chains the plain case
    (test_carry_vitx_state_mid_run) does not cover -- vitx's
    FusedAdamWState, and optax's state behind clipping and a schedule --
    comes across as (count, mu, nu)."""
    _, tcfg, params, _, _, _ = tiny_fp32
    if kw.get("schedule"):
        kw = dict(kw, schedule=jstep.warmup_cosine(1e-3, 10, 2))
    opt = jstep.make_optimizer(**kw)
    params = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), params)
    _, state = jax.jit(opt.update)(grads, opt.init(params), params)
    got = vitx_torch.adamw_state_from_jax(state, tcfg, "cpu")
    assert got.count == 1
    node = [s for s in jax.tree.leaves(
        state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    for name in ("mu", "nu"):
        ref = flat(tree_np(getattr(node, name)))
        for k, v in flat(getattr(got, name)).items():
            assert np.array_equal(v, ref[k]), (name, k)
