"""vitx's fine-tuning knobs in the port, on the CPU, against vitx.

One train step of each knob from the same weights (drawn by the port's
``init_params``, given to vitx as numpy) and batch, fp32, at depth 2 of
``tiny`` (E 64, 4 heads, 64² images in 8² patches), batch 4, no dropout:
a frozen backbone (``train_filter="head"``), layer-wise lr decay,
accumulation over two micro-batches (``optax.MultiSteps``), and mixup,
cutmix and their switch with vitx's own draws fed in (``mix=``; threefry's
Beta draws cannot be matched). The loss and every trainable gradient
within 1e-4 (max |a - b| over max |b|, the repo's fp32 bar); the params
after the update in lr units, each element within what its gradients
allow (``allowance``: the bound ``chip_smoke.py::param_gap`` holds the
card's step to); frozen leaves bit-unchanged. Then the ``.ckpt`` files of masked
and accumulating runs cross both ways bit for bit, K1's and K2's
backward honour ``needs_input_grad`` bit for bit, and the knobs still
unported refuse, naming their item.
"""

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
from vitx_torch.kernels.mha_block import fused_mha_block
from vitx_torch.kernels.mlp_block import fused_mlp_block
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

LR = 1e-3
EPS = 1e-8                 # AdamW's


def configs(**kw):
    kw = {"depth": 2, "compute_dtype": "float32", "dropout": 0.0, **kw}
    return vitx.get_config("tiny", **kw), vitx_torch.get_config("tiny", **kw)


def init(tcfg, seed=0, lora_b=False):
    """Fresh params as a numpy tree (vitx's layout); ``lora_b`` fills the
    adapters' zero B factors, so that the adapters act in the forward; a
    distillation head gets nonzero weights too."""
    p = tstep.tree_map(lambda t: t.numpy(),
                       vitx_torch.init_params(seed, tcfg, device="cpu"))
    if lora_b:
        rng = np.random.default_rng(seed)
        for k, v in p["blocks"].items():
            if k.startswith("lora_") and k.endswith("_b"):
                p["blocks"][k] = (0.05 * rng.standard_normal(v.shape)
                                  ).astype(np.float32)
    if "dist_head" in p:
        p["dist_head"]["w"] = (0.05 * np.random.default_rng(seed + 1)
                               .standard_normal(p["dist_head"]["w"].shape)
                               ).astype(np.float32)
    return p


def batch(n=4, seed=0, size=64, classes=4):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, size, size, 3)).astype(
                np.float32),
            "label": rng.integers(0, classes, n).astype(np.int32)}


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def names(tree):
    return ["/".join(p) for p in tstep.leaf_paths(tree)]


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


_GRAD_FNS = {}


def vitx_grads(jcfg, params, b, train_filter=None, rng=None, **loss_kw):
    """vitx's loss and gradients as its train_step takes them: frozen
    leaves behind ``stop_gradient``. One jitted function per (config,
    policy, knobs), shared by the tests."""
    key = (jcfg, train_filter, rng is None, tuple(sorted(loss_kw.items())))
    if key not in _GRAD_FNS:
        mask_fn = jstep.make_trainable_mask(train_filter)

        def f(p, b, rng):
            if mask_fn is not None:
                p = jax.tree.map(
                    lambda m, x: x if m else jax.lax.stop_gradient(x),
                    mask_fn(p), p)
            return jstep.loss_fn(p, b, jcfg, rng, **loss_kw)[0]
        _GRAD_FNS[key] = jax.jit(jax.value_and_grad(f))
    loss, grads = _GRAD_FNS[key](jnp_tree(params), jnp_tree(b), rng)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def vitx_update(jopt, params, grads_list, state=None):
    """vitx's train_step after its gradients: ``jopt.update`` and
    ``optax.apply_updates`` -> (params, opt_state)."""
    params = jnp_tree(params)
    grads = jax.tree.unflatten(jax.tree.structure(params),
                               [jnp.asarray(g) for g in grads_list])
    state = jopt.init(params) if state is None else state
    upd, state = jax.jit(jopt.update)(grads, state, params)
    return optax.apply_updates(params, upd), state


def port_grads(tcfg, params, b, train_filter=None, **loss_kw):
    """The port's loss and gradients (None for a frozen leaf)."""
    req, wrt = tstep.trainable_params(params, train_filter)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, _ = tstep.loss_fn(req, tb, tcfg, **loss_kw)
    grads = iter(torch.autograd.grad(
        loss, [t for t, w in zip(tstep.leaves(req), wrt) if w]))
    return float(loss.detach()), [next(grads).numpy() if w else None
                                  for w in wrt]


def check_grads(jloss, jgrads, tloss, tgrads, leaf_names):
    assert abs(tloss - jloss) <= 1e-4 * abs(jloss), (tloss, jloss)
    for name, a, b in zip(leaf_names, tgrads, jgrads):
        if a is None:                       # frozen: vitx's grad is zero
            assert not np.any(b), name
        else:
            assert rel_err(a, b) <= 1e-4, (name, rel_err(a, b))


def allowance(tgrads, jgrads, lr=LR):
    """Per element, how far one AdamW step from zero moments may move the
    port's param from vitx's given the two gradients: the step is lr *
    (u(g) + wd * p), u(g) = g / (|g| + eps); with d the leaf's largest
    gradient gap, two steps differ by at most lr * (u(|g| + d) + u(|g|)),
    and by lr * eps * d / (|g| - d + eps)² where |g| > d. Plus 1e-4 lr
    for the update's roundings (``check_params`` adds one ulp of the new
    param). None for a frozen leaf (no move at all)."""
    out = []
    for a, b in zip(tgrads, jgrads):
        if a is None:
            out.append(None)
            continue
        d = float(np.abs(a - b).max())
        g = np.abs(b).astype(np.float64)
        bound = (g + d) / (g + d + EPS) + g / (g + EPS)
        mvt = EPS * d / (g - d + EPS) ** 2
        bound = np.where(g > d, np.minimum(bound, mvt), bound)
        out.append(lr * (1e-4 + bound))
    return out


def port_steps(tcfg, params, batches, opt, mixes=None, **step_kw):
    p = vitx_torch.params_from_jax(params, tcfg, "cpu")
    state = tstep.TrainState(0, p, opt.init(p))
    losses = []
    for i, b in enumerate(batches):
        state, m = tstep.train_step(
            state, b, cfg=tcfg, optimizer=opt, device="cpu",
            mix=None if mixes is None else mixes[i], **step_kw)
        losses.append(float(m["loss"]))
    return state, losses


def check_params(tstate, jparams, allow, init_params=None):
    """Each param within its ``allowance`` of vitx's plus one ulp; a
    frozen one (None) equal to vitx's and to ``init_params``' bit for
    bit."""
    ref = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    start = None if init_params is None else jax.tree.leaves(init_params)
    for i, (name, a, al) in enumerate(zip(
            names(tstate.params), tstep.leaves(tstate.params), allow)):
        if al is None:
            assert np.array_equal(a.numpy(), ref[i]), name
            assert start is None or np.array_equal(a.numpy(), start[i]), name
        else:
            gap = np.abs(a.numpy().astype(np.float64) - ref[i])
            al = al + np.spacing(np.abs(ref[i]))     # one ulp of the param
            assert np.all(gap <= al), (name, float((gap / al).max()))


@pytest.mark.parametrize("train_filter", ["head", "all"])
def test_trainable_mask_matches_vitx(train_filter):
    _, tcfg = configs(lora_rank=2, distill_token=True)
    p = init(tcfg)
    want = jax.tree.leaves(jstep.make_trainable_mask(train_filter)(p)
                           if train_filter != "all" else
                           jax.tree.map(lambda _: True, p))
    tp = vitx_torch.params_from_jax(p, tcfg, "cpu")
    assert tstep.trainable_flags(tp, train_filter) == want
    assert tstep.make_trainable_mask("lora")(tp) == jax.tree.leaves(
        jstep.make_trainable_mask("lora")(p))
    with pytest.raises(ValueError, match="train_filter"):
        tstep.make_trainable_mask("backbone")


def port_step_vs_vitx(jcfg, tcfg, p, b, opt_kw, train_filter=None,
                      mix=None, rng=None, **loss_kw):
    """One train step of the port against vitx's gradients and update:
    the loss and gradients within 1e-4, the params within ``allowance``
    (frozen ones bit-unchanged) -> the port's state."""
    jl, jg = vitx_grads(jcfg, p, b, train_filter, rng=rng, **loss_kw)
    tl, tg = port_grads(tcfg, vitx_torch.params_from_jax(p, tcfg, "cpu"), b,
                        train_filter, mix=mix, **loss_kw)
    check_grads(jl, jg, tl, tg, names(p))
    jp, _ = vitx_update(jstep.make_optimizer(**opt_kw), p, jg)
    tst, (loss,) = port_steps(tcfg, p, [b], tstep.make_optimizer(**opt_kw),
                              mixes=[mix], train_filter=train_filter,
                              **loss_kw)
    assert abs(loss - jl) <= 1e-4 * abs(jl)
    check_params(tst, jp, allowance(tg, jg), p)
    return tst


def test_freeze_backbone_step_matches_vitx():
    """``train_filter="head"`` with an optimizer of the same policy: only
    the head moves, and only the head has moments; vitx's frozen
    gradients are zeros, the port forms none."""
    jcfg, tcfg = configs()
    tst = port_step_vs_vitx(jcfg, tcfg, init(tcfg), batch(),
                            dict(lr=LR, trainable="head"), "head")
    assert tstep.leaves(tst.opt_state.mu) and all(
        k.startswith("head/") for k in names(tst.opt_state.mu))


def test_llrd_step_matches_vitx():
    """LLRD 0.65 with weight decay: blocks at 0.65^(depth - l), the
    embeddings at 0.65^(depth + 1), the head at 1, after AdamW's whole
    update."""
    jcfg, tcfg = configs()
    tst = port_step_vs_vitx(jcfg, tcfg, init(tcfg), batch(), dict(
        lr=LR, weight_decay=0.05, llrd=0.65, llrd_depth=2))
    got = dict(zip(names(tst.params), tstep.llrd_factors(tst.params, 0.65,
                                                         2)))
    assert got["head/w2"] is None
    assert float(got["pos_embed"]) == np.float32(0.65 ** 3)
    assert got["blocks/wqkv"].reshape(-1).tolist() == [
        float(np.float32(0.65 ** 2)), float(np.float32(0.65))]


@pytest.mark.parametrize("clip", [None, 0.5])
def test_accumulation_matches_vitx_multisteps(clip):
    """k = 2 over two micro-batches under a cosine schedule: after the
    first, the params unchanged and the running mean of the gradients
    vitx's; after the second, one update on the mean (Welford's form,
    clipped when ``clip``), the count (the schedule's, MultiSteps'
    gradient_step) once."""
    jcfg, tcfg = configs()
    p = init(tcfg)
    bs = [batch(seed=s) for s in range(2)]
    kw = dict(lr=LR, accum_steps=2, grad_clip=clip)
    jopt = jstep.make_optimizer(schedule=jstep.warmup_cosine(LR, 10, 1), **kw)
    topt = tstep.make_optimizer(schedule=tstep.warmup_cosine(LR, 10, 1), **kw)
    tp = vitx_torch.params_from_jax(p, tcfg, "cpu")
    jgs = [vitx_grads(jcfg, p, b)[1] for b in bs]
    tgs = [port_grads(tcfg, tp, b)[1] for b in bs]
    jp1, js1 = vitx_update(jopt, p, jgs[0])
    jp2, js2 = vitx_update(jopt, p, jgs[1], js1)
    tst, _ = port_steps(tcfg, p, bs[:1], topt)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(
        tstep.leaves(tst.params), jax.tree.leaves(p)))
    for name, a, b in zip(names(p), tstep.leaves(tst.opt_state.acc),
                          jax.tree.leaves(js1.acc_grads)):
        assert rel_err(a.numpy(), np.asarray(b)) <= 1e-4, name
    state, _ = tstep.train_step(tst, bs[1], cfg=tcfg, optimizer=topt,
                                device="cpu")
    means = []
    for g1, g2 in (jgs, tgs):
        m = [x + (y - x) / np.float32(2) for x, y in zip(g1, g2)]
        norm = np.sqrt(sum(float(np.square(x, dtype=np.float64).sum())
                           for x in m))
        scale = 1.0 if clip is None or norm < clip else clip / norm
        means.append([x * scale for x in m])
    check_params(state, jp2, allowance(means[1], means[0]))
    assert state.opt_state.count == int(js2.gradient_step) == 1
    assert state.opt_state.mini_step == int(js2.mini_step) == 0
    assert not any(a.any() for a in tstep.leaves(state.opt_state.acc))


def vitx_mix(key, shape, mixup, cutmix):
    """The (perm, map) vitx's ``loss_fn`` draws from ``key`` (its
    three-way split)."""
    _, k_perm, k_mix = jax.random.split(key, 3)
    perm = np.asarray(jax.random.permutation(k_perm, shape[0]))
    w = np.asarray(jstep._mix_weight_map(k_mix, shape, mixup, cutmix))
    return perm, w


@pytest.mark.parametrize("mode,seed", [("mixup", 3), ("cutmix", 5)])
def test_mixup_cutmix_step_matches_vitx(mode, seed):
    """vitx's own permutation and map fed to the port: the mixed loss
    lam * CE(y) + (1 - lam) * CE(y[perm]), its gradients and the step.
    Both knobs on (DeiT's switch); the key decides the map: a constant
    Beta(0.8) one (mixup) or a 0/1 box (cutmix)."""
    jcfg, tcfg = configs()
    b = batch()
    key = jax.random.PRNGKey(seed)
    mix = vitx_mix(key, b["image"].shape, 0.8, 1.0)
    uniq = np.unique(mix[1])
    assert len(uniq) == 1 if mode == "mixup" else set(uniq) == {0.0, 1.0}
    port_step_vs_vitx(jcfg, tcfg, init(tcfg), b, dict(lr=LR), mix=mix,
                      rng=key, mixup_alpha=0.8, cutmix_alpha=1.0)


def test_mix_weight_map_draws():
    """The port's own draws: a constant Beta map for mixup, a 0/1 box for
    cutmix, both kinds under the switch; the same generator seed gives
    the same map."""
    shape = (4, 64, 64, 3)
    kinds = set()
    for seed in range(12):
        g = torch.Generator().manual_seed(seed)
        w = tstep.mix_weight_map(g, shape, 0.8, 1.0, "cpu")
        assert w.shape == (1, 64, 64, 1) and 0 <= float(w.min())
        kinds.add(len(torch.unique(w)) == 1)
        again = tstep.mix_weight_map(torch.Generator().manual_seed(seed),
                                     shape, 0.8, 1.0, "cpu")
        assert torch.equal(w, again)
    assert kinds == {True, False}
    w = tstep.mix_weight_map(torch.Generator().manual_seed(0), shape, None,
                             1.0, "cpu")
    assert set(torch.unique(w).tolist()) <= {0.0, 1.0}


# --- .ckpt files of masked and accumulating runs, both ways -------------

CKPT_RUNS = {
    "lora": dict(cfg=dict(lora_rank=2), opt=dict(trainable="lora"),
                 meta={"train_filter": "lora"}),
    "freeze": dict(cfg={}, opt=dict(trainable="head"),
                   meta={"train_filter": "head"}),
    "lora_accum_cosine_ema": dict(
        cfg=dict(lora_rank=2), opt=dict(trainable="lora", accum_steps=2,
                                        ema_decay=0.9, schedule=True),
        meta={"train_filter": "lora", "accum_steps": 2, "ema_decay": 0.9,
              "schedule": True}),
}


def ckpt_optimizers(run):
    kw = dict(CKPT_RUNS[run]["opt"], lr=LR)
    sched = kw.pop("schedule", False)
    return (jstep.make_optimizer(
                schedule=jstep.warmup_cosine(LR, 10, 1) if sched else None,
                **kw),
            tstep.make_optimizer(
                schedule=tstep.warmup_cosine(LR, 10, 1) if sched else None,
                **kw), sched)


@pytest.mark.parametrize("run", ["freeze"])
def test_masked_and_accum_ckpt_cross_both_ways(tmp_path, run):
    """A frozen backbone's ``.ckpt`` (``ckpt_cross_both_ways``); the LoRA
    runs', with and without accumulation, are ``tests/test_torch_lora.py``'s."""
    ckpt_cross_both_ways(tmp_path, run)


def ckpt_cross_both_ways(tmp_path, run):
    """Three updates of the run's vitx optimizer (an update and a
    half-accumulated mean where k = 2), saved; the port restores the file
    leaf for leaf and bit for bit (``restore_checkpoint``, and
    ``restore_eval_params`` from the meta alone: the EMA shadow where
    there is one); the port writes it again and vitx restores that bit
    for bit."""
    jcfg, tcfg = configs(**CKPT_RUNS[run]["cfg"])
    jopt, topt, sched = ckpt_optimizers(run)
    meta = dict(CKPT_RUNS[run]["meta"])
    p = init(tcfg, lora_b=True)
    rng = np.random.default_rng(2)
    jp, js = jnp_tree(p), None
    for _ in range(3):
        jp, js = vitx_update(jopt, jp, [
            rng.standard_normal(x.shape).astype(np.float32)
            for x in jax.tree.leaves(p)], js)
    jst = jstep.TrainState(jnp.asarray(3, jnp.int32), jp, js)
    jckpt.save_checkpoint(tmp_path / "v", jax.device_get(jst), 2, meta=meta)
    template = tstep.create_train_state(1, tcfg, topt, device="cpu")
    got, _ = tckpt.restore_checkpoint(tmp_path / "v" / "2.ckpt", template,
                                      sched)
    want = [np.asarray(x) for x in jax.tree.leaves(jst)]
    arrays = tckpt.snapshot(got, sched)
    assert len(arrays) == len(want)
    for a, b in zip(arrays, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    params, _ = tckpt.restore_eval_params(tmp_path / "v", tcfg, device="cpu")
    jparams = jstep.get_ema_params(js)
    for a, b in zip(tstep.leaves(params), jax.tree.leaves(
            jp if jparams is None else jparams)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    tckpt.save_checkpoint(tmp_path / "t", arrays, 2, meta=meta)
    jtemplate = jstep.TrainState(jnp.zeros((), jnp.int32), jnp_tree(p),
                                 jopt.init(jnp_tree(p)))
    back, _ = jckpt.restore_checkpoint(tmp_path / "t" / "2.ckpt", jtemplate)
    for a, b in zip(jax.tree.leaves(back), want):
        assert np.array_equal(np.asarray(a), b)


# --- K1 and K2 backward for the inputs that need a gradient -------------

@pytest.mark.parametrize("kernel", ["mha", "mlp"])
def test_block_backward_needs_input_grad(kernel):
    """Autograd through K1 (``fuse_mha``) and K2 with only some inputs
    needing a gradient -- LoRA's weights, a frozen block's residual
    stream: those gradients are bit-equal to the full backward's and the
    others are never formed."""
    rng = np.random.default_rng(5)
    B, T, E, H, M = 2, 9, 32, 4, 64

    def t(*shape):
        return torch.from_numpy((0.2 * rng.standard_normal(shape)).astype(
            np.float32))
    x = t(B, T, E)
    if kernel == "mha":
        ins = [x, t(E, 3, H, E // H), t(E, E), t(E), 1 + t(E), t(E)]

        def fn(*a):
            return fused_mha_block(*a, eps=1e-6)
        subsets = [(1,), (1, 2), (0,), (4, 5)]
    else:
        ins = [x, t(E, M), t(M), t(M, E), t(E), 1 + t(E), t(E)]

        def fn(*a):
            return fused_mlp_block(*a, act="gelu", eps=1e-6)
        subsets = [(3, 4), (1,), (0,), (5, 6)]
    dout = t(B, T, E)
    full = [a.clone().requires_grad_() for a in ins]
    want = torch.autograd.grad(fn(*full), full, dout)
    for sub in subsets:
        some = [a.clone().requires_grad_(i in sub) for i, a in enumerate(ins)]
        got = torch.autograd.grad(fn(*some), [some[i] for i in sub], dout)
        for i, g in zip(sub, got):
            assert torch.equal(g, want[i]), (kernel, sub, i)


# --- the A12 knobs with the fine-tuning ones -------------------------------

@pytest.mark.parametrize("call,item", [
    ("optimizer=adafactor", "A12"), ("mu_dtype", "A12"), ("sam", "A12"),
    ("loss=bce", "A12"), ("trainer_sam", "A12"),
    ("cli_sam", "A12"), ("cli_layerscale", "A12"), ("cli_tp", "A13")])
def test_still_unported_refuse(call, item):
    """Once refused (A12), now composed with the fine-tuning knobs: a
    head-only Adafactor keeps factored state for the trainable leaves
    only and leaves the frozen ones bit-unchanged; a bf16 first moment
    under LLRD; SAM and the multi-label loss under a freeze policy, the
    frozen leaves unchanged; SAM through the Trainer and the train CLI.
    ``--tp`` (A13) is still refused; ``--layerscale`` is ported."""
    from vitx_torch.cli import train as ttrain
    from vitx_torch.train import loop as tloop

    _, tcfg = configs()
    if call in ("optimizer=adafactor", "mu_dtype", "sam", "loss=bce"):
        kw = {"optimizer=adafactor": {"optimizer": "adafactor",
                                      "trainable": "head"},
              "mu_dtype": {"mu_dtype": "bfloat16", "llrd": 0.75,
                           "llrd_depth": tcfg.depth}}.get(
                  call, {"trainable": "head"})
        opt = tstep.make_optimizer(**kw)
        state = tstep.create_train_state(0, tcfg, opt, device="cpu")
        before = tstep.tree_map(torch.clone, state.params)
        b = batch(2)
        step_kw = {"sam": {"sam_rho": 0.05, "train_filter": "head"},
                   "loss=bce": {"loss": "bce", "train_filter": "head"}}.get(
                       call, {"train_filter": kw.get("trainable")})
        if call == "loss=bce":
            b["label"] = np.eye(4, dtype=np.int32)[b["label"]]
        state, m = tstep.train_step(state, b, cfg=tcfg, optimizer=opt,
                                    device="cpu", **step_kw)
        assert np.isfinite(float(m["loss"]))
        flags = tstep.trainable_flags(before, step_kw["train_filter"])
        for f, x, y in zip(flags, tstep.leaves(before),
                           tstep.leaves(state.params)):
            assert torch.equal(x, y) != f
        if call == "optimizer=adafactor":
            trained = {q for q, f in zip(tstep.leaf_paths(before), flags)
                       if f}
            assert set(tstep.leaf_paths(state.opt_state.v)) == trained
        return
    if call == "trainer_sam":
        tr = tloop.Trainer(tcfg, tloop.TrainerConfig(sam_rho=0.05),
                           device="cpu")
        assert tr.tcfg.sam_rho == 0.05
    elif call == "cli_layerscale":
        # ported since: the flag reaches the config and its gains the tree
        p = ttrain.build_argparser()
        tr, _, _ = ttrain.build_trainer(p.parse_args(
            ["--layerscale", "0.1", "--device", "cpu"]), p)
        assert tr.cfg.layerscale_init == 0.1
        assert float(tr.state.params["blocks"]["ls1"][0, 0]) == \
            pytest.approx(0.1)
    elif call == "cli_sam":
        p = ttrain.build_argparser()
        tr, _, _ = ttrain.build_trainer(p.parse_args(
            ["--sam-rho", "0.05", "--device", "cpu"]), p)
        assert tr.tcfg.sam_rho == 0.05
    else:
        with pytest.raises(SystemExit, match=item):
            ttrain.main(["--tp", "2", "--device", "cpu"])


def test_cli_fine_tune_conflicts(tmp_path):
    """vitx's refusals: --freeze-backbone with LoRA, and a distillation
    step with a freeze policy or mixing."""
    from vitx_torch.cli import train as ttrain

    base = ["--device", "cpu", "--epochs", "1"]
    with pytest.raises(SystemExit, match="conflicts"):
        ttrain.main(base + ["--freeze-backbone", "--lora-rank", "2"])
    with pytest.raises(SystemExit, match="freeze policy"):
        ttrain.main(base + ["--distill-from", str(tmp_path),
                            "--freeze-backbone"])
    with pytest.raises(SystemExit, match="mixup"):
        ttrain.main(base + ["--distill-from", str(tmp_path),
                            "--mixup-alpha", "0.8"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        ttrain.main(base + ["--distill-from", str(tmp_path / "none")])
