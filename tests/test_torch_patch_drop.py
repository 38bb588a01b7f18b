"""Patch dropout (FLIP) in the port (``vitx_torch.nn.vit._patch_drop``)
against vitx's (``vitx.nn.vit._patch_drop``), on the CPU.

torch cannot draw threefry's streams, so vitx's uniform noise is drawn with
vitx's key and fed to the port's ``_patch_drop`` (its ``noise`` argument);
the step tests swap the port's draw for that noise. Geometry: vitx's ToMe
tests' (``tests/test_tome.py:12-13``: image 32, patch 4, E 32, depth 3, 2
heads, 64 patches, 32 kept), with ``fuse_mha`` "on" (vitx's Pallas K1
with its stash and the flash backward in interpret mode, the port's
plain versions) and "auto" (the composed path on both sides), and a
depth-2 ``small16`` copy (196 patches, 98 kept: T 99, the recipe's
``--patch-drop 0.5``). Dropout is 0, so the noise is the step's only draw.

Bars: the kept tokens exactly; the loss, grad_norm and every gradient
within 1e-4 of the largest element of its leaf (fp32, the repo's parity
bar, ``tests/test_parity_torch.py:58``); the params after one AdamW step
within the allowance the two gradients leave them (``adam_step_gap``,
``chip_smoke.py``'s ``param_gap``: a gradient within rounding of zero
may flip the sign of its element's step).
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
from vitx.nn import vit as jvit
from vitx.train import step as jstep
from vitx_torch.cli import train as ttrain
from vitx_torch.nn import vit as tvit
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=4, num_classes=4, embed_dim=32,
            depth=3, num_heads=2, compute_dtype="float32")
LR = 1e-3


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def configs(case, **over):
    """(vitx's config, the port's) of a step case."""
    if case == "small16_d2":
        kw = dict(depth=2, compute_dtype="float32", num_classes=10, **over)
        return (vitx.get_config("small16", **kw),
                vitx_torch.get_config("small16", **kw))
    kw = dict(TINY, **over)
    return vitx.ViTConfig(**kw), vitx_torch.ViTConfig(**kw)


def numpy_params(cfg, seed=0):
    """The port's init of ``cfg`` with every leaf nudged by N(0, 0.02), as
    numpy, so that biases and LayerNorm parameters take part."""
    rng = np.random.default_rng(seed)
    params = vitx_torch.init_params(seed, cfg, device="cpu")
    return jax.tree.map(lambda t: t.numpy() + 0.02 * rng.standard_normal(
        t.shape).astype(np.float32), params)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): np.asarray(
        tree.detach() if torch.is_tensor(tree) else tree, np.float32)}


def adam_step_gap(tgrads, jgrads, tparams, jparams, lr=LR, eps=1e-8):
    """The largest gap between two params after one Adam step from zero
    moments, in units of its allowance (chip_smoke.py's ``param_gap``).

    That step moves an element by lr * (u(g) + wd * p), u(g) = g / (|g| +
    eps); with d the leaf's largest gradient difference the two moves
    differ by at most lr * (u(|g| + d) + u(|g|)), and by at most lr * eps
    * d / (|g| - d + eps)**2 where |g| > d. Each element is allowed the
    smaller, plus 1e-4 lr for the update's rounding and one ulp of the new
    param. A gradient within rounding of zero may flip its step's sign, so
    such an element may differ by up to 2 lr."""
    worst = 0.0
    for a, b, pa, pb in zip(tgrads, jgrads, tparams, jparams):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d = np.max(np.abs(a - b))
        g = np.abs(b)
        bound = (g + d) / (g + d + eps) + g / (g + eps)
        mvt = eps * d / (g - d + eps) ** 2
        bound = np.where(g > d, np.minimum(bound, mvt), bound)
        pb32 = np.asarray(pb, np.float32)
        ulp = np.abs(np.spacing(pb32)).astype(np.float64)
        allow = lr * (1e-4 + bound) + ulp
        gap = np.abs(np.asarray(pa, np.float64) - pb32)
        worst = max(worst, float(np.max(gap / allow)))
    return worst


def vitx_noise(key, cfg, batch):
    """The uniform noise vitx's ``encode`` draws for patch dropout from the
    key its forward gets: the second half of its first split."""
    _, r = jax.random.split(key)
    return np.array(jax.random.uniform(r, (batch, cfg.num_patches)))


@pytest.mark.parametrize("drop,n_reg", [(0.5, 0), (0.3, 2), (0.75, 0)])
def test_patch_drop_keeps_vitx_tokens(drop, n_reg):
    """The port's ``_patch_drop`` on vitx's noise keeps exactly the tokens
    vitx's keeps, in the same order; prefix and registers pass through."""
    jcfg, tcfg = configs("tiny", patch_drop=drop, num_registers=n_reg)
    B, T = 4, jcfg.seq_len
    x = np.random.default_rng(1).standard_normal(
        (B, T, jcfg.embed_dim)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jvit._patch_drop(jnp.asarray(x), jcfg, key))
    noise = np.array(jax.random.uniform(key, (B, jcfg.num_patches)))
    out = tvit._patch_drop(torch.from_numpy(x), tcfg,
                           noise=torch.from_numpy(noise))
    keep = tcfg.patch_keep_count
    assert out.shape == (B, tcfg.num_prefix_tokens + keep + n_reg,
                         tcfg.embed_dim)
    np.testing.assert_array_equal(out.numpy(), ref)


@functools.lru_cache(maxsize=None)
def vitx_grad(jcfg):
    """vitx's jitted value-and-grad of ``loss_fn``: what its train_step
    differentiates."""
    return jax.jit(jax.value_and_grad(
        lambda p, b, k: jstep.loss_fn(p, b, jcfg, k), has_aux=True))


@jax.jit
def vitx_adamw(params, grads):
    """vitx's AdamW (``make_optimizer(lr=LR)``) applied once from its
    initial state, as its train_step applies it: the new params."""
    opt = jstep.make_optimizer(lr=LR)
    updates, _ = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, updates)


@pytest.mark.parametrize("case,fuse", [("tiny", "on"), ("tiny", "auto"),
                                       ("small16_d2", "auto")])
def test_patch_drop_step_matches_vitx(monkeypatch, case, fuse):
    """One patch-drop train step from the same params with vitx's noise:
    the loss, grad_norm and gradients within 1e-4, the params after the
    AdamW step within ``adam_step_gap``'s allowance of vitx's AdamW on its
    gradients (its train_step's update)."""
    jcfg, tcfg = configs(case, patch_drop=0.5, fuse_mha=fuse)
    B = 2
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal(
                 (B, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32),
             "label": rng.integers(0, jcfg.num_classes, B).astype(np.int32)}
    pn = numpy_params(tcfg)
    key = jax.random.PRNGKey(11)
    # vitx's train_step folds the step into its key before the forward
    vitx_draw = torch.from_numpy(
        vitx_noise(jax.random.fold_in(key, 0), jcfg, B))
    orig, drawn = tvit._patch_drop, []

    def with_vitx_noise(x, cfg, gen=None, noise=None):
        drawn.append(gen)
        return orig(x, cfg, noise=vitx_draw)

    monkeypatch.setattr(tvit, "_patch_drop", with_vitx_noise)

    jp = jax.tree.map(jnp.asarray, pn)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = vitx_grad(jcfg)(jp, jb, jax.random.fold_in(key, 0))
    jparams = vitx_adamw(jp, jgrads)

    tp = vitx_torch.params_from_jax(pn, tcfg, "cpu")
    req = tstep.tree_map(lambda t: t.detach().requires_grad_(), tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    tloss, _ = tstep.loss_fn(req, tb, tcfg, gen)
    tgrads = torch.autograd.grad(tloss, tstep.leaves(req))
    topt = tstep.make_optimizer(lr=LR)
    tstate = tstep.TrainState(0, tp, topt.init(tp))
    tstate, tm = tstep.train_step(tstate, batch, gen, cfg=tcfg,
                                  optimizer=topt, device="cpu")
    assert drawn == [gen, gen]          # the draw is the generator's

    for got in (tloss.detach(), tm["loss"]):
        assert rel_err(float(got), float(jloss)) <= 1e-4
    assert rel_err(float(tm["grad_norm"]),
                   float(optax.global_norm(jgrads))) <= 1e-4
    jg = jax.tree_util.tree_leaves(jgrads)
    assert len(jg) == len(tgrads)
    for g, r in zip(tgrads, jg):
        assert rel_err(g.numpy(), np.asarray(r)) <= 1e-4
    got, want = flat(tstate.params), flat(jparams)
    assert got.keys() == want.keys()
    assert adam_step_gap(tgrads, jg, got.values(), want.values()) <= 1.0


def test_patch_drop_runs_kept_tokens_in_training():
    """A training encode runs prefix + kept patches, reproducibly for one
    seed; the deterministic one (and one without a generator) every
    token."""
    tcfg = vitx_torch.ViTConfig(**dict(TINY, patch_drop=0.5))
    tp = vitx_torch.params_from_jax(numpy_params(tcfg), tcfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    run = functools.partial(tvit.encode, tp, x, tcfg)
    a = run(rng=torch.Generator().manual_seed(5), deterministic=False)
    b = run(rng=torch.Generator().manual_seed(5), deterministic=False)
    c = run(rng=torch.Generator().manual_seed(6), deterministic=False)
    assert a.shape == (3, 1 + tcfg.patch_keep_count, tcfg.embed_dim)
    assert torch.equal(a, b) and not torch.equal(a, c)
    full = run(rng=torch.Generator().manual_seed(5), deterministic=True)
    assert full.shape == (3, tcfg.seq_len, tcfg.embed_dim)
    assert torch.equal(full, run())


def test_patch_drop_inference_is_full_token():
    """patch_drop changes training only: the forward is bit-equal to the
    same params under patch_drop=0, and to vitx's within 1e-4."""
    jcfg, tcfg = configs("tiny", patch_drop=0.5)
    pn = numpy_params(tcfg)
    tp = vitx_torch.params_from_jax(pn, tcfg, "cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    a = vitx_torch.forward(tp, x, tcfg, device="cpu")
    b = vitx_torch.forward(tp, x, tcfg.replace(patch_drop=0.0), device="cpu")
    assert torch.equal(a, b)
    ref = vitx.forward(jax.tree.map(jnp.asarray, pn), jnp.asarray(x), jcfg)
    assert rel_err(a.numpy(), np.asarray(ref)) <= 1e-4


def test_train_cli_patch_drop(tmp_path, capsys):
    """``--patch-drop 0.5`` trains through the CLI: the config carries it,
    the trainer draws a generator each step, the eval runs every token and
    the eval CLI reproduces the logged accuracy."""
    from vitx_torch.cli import eval as teval

    data = ["--preset", "tiny", "--data", "procedural:32,16", "--device",
            "cpu"]
    train = data + ["--compute-dtype", "float32", "--patch-drop", "0.5",
                    "--batch-size", "16", "--epochs", "1"]
    parser = ttrain.build_argparser()
    tr, _, _ = ttrain.build_trainer(parser.parse_args(train), parser)
    assert tr.cfg.patch_drop == 0.5 and tr._stochastic
    assert ttrain.main(train + ["--checkpoint-dir", str(tmp_path / "ck")]) == 0
    logged = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(logged["loss"])
    assert teval.main(data + ["--checkpoint", str(tmp_path / "ck"),
                              "--batch-size", "16"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["accuracy"] == logged["val_accuracy"]
    assert report["num_examples"] == 16
