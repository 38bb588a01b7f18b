"""Training through ToMe (``cfg.tome_train``) in the port against vitx's,
on the CPU.

vitx's train step runs jitted on the CPU backend, its ToMe encoder in
training mode (``vitx/nn/tome.py:185-312``); the port's runs
``vitx_torch.nn.tome.encode_tome`` under autograd. With ``fuse_mha="on"``
the attention half is vitx's Pallas B8 in interpret mode with its custom
VJP (``_composed_tome``) on one side, the port's B8 wrapper on the other
(its plain version forward, ``composed_tome``'s autograd backward, as on
the card); with "auto" both run the composed path. Geometry: vitx's ToMe
tests' (``tests/test_tome.py:12-13``: image 32, patch 4, E 32, depth 3, 2
heads, 64 patches) at r=4 and ``to40`` ((13, 12, 0)), and a depth-2
``small16`` copy at ``to128``, the recipe's schedule (35, 34). Dropout and
drop-path are 0 in the steps held to vitx (threefry's streams cannot be
drawn in torch); their pieces are held by their own properties.

Bars: the merges' source maps exactly (fp32; two correct runs that merge
differently cannot be compared, so sources come first); the loss,
grad_norm and every gradient within 1e-4 of the largest element of its
leaf (fp32, the repo's parity bar, ``tests/test_parity_torch.py:58``); the
params after one AdamW step within the allowance the two gradients leave
them (``adam_step_gap``, ``chip_smoke.py``'s ``param_gap``); the
deterministic forward of a tome_train config bit for bit that of the
plain tome_r config; eval accuracies through both packages' eval CLIs
equal.
"""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vitx
import vitx_torch
from test_torch_patch_drop import (TINY, adam_step_gap, flat, numpy_params,
                                   rel_err)
from vitx.cli import eval as jeval
from vitx.nn import tome as jtome
from vitx.train import checkpoint as jckpt
from vitx.train import step as jstep
from vitx_torch.cli import eval as teval
from vitx_torch.cli import train as ttrain
from vitx_torch.kernels import composed_tome, fused_mha_block_tome
from vitx_torch.nn.vit import model_logits
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

LR = 1e-3
VITX_ENCODE_TOME = jax.jit(jtome.encode_tome, static_argnums=(2, 3))


def configs(case, fuse):
    """(vitx's config, the port's) of a step case: tome_train on, the
    schedule resolved as the train CLI resolves it, no dropout."""
    kw = dict(fuse_mha=fuse, dropout=0.0, drop_path=0.0)
    if case == "small16_d2_to128":
        kw.update(depth=2, compute_dtype="float32", num_classes=10)
        jcfg = vitx.get_config("small16", **kw)
        tcfg = vitx_torch.get_config("small16", **kw)
        target = 128
    else:
        jcfg, tcfg = vitx.ViTConfig(**TINY, **kw), vitx_torch.ViTConfig(
            **TINY, **kw)
        target = 40 if case == "to40" else None
    r = (jtome.aligned_schedule(jcfg, target) if target else 4)
    if target:
        assert vitx_torch.aligned_schedule(tcfg, target) == r
    return (jcfg.replace(tome_r=r, tome_train=True),
            tcfg.replace(tome_r=r, tome_train=True))


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


@pytest.mark.parametrize("case,fuse", [
    ("r4", "auto"), ("to40", "on"), ("small16_d2_to128", "auto")])
def test_tome_train_step_matches_vitx(case, fuse):
    """One ToMe-train step from the same params: equal sources, then the
    loss and gradients of ``loss_fn`` within 1e-4, and ``train_step``'s
    loss, grad_norm and params after the AdamW step against vitx's AdamW
    on its gradients (its train_step's update; dropout 0 makes the key
    irrelevant)."""
    jcfg, tcfg = configs(case, fuse)
    B = 2
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal(
                 (B, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32),
             "label": rng.integers(0, jcfg.num_classes, B).astype(np.int32)}
    pn = numpy_params(tcfg)
    jp = jax.tree.map(jnp.asarray, pn)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = vitx_torch.params_from_jax(pn, tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    _, jsrc = VITX_ENCODE_TOME(jp, jb["image"], jcfg, True)
    with torch.no_grad():
        toks, tsrc = vitx_torch.encode_tome(tp, tb["image"], tcfg,
                                            return_sources=True)
    assert toks.shape[1] == tcfg.seq_len - sum(tcfg.tome_schedule)
    np.testing.assert_array_equal(tsrc.numpy(), np.asarray(jsrc))

    (jloss, _), jgrads = vitx_grad(jcfg)(jp, jb, jax.random.PRNGKey(1))
    jparams = vitx_adamw(jp, jgrads)

    gen = torch.Generator().manual_seed(0)
    req = tstep.tree_map(lambda t: t.detach().requires_grad_(), tp)
    tloss, _ = tstep.loss_fn(req, tb, tcfg, gen)
    tgrads = torch.autograd.grad(tloss, tstep.leaves(req))
    full, _ = tstep.loss_fn(req, tb, tcfg.replace(tome_train=False), gen)
    assert float(full.detach()) != float(tloss.detach())   # it merges
    topt = tstep.make_optimizer(lr=LR)
    tstate, tm = tstep.train_step(tstep.TrainState(0, tp, topt.init(tp)),
                                  batch, gen, cfg=tcfg, optimizer=topt,
                                  device="cpu")

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


@pytest.mark.parametrize("dropout,drop_path", [(0.1, 0.0), (0.0, 0.2),
                                               (0.1, 0.2)])
def test_tome_train_stochastic_pieces(dropout, drop_path):
    """Dropout and drop-path inside the merging encoder: the training
    forward depends on the generator and repeats for one seed; the
    deterministic forward ignores a generator
    (``test_tome_train_stochastic_pieces_compose``'s checks)."""
    cfg = vitx_torch.ViTConfig(**TINY, tome_r=4, tome_train=True,
                               dropout=dropout, drop_path=drop_path)
    tp = vitx_torch.params_from_jax(numpy_params(cfg), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))

    def run(seed=None, deterministic=False):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return vitx_torch.encode_tome(tp, x, cfg, rng=gen,
                                          deterministic=deterministic)

    t1, t2, t3 = run(5), run(6), run(5)
    assert float((t1 - t2).abs().max()) > 1e-6
    assert torch.equal(t1, t3)
    d = run()
    assert torch.equal(d, run(7, deterministic=True))
    assert torch.equal(d, run(None, deterministic=True))
    assert t1.shape == d.shape == (2, cfg.seq_len - 3 * 4, cfg.embed_dim)


def test_tome_train_deterministic_forward_is_tome_r():
    """The eval forward of a tome_train config is that of the plain tome_r
    config bit for bit; a training forward without a generator merges as
    well, while tome_r alone trains on every token."""
    cfg = vitx_torch.ViTConfig(**TINY, tome_r=4, tome_train=True)
    plain = cfg.replace(tome_train=False)
    tp = vitx_torch.params_from_jax(numpy_params(cfg), cfg, "cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    a = vitx_torch.forward(tp, x, cfg, device="cpu")
    assert torch.equal(a, vitx_torch.forward(tp, x, plain, device="cpu"))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        train = model_logits(tp, xt, cfg, deterministic=False)
        full = model_logits(tp, xt, plain, deterministic=False)
    assert torch.equal(train, a) and not torch.equal(full, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_tome_autograd_takes_needed_inputs(dtype):
    """B8's autograd as a ToMe-train step drives it: x and the weights need
    gradients, the zero QKV bias and log_size none, and k_mean feeds only
    the merge's selection (a zero cotangent). Its gradients equal
    ``composed_tome``'s autograd bit for bit (on the CPU both run the same
    functions), and the inputs without grad get none."""
    rng = np.random.default_rng(5)
    B, T, E, H = 2, 13, 32, 2
    D = E // H

    def arr(shape, scale=1.0, shift=0.0, dt=torch.float32):
        return torch.from_numpy((shift + scale * rng.standard_normal(shape))
                                .astype(np.float32)).to(dt)

    x, wqkv, wo = arr((B, T, E), dt=dtype), arr((E, 3, H, D), 0.1,
                                                dt=dtype), arr((E, E), 0.1,
                                                               dt=dtype)
    bqkv = torch.zeros(3, H, D)
    bo, g, b = arr((E,), 0.1), arr((E,), 0.1, 1.0), arr((E,), 0.1)
    log_size = torch.log(1.0 + 3.0 * torch.from_numpy(
        rng.random((B, T)).astype(np.float32)))
    w_out = arr((B, T, E), dt=dtype)
    grads = []
    for fn in (fused_mha_block_tome, composed_tome):
        ins = [t.clone().requires_grad_() for t in (x, wqkv, wo, bo, g, b)]
        bq, ls = bqkv.clone(), log_size.clone()
        out, k_mean = fn(ins[0], ins[1], bq, ins[2], *ins[3:], ls, eps=1e-5)
        assert k_mean.requires_grad
        loss = (out.float() * w_out.float()).sum()
        loss.backward()
        assert bq.grad is None and ls.grad is None
        grads.append([t.grad for t in ins])
    for a, c in zip(*grads):
        assert a.dtype == c.dtype and torch.equal(a, c)


@pytest.mark.parametrize("argv,err,match", [
    (["--tome-r", "4"], SystemExit, "go together"),
    (["--tome-train"], SystemExit, "go together"),
    (["--tome-r", "to40", "--tome-train", "--patch-drop", "0.5"], ValueError,
     "patch_drop"),
], ids=["r_alone", "train_alone", "with_patch_drop"])
def test_train_cli_tome_flag_rules(argv, err, match):
    """vitx's rules: --tome-r and --tome-train go together; ToMe-train with
    patch dropout is refused by the config."""
    with pytest.raises(err, match=match):
        ttrain.main(["--preset", "tiny", "--data", "procedural:16,8",
                     "--device", "cpu", *argv])


def test_train_cli_resolves_schedule_after_geometry():
    """A ``toN`` schedule resolves against the final geometry: at
    ``--image-size 96`` tiny has 145 tokens (65 at its own 64), and
    ``to100`` gives vitx's schedule for that model, in a ToMe-train
    config."""
    parser = ttrain.build_argparser()
    args = parser.parse_args(["--preset", "tiny", "--image-size", "96",
                              "--data", "procedural:16,8", "--tome-r",
                              "to100", "--tome-train", "--device", "cpu"])
    tr, _, _ = ttrain.build_trainer(args, parser)
    jcfg = vitx.get_config("tiny", image_size=96)
    want = jcfg.replace(tome_r=jtome.aligned_schedule(jcfg, 100))
    assert tr.cfg.seq_len == 145 and tr.cfg.tome_train
    assert tr.cfg.tome_r == want.tome_r and not tr._stochastic


def run_cli(main_fn, argv, capsys) -> dict:
    assert main_fn(argv) in (0, None)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


DATA = ["--preset", "tiny", "--data", "procedural:32,16", "--batch-size",
        "16"]


def eval_both(ck, capsys) -> dict:
    """{(package, tome_r flag): the eval CLI's report} on checkpoint
    ``ck``: every token by default, merged with ``--tome-r to40``."""
    out = {}
    for tome in ([], ["--tome-r", "to40"]):
        argv = DATA + ["--checkpoint", str(ck), *tome]
        out["vitx", bool(tome)] = run_cli(jeval.main, argv, capsys)
        out["port", bool(tome)] = run_cli(teval.main, argv + ["--device",
                                                              "cpu"], capsys)
    for tome in (False, True):
        for k in ("accuracy", "confusion_matrix", "num_examples", "epoch"):
            assert out["port", tome][k] == out["vitx", tome][k], (tome, k)
    return out


@pytest.fixture(scope="module")
def tome_run(tmp_path_factory):
    """A port ToMe-train run through the train CLI (tiny, fp32, ``to40``,
    one epoch): (its checkpoint directory, its last printed line)."""
    ck = tmp_path_factory.mktemp("tome") / "ck"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ttrain.main(DATA + [
            "--compute-dtype", "float32", "--tome-r", "to40",
            "--tome-train", "--epochs", "1", "--checkpoint-dir", str(ck),
            "--device", "cpu"]) == 0
    return ck, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_port_tome_train_ckpt_read_by_vitx(tome_run, capsys):
    """The port's ToMe-train .ckpt: its meta carries the resolved schedule
    and tome_train as vitx writes them; vitx's and the port's artifact
    config drop both; both eval CLIs agree, every token by default and
    merged with --tome-r, and the merged accuracy is the one the trainer
    logged (its eval merges)."""
    ck, logged = tome_run
    meta = tckpt.peek_meta(ck / "0.ckpt")
    assert meta["config"]["tome_r"] == [13, 12, 0, 0]
    assert meta["config"]["tome_train"] is True
    want = jckpt.resolve_artifact_config(str(ck), None, "base16")
    got = tckpt.resolve_artifact_config(ck, None, "base16")
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.tome_r == 0 and not got.tome_train
    reports = eval_both(ck, capsys)
    assert reports["port", True]["accuracy"] == logged["val_accuracy"]


@pytest.mark.parametrize("tome_r", [0, "to40"], ids=["full", "to40"])
def test_tome_train_ckpt_serves(tome_run, tome_r):
    """``load_server`` on the ToMe-train .ckpt with the serve CLI's config
    rule: every token by default, merged with ``--tome-r to40``; each
    answer's top class that of a direct forward on the EMA shadow."""
    from vitx_torch.serve import load_server

    ck, _ = tome_run
    cfg = tckpt.resolve_artifact_config(ck, None, "tiny", tome_r)
    assert cfg.tome_schedule[:2] == ((13, 12) if tome_r else (0, 0))
    ema, _ = tckpt.restore_eval_params(ck / "0.ckpt", cfg, device="cpu")
    imgs = np.random.default_rng(6).standard_normal(
        (4, 64, 64, 3)).astype(np.float32)
    with load_server(ck / "0.ckpt", cfg, device="cpu", batch_size=4,
                     top_k=2) as srv:
        got = [srv.predict(x)["classes"][0] for x in imgs]
    want = vitx_torch.forward(ema, imgs, cfg, device="cpu").argmax(-1)
    assert got == want.tolist()


def test_vitx_tome_train_ckpt_read_by_port(tmp_path, capsys):
    """A vitx .ckpt whose meta records a ToMe-train config: the port's
    artifact config drops the ToMe knobs as vitx's does, and both eval
    CLIs agree on it, with and without --tome-r."""
    jcfg = vitx.get_config("tiny", compute_dtype="float32", num_classes=10)
    jcfg = jcfg.replace(tome_r=jtome.aligned_schedule(jcfg, 40),
                        tome_train=True)
    opt = jstep.make_optimizer(lr=LR)
    state = jstep.create_train_state(jax.random.PRNGKey(0), jcfg, opt)
    jckpt.save_checkpoint(tmp_path, jax.device_get(state), 0,
                          meta={"config": json.loads(jcfg.to_json())})
    got = tckpt.resolve_artifact_config(tmp_path, None, "base16")
    want = jckpt.resolve_artifact_config(str(tmp_path), None, "base16")
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.tome_r == 0 and not got.tome_train
    eval_both(tmp_path, capsys)


def test_convergence_runs_the_recipe_variants(tmp_path):
    """``vitx_torch.cli.convergence`` runs examples/convergence.py's recipe
    and variants, and reads the train CLI's epoch lines into its summary:
    the best val accuracy and its epoch, the curve, the median img/s after
    the first epoch."""
    import importlib.util
    import pathlib

    from vitx_torch.cli import convergence as tconv

    path = pathlib.Path(__file__).parents[1] / "examples" / "convergence.py"
    spec = importlib.util.spec_from_file_location("convergence", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert tconv.RECIPE == ref.RECIPE and tconv.VARIANTS == ref.VARIANTS
    log = tmp_path / "run.log"
    log.write_text("# cmd\n" + "\n".join(
        f"epoch {e}: loss=1.0000, val_accuracy={a:.4f}, "
        f"images_per_sec={r:.1f}" for e, a, r in
        ((0, 0.1, 500.0), (1, 0.3, 900.0), (2, 0.3, 1000.0),
         (3, 0.2, 950.0))))
    s = tconv.summarize(tconv.parse_log(log), 12.5)
    assert s["best_val_acc"] == 0.3 and s["best_epoch"] == 1
    assert s["val_acc_at_epoch"] == {0: 0.1, 3: 0.2}
    assert s["steady_images_per_sec"] == 950.0 and s["epochs_run"] == 4
