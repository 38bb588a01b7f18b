"""The port's training driver, eval CLI and metrics against vitx's, on the
CPU.

One vitx ``Trainer`` run (module fixture: tiny, fp32, 64 synthetic images,
batch 16, the recipe's optimizer knobs -- warmup + cosine, weight decay
0.05 on the matrix weights only, an EMA -- and early stopping) is held
against the port's ``Trainer`` from the same params: per-step losses
within 1e-4 relative, equal val accuracies and stopping epoch, params and
EMA within ``PARAM_BAR`` (``tests/test_torch_train.py``'s bar, 5 % of one
step). vitx's checkpoints of that run resume in the port, and score alike
through both eval CLIs. The port's own resume is bit-identical to an
uninterrupted run, with RandAugment on.
"""

import json
import shutil
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.cli import eval as jeval
from vitx.data import BatchLoader as JBatchLoader
from vitx.data import SyntheticDataset as JSynthetic
from vitx.data.pipeline import make_preprocess as jmake_preprocess
from vitx.metrics import calibration as jcal
from vitx.metrics import confusion_to_metrics as jmetrics
from vitx.train import loop as jloop
from vitx.train import step as jstep
from vitx_torch.cli import eval as teval
from vitx_torch.cli import train as ttrain
from vitx_torch.data import BatchLoader, SyntheticDataset, make_preprocess
from vitx_torch.metrics import calibration as tcal
from vitx_torch.metrics import confusion_to_metrics as tmetrics
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import loop as tloop
from vitx_torch.train import step as tstep
from vitx_torch.train.logging import ScalarWriter

torch.set_num_threads(1)

LR = 1e-3
PARAM_BAR = 0.05 * LR
KW = dict(compute_dtype="float32")
JCFG = vitx.get_config("tiny", **KW)
TCFG = vitx_torch.get_config("tiny", **KW)
DATA = dict(image_size=64, num_classes=4)
EPOCHS, STEPS = 4, 4          # 64 images in batches of 16
TRAIN = dict(epochs=EPOCHS, lr=LR, weight_decay=0.05, wd_exclude=True,
             ema_decay=0.9, early_stop_patience=2, early_stop_min_delta=0.5,
             log_every=3, seed=0)


def recording(trainer_cls):
    """``trainer_cls`` that keeps every flushed train loss in ``losses``."""
    class Recording(trainer_cls):
        losses: list

        def _flush(self, pending, writer):
            self.__dict__.setdefault("losses", []).extend(
                float(m["loss"]) for _, m in pending)
            return super()._flush(pending, writer)
    return Recording


def loaders(pkg):
    ds, loader = ((SyntheticDataset, BatchLoader) if pkg == "port"
                  else (JSynthetic, JBatchLoader))
    return (loader(ds(num_examples=64, seed=0, **DATA), 16, shuffle=True,
                   seed=0, num_threads=2),
            loader(ds(num_examples=32, seed=1, **DATA), 16, num_threads=2))


def port_trainer(ckpt_dir, init, epochs=EPOCHS, preprocess=None):
    sched = tstep.warmup_cosine(LR, EPOCHS * STEPS, 3)
    opt = tstep.make_optimizer(lr=LR, schedule=sched, weight_decay=0.05,
                               ema_decay=0.9, wd_exclude=True)
    p = vitx_torch.params_from_jax(init, TCFG, "cpu")
    tcfg = tloop.TrainerConfig(**dict(TRAIN, epochs=epochs),
                               checkpoint_dir=str(ckpt_dir))
    pre = preprocess or make_preprocess(out_size=64, mean=(0.5,) * 3,
                                        std=(0.5,) * 3, random_flip=False)
    return recording(tloop.Trainer)(
        TCFG, tcfg, preprocess=pre, optimizer=opt, lr_schedule=sched,
        init_state=tstep.TrainState(0, p, opt.init(p)), device="cpu")


@pytest.fixture(scope="module")
def vitx_run(tmp_path_factory):
    """vitx's Trainer: (initial params, per-step losses, history, its
    checkpoint directory)."""
    ckpt = tmp_path_factory.mktemp("vitx_ckpt")
    sched = jstep.warmup_cosine(LR, EPOCHS * STEPS, 3)
    opt = jstep.make_optimizer(schedule=sched, weight_decay=0.05,
                               ema_decay=0.9, wd_exclude=True)
    tcfg = jloop.TrainerConfig(**TRAIN, checkpoint_dir=str(ckpt))
    pre = jmake_preprocess(out_size=64, mean=(0.5,) * 3, std=(0.5,) * 3,
                           random_flip=False)
    trainer = recording(jloop.Trainer)(JCFG, tcfg, preprocess=pre,
                                       optimizer=opt, lr_schedule=sched)
    init = jax.tree.map(np.array, jax.device_get(trainer.state.params))
    history = trainer.fit(*loaders("vitx"))
    return init, trainer.losses, history, ckpt


def ckpt_arrays(path):
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]


def assert_state_close(got_path, want_path):
    """Every leaf of two checkpoints of the EMA + schedule chain within
    PARAM_BAR, the step and counts equal."""
    got, want = ckpt_arrays(got_path), ckpt_arrays(want_path)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if a.ndim == 0:
            assert a == b
        else:
            assert np.abs(a - b).max() <= PARAM_BAR


def rel(a, b):
    return np.abs(np.array(a) - np.array(b)) / np.abs(np.array(b))


def test_trainer_matches_vitx(vitx_run, tmp_path):
    init, jlosses, jhist, jdir = vitx_run
    tr = port_trainer(tmp_path, init)
    hist = tr.fit(*loaders("port"))
    # early stop: epoch 0 sets the best, epochs 1 and 2 miss it by 0.5
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in jhist] == \
        [0, 1, 2]
    assert len(tr.losses) == len(jlosses) == 3 * STEPS
    assert rel(tr.losses, jlosses).max() <= 1e-4
    for h, j in zip(hist, jhist):
        assert h["val_accuracy"] == j["val_accuracy"]
        assert abs(h["val_loss"] - j["val_loss"]) <= 1e-4 * abs(j["val_loss"])
    assert tckpt.list_checkpoints(tmp_path) == [0, 1, 2]
    assert_state_close(tmp_path / "2.ckpt", jdir / "2.ckpt")
    meta = tckpt.peek_meta(tmp_path)
    assert meta["schedule"] and meta["ema_decay"] == 0.9
    assert meta["step"] == 3 * STEPS and "partial" not in meta


def test_vitx_checkpoint_resumes_in_port(vitx_run, tmp_path):
    """vitx's epochs 0-1 on disk: the port runs epoch 2 as vitx did."""
    init, jlosses, _, jdir = vitx_run
    for e in (0, 1):
        shutil.copy(jdir / f"{e}.ckpt", tmp_path)
    tr = port_trainer(tmp_path, init, epochs=3)
    hist = tr.fit(*loaders("port"))
    assert tr.start_epoch == 2 and [h["epoch"] for h in hist] == [2]
    assert rel(tr.losses, jlosses[2 * STEPS:]).max() <= 1e-4
    assert_state_close(tmp_path / "2.ckpt", jdir / "2.ckpt")


def test_port_resume_is_bit_identical(tmp_path, vitx_run):
    init = vitx_run[0]
    pre = make_preprocess(out_size=64, mean=(0.5,) * 3, std=(0.5,) * 3,
                          randaug_layers=2, randaug_magnitude=5.0,
                          random_erase=0.25)
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    a = port_trainer(whole, init, epochs=3, preprocess=pre)
    a.fit(*loaders("port"))
    port_trainer(parts, init, epochs=2, preprocess=pre).fit(*loaders("port"))
    b = port_trainer(parts, init, epochs=3, preprocess=pre)
    b.fit(*loaders("port"))
    assert b.start_epoch == 2 and b.losses == a.losses[2 * STEPS:]
    for x, y in zip(ckpt_arrays(whole / "2.ckpt"),
                    ckpt_arrays(parts / "2.ckpt")):
        assert np.array_equal(x, y)


def test_preemption_saves_a_partial_epoch(vitx_run, tmp_path):
    """SIGTERM in epoch 1: the epoch stops, is saved as ``partial`` and the
    old handler is back; a resume runs epoch 1 again from that state."""
    tr = port_trainer(tmp_path, vitx_run[0], epochs=2)
    before = signal.getsignal(signal.SIGTERM)
    step = tr.train_step

    def preempted_at_step_6(state, batch, rng):
        out = step(state, batch, rng)
        if out[0].step == STEPS + 2:
            handler = signal.getsignal(signal.SIGTERM)
            if callable(handler) and handler is not before:
                handler(signal.SIGTERM, None)
            else:              # fit() ran off the main thread: no handler
                tr._preempted = True
        return out

    tr.train_step = preempted_at_step_6
    hist = tr.fit(*loaders("port"))
    assert [h["epoch"] for h in hist] == [0, 1]
    assert signal.getsignal(signal.SIGTERM) is before
    meta = tckpt.peek_meta(tmp_path)
    assert meta["epoch"] == 1 and meta["partial"] and meta["step"] == \
        STEPS + 2
    again = port_trainer(tmp_path, vitx_run[0], epochs=2)
    again.fit(*loaders("port"))
    assert again.start_epoch == 1 and len(again.losses) == STEPS
    assert tckpt.peek_meta(tmp_path)["step"] == 2 * STEPS + 2


def run_cli(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [[], ["--tta", "--calibrate"]],
                         ids=["plain", "tta_calibrate"])
def test_eval_cli_matches_vitx(vitx_run, capsys, extra):
    ckpt = str(vitx_run[3])
    argv = ["--checkpoint", ckpt, "--data", "synthetic", "--batch-size",
            "128", *extra]
    want = run_cli(jeval.main, argv, capsys)
    got = run_cli(teval.main, argv + ["--device", "cpu"], capsys)
    assert got.keys() == want.keys()
    for k in ("epoch", "num_examples", "confusion_matrix",
              "per_class_accuracy", "per_class_f1", "calibration",
              "accuracy"):
        assert got.get(k) == want.get(k), k
    for k in ("precision_weighted", "recall_weighted", "f1_macro"):
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_port_recipe_cli_checkpoints_read_by_vitx(tmp_path, capsys,
                                                 monkeypatch):
    """The recipe's flags at tiny size on procedural data: vitx's eval
    reads the port's checkpoints and both evals report the accuracy the
    trainer logged for the last epoch."""
    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    data = ["--data", "procedural:64,32", "--preset", "tiny"]
    out = run_cli(ttrain.main, [
        *data, "--device-cache", "--batch-size", "16", "--lr", "3e-4",
        "--schedule", "cosine", "--warmup-steps", "2", "--weight-decay",
        "0.05", "--wd-exclude", "--randaug", "5", "--ema-decay", "0.999",
        "--early-stop", "10", "--seed", "0", "--log-every", "2",
        "--epochs", "2", "--checkpoint-dir", str(tmp_path / "ck"),
        "--log-dir", str(tmp_path / "logs"), "--device", "cpu"], capsys)
    assert out["epoch"] == 1 and np.isfinite(out["loss"])
    argv = [*data, "--checkpoint", str(tmp_path / "ck"), "--batch-size",
            "16"]
    want = run_cli(jeval.main, argv, capsys)
    got = run_cli(teval.main, argv + ["--device", "cpu"], capsys)
    assert got["epoch"] == want["epoch"] == 1
    assert got["accuracy"] == want["accuracy"] == out["val_accuracy"]
    assert got["confusion_matrix"] == want["confusion_matrix"]


@pytest.mark.parametrize("argv,exc,item", [
    (["--data", "cifar10:/nowhere"], FileNotFoundError, "nowhere"),
    (["--data", "synthetic-ml", "--loss", "bce"], None, "loss"),
    (["--sam-rho", "0.05"], None, "sam_rho"),
    (["--optimizer", "sgd"], None, "optimizer"),
    (["--dp", "2", "--sp"], SystemExit, "requires --tp"),
    (["--init-from", "run/3.ckpt"], FileNotFoundError, "run/3.ckpt"),
], ids=["cifar", "multilabel", "sam", "sgd", "dp", "init_ckpt"])
def test_train_cli_refuses_unported(argv, exc, item):
    """Refused flags exit with vitx's message (``--dp`` with ``--sp``
    but no ``--tp``: sequence parallelism needs a model axis).
    CIFAR-10 and ``--init-from`` a checkpoint are ported (A7, A3): those
    two cases hold that a source that is not there is refused, naming its
    path. The multi-label data and loss, SAM and the optimizers, refused
    until A12 brought them, reach the Trainer: its config, its step's
    optimizer, and (B, C) multi-hot batches."""
    if exc is None:
        p = ttrain.build_argparser()
        tr, train_loader, _ = ttrain.build_trainer(
            p.parse_args(argv + ["--device", "cpu"]), p)
        want = {"loss": "bce", "sam_rho": 0.05, "optimizer": "sgd"}[item]
        assert getattr(tr.tcfg, item) == want
        assert isinstance(tr.optimizer, tstep.SGD) == (item == "optimizer")
        labels = next(iter(train_loader))["label"]
        assert labels.shape == ((64, tr.cfg.num_classes) if item == "loss"
                                else (64,))
        return
    with pytest.raises(exc, match=item):
        ttrain.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("argv,item", [
    (["--soup", "a"], "A12"), (["--patch-size", "8"], "A12"),
    (["--export-stablehlo", "m.stablehlo"], "--export-pt2")])
def test_eval_cli_refuses_unported(argv, item, capsys):
    """vitx's StableHLO export is refused. ``--soup`` and ``--patch-size``,
    refused until A12 brought the model soup and FlexiViT's resize, are
    taken now: the run gets as far as the missing checkpoint."""
    if argv[0] in ("--patch-size", "--soup"):
        assert teval.main(["--checkpoint", "x", "--device", "cpu",
                           *argv]) == 1
        assert "no checkpoint under x" in capsys.readouterr().err
        return
    with pytest.raises(SystemExit, match=item):
        teval.main(["--checkpoint", "x", "--device", "cpu", *argv])


@pytest.mark.parametrize("field,value,item", [
    ("steps_per_dispatch", 4, "A12"), ("profile_epoch", 0, "A12"),
    ("pp_schedule", "1f1b", "A13"), ("mu_dtype", "bfloat16", "A12")])
def test_trainer_refuses_unported(field, value, item):
    """The fields once refused are taken: the pipeline's schedule (A13,
    ported since; it acts on a stage mesh, where the Trainer builds the
    pipeline step with it, ``tests/test_torch_pipeline.py``), and the
    fields A12 brought (``tests/test_torch_remat_dispatch.py`` holds what
    they do): the dispatch width, the profiled epoch, and the bf16 first
    moment in the optimizer's state."""
    tcfg = tloop.TrainerConfig(**{field: value})
    if item == "A13":
        from vitx_torch.parallel import Mesh
        from vitx_torch.parallel.pipeline import PPTrainStep

        assert tloop.Trainer(TCFG, tcfg, device="cpu").tcfg.pp_schedule \
            == value
        tr = tloop.Trainer(TCFG, tcfg, mesh=Mesh(
            {"data": 1, "stage": 2}, 0, "cpu", "gloo"))
        assert isinstance(tr.train_step, PPTrainStep)
        assert tr.train_step.schedule == value
        return
    tr = tloop.Trainer(TCFG, tcfg, device="cpu")
    assert getattr(tr.tcfg, field) == value
    mu = tr.state.opt_state.mu["pos_embed"]
    assert mu.dtype == (torch.bfloat16 if field == "mu_dtype"
                        else torch.float32)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.Trainer(TCFG, tloop.TrainerConfig())
    from vitx_torch.data import DeviceBatchLoader

    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBatchLoader(SyntheticDataset(num_examples=2), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--epochs", "1"])


@pytest.mark.parametrize("chain", [
    {"ema_decay": 0.9}, {"wd_exclude": True},
    {"ema_decay": 0.9, "wd_exclude": True, "grad_clip": 0.5}],
    ids=["ema", "wd_exclude", "ema_wdx_clip"])
def test_optimizer_chain_matches_vitx(vitx_run, chain):
    """Three updates of the port's AdamW with the EMA and the decay mask
    against optax's chain in vitx: params and EMA within PARAM_BAR's
    hundredth (no autograd between them)."""
    init = vitx_run[0]
    jopt = jstep.make_optimizer(lr=LR, weight_decay=0.05, **chain)
    topt = tstep.make_optimizer(lr=LR, weight_decay=0.05, **chain)
    assert not topt.fused
    params = jax.tree.map(jnp.asarray, init)
    jst = jopt.init(params)
    tp = vitx_torch.params_from_jax(init, TCFG, "cpu")
    tst = topt.init(tp)
    rng = np.random.default_rng(0)
    update = jax.jit(jopt.update)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)), params)
        u, jst = update(g, jst, params)
        params = jax.tree.map(lambda p, d: p + d, params, u)
        tp, tst = topt.update([torch.tensor(np.asarray(x)) for x in
                               jax.tree_util.tree_leaves(g)], tst, tp)
    pairs = [(tstep.leaves(tp), jax.tree_util.tree_leaves(params))]
    if "ema_decay" in chain:
        pairs.append((tstep.leaves(tst.ema), jax.tree_util.tree_leaves(
            jstep.get_ema_params(jst))))
    for got, want in pairs:
        for a, b in zip(got, want):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= PARAM_BAR / 100
    mask = tstep.weight_decay_mask(tp)
    want = jax.tree_util.tree_leaves(jstep.weight_decay_mask(params))
    assert mask == want and 0 < sum(mask) < len(mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_metrics_match_vitx(seed):
    rng = np.random.default_rng(seed)
    cm = rng.integers(0, 9, (6, 6)).astype(np.int32)
    cm[seed] = 0                      # an absent class
    cm[:, (seed + 2) % 6] = 0         # a class never predicted
    got = tmetrics(torch.from_numpy(cm))
    want = jmetrics(jnp.asarray(cm))
    for k in want:
        assert np.allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                           atol=0), k


def test_calibration_matches_vitx():
    rng = np.random.default_rng(4)
    logits = (3.0 * rng.standard_normal((200, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 200).astype(np.int32)
    assert tcal.calibration_report(logits, labels) == \
        jcal.calibration_report(logits, labels)
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    assert abs(float(tcal.expected_calibration_error(
        np.asarray(probs), labels)) - float(
        jcal.expected_calibration_error(probs, jnp.asarray(labels)))) <= 1e-6


def test_scalar_writer_falls_back_to_jsonl(tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "tensorboard"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    with ScalarWriter(tmp_path) as w:
        w.add_scalar("Loss/train_batch", 1.5, 3)
        w.add_scalar("val?acc", 0.25, 0)
    rows = [json.loads(x) for x in (tmp_path / "scalars.jsonl").read_text()
            .splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("Loss/train_batch", 1.5, 3), ("val?acc", 0.25, 0)]
