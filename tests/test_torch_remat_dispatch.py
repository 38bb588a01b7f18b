"""Remat as activation checkpointing, ``steps_per_dispatch`` and
``profile_epoch`` in the port, on the CPU.

Remat (``vitx_torch.nn.vit.run_blocks``, vitx's ``cfg.remat``): the four
modes give the same loss and gradients (1e-6; here bit for bit) with
dropout and drop-path drawn from an explicit generator, on K1's route
(its plain version here), the composed one and a LoRA model, and leave the
generator where the unwrapped forward leaves it; "block" and
"save_stash" save less than "none" (bytes counted with
``saved_tensors_hooks``), "dots" recomputes none of the forward's 2-D
products; "block" and "dots"
run K1 twice per block per step, "none" and "save_stash" once; inference
never checkpoints; and a depth-2 remat step's loss and gradients match
vitx's under the same policy (the repo's 1e-4). ``steps_per_dispatch`` 4
gives the trajectory of single steps, with augmentation and dropout on and
an epoch's remainder, from the host and the device loaders; a Trainer
resumes an Adafactor multi-label run bit for bit; ``profile_epoch``
writes a trace.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.train import step as jstep
from vitx_torch.data import (BatchLoader, DeviceBatchLoader,
                             SyntheticDataset, SyntheticMultiLabelDataset,
                             make_preprocess)
from vitx_torch.kernels import mha_block as tmha
from vitx_torch.nn.vit import init_params, param_spec, remat_mode
from vitx_torch.train import loop as tloop
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

MODES = ("block", "dots", "save_stash")
KW = dict(depth=2, compute_dtype="float32", image_size=32)


def cfg_of(route, **kw):
    over = dict(KW, dropout=0.1, drop_path=0.1, **kw)
    if route == "k1":
        over["fuse_mha"] = "on"          # K1's plain version on the CPU
    elif route == "composed":
        over["fuse_mha"] = "off"
    else:                                # a LoRA model on K1's route
        over.update(fuse_mha="on", lora_rank=2, lora_alpha=4.0)
    return vitx_torch.get_config("tiny", **over)


def images(n=4, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32))


def grads_of(cfg, params, seed=3):
    """(loss, gradients, the generator's state after) of one stochastic
    loss_fn on ``params``."""
    b = {"image": images(), "label": torch.tensor([0, 1, 2, 3])}
    req = tstep.tree_map(lambda t: t.detach().requires_grad_(), params)
    gen = torch.Generator().manual_seed(seed)
    loss, _ = tstep.loss_fn(req, b, cfg, gen)
    return loss.detach(), torch.autograd.grad(loss, tstep.leaves(req)), \
        gen.get_state()


@pytest.mark.parametrize("route", ["k1", "composed", "lora"])
@pytest.mark.parametrize("mode", MODES)
def test_remat_modes_agree(mode, route):
    """Each mode against "none": loss and every gradient within 1e-6 of
    its leaf's largest (bit for bit here), the generator's stream where
    the unwrapped forward left it."""
    cfg = cfg_of(route)
    params = init_params(0, cfg, device="cpu")
    if route == "lora":            # nonzero B factors: the adapters act
        params["blocks"] = {k: v + 0.01 if k.endswith("_b") else v
                            for k, v in params["blocks"].items()}
    l0, g0, s0 = grads_of(cfg.replace(remat="none"), params)
    l1, g1, s1 = grads_of(cfg.replace(remat=mode), params)
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    same = True
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-30)
        same = same and torch.equal(a, b)
    print(f"remat {mode} on {route}: gradients bit-equal to none: {same}")
    assert torch.equal(s1, s0)


def saved_bytes(cfg, params) -> int:
    """Bytes autograd keeps for the backward of one training forward."""
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t
    req = tstep.tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tstep.loss_fn(req, {"image": images(8), "label": torch.zeros(
            8, dtype=torch.long)}, cfg, torch.Generator().manual_seed(1))
    return total


def test_remat_saves_less():
    """At depth 4 on K1's route, the bytes autograd's saved-tensor hooks
    see: "block" keeps the least, "save_stash" less than "none". ("dots"
    keeps its products in selective checkpointing's own cache, which the
    hooks do not see: ``test_dots_keeps_the_products`` holds it.)"""
    cfg = cfg_of("k1").replace(depth=4)
    params = init_params(0, cfg, device="cpu")
    got = {m: saved_bytes(cfg.replace(remat=m), params)
           for m in ("none", "block", "save_stash")}
    print("saved bytes:", got)
    assert got["block"] < got["save_stash"] < got["none"]


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def backward_mms(cfg, params) -> int:
    """The 2-D products the backward of one training forward runs."""
    req = tstep.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = tstep.loss_fn(req, {"image": images(2), "label": torch.zeros(
        2, dtype=torch.long)}, cfg, torch.Generator().manual_seed(1))
    with _CountMM() as mode:
        torch.autograd.grad(loss, tstep.leaves(req))
    return mode.mm


def test_dots_keeps_the_products():
    """On the composed route: "dots" recomputes none of the forward's 2-D
    products (its backward runs as many as "none"'s), "block" recomputes
    them all."""
    cfg = cfg_of("composed")
    params = init_params(0, cfg, device="cpu")
    got = {m: backward_mms(cfg.replace(remat=m), params)
           for m in ("none", "dots", "block")}
    print("backward 2-D products:", got)
    assert got["dots"] == got["none"] < got["block"]


@pytest.mark.parametrize("mode,per_block", [
    ("none", 1), ("block", 2), ("dots", 2), ("save_stash", 1)])
def test_remat_recomputes_k1(mode, per_block, monkeypatch):
    """K1's forward per block per step: once without remat and under
    "save_stash" (its stash kept), twice under "block" and "dots" (vitx's
    remat re-runs the custom_vjp's forward rule)."""
    calls = []
    real = tmha._forward

    def counting(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(tmha, "_forward", counting)
    cfg = cfg_of("k1").replace(remat=mode)
    grads_of(cfg, init_params(0, cfg, device="cpu"))
    assert len(calls) == per_block * cfg.depth


def test_inference_never_checkpoints():
    """No grad recorded (inference mode, no_grad, or nothing requiring
    grad): the mode is "none"; under grad it is the config's."""
    cfg = cfg_of("k1").replace(remat="block")
    params = init_params(0, cfg, device="cpu")
    layers = vitx_torch.nn.vit.encoder_layers(params)
    x = torch.zeros(1, 5, cfg.embed_dim)
    assert remat_mode(cfg, x, layers) == "none"
    with torch.no_grad():
        assert remat_mode(cfg, x.requires_grad_(), layers) == "none"
    assert remat_mode(cfg, x, layers) == "block"
    out = vitx_torch.forward(params, images(2), cfg, device="cpu")
    assert out.shape == (2, cfg.num_classes)


def vitx_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        shape, init = node
        base = (0.02 * rng.standard_normal(shape) if init == "normal"
                else np.full(shape, init))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    return draw(param_spec(cfg))


@pytest.mark.parametrize("mode", ["block", "dots"])
def test_remat_step_matches_vitx(mode):
    """A depth-2 fp32 deterministic loss and its gradients under the
    policy, against vitx's ``value_and_grad`` under the same policy
    (composed attention, 1e-4)."""
    kw = dict(KW, fuse_mha="off", remat=mode)
    jcfg, tcfg = vitx.get_config("tiny", **kw), vitx_torch.get_config(
        "tiny", **kw)
    params = vitx_params(tcfg)
    b = {"image": images().numpy(), "label": np.array([0, 1, 2, 3],
                                                      np.int32)}
    want, jg = jax.jit(jax.value_and_grad(lambda p: jstep.loss_fn(
        p, jax.tree.map(jnp.asarray, b), jcfg, None)[0]))(
        jax.tree.map(jnp.asarray, params))
    req = tstep.tree_map(lambda t: t.requires_grad_(),
                         vitx_torch.params_from_jax(params, tcfg, "cpu"))
    got = tstep.loss_fn(req, {k: torch.from_numpy(v) for k, v in b.items()},
                        tcfg)[0]
    tg = torch.autograd.grad(got, tstep.leaves(req))
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
    for a, g in zip(jax.tree.leaves(jg), tg):
        a = np.asarray(a)
        assert np.max(np.abs(g.numpy() - a)) <= 1e-4 * max(
            np.max(np.abs(a)), 1e-12)


# --- the Trainer ---------------------------------------------------------------

def trainer_run(k, loader_kind, epochs=1, n=42, **tkw):
    cfg = vitx_torch.get_config("tiny", **dict(KW, dropout=0.1,
                                               drop_path=0.1))
    ds = SyntheticDataset(num_examples=n, image_size=32, num_classes=4)
    pre = make_preprocess(out_size=32, mean=(0.5,) * 3, std=(0.5,) * 3,
                          random_flip=True, random_crop=True)
    loader = (BatchLoader(ds, 4, shuffle=True) if loader_kind == "host"
              else DeviceBatchLoader(ds, 4, shuffle=True, device="cpu"))
    tr = tloop.Trainer(cfg, tloop.TrainerConfig(
        epochs=epochs, steps_per_dispatch=k, log_every=5, lr=1e-3, **tkw),
        preprocess=pre, device="cpu")
    history = tr.fit(loader)
    return tr, history


@pytest.mark.parametrize("loader_kind", ["host", "device"])
def test_steps_per_dispatch_matches_single_steps(loader_kind):
    """k = 4 over 11 batches (two dispatches, a remainder of 3 single
    steps; the last batch ragged, its padding masked), random crops, flips,
    dropout and drop-path: the losses, the step count and every param
    equal the k = 1 run's bit for bit."""
    one, h1 = trainer_run(1, loader_kind)
    four, h4 = trainer_run(4, loader_kind)
    assert int(one.state.step) == int(four.state.step) == 11
    assert h1[-1]["epoch_loss_sum"] == h4[-1]["epoch_loss_sum"]
    for a, b in zip(tstep.leaves(one.state.params),
                    tstep.leaves(four.state.params)):
        assert torch.equal(a, b)


def test_profile_epoch_writes_trace(tmp_path):
    """``profile_epoch`` 0 with a ``log_dir``: a Chrome trace of the epoch
    holding the step's operators."""
    trainer_run(2, "host", n=8, log_dir=str(tmp_path), profile_epoch=0)
    trace = json.loads((tmp_path / "profile_epoch0.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_multilabel_adafactor_sam_resume(tmp_path):
    """A multi-label (BCE) Adafactor run with SAM and a cosine-free
    constant lr, 2 epochs, against 1 epoch then a resume: the same params
    bit for bit, the checkpoint's meta recording the loss and optimizer,
    the eval a multi-label report."""
    cfg = vitx_torch.get_config("tiny", **dict(KW, num_classes=5))
    train = SyntheticMultiLabelDataset(num_examples=16, image_size=32,
                                       num_classes=5)
    val = SyntheticMultiLabelDataset(num_examples=8, image_size=32,
                                     num_classes=5, seed=1)

    def run(epochs, ck):
        tr = tloop.Trainer(cfg, tloop.TrainerConfig(
            epochs=epochs, loss="bce", optimizer="adafactor", sam_rho=0.05,
            lr=1e-3, checkpoint_dir=str(ck)), device="cpu")
        h = tr.fit(BatchLoader(train, 8), BatchLoader(val, 8))
        return tr, h
    full, h = run(2, tmp_path / "a")
    assert {"val_mAP", "val_f1_micro", "val_f1_macro"} <= set(h[-1])
    run(1, tmp_path / "b")
    resumed, _ = run(2, tmp_path / "b")
    for a, b in zip(tstep.leaves(full.state.params),
                    tstep.leaves(resumed.state.params)):
        assert torch.equal(a, b)
    meta = json.loads(bytes(np.load(tmp_path / "b" / "1.ckpt")[
        "__meta__"]).decode())
    assert meta["loss_type"] == "bce" and meta["optimizer"] == "adafactor"
