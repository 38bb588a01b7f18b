#!/usr/bin/env python3
"""Drive the PyTorch port (vitx_torch) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; a phase that fails raises and the script exits non-zero:

1. device  -- a CUDA device is present; prints its name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build   -- builds every kernel from the sources in the checkout
              (vitx_torch/kernels/csrc, one nvcc per source, in parallel).
3. kernels -- K1 (fused MHA block) and K2 (fused MLP block) at ViT-B/16
              shapes, batch 8 and 32, against their plain torch versions
              on the same card: float32 within 1e-4 relative, bfloat16 within
              BF16_TOL (see below), all three activations.
4. grad    -- the training kernels at ViT-B/16 shapes (T 197) against
              their plain versions: batch 8 in float32 (1e-4) and bfloat16,
              and the train main path's batch 128 in bfloat16: B2
              (attention backward), B3 (LayerNorm backward at E 768 and the
              head's 3072), the K1 and K2 stashes, and torch.autograd.grad
              through both fused blocks on the card against the same on the
              CPU (plain versions); B12 (AdamW) on a base16 leaf.
5. forward -- the base16 forward (depth 12, bf16) at batch 8 on the card
              against the port's plain forward on the CPU with the same
              weights (relative error < 0.05 on the logits); exactly 12 K1
              and 12 K2 launches per forward.
6. serve   -- main path 1: an InferenceServer for base16 at batch 32
              answers 64 requests from 8 threads; each top-k must equal a
              direct forward of the same images at the same batch shape.
7. train   -- (a) base16 at depth 2, batch 4, float32: one train_step on
              the card against the same step on the CPU from the same
              params (loss, grad_norm and gradients within 1e-4; each
              param within 1e-4 lr of the gap its gradient's error
              allows). (b) main path 2: full base16 in bf16 at batch 128
              on SyntheticDataset batches: 20 train_steps with
              make_optimizer(lr=1e-4), then 5 with fused=True, on one
              repeated batch; the loss must be finite and fall, the
              launches per step must be K1 12, B2 12, B3 25, K2 0 and B12
              0 or one per leaf; one eval_step.
8. times   -- CUDA-event medians: the base16 forward at batch 256 bf16
              (img/s) and the train step at batch 128 bf16 (img/s), each
              with a torch.profiler split; for each kernel its time, its
              bound, its plain version's time and one PyTorch library call
              of the same function, at the shapes of those two paths.

Each main path runs with the kernels' launch counts set to 0 just before
it and read just after. The last lines are one JSON object listing the
kernels and, last, ``{"ok": true, "device": {...}}``. ``--phases`` runs a
subset (``device,build,grad`` is the quick check after editing a kernel);
a subset never prints the ok line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# bf16 kernel vs plain: both accumulate in fp32 but in another order, which
# flips the bf16 rounding of a few intermediates (h, q|k|v, p, o, hp, ha;
# qs, cast(pu), do/l, e; dx) by one ulp (2**-8 relative); a few such flips
# bound the output error by a few ulps of its largest element.
BF16_TOL = 2e-2
# bf16 gradients through a whole block, card vs CPU: five casts in a chain
# (do, dq|dk|dv, dh, dx and the weights' grads) compound those flips
GRAD_BF16_TOL = 5e-2
FP32_TOL = 1e-4
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PHASES = ("device", "build", "kernels", "grad", "forward", "serve", "train",
          "times")

KERNELS = {
    "fused_mha_block": {
        "source": "vitx_torch/kernels/csrc/mha_block.cu",
        "replaces": "vitx/kernels/mha_block.py:46",
        "tpu_kernel": "vitx/kernels/mha_block.py::_kernel",
    },
    "fused_mlp_block": {
        "source": "vitx_torch/kernels/csrc/mlp_block.cu",
        "replaces": "vitx/kernels/mlp_block.py:67",
        "tpu_kernel": "vitx/kernels/mlp_block.py::_kernel",
    },
    "attention_bwd": {
        "source": "vitx_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "vitx/kernels/flash_attention.py:287",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_bwd_kernel_nq1",
    },
    "ln_bwd": {
        "source": "vitx_torch/kernels/csrc/layer_norm_bwd.cu",
        "replaces": "vitx/kernels/layer_norm.py:173",
        "tpu_kernel": "vitx/kernels/layer_norm.py::_ln_bwd3_kernel",
    },
    "fused_adamw_": {
        "source": "vitx_torch/kernels/csrc/adamw.cu",
        "replaces": "vitx/kernels/adamw.py:56",
        "tpu_kernel": "vitx/kernels/adamw.py::_kernel",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, each timed with
    CUDA events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_inputs(B, T, E, H, M, dtype, seed, device):
    """Seeded inputs of one block at (B, T, E), weights in ``dtype``."""
    rng = np.random.default_rng(seed)
    D = E // H

    def t(shape, scale, dt=dtype, shift=0.0):
        a = (shift + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dt)

    f32 = torch.float32
    x = t((B, T, E), 1.0)
    mha = dict(wqkv=t((E, 3, H, D), 0.03), wo=t((E, E), 0.03),
               bo=t((E,), 0.1, f32), g=t((E,), 0.1, f32, 1.0),
               b=t((E,), 0.1, f32))
    mlp = dict(w1=t((E, M), 0.03), b1=t((M,), 0.1, f32), w2=t((M, E), 0.03),
               b2=t((E,), 0.1, f32), g=t((E,), 0.1, f32, 1.0),
               b=t((E,), 0.1, f32))
    return x, mha, mlp


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    from vitx_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    for name, log in _build.build_log.items():
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    emit({"phase": "build", "seconds": round(seconds, 2),
          "per_source_s": {n: round(v["seconds"], 2)
                           for n, v in _build.build_log.items()}})


def phase_kernels(errs: dict):
    T, E, H = 197, 768, 12
    # batch 8, and batch 32: the shape the serve phase gives the kernels
    for B in (8, 32):
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            check_block(B, T, E, H, dtype, tol, errs)


def check_block(B, T, E, H, dtype, tol, errs: dict):
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    x, mha, mlp = block_inputs(B, T, E, H, 4 * E, dtype, B, "cuda")
    runs = [("fused_mha_block", None, lambda: fused_mha_block(x, **mha),
             lambda: mha_block_plain(x, **mha))]
    for act in ("gelu", "gelu_tanh", "relu"):
        runs.append(("fused_mlp_block", act,
                     lambda a=act: fused_mlp_block(x, **mlp, act=a),
                     lambda a=act: mlp_block_plain(x, **mlp, act=a)))
    for name, act, kern, plain in runs:
        out = kern()
        torch.cuda.synchronize()
        check("kernels", name, out, plain(), tol,
              errs if dtype == torch.bfloat16 and act in (None, "gelu_tanh")
              else None, name, act=act, batch=B, dtype=str(dtype))


def wrappers() -> dict:
    import vitx_torch.kernels as k

    return {name: getattr(k, name) for name in KERNELS}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def forward_launches(cfg, forwards: int) -> dict:
    """Inference launches: one K1 and one K2 per block, nothing else."""
    return {name: (cfg.depth * forwards if name in ("fused_mha_block",
                                                    "fused_mlp_block")
                   else 0) for name in KERNELS}


def check(phase: str, what: str, out, ref, tol: float,
          errs: dict | None = None, key: str | None = None, **info) -> None:
    """Emit one comparison of ``out`` with ``ref`` (tensors or sequences
    of them, compared on the CPU) and raise past ``tol``; ``errs[key]``
    keeps the largest absolute error."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    refs = ref if isinstance(ref, (tuple, list)) else (ref,)
    rel = abs_err = 0.0
    finite = True
    for o, r in zip(outs, refs):
        o, r = o.detach().float().cpu(), r.detach().float().cpu()
        finite = finite and bool(torch.isfinite(o).all())
        rel = max(rel, rel_err(o, r))
        abs_err = max(abs_err, float((o - r).abs().max()))
    emit({"phase": phase, "check": what, "rel_err": rel,
          "max_abs_err": abs_err, "tol": tol, **info})
    if not (finite and rel <= tol):
        raise AssertionError(f"{what} {info}: rel err {rel} > {tol}")
    if errs is not None and key is not None:
        errs[key] = max(errs.get(key, 0.0), abs_err)


def seeded(shape, seed, scale=1.0, shift=0.0, dtype=torch.float32,
           device="cuda"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(shift + scale * a).to(device=device, dtype=dtype)


def check_training_kernels(B, T, E, H, dtype, tol, gtol, errs: dict):
    """B2, B3 (E and the head's 4E), the K1 and K2 stashes and autograd
    through both blocks (card against CPU) at (B, T, E) in ``dtype``."""
    from vitx_torch.kernels import (attention_bwd, attention_bwd_plain,
                                    fused_mha_block, fused_mlp_block,
                                    ln_bwd, ln_bwd_plain, mha_block_plain,
                                    mlp_block_plain)

    D = E // H
    bf = dtype == torch.bfloat16
    info = {"dtype": str(dtype), "batch": B}
    q, k, v = (seeded((B, H, T, D), s, 1.5, dtype=dtype) for s in (1, 2, 3))
    do = seeded((B, H, T, D), 4, 0.1, dtype=dtype)
    out = attention_bwd(q, k, v, do)
    torch.cuda.synchronize()
    check("grad", "attention_bwd", out, attention_bwd_plain(q, k, v, do),
          tol, errs if bf else None, "attention_bwd", **info)
    del q, k, v, do, out
    for shape in ((B, T, E), (B, 4 * E)):
        x = seeded(shape, 5, 2.0, 0.5, dtype=dtype)
        dy = seeded(shape, 6, 0.1, dtype=dtype)
        sc = seeded(shape[-1:], 7, 0.1, 1.0)
        out = ln_bwd(x, sc, dy)
        torch.cuda.synchronize()
        check("grad", "ln_bwd", out, ln_bwd_plain(x, sc, dy), tol,
              errs if bf else None, "ln_bwd", shape=list(shape), **info)
    x, mha, mlp = block_inputs(B, T, E, H, 4 * E, dtype, 8, "cuda")
    out = fused_mha_block(x, **mha, stash=True)
    torch.cuda.synchronize()
    check("grad", "fused_mha_block stash (out, q, k, v, o_all)", out,
          mha_block_plain(x, **mha, stash=True), tol, **info)
    out = fused_mlp_block(x, **mlp, act="gelu_tanh", stash=True)
    torch.cuda.synchronize()
    check("grad", "fused_mlp_block stash (out, hp)", out,
          mlp_block_plain(x, **mlp, act="gelu_tanh", stash=True), tol,
          **info)
    del out
    dout = seeded((B, T, E), 9, 0.1, dtype=dtype)
    for name, fn, args in (
            ("fused_mha_block", fused_mha_block, mha),
            ("fused_mlp_block",
             lambda x, **a: fused_mlp_block(x, **a, act="gelu_tanh"),
             mlp)):
        card = [x, *args.values()]
        host = [t.detach().cpu() for t in card]
        grads = []
        for ts, d in ((card, dout), (host, dout.cpu())):
            ts = [t.detach().requires_grad_() for t in ts]
            y = fn(ts[0], **dict(zip(args, ts[1:])))
            grads.append(torch.autograd.grad(y, ts, d))
        torch.cuda.synchronize()
        check("grad", f"{name} autograd.grad, card vs CPU", grads[0],
              grads[1], gtol, **info)


def phase_grad(errs: dict):
    from vitx_torch.kernels import adamw_plain, fused_adamw_

    E = 768
    # batch 8 in both dtypes, and the train main path's batch 128 in bf16
    for B, dtype, tol, gtol in ((8, torch.float32, FP32_TOL, FP32_TOL),
                                (8, torch.bfloat16, BF16_TOL, GRAD_BF16_TOL),
                                (128, torch.bfloat16, BF16_TOL,
                                 GRAD_BF16_TOL)):
        check_training_kernels(B, 197, E, 12, dtype, tol, gtol, errs)
    # B12 on a base16 leaf (the stacked block W1), float32 and bf16 grads
    shape = (12, E, 4 * E)
    for gdt in (torch.float32, torch.bfloat16):
        p = seeded(shape, 10, 0.02)
        g = seeded(shape, 11, 1e-3, dtype=gdt)
        mu = seeded(shape, 12, 1e-4)
        nu = seeded(shape, 13, 1e-6).abs()
        kw = dict(lr=1e-4, c1=0.271, c2=0.002997, b1=0.9, b2=0.999,
                  eps=1e-8, wd=1e-4)
        ref = adamw_plain(p, g, mu, nu, **kw)
        fused_adamw_(p, g, mu, nu, **kw)
        torch.cuda.synchronize()
        check("grad", "fused_adamw_ (p, mu, nu)", (p, mu, nu), ref,
              FP32_TOL, errs, "fused_adamw_", grad_dtype=str(gdt),
              elements=p.numel())


def phase_forward(cfg, params):
    from vitx_torch import forward
    from vitx_torch.nn.vit import params_to

    rng = np.random.default_rng(1)
    images = rng.standard_normal(
        (8, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    reset_counts()
    logits = forward(params, images, cfg)
    torch.cuda.synchronize()
    n = counts()
    if n != forward_launches(cfg, 1):
        raise AssertionError(f"launches per forward {n}, expected "
                             f"{forward_launches(cfg, 1)}")
    t0 = time.perf_counter()
    ref = forward(params_to(params, "cpu"), images, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = rel_err(logits.cpu(), ref)
    emit({"phase": "forward", "shape": list(logits.shape), "rel_err": err,
          "launches": n, "cpu_plain_s": round(cpu_s, 2)})
    if not (logits.shape == (8, cfg.num_classes)
            and torch.isfinite(logits).all() and err < 0.05):
        raise AssertionError(f"forward vs plain: rel err {err}")


def phase_serve(cfg, params) -> dict:
    from vitx_torch import forward
    from vitx_torch.serve import InferenceServer

    rng = np.random.default_rng(2)
    imgs = rng.standard_normal(
        (64, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    results = [None] * 64
    reset_counts()
    with InferenceServer(params, cfg, batch_size=32, top_k=5,
                         max_delay_ms=20.0) as srv:
        def client(c):
            for i in range(c * 8, c * 8 + 8):
                results[i] = srv.predict(imgs[i])

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve: clients did not finish")
        stats = srv.stats.summary()
    launches = counts()
    forwards = 1 + stats["batches"]            # the warm-up, then batches
    expect = forward_launches(cfg, forwards)
    if launches != expect:
        raise AssertionError(f"serve launches {launches}, expected {expect}")
    for lo in (0, 32):
        logits = forward(params, imgs[lo:lo + 32], cfg)
        probs, classes = torch.topk(torch.softmax(logits.float(), -1), 5)
        for i in range(32):
            got = results[lo + i]
            if got["classes"] != classes[i].tolist():
                raise AssertionError(f"request {lo + i}: served "
                                     f"{got['classes']}, direct "
                                     f"{classes[i].tolist()}")
            np.testing.assert_allclose(got["probs"], probs[i].cpu().numpy(),
                                       rtol=1e-6, atol=1e-9)
    if stats["requests"] != 64:
        raise AssertionError(f"stats count {stats['requests']} requests")
    emit({"phase": "serve", "stats": stats, "launches": launches})
    return launches


def synthetic_batch(ds, n: int) -> dict:
    """The first ``n`` examples of a SyntheticDataset, stacked as vitx's
    BatchLoader stacks them: uint8 NHWC images and int32 labels."""
    ex = [ds.get_example(i) for i in range(n)]
    return {"image": np.stack([e[0] for e in ex]),
            "label": np.array([e[1] for e in ex], np.int32)}


def expected_train_launches(cfg, n_leaves: int, steps: int,
                            fused_steps: int) -> dict:
    """Launches per the code's routing: one K1 and one B2 per block; B3 for
    LN1 (inside K1's backward) and LN2 of every block, the reference head's
    LayerNorm and the final norm; K2 off under grad (fuse_mlp "auto"); B12
    once per leaf in the fused steps."""
    b3 = 2 * cfg.depth + (cfg.head_type == "reference") + int(cfg.final_norm)
    return {"fused_mha_block": cfg.depth * steps,
            "fused_mlp_block": 0,
            "attention_bwd": cfg.depth * steps,
            "ln_bwd": b3 * steps,
            "fused_adamw_": n_leaves * fused_steps}


def param_gap(gc, gh, pc, ph, lr: float, eps: float) -> dict:
    """Hold the params after one Adam step from zero moments on the card
    (``pc``, gradients ``gc``) to those on the CPU (``ph``, ``gh``).

    That step moves an element by lr * (u(g) + wd * p), u(g) = g / (|g| +
    eps). With d the leaf's largest gradient difference, the two moves
    differ by at most lr * (u(|g| + d) + u(|g|)) in any case, and by at most
    lr * eps * d / (|g| - d + eps)**2 where |g| > d (mean value theorem).
    Each element is held to the smaller of the two, plus 1e-4 lr for the
    update's rounding and one ulp of the new param. ``worst`` is the
    largest gap over its allowance; ``loose_share`` the share of elements
    whose allowance exceeds lr / 2 (a sign the two steps may not share)."""
    worst, loose, total = 0.0, 0, 0
    for a, b, p_card, p_host in zip(gc, gh, pc, ph):
        d = float((a - b).abs().max())
        g = b.abs()
        bound = (g + d) / (g + d + eps) + g / (g + eps)
        mvt = eps * d / (g - d + eps) ** 2
        bound = torch.where(g > d, torch.minimum(bound, mvt), bound)
        size = p_host.abs()
        ulp = torch.nextafter(size, torch.full_like(size, np.inf)) - size
        allow = lr * (1e-4 + bound) + ulp
        worst = max(worst, float(((p_card - p_host).abs() / allow).max()))
        loose += int((bound > 0.5).sum())
        total += g.numel()
    return {"worst": worst, "loose_share": loose / total, "elements": total}


def phase_train(ds) -> tuple:
    """(a) one fp32 step at depth 2, card vs CPU; (b) the bf16 main path.
    Returns (the main path's launches, its state, its batch, the step)."""
    import vitx_torch
    from vitx_torch.nn.vit import init_params, params_to
    from vitx_torch.train import (TrainState, create_train_state, eval_step,
                                  make_optimizer, make_train_step,
                                  train_step)
    from vitx_torch.train.step import leaves, loss_fn, tree_map

    # (a) base16 at depth 2, batch 4, fp32: card against CPU. The gradients
    # of the step's loss agree to FP32_TOL of each leaf's largest.
    cfg2 = vitx_torch.get_config("base16", depth=2, compute_dtype="float32")
    lr = 1e-4
    opt = make_optimizer(lr=lr)
    host = init_params(1, cfg2, device="cpu")
    card = params_to(host, "cuda")
    batch4 = synthetic_batch(ds, 4)
    out = []
    for params, dev in ((card, "cuda"), (host, "cpu")):
        t0 = time.perf_counter()
        req = tree_map(lambda t: t.detach().requires_grad_(), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch4.items()}
        grads = torch.autograd.grad(loss_fn(req, b, cfg2)[0], leaves(req))
        state = TrainState(0, params, opt.init(params))
        state, m = train_step(state, batch4, cfg=cfg2, optimizer=opt,
                              device=dev)
        out.append(([g.cpu() for g in grads], [t.cpu() for t in
                                                leaves(state.params)],
                    {k: float(v) for k, v in m.items()},
                    time.perf_counter() - t0))
    (gc, pc, mc, card_s), (gh, ph, mh, cpu_s) = out
    errs = {k: abs(mc[k] - mh[k]) / abs(mh[k]) for k in ("loss", "grad_norm")}
    errs["grads"] = max(rel_err(a, b) for a, b in zip(gc, gh))
    p_err = param_gap(gc, gh, pc, ph, lr, opt.eps)
    emit({"phase": "train", "part": "a: base16 depth 2 fp32, card vs CPU",
          "card": mc, "cpu": mh, "rel_err": errs, "params": p_err,
          "tol": FP32_TOL, "card_s": card_s, "cpu_s": cpu_s})
    if not (max(errs.values()) <= FP32_TOL and p_err["worst"] <= 1.0):
        raise AssertionError(f"train step card vs CPU: {errs}, {p_err}")

    # (b) the main path: full base16, bf16, batch 128
    cfg = vitx_torch.get_config("base16")
    batch = synthetic_batch(ds, 128)
    opt = make_optimizer(lr=1e-4)
    fused = make_optimizer(lr=1e-4, fused=True)
    state = create_train_state(0, cfg, opt)
    step, fused_step = (make_train_step(cfg, o) for o in (opt, fused))
    n_leaves = len(leaves(state.params))
    losses = []
    reset_counts()
    t0 = time.perf_counter()
    for i in range(25):
        state, m = (step if i < 20 else fused_step)(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    losses = [float(v) for v in losses]
    expect = expected_train_launches(cfg, n_leaves, 25, 5)
    cm, eval_loss = eval_step(state.params, batch, cfg=cfg)
    emit({"phase": "train", "part": "b: base16 bf16 batch 128, 20 + 5 "
          "fused steps", "losses": losses, "launches": launches,
          "expected": expect, "wall_s": wall, "eval_loss": float(eval_loss),
          "eval_accuracy": float(cm.diagonal().sum()) / float(cm.sum())})
    if launches != expect:
        raise AssertionError(f"train launches {launches}, expected {expect}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and min(losses[-5:]) < min(losses[:5])):
        raise AssertionError(f"train loss did not fall: {losses}")
    if int(cm.sum()) != 128 or not np.isfinite(float(eval_loss)):
        raise AssertionError(f"eval_step: {int(cm.sum())} rows counted, "
                             f"loss {float(eval_loss)}")
    return launches, state, batch, step


def profile_call(what: str, fn, top: int = 12) -> None:
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device kernels only: an aten:: op's row repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key[:90]))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    emit({"phase": "profile", "what": what, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if rows else "not measured",
          "busy_share": busy_ms / wall_ms if rows else "not measured",
          "top": [{"ms": ms, "count": n, "kernel": k}
                  for ms, n, k in rows[:top]]})


def phase_times(cfg, params, errs: dict, launches: dict) -> list:
    """The forward at batch 256 and the K1/K2 rows at its shapes."""
    import torch.nn.functional as F

    from vitx_torch import forward
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    B, E, H = 256, cfg.embed_dim, cfg.num_heads
    T, M, D = cfg.seq_len, cfg.mlp_dim, cfg.head_dim
    images = torch.randn(B, cfg.image_size, cfg.image_size, 3,
                         device="cuda", generator=torch.Generator(
                             "cuda").manual_seed(3)).to(torch.bfloat16)
    fwd_ms = cuda_ms(lambda: forward(params, images, cfg), reps=10)
    emit({"phase": "times", "what": "forward", "batch": B,
          "ms": fwd_ms, "img_per_s": B / (fwd_ms / 1000.0)})
    profile_call("forward", lambda: forward(params, images, cfg))

    x, mha, mlp = block_inputs(B, T, E, H, M, torch.bfloat16, 4, "cuda")
    bf = torch.bfloat16
    eps = cfg.layer_norm_eps
    wqkv_t = mha["wqkv"].reshape(E, 3 * E).t().contiguous()
    wo_t = mha["wo"].t().contiguous()
    w1_t, w2_t = mlp["w1"].t().contiguous(), mlp["w2"].t().contiguous()

    def lib_mha():
        h = F.layer_norm(x, (E,), mha["g"].to(bf), mha["b"].to(bf), eps)
        q, k, v = F.linear(h, wqkv_t).view(B, T, 3, H, D).permute(
            2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return F.linear(o.transpose(1, 2).reshape(B, T, E), wo_t,
                        mha["bo"].to(bf))

    def lib_mlp():
        h = F.layer_norm(x, (E,), mlp["g"].to(bf), mlp["b"].to(bf), eps)
        h = F.gelu(F.linear(h, w1_t, mlp["b1"].to(bf)), approximate="tanh")
        return F.linear(h, w2_t, mlp["b2"].to(bf))

    item = 2
    rows = B * T
    k1_flops = 2 * rows * E * 3 * E + 2 * rows * E * E + 4 * B * H * T * T * D
    k1_bytes = 2 * rows * E * item + 4 * E * E * item + 3 * E * 4
    k2_flops = 4 * rows * E * M
    k2_bytes = 2 * rows * E * item + 2 * E * M * item + (M + 3 * E) * 4
    return [
        kernel_row("fused_mha_block",
                   lambda: fused_mha_block(x, **mha, eps=eps),
                   lambda: mha_block_plain(x, **mha, eps=eps), lib_mha,
                   k1_flops, PEAK_BF16_FLOPS, k1_bytes, launches, errs,
                   shape=[B, T, E]),
        kernel_row("fused_mlp_block",
                   lambda: fused_mlp_block(x, **mlp, act=cfg.mlp_act,
                                           eps=eps),
                   lambda: mlp_block_plain(x, **mlp, act=cfg.mlp_act,
                                           eps=eps), lib_mlp,
                   k2_flops, PEAK_BF16_FLOPS, k2_bytes, launches, errs,
                   shape=[B, T, E]),
    ]


def kernel_row(name, kern, plain, lib, flops, peak, nbytes, launches,
               errs, **extra) -> dict:
    """Time ``kern`` twice between two runs of ``plain`` (compare only
    within this call), and ``lib``; profile one call of ``kern``; the bound
    is max(flops / peak, bytes / HBM rate)."""
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    ms = cuda_ms(kern, reps=20)
    ms2 = cuda_ms(kern, reps=20)
    plain_ms2 = cuda_ms(plain, reps=3, warmup=1)
    lib_ms = cuda_ms(lib, reps=20) if lib is not None else None
    profile_call(name, kern)
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    row = {"name": name, "route": "cuda", **KERNELS[name],
           "launches": launches.get(name), "max_abs_err": errs.get(name),
           "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
           "tflops": flops / (min(ms, ms2) * 1e-3) / 1e12, **extra}
    emit({"phase": "times", "what": name, "ms_runs": [ms, ms2],
          "plain_ms_runs": [plain_ms, plain_ms2], **row})
    return row


def phase_train_times(cfg, state, batch, step, launches: dict,
                      errs: dict) -> list:
    """The train step at batch 128 bf16 (img/s, profiler split), and the
    training kernels' rows at its shapes: B2 and B3 per call, B12 per step
    over every leaf; K1 and K2 with their stash."""
    import torch.nn.functional as F

    from vitx_torch.kernels import (adamw_plain, attention_bwd,
                                    attention_bwd_plain, fused_adamw_,
                                    fused_mha_block, fused_mlp_block,
                                    ln_bwd, ln_bwd_plain)
    from vitx_torch.train.step import leaves

    B = batch["image"].shape[0]
    T, E, H, D = cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.head_dim
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    step_ms = cuda_ms(one_step, reps=5, warmup=1)
    emit({"phase": "times", "what": "train_step", "batch": B,
          "ms": step_ms, "img_per_s": B / (step_ms / 1000.0)})
    profile_call("train_step", one_step, top=16)

    bf = torch.bfloat16
    rows = []
    # B2 at the step's shapes
    q, k, v = (seeded((B, H, T, D), s, 1.5, dtype=bf) for s in (21, 22, 23))
    do = seeded((B, H, T, D), 24, 0.1, dtype=bf)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qs, ks, vs)
    rows.append(kernel_row(
        "attention_bwd", lambda: attention_bwd(q, k, v, do),
        lambda: attention_bwd_plain(q, k, v, do),
        lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do,
                                    retain_graph=True),
        10 * B * H * T * T * D, PEAK_BF16_FLOPS, 7 * B * H * T * D * 2,
        launches, errs, shape=[B, H, T, D],
        per_step=launches.get("attention_bwd", 0) // 25))
    # B3 at a block's LayerNorm (B, T, E)
    x = seeded((B, T, E), 25, 2.0, 0.5, dtype=bf)
    dy = seeded((B, T, E), 26, 0.1, dtype=bf)
    sc = seeded((E,), 27, 0.1, 1.0)
    xs, scs = x.detach().requires_grad_(), sc.detach().to(bf).requires_grad_()
    bs = torch.zeros(E, dtype=bf, device="cuda", requires_grad=True)
    y_lib = F.layer_norm(xs, (E,), scs, bs, cfg.layer_norm_eps)
    rows.append(kernel_row(
        "ln_bwd", lambda: ln_bwd(x, sc, dy), lambda: ln_bwd_plain(x, sc, dy),
        lambda: torch.autograd.grad(y_lib, (xs, scs, bs), dy,
                                    retain_graph=True),
        20 * B * T * E, PEAK_FP32_FLOPS, 3 * B * T * E * 2 + 3 * E * 4,
        launches, errs, shape=[B, T, E],
        per_step=launches.get("ln_bwd", 0) // 25))
    # B12 over every leaf of the base16 state, per step
    ps = [t.detach().clone() for t in leaves(holder[0].params)]
    gs = [torch.randn_like(t) * 1e-3 for t in ps]
    mus = [torch.zeros_like(t) for t in ps]
    nus = [torch.zeros_like(t) for t in ps]
    n = sum(t.numel() for t in ps)
    kw = dict(lr=1e-4, c1=0.1, c2=0.001, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    lib_opt = torch.optim.AdamW(
        [torch.nn.Parameter(t.clone()) for t in ps], lr=1e-4, eps=1e-8,
        weight_decay=1e-4, fused=True)
    for prm, g in zip(lib_opt.param_groups[0]["params"], gs):
        prm.grad = g

    def fused_all():
        for a, b, c, d in zip(ps, gs, mus, nus):
            fused_adamw_(a, b, c, d, **kw)

    def plain_all():
        for a, b, c, d in zip(ps, gs, mus, nus):
            adamw_plain(a, b, c, d, **kw)

    rows.append(kernel_row(
        "fused_adamw_", fused_all, plain_all, lib_opt.step,
        15 * n, PEAK_FP32_FLOPS, 7 * 4 * n, launches, errs,
        leaves=len(ps), elements=n,
        per_step=launches.get("fused_adamw_", 0) // 5))
    # K1 and K2 with their stash at the step's shapes
    x, mha, mlp = block_inputs(B, T, E, H, cfg.mlp_dim, bf, 28, "cuda")
    stash = {
        "fused_mha_block": cuda_ms(
            lambda: fused_mha_block(x, **mha, stash=True), reps=10),
        "fused_mlp_block": cuda_ms(
            lambda: fused_mlp_block(x, **mlp, act=cfg.mlp_act, stash=True),
            reps=10),
    }
    emit({"phase": "times", "what": "stash", "batch": B, "ms": stash})
    return rows, stash


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    args = p.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an H100")
    import vitx_torch                   # fails outside a checkout
    from vitx_torch.nn.vit import init_params

    phase_device()

    if "build" in phases:
        phase_build()
    errs: dict = {}
    if "kernels" in phases:
        phase_kernels(errs)
    if "grad" in phases:
        phase_grad(errs)
    cfg = vitx_torch.get_config("base16")
    params = None
    if {"forward", "serve", "times"} & set(phases):
        params = init_params(0, cfg)
    if "forward" in phases:
        phase_forward(cfg, params)
    serve_launches, train_launches, train = {}, {}, None
    if "serve" in phases:
        serve_launches = phase_serve(cfg, params)
    if "train" in phases:
        from vitx_torch.data import SyntheticDataset

        ds = SyntheticDataset(num_examples=128, image_size=cfg.image_size,
                              num_classes=cfg.num_classes, seed=0)
        train_launches, *train = phase_train(ds)
    launches = {k: serve_launches.get(k, 0) + train_launches.get(k, 0)
                for k in KERNELS}
    if "times" in phases:
        rows = phase_times(cfg, params, errs, launches)
        del params
        stash = {}
        if train:
            new_rows, stash = phase_train_times(cfg, *train, launches, errs)
            rows += new_rows
        for row in rows:
            row["launches_by_path"] = {
                "serve": serve_launches.get(row["name"], 0),
                "train": train_launches.get(row["name"], 0)}
            if row["name"] in stash:
                row["stash_ms_b128"] = stash[row["name"]]
        emit({"kernels": rows})
    if phases != list(PHASES):
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
