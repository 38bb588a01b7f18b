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
4. forward -- the base16 forward (depth 12, bf16) at batch 8 on the card
              against the port's plain forward on the CPU with the same
              weights (relative error < 0.05 on the logits); exactly 12 K1
              and 12 K2 launches per forward.
5. serve   -- the main path: an InferenceServer for base16 at batch 32
              answers 64 requests from 8 threads; each top-k must equal a
              direct forward of the same images at the same batch shape.
              The kernels' launch counts are set to 0 just before this
              phase and read just after.
6. times   -- CUDA-event medians at base16 batch 256 bf16: forward img/s,
              and for each kernel its time, its bound, its plain version's
              time and one PyTorch library call of the same function;
              a torch.profiler split by launch of one forward and of one
              call of each kernel.

The last lines are one JSON object listing the kernels and, last,
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (for a quick
first check of a new kernel); a subset never prints the ok line.
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
# flips the bf16 rounding of a few intermediates (h, q|k|v, p, o, hp, ha)
# by one ulp (2**-8 relative); a few such flips bound the output error by a
# few ulps of its largest element.
BF16_TOL = 2e-2
FP32_TOL = 1e-4
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PHASES = ("device", "build", "kernels", "forward", "serve", "times")

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
        ref = plain()
        err = rel_err(out, ref)
        abs_err = float((out.float() - ref.float()).abs().max())
        emit({"phase": "kernels", "kernel": name, "act": act, "batch": B,
              "dtype": str(dtype), "rel_err": err, "max_abs_err": abs_err,
              "tol": tol})
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"{name} {act} {dtype} batch {B}: "
                                 f"rel err {err} > {tol}")
        if dtype == torch.bfloat16 and act in (None, "gelu_tanh"):
            errs[name] = max(errs.get(name, 0.0), abs_err)


def reset_counts():
    from vitx_torch.kernels import fused_mha_block, fused_mlp_block

    fused_mha_block.launches = 0
    fused_mlp_block.launches = 0


def counts():
    from vitx_torch.kernels import fused_mha_block, fused_mlp_block

    return {"fused_mha_block": fused_mha_block.launches,
            "fused_mlp_block": fused_mlp_block.launches}


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
    if n != {"fused_mha_block": cfg.depth, "fused_mlp_block": cfg.depth}:
        raise AssertionError(f"launches per forward {n}, expected "
                             f"{cfg.depth} of each")
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
    expect = {k: cfg.depth * forwards for k in launches}
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
    cases = (
        ("fused_mha_block", lambda: fused_mha_block(x, **mha, eps=eps),
         lambda: mha_block_plain(x, **mha, eps=eps), lib_mha,
         k1_flops, k1_bytes),
        ("fused_mlp_block",
         lambda: fused_mlp_block(x, **mlp, act=cfg.mlp_act, eps=eps),
         lambda: mlp_block_plain(x, **mlp, act=cfg.mlp_act, eps=eps),
         lib_mlp, k2_flops, k2_bytes),
    )
    rows_out = []
    for name, kern, plain, lib, flops, nbytes in cases:
        # plain, kernel, kernel, plain: compare only within this call
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        ms = cuda_ms(kern, reps=20)
        ms2 = cuda_ms(kern, reps=20)
        plain_ms2 = cuda_ms(plain, reps=3, warmup=1)
        lib_ms = cuda_ms(lib, reps=20)
        profile_call(name, kern)      # the kernel's time by launch
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda", **KERNELS[name],
               "launches": launches.get(name),
               "max_abs_err": errs.get(name),
               "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": lib_ms,
               "shape": [B, T, E], "flops": flops, "bytes": nbytes,
               "tflops": flops / (min(ms, ms2) * 1e-3) / 1e12}
        emit({"phase": "times", "what": name, "ms_runs": [ms, ms2],
              "plain_ms_runs": [plain_ms, plain_ms2], **row})
        rows_out.append(row)
    return rows_out


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
    cfg = vitx_torch.get_config("base16")
    params = None
    if {"forward", "serve", "times"} & set(phases):
        params = init_params(0, cfg)
    if "forward" in phases:
        phase_forward(cfg, params)
    launches = {}
    if "serve" in phases:
        launches = phase_serve(cfg, params)
    if "times" in phases:
        rows = phase_times(cfg, params, errs, launches)
        emit({"kernels": rows})
    if phases != list(PHASES):
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
