"""Throughput autotuner: ``python -m vitx_torch.cli.tune --preset base16 --mode train``.

The counterpart of ``vitx/cli/tune.py``: measures images/s of every
per-device batch size on the current card and reports one JSON line per
candidate (vitx's keys: ``batch``, ``remat``, ``scan_unroll``,
``step_ms``, ``images_per_sec``), then a ``{"best": ...}`` line.

The port runs its blocks as a Python loop with autograd keeping the
activations: it has neither vitx's remat policies nor its scan unroll
(``vitx_torch/nn/vit.py``), so it sweeps batches only and each row
carries the config's ``remat`` and ``scan_unroll``; an explicit
``--remat`` or ``--unroll`` grid exits naming ROADMAP A12, where remat as
activation checkpointing waits.

A candidate the port refuses before it runs (``check_candidate``: a
batch below 1, a config asking for vitx's sharding), or one that runs out of
device memory (the cache is freed before the next), becomes a row with
an ``"error"`` field; any other error raised while it times, a kernel
wrapper's ``ValueError`` among them, propagates. Timing, as the bench CLI's (``cli/bench.py``:
``forward_timing``, ``train_timing``): CUDA events around ``--iters``
back-to-back calls after a warm-up call, the minimum over ``--reps`` (the
host clock with ``--device cpu``, whose rows are CPU times); a train
candidate is the plain-AdamW step with a generator, as vitx's passes its
rng.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from vitx_torch.cli.bench import device_name, forward_timing, train_timing
from vitx_torch.core.device import resolve_device


def check_candidate(cfg, batch: int) -> None:
    """Raise for a candidate the port refuses before it runs: a batch
    below 1 (ValueError), or a config whose throughput is that of a
    sharded run, expert (``ep``) or sequence (``sp``) parallel, which
    waits for ROADMAP A13 (NotImplementedError): one card would time
    another program."""
    if batch < 1:
        raise ValueError(f"batch {batch} must be positive")
    if cfg.ep or cfg.sp:
        raise NotImplementedError(
            "expert- and sequence-parallel configs (ep, sp) shard over a "
            "mesh, which is not ported to vitx_torch yet (ROADMAP A13)")


def run_sweep(cfg, mode, batches, iters, reps, emit=print, device="cuda"):
    """Measure every batch of ``batches``; returns the result rows
    (dicts). A candidate ``check_candidate`` refuses, or one that runs out
    of device memory, makes a row with an "error" field; an error raised
    while timing propagates."""
    dev = resolve_device(device)
    timing = train_timing if mode == "train" else forward_timing
    results = []
    for batch in batches:
        cand = {"batch": batch, "remat": cfg.remat,
                "scan_unroll": cfg.scan_unroll}
        try:
            check_candidate(cfg, batch)
        except (ValueError, NotImplementedError) as e:
            row = {**cand, "error": f"{type(e).__name__}: {e}"[:200]}
        else:
            try:
                ms = min(timing(cfg, batch, iters, reps, dev))
                row = {**cand, "step_ms": ms,
                       "images_per_sec": batch / (ms / 1e3)}
            except torch.OutOfMemoryError as e:
                torch.cuda.empty_cache()
                row = {**cand, "error": f"{type(e).__name__}: {e}"[:200]}
        results.append(row)
        emit(json.dumps(row))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="base16")
    p.add_argument("--config-json", default=None,
                   help="full ViTConfig JSON (overrides --preset)")
    p.add_argument("--mode", default="train", choices=["train", "infer"])
    p.add_argument("--batches", default="32,64,128,256",
                   help="comma-separated per-device batch sizes")
    p.add_argument("--remat", default=None,
                   help="remat policies to sweep: not ported (ROADMAP A12)")
    p.add_argument("--unroll", default=None,
                   help="scan_unroll values to sweep: the port has no scan "
                        "(ROADMAP A12)")
    p.add_argument("--iters", type=int, default=20,
                   help="back-to-back calls a timing")
    p.add_argument("--reps", type=int, default=3,
                   help="timings per candidate (the min is reported)")
    p.add_argument("--out", default=None,
                   help="also write the rows + best to this JSON file")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for flag, value in (("--remat", args.remat), ("--unroll", args.unroll)):
        if value is not None:
            raise SystemExit(
                f"error: {flag} is not ported to vitx_torch: it has no remat "
                f"or scan to sweep (ROADMAP A12, remat as activation "
                f"checkpointing)")

    from vitx_torch.core.config import ViTConfig, get_config

    dev = resolve_device(args.device)
    if args.config_json:
        with open(args.config_json) as f:
            cfg = ViTConfig.from_json(f.read())
    else:
        cfg = get_config(args.preset)
    batches = [int(b) for b in args.batches.split(",")]
    results = run_sweep(cfg, args.mode, batches, args.iters, args.reps,
                        device=dev)
    ok = [r for r in results if "error" not in r]
    best = max(ok, key=lambda r: r["images_per_sec"]) if ok else None
    summary = {"best": best, "mode": args.mode,
               "device": device_name(dev),
               "candidates": len(results), "failed": len(results) - len(ok)}
    print(json.dumps(summary))
    if args.out:
        # written when every candidate failed too: its error rows are the
        # diagnostics of an unattended sweep
        with open(args.out, "w") as f:
            json.dump({"results": results, **summary}, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
