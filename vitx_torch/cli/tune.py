"""Throughput autotuner: ``python -m vitx_torch.cli.tune --preset base16 --mode train``.

The counterpart of ``vitx/cli/tune.py``: measures images/s of every
(per-device batch, remat policy) candidate on the current card and
reports one JSON line per candidate (vitx's keys: ``batch``, ``remat``,
``scan_unroll``, ``step_ms``, ``images_per_sec``), then a ``{"best":
...}`` line. ``--remat`` sweeps the policies (activation checkpointing
per block, ``vitx_torch/nn/vit.py``; default ``none,block`` for train,
the config's for infer, where nothing is checkpointed). The port runs its
blocks as a Python loop, so there is no scan to unroll: each row carries
the config's ``scan_unroll`` and ``--unroll`` exits saying so.

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
import itertools
import json
import sys

import torch

from vitx_torch.cli.bench import device_name, forward_timing, train_timing
from vitx_torch.core.device import resolve_device


def check_candidate(cfg, batch: int) -> None:
    """Raise for a candidate the port refuses before it runs: a batch
    below 1 (ValueError), or an expert- (``ep``) or sequence-parallel
    (``sp``) config (RuntimeError, vitx's reason: such a config constrains
    its tensors to a mesh, and the sweep times one device with no mesh;
    vitx's sweep fails there in ``with_sharding_constraint``)."""
    if batch < 1:
        raise ValueError(f"batch {batch} must be positive")
    if cfg.ep or cfg.sp:
        raise RuntimeError(
            "expert- and sequence-parallel configs (ep, sp) shard their "
            "tensors over a mesh, and the sweep times one device with no "
            "mesh (vitx: with_sharding_constraint requires a non-empty "
            "mesh)")


def run_sweep(cfg, mode, batches, iters, reps, emit=print, device="cuda",
              remats=None):
    """Measure every (batch, remat) candidate of ``batches`` and
    ``remats`` (default: the config's policy); returns the result rows
    (dicts). A candidate ``check_candidate`` refuses, an unknown policy,
    or one that runs out of device memory, makes a row with an "error"
    field; an error raised while timing propagates."""
    dev = resolve_device(device)
    timing = train_timing if mode == "train" else forward_timing
    results = []
    for batch, remat in itertools.product(batches, remats or [cfg.remat]):
        cand = {"batch": batch, "remat": remat,
                "scan_unroll": cfg.scan_unroll}
        try:
            c = cfg.replace(remat=remat)
            check_candidate(c, batch)
        except (ValueError, RuntimeError) as e:
            row = {**cand, "error": f"{type(e).__name__}: {e}"[:200]}
        else:
            try:
                ms = min(timing(c, batch, iters, reps, dev))
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
                   help="comma-separated remat policies to sweep (default: "
                        "train sweeps none,block; infer uses the config's)")
    p.add_argument("--unroll", default=None,
                   help="scan_unroll values: the port has no scan to "
                        "unroll, so this exits")
    p.add_argument("--iters", type=int, default=20,
                   help="back-to-back calls a timing")
    p.add_argument("--reps", type=int, default=3,
                   help="timings per candidate (the min is reported)")
    p.add_argument("--out", default=None,
                   help="also write the rows + best to this JSON file")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.unroll is not None:
        raise SystemExit("error: --unroll sweeps vitx's scan_unroll; "
                         "vitx_torch runs its blocks as a Python loop and "
                         "has no scan to unroll")

    from vitx_torch.core.config import ViTConfig, get_config

    dev = resolve_device(args.device)
    if args.config_json:
        with open(args.config_json) as f:
            cfg = ViTConfig.from_json(f.read())
    else:
        cfg = get_config(args.preset)
    batches = [int(b) for b in args.batches.split(",")]
    if args.remat:
        remats = args.remat.split(",")
    else:
        remats = ["none", "block"] if args.mode == "train" else [cfg.remat]
    results = run_sweep(cfg, args.mode, batches, args.iters, args.reps,
                        device=dev, remats=remats)
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
