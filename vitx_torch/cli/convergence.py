"""Convergence runs of the ViT-S/16 recipe on the card:
``python -m vitx_torch.cli.convergence --variants tome,full,pdrop``.

The counterpart of ``examples/convergence.py`` (which writes
``CONVERGENCE.md``'s table with vitx's train CLI): the same recipe and
the same three variants, each one subprocess of ``vitx_torch.cli.train``
on the full procedural split (12800 + 2560 images at 224²), seed 0. Each
run's stdout goes to ``<out>/run_<variant>.log`` and its scalars to
``<out>/tb_<variant>``; ``<out>/summary.json`` holds per variant the best
val accuracy and its epoch, the val accuracy at epochs 0, 10, 20, 30, 40
and the last, the median img/s over epochs after the first, the epochs
run and the wall time, beside the card's name and power limit as
``nvidia-smi`` gives them. Checkpoints go to ``--ckpt-root`` and only the
newest and the best are kept. No pixel probe: it needs no card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

RECIPE = [
    "--preset", "small16", "--data", "procedural", "--device-cache",
    "--batch-size", "128", "--lr", "3e-4", "--schedule", "cosine",
    "--warmup-steps", "300", "--weight-decay", "0.05", "--wd-exclude",
    "--randaug", "5", "--ema-decay", "0.999", "--early-stop", "10",
    "--seed", "0", "--log-every", "100",
]

VARIANTS = {
    "full": [],
    "tome": ["--tome-r", "to128", "--tome-train"],
    "pdrop": ["--patch-drop", "0.5"],
}

CURVE_EPOCHS = (0, 10, 20, 30, 40)


def card() -> str:
    """The card's name and power limit, or "not measured" without
    nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def parse_log(path: pathlib.Path) -> list:
    """The per-epoch stats lines the train CLI prints, as dicts."""
    hist = []
    pat = re.compile(r"epoch (\d+): (.*)")
    for line in path.read_text().splitlines():
        m = pat.match(line.strip())
        if not m:
            continue
        row = {"epoch": int(m.group(1))}
        for kv in m.group(2).split(", "):
            k, _, v = kv.partition("=")
            try:
                row[k] = float(v)
            except ValueError:
                pass
        hist.append(row)
    return hist


def summarize(hist: list, wall: float) -> dict:
    accs = {r["epoch"]: r["val_accuracy"] for r in hist
            if "val_accuracy" in r}
    best = max(accs, key=lambda e: (accs[e], -e)) if accs else None
    rates = sorted(r["images_per_sec"] for r in hist[1:]
                   if "images_per_sec" in r)
    last = hist[-1]["epoch"] if hist else None
    curve = {e: accs[e] for e in (*CURVE_EPOCHS, last) if e in accs}
    return {"best_val_acc": accs[best] if accs else None,
            "best_epoch": best, "val_acc_at_epoch": curve,
            "steady_images_per_sec": (rates[len(rates) // 2] if rates
                                      else None),
            "epochs_run": len(hist), "wall_s": wall, "history": hist}


def run_variant(name: str, epochs: int, out: pathlib.Path,
                ckpt_root: pathlib.Path) -> dict:
    log = out / f"run_{name}.log"
    cmd = [sys.executable, "-m", "vitx_torch.cli.train", *RECIPE,
           *VARIANTS[name], "--epochs", str(epochs), "--checkpoint-dir",
           str(ckpt_root / name), "--keep-checkpoints", "1", "--log-dir",
           str(out / f"tb_{name}")]
    print(f"[{name}] {' '.join(cmd)}", flush=True)
    t0 = time.time()
    with open(log, "w") as fh:
        fh.write("# " + " ".join(cmd) + "\n")
        fh.flush()
        rc = subprocess.call(cmd, stdout=fh, stderr=subprocess.STDOUT)
    wall = time.time() - t0
    if rc != 0:
        raise SystemExit(f"variant {name} failed (exit {rc}): see {log}")
    return summarize(parse_log(log), wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vitx_torch.convergence")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ",".join(VARIANTS))
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--out", default="build/convergence")
    ap.add_argument("--ckpt-root", default="build/convergence_ckpt")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    summary = {"epochs": args.epochs, "card": card()}
    for name in names:
        summary[name] = run_variant(name, args.epochs, out,
                                    pathlib.Path(args.ckpt_root))
        s = summary[name]
        print(f"[{name}] best val acc {s['best_val_acc']} (epoch "
              f"{s['best_epoch']}), median {s['steady_images_per_sec']} "
              f"img/s, {s['epochs_run']} epochs, wall {s['wall_s']:.1f} s",
              flush=True)
        (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "history"}
                      if isinstance(v, dict) else v
                      for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
