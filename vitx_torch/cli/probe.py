"""Representation probing CLI: ``python -m vitx_torch.cli.probe --checkpoint DIR``.

The counterpart of ``vitx/cli/probe.py``: evaluates a backbone's features
rather than its head, by the self-supervised evaluation protocols.

- Linear probe: closed-form ridge regression from frozen features to
  one-hot targets, fit on the train split in float64, reported on both
  splits.
- k-NN: cosine-similarity vote over the train-split features, weighted
  by exp(sim / T) with T = 0.07 (the DINO protocol).
- ``--features OUT.npz``: the raw (features, labels) of both splits.

Features come from ``vitx_torch.forward_features`` (CLS token or the
patch mean), on the card unless ``--device cpu``. Any artifact the eval
CLI evaluates works here, by the same rules
(``train/checkpoint.py::{resolve_artifact_config,load_artifact_params}``):
``.ckpt`` files and directories (the EMA shadow where there is one), int8
``.quant.npz`` artifacts, bare params ``.npz`` and reference ``.pt``. A
``.pt2`` program is refused (it holds only the logits program, as vitx
refuses ``.stablehlo``). ``--dp N`` extracts the features over a data
mesh of N rank processes: each loads and runs its rows of every batch,
the features are gathered, and rank 0 fits the probes and prints.

    python -m vitx_torch.cli.probe --checkpoint ckpt/run --data folder:data \\
        --pool cls --knn 20 --features /tmp/feats.npz
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vitx_torch.core.config import PRESETS, ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.data import BatchLoader, make_preprocess
from vitx_torch.nn.vit import forward_features
from vitx_torch.parallel import comm
from vitx_torch.parallel.mesh import DATA_AXIS


def extract_features(params, dataset, cfg: ViTConfig, *, pool: str = "cls",
                     batch_size: int = 64, normalize: bool = True,
                     pre=None, device="cuda", mesh=None):
    """Dataset -> (features (N, E) fp32, labels (N,)); the padded rows of
    a ragged last batch never reach the output. ``pre``: a
    ``make_preprocess`` callable to reuse across calls (built per call
    otherwise). ``mesh``: a rank of a data mesh (``vitx_torch.parallel.
    make_mesh``): it loads and runs its rows of each batch (batch_size
    must divide over the data axis), and every rank gets the whole
    batch's features."""
    rows = None
    if mesh is not None:
        if batch_size % mesh.dp:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"the mesh's data axis ({mesh.dp})")
        rows = (mesh.index(DATA_AXIS), mesh.dp)
        device = mesh.device
    dev = resolve_device(device)
    if pre is None:
        pre = make_preprocess(
            out_size=cfg.image_size,
            mean=(0.5, 0.5, 0.5) if normalize else None,
            std=(0.5, 0.5, 0.5) if normalize else None,
            random_flip=False)
    feats, labels = [], []
    for batch in BatchLoader(dataset, batch_size, rows=rows):
        x = pre(torch.from_numpy(batch["image"]).to(dev), None, train=False)
        f = forward_features(params, x, cfg, pool=pool, device=dev)
        keep = torch.from_numpy(np.asarray(batch["mask"])).to(dev)
        label = torch.from_numpy(np.asarray(batch["label"])).to(dev)
        if mesh is not None:
            f, keep, label = (comm.all_gather_cat(t, mesh, DATA_AXIS, 0)
                              for t in (f, keep, label))
        keep = keep.cpu().numpy().astype(bool)
        feats.append(f.cpu().numpy()[keep])
        labels.append(label.cpu().numpy()[keep])
    return np.concatenate(feats), np.concatenate(labels)


def fit_linear_probe(train_x, train_y, num_classes: int, lam: float = 1e-2):
    """Closed-form ridge probe (``vitx/cli/probe.py:99-119``): standardised
    features and a bias column onto one-hot targets, one (E+1)x(E+1)
    float64 solve. Returns a ``predict(features) -> labels`` closure."""
    mu = train_x.mean(axis=0)
    sd = train_x.std(axis=0) + 1e-6
    xs = (train_x - mu) / sd
    xs = np.concatenate([xs, np.ones((xs.shape[0], 1), xs.dtype)], axis=1)
    onehot = np.eye(num_classes, dtype=np.float64)[train_y]
    a = xs.T.astype(np.float64) @ xs.astype(np.float64)
    a += lam * len(xs) * np.eye(xs.shape[1])
    w = np.linalg.solve(a, xs.T.astype(np.float64) @ onehot)

    def predict(x):
        z = (x - mu) / sd
        z = np.concatenate([z, np.ones((z.shape[0], 1), z.dtype)], axis=1)
        return np.argmax(z @ w, axis=-1)

    return predict


def knn_predict(train_x, train_y, test_x, num_classes: int, *, k: int = 20,
                temperature: float = 0.07, chunk: int = 256):
    """Cosine k-NN with exp(sim / T)-weighted votes
    (``vitx/cli/probe.py:122-140``)."""
    def _norm(x):
        return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)

    tr, te = _norm(train_x), _norm(test_x)
    k = min(k, len(train_x))
    preds = []
    for i in range(0, len(te), chunk):
        sims = te[i:i + chunk] @ tr.T                        # (c, Ntrain)
        idx = np.argpartition(-sims, k - 1, axis=1)[:, :k]
        rows = np.arange(len(idx))[:, None]
        w = np.exp(sims[rows, idx] / temperature)            # (c, k)
        votes = np.zeros((len(idx), num_classes))
        np.add.at(votes, (rows, train_y[idx]), w)
        preds.append(np.argmax(votes, axis=1))
    return np.concatenate(preds)


def main(argv=None):
    p = argparse.ArgumentParser(prog="vitx_torch.probe")
    p.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    p.add_argument("--config-json", default=None)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir / {epoch}.ckpt / .quant.npz / bare "
                        "params .npz / reference .pt")
    p.add_argument("--data", default="synthetic",
                   help="any spec the train CLI takes: 'synthetic', "
                        "'procedural[:<ntrain>,<nval>]', 'cifar10:DIR', "
                        "'folder:DIR' or 'shards:DIR'")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--pool", default="cls", choices=["cls", "gap"],
                   help="cls: token 0 (what the head reads); gap: mean over "
                        "patch tokens (MAE fine-tune pooling)")
    p.add_argument("--ridge-lambda", type=float, default=1e-2,
                   help="linear-probe ridge regularizer (per-example scale)")
    p.add_argument("--knn", type=int, default=0, metavar="K",
                   help="also report cosine k-NN accuracy with K neighbors")
    p.add_argument("--features", default=None, metavar="OUT.npz",
                   help="also export raw features+labels for both splits")
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--dp", type=int, default=None,
                   help="extract features over a data-parallel mesh of "
                        "this many ranks (batch-size must divide)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.dp:
        from vitx_torch.parallel import spawn

        return spawn(probe_rank, args.dp, (args,), device=args.device)[0]
    return probe(args)


def probe_rank(ctx, args) -> int:
    """One rank of ``--dp``: its rows' features; rank 0 probes."""
    from vitx_torch.parallel import make_mesh

    return probe(args, make_mesh(args.dp, device=ctx.device))


def probe(args, mesh=None) -> int:
    """Extract both splits' features (over ``mesh``'s data ranks) and, on
    rank 0, fit and report the probes."""
    dev = resolve_device(args.device if mesh is None else mesh.device)

    from vitx_torch.cli.train import make_datasets
    from vitx_torch.train.checkpoint import (load_artifact_params,
                                             resolve_artifact_config)

    cfg = resolve_artifact_config(args.checkpoint, args.config_json,
                                  args.preset)
    train_ds, eval_ds = make_datasets(args.data, cfg, seed=0)
    classes = getattr(train_ds, "classes", None)
    n_classes = getattr(train_ds, "num_classes",
                        len(classes) if classes else cfg.num_classes)
    if n_classes != cfg.num_classes:
        cfg = cfg.replace(num_classes=n_classes)

    params, _ = load_artifact_params(args.checkpoint, cfg, device=dev)

    pre = make_preprocess(
        out_size=cfg.image_size,
        mean=None if args.no_normalize else (0.5, 0.5, 0.5),
        std=None if args.no_normalize else (0.5, 0.5, 0.5),
        random_flip=False)
    kw = dict(pool=args.pool, batch_size=args.batch_size, pre=pre,
              device=dev, mesh=mesh)
    train_x, train_y = extract_features(params, train_ds, cfg, **kw)
    val_x, val_y = extract_features(params, eval_ds, cfg, **kw)
    if mesh is not None and mesh.rank:
        return 0

    if args.features:
        np.savez(args.features,
                 train_features=train_x, train_labels=train_y,
                 val_features=val_x, val_labels=val_y,
                 pool=np.asarray(args.pool),
                 config=np.asarray(cfg.to_json()))
        print(f"wrote features to {args.features}", file=sys.stderr)

    predict = fit_linear_probe(train_x, train_y, cfg.num_classes,
                               lam=args.ridge_lambda)
    out = {
        "pool": args.pool,
        "dim": int(train_x.shape[1]),
        "num_train": int(len(train_y)),
        "num_val": int(len(val_y)),
        "linear_probe_train_acc": round(
            float((predict(train_x) == train_y).mean()), 6),
        "linear_probe_val_acc": round(
            float((predict(val_x) == val_y).mean()), 6),
    }
    if args.knn:
        knn = knn_predict(train_x, train_y, val_x, cfg.num_classes,
                          k=args.knn)
        out["knn_val_acc"] = round(float((knn == val_y).mean()), 6)
        out["knn_k"] = int(min(args.knn, len(train_y)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
