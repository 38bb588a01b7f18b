"""Evaluation CLI: ``python -m vitx_torch.cli.eval --checkpoint DIR ...``.

The counterpart of ``vitx/cli/eval.py``: restores a ``.ckpt`` file or the
newest one in a directory (the EMA shadow when the run kept one; the
model config from the checkpoint's meta), a bare params ``.npz`` or a
reference ``.pt`` (imported at the preset's or ``--config-json``'s
geometry), evaluates it on the val split of any ``--data`` spec the train
CLI takes (``make_datasets``: also ``cifar10:``, ``folder:`` and
``shards:`` directories), and prints vitx's JSON report -- accuracy, weighted precision and recall,
macro F1, per-class accuracy and F1, the example count and, for up to 10
classes, the confusion matrix -- from one confusion matrix. ``--predict``
writes per-example predictions, ``--tta`` averages the logits over the
horizontal flip, ``--calibrate`` adds ECE and temperature scaling, and
``--tome-r`` merges tokens at inference and ``--patch-size P`` runs the
model at another patch size (FlexiViT's PI-resize of the patchify kernel,
the input scaled with it, ``resize_patch_embed``). ``--export-quantized OUT``
writes the loaded parameters as an int8 ``.quant.npz`` (vitx reads it
too) and ``--export-pt2 OUT`` as a ``torch.export`` program, the
counterpart of vitx's ``--export-stablehlo`` (the batch pinned to
``--batch-size`` under ToMe); both store the config without the
inference-only ``--tome-r``. Any artifact the loading rule takes is
evaluated, ``.quant.npz`` included. ``--device`` defaults to ``cuda``.
``--soup`` (ROADMAP A12) is refused, and
``--export-stablehlo``, whose StableHLO only JAX runs, names
``--export-pt2``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vitx_torch.core.config import PRESETS
from vitx_torch.core.device import resolve_device
from vitx_torch.data import BatchLoader, make_preprocess
from vitx_torch.metrics import confusion_matrix, confusion_to_metrics
from vitx_torch.nn.tome import aligned_schedule, parse_tome_r
from vitx_torch.nn.vit import model_logits

UNPORTED = {"soup": "A12"}


def main(argv=None):
    p = argparse.ArgumentParser(prog="vitx_torch.eval")
    p.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    p.add_argument("--config-json", default=None)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint directory (newest epoch), "
                        "{epoch}.ckpt, an int8 .quant.npz, a bare params "
                        ".npz or a reference .pt")
    p.add_argument("--data", default="synthetic",
                   help="any spec the train CLI takes: 'synthetic', "
                        "'procedural[:<ntrain>,<nval>]', 'cifar10:DIR', "
                        "'folder:DIR' or 'shards:DIR' (the val split)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--predict", default=None, metavar="OUT.jsonl",
                   help="also write per-example predictions (id, label, "
                        "pred, prob) as JSON lines")
    p.add_argument("--tta", action="store_true",
                   help="average the logits over the horizontal flip")
    p.add_argument("--calibrate", action="store_true",
                   help="fit temperature scaling on this set and report "
                        "ECE/NLL before and after")
    p.add_argument("--soup", nargs="+", default=None)
    p.add_argument("--export-quantized", default=None, metavar="OUT",
                   help="also write the params as an int8 .quant.npz")
    p.add_argument("--export-pt2", default=None, metavar="OUT.pt2",
                   help="also write a torch.export program with the params "
                        "baked in (symbolic batch; pinned under ToMe)")
    p.add_argument("--export-stablehlo", default=None,
                   help="vitx's StableHLO export: JAX only; see "
                        "--export-pt2")
    p.add_argument("--patch-size", type=int, default=None, metavar="P",
                   help="FlexiViT PI-resize: run the checkpoint at patch "
                        "size P, the input scaled with it (the token grid "
                        "unchanged)")
    p.add_argument("--tome-r", type=parse_tome_r, default=0,
                   help="ToMe token merging at inference")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for dest, item in UNPORTED.items():
        if getattr(args, dest) is not None:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"error: {flag} is not ported to vitx_torch "
                             f"yet (ROADMAP {item})")
    if args.export_stablehlo is not None:
        raise SystemExit("error: --export-stablehlo writes a StableHLO "
                         "program, which only JAX runs; vitx_torch's "
                         "deployment program is --export-pt2 OUT.pt2")
    dev = resolve_device(args.device)

    from vitx_torch.cli.train import make_datasets
    from vitx_torch.nn.lora import merge_lora_params
    from vitx_torch.train.checkpoint import (load_artifact_params,
                                             resolve_artifact_config)

    cfg = resolve_artifact_config(args.checkpoint, args.config_json,
                                  args.preset)
    _, eval_ds = make_datasets(args.data, cfg, seed=0)
    classes = getattr(eval_ds, "classes", None)
    n_classes = getattr(eval_ds, "num_classes",
                        len(classes) if classes else cfg.num_classes)
    if n_classes != cfg.num_classes:
        cfg = cfg.replace(num_classes=n_classes)
    if args.tome_r:
        tr = args.tome_r
        if isinstance(tr, str):
            tr = aligned_schedule(cfg, target_tokens=int(tr[2:]))
        cfg = cfg.replace(tome_r=tr)
    try:
        params, meta = load_artifact_params(args.checkpoint, cfg, device=dev)
    except FileNotFoundError:
        print(f"error: no checkpoint under {args.checkpoint}",
              file=sys.stderr)
        return 1
    # a LoRA run is evaluated (and exported) with its adapters folded in
    params, cfg = merge_lora_params(params, cfg)
    if args.patch_size and args.patch_size != cfg.patch_size:
        from vitx_torch.nn.flexivit import resize_patch_embed

        params, cfg = resize_patch_embed(params, cfg,
                                         patch_size=args.patch_size)
        # the input resolution scaled with the patch: the val split again
        # at the new size
        _, eval_ds = make_datasets(args.data, cfg, seed=0)
        print(f"PI-resized patchify to patch {cfg.patch_size} "
              f"(input {cfg.image_size}px)", file=sys.stderr)
    if args.export_quantized:
        from vitx_torch.quant import save_quantized

        # the config without inference-only overrides: this eval's
        # --tome-r must not switch on in every later use of the artifact
        save_quantized(args.export_quantized, params,
                       meta={"config": json.loads(
                                 cfg.replace(tome_r=0).to_json()),
                             "epoch": meta.get("epoch")})
        print(f"wrote int8 artifact {args.export_quantized}",
              file=sys.stderr)
    if args.export_pt2:
        from vitx_torch.export import save_exported

        # ToMe's merges are traced at static token counts: pin the batch
        nbytes = save_exported(
            args.export_pt2, params, cfg,
            batch_size=args.batch_size if cfg.tome_r else None)
        print(f"wrote torch.export program {args.export_pt2} "
              f"({nbytes / 1e6:.1f} MB)", file=sys.stderr)
    pre = make_preprocess(
        out_size=cfg.image_size,
        mean=None if args.no_normalize else (0.5, 0.5, 0.5),
        std=None if args.no_normalize else (0.5, 0.5, 0.5),
        random_flip=False)

    @torch.no_grad()
    def logits_of(x):
        out = model_logits(params, x, cfg).float()
        if args.tta:
            out = 0.5 * (out + model_logits(params, x.flip(2), cfg).float())
        return out

    pred_file = open(args.predict, "w") if args.predict else None
    cm = None
    seen = top5_hits = top5_n = 0
    cal_logits, cal_labels = [], []
    try:
        for batch in BatchLoader(eval_ds, args.batch_size):
            img = pre(torch.from_numpy(batch["image"]).to(dev), None,
                      train=False)
            lg = logits_of(img)
            mask = torch.from_numpy(batch["mask"]).to(dev).long()
            labels = torch.from_numpy(batch["label"]).to(dev).long()
            cm_b = confusion_matrix(lg.argmax(-1) * mask, labels * mask,
                                    cfg.num_classes)
            cm_b[0, 0] -= int((1 - mask).sum())
            cm = cm_b if cm is None else cm + cm_b
            if not (args.predict or args.calibrate or args.tta):
                continue
            keep = batch["mask"].astype(bool)
            lg_np = lg.cpu().numpy()
            if args.calibrate:
                cal_logits.append(lg_np[keep])
                cal_labels.append(batch["label"][keep])
            if cfg.num_classes > 5:
                top5 = np.argsort(lg_np[keep], axis=-1)[:, -5:]
                top5_hits += int((top5 == batch["label"][keep, None]).sum())
                top5_n += int(keep.sum())
            if pred_file is not None:
                e = np.exp(lg_np - lg_np.max(axis=-1, keepdims=True))
                probs = e / e.sum(axis=-1, keepdims=True)
                for j in np.flatnonzero(keep):
                    pred = int(np.argmax(probs[j]))
                    lab = int(batch["label"][j])
                    row = {"id": seen,
                           "label": classes[lab] if classes else lab,
                           "pred": classes[pred] if classes else pred,
                           "prob": round(float(probs[j, pred]), 6)}
                    pred_file.write(json.dumps(row) + "\n")
                    seen += 1
    finally:
        if pred_file is not None:
            pred_file.close()

    metrics = confusion_to_metrics(cm)
    cm_np = cm.cpu().numpy()
    name = (lambda i: classes[i]) if classes else str
    out = {
        "epoch": meta.get("epoch", -1),
        "accuracy": float(metrics["accuracy"]),
        "precision_weighted": float(metrics["precision_weighted"]),
        "recall_weighted": float(metrics["recall_weighted"]),
        "f1_macro": float(metrics["f1_macro"]),
        "per_class_accuracy": {
            name(i): round(float(v), 4)
            for i, v in enumerate(metrics["per_class_accuracy"].tolist())},
        "per_class_f1": {
            name(i): round(float(v), 4)
            for i, v in enumerate(metrics["per_class_f1"].tolist())},
        "num_examples": int(cm_np.sum()),
    }
    if cfg.num_classes <= 10:
        out["confusion_matrix"] = cm_np.astype(int).tolist()
    if top5_n:
        out["top5_accuracy"] = round(top5_hits / top5_n, 6)
    if args.calibrate:
        from vitx_torch.metrics.calibration import calibration_report

        out["calibration"] = calibration_report(
            np.concatenate(cal_logits), np.concatenate(cal_labels))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
