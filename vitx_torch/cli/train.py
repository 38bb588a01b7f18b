"""Training CLI: ``python -m vitx_torch.cli.train --preset small16 ...``.

The counterpart of ``vitx/cli/train.py``, with its flags under the same
names and defaults plus ``--device`` (default ``cuda``; without a CUDA
device it exits unless ``--device cpu`` is given). It trains on
``synthetic``, ``procedural[:<ntrain>,<nval>]`` (``VITX_PROC_CACHE`` names
the procedural cache directory, default ``.procdata``), ``cifar10:DIR``,
``folder:DIR`` or ``shards:DIR`` data (vitx's splits and seeds,
``make_datasets``), through ``BatchLoader`` or, with ``--device-cache``,
``DeviceBatchLoader``, with vitx's device-side preprocessing (normalise
with 0.5 / 0.5, flips, and the augmentation flags) and ``Trainer``.
``--init-from`` starts a transfer fine-tune from any artifact the port
reads (``train.checkpoint.transfer_params``). The fine-tuning knobs are
vitx's: ``--lora-rank/--lora-alpha/--lora-targets`` (adapters and head
train, the base frozen), ``--freeze-backbone`` (the head alone),
``--llrd``, ``--accum-steps`` (the schedule's horizon in optimizer
updates), ``--mixup-alpha/--cutmix-alpha`` and
``--distill-from/--distill-alpha/--distill-tau/--distill-hard/
--distill-token`` (DeiT distillation from a self-describing checkpoint).
The model's geometry flags are vitx's too: ``--layerscale``, ``--mlp-act``,
``--pos-embed`` (learned, sincos2d, rope), ``--qk-norm``, ``--head-type``
(reference, standard, map), ``--global-pool``, ``--num-registers`` and
``--moe-experts/--moe-blocks/--moe-slots`` (Soft-MoE blocks last).
So are the training knobs: ``--optimizer`` (adamw, sgd, lion, adafactor),
``--mu-dtype``, ``--sam-rho``, ``--loss bce`` (multi-label, with ``--data
synthetic-ml``), ``--class-weights`` (a list or ``balanced``) and
``--steps-per-dispatch``. The parallelism flags set away from their
defaults exit non-zero, naming the ROADMAP item that brings them
(``UNPORTED``).

``CONVERGENCE.md``'s ViT-S/16 recipe (``examples/convergence.py``)::

    python -m vitx_torch.cli.train --preset small16 --data procedural \\
      --device-cache --batch-size 128 --lr 3e-4 --schedule cosine \\
      --warmup-steps 300 --weight-decay 0.05 --wd-exclude --randaug 5 \\
      --ema-decay 0.999 --early-stop 10 --seed 0 --checkpoint-dir ckpt

and its two variants: add ``--tome-r to128 --tome-train`` (merge tokens
in training too; the two flags go together) or ``--patch-drop 0.5``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import numpy as np

from vitx_torch.core.config import PRESETS, ViTConfig, get_config
from vitx_torch.data import (CIFAR10, BatchLoader, DeviceBatchLoader,
                             FolderDataset, ProceduralShapes, ShardDataset,
                             SyntheticDataset, SyntheticMultiLabelDataset,
                             make_preprocess)
from vitx_torch.nn.tome import aligned_schedule, parse_tome_r
from vitx_torch.train.loop import NonFiniteLossError, Trainer, TrainerConfig

# flags the port does not take yet -> the ROADMAP item that brings them;
# each is refused when set away from its default
UNPORTED = {
    "dp": "A13", "tp": "A13", "zero": "A13", "ep": "A13", "sp": "A13",
    "pp": "A13", "pp_microbatches": "A13", "pp_schedule": "A13",
}


def build_argparser():
    p = argparse.ArgumentParser(
        prog="vitx_torch.train",
        description="Train a ViT classifier on a CUDA device")
    a = p.add_argument
    a("--preset", default="tiny", choices=sorted(PRESETS))
    a("--config-json", default=None,
      help="path to a ViTConfig JSON (overrides --preset)")
    a("--class-weights", default=None,
      help="per-class loss weights: 'balanced' (n / (C * count_c) from the "
           "train split) or C comma-separated floats")
    a("--image-size", type=int, default=None,
      help="override the config's input resolution")
    a("--data", default="synthetic",
      help="'synthetic', 'procedural[:<ntrain>,<nval>]' (default "
           "12800,2560), 'cifar10:DIR' (local python batches), "
           "'folder:DIR' (one subfolder per class) or 'shards:DIR' (tar "
           "shards, e.g. from vitx_torch.cli.pack); a folder or shard "
           "directory with train/ and val/ (or test/) takes those splits")
    a("--epochs", type=int, default=10)
    a("--batch-size", type=int, default=64)
    a("--lr", type=float, default=1e-4)
    a("--loss", default="ce", choices=["ce", "bce"],
      help="'ce' single-label softmax cross-entropy; 'bce' multi-label "
           "sigmoid BCE over (B, C) multi-hot labels (eval reports micro "
           "and macro F1 and mAP; try --data synthetic-ml)")
    a("--optimizer", default="adamw",
      choices=["adamw", "sgd", "lion", "adafactor"],
      help="adamw; sgd (momentum 0.9, decoupled wd); lion (~10x lower lr, "
           "3-10x higher wd than adamw); adafactor (factored second "
           "moments)")
    a("--mu-dtype", default=None, choices=["float32", "bfloat16"],
      help="storage dtype of adamw's first moment")
    a("--weight-decay", type=float, default=1e-4)
    a("--wd-exclude", action="store_true",
      help="weight decay on the matrix weights only (timm's no-decay rule)")
    a("--checkpoint-dir", default=None)
    a("--keep-checkpoints", type=int, default=None, metavar="N",
      help="prune to the N newest {epoch}.ckpt (the best epoch is kept)")
    a("--log-dir", default=None)
    a("--async-checkpoint", action="store_true",
      help="write epoch checkpoints on a background thread")
    a("--eval-every", type=int, default=1)
    a("--log-every", type=int, default=50)
    a("--seed", type=int, default=0)
    a("--device-cache", action="store_true",
      help="keep both splits on the device as uint8; batches are gathers "
           "there, in the host loader's order")
    a("--cache-decoded", action="store_true",
      help="keep decoded examples in host RAM after their first read")
    a("--no-augment", action="store_true",
      help="no normalisation and no flips")
    a("--random-crop", action="store_true")
    a("--color-jitter", type=float, default=None)
    a("--randaug", type=float, default=None, metavar="M",
      help="RandAugment magnitude (timm rand-mM-n2), on the device")
    a("--randaug-layers", type=int, default=2)
    a("--random-erase", type=float, default=None, metavar="P")
    a("--init-from", default=None,
      help="initialise the params from an artifact for transfer "
           "fine-tuning (transfer_params): a checkpoint directory, an "
           "{epoch}.ckpt, a bare params .npz (--export-vit) or a "
           "reference .pt; leaves graft by path and shape, pos_embed is "
           "resized to the new grid, the rest keeps a fresh init")
    a("--lora-rank", type=int, default=0)
    a("--lora-alpha", type=float, default=0.0)
    a("--lora-targets", default="attn", choices=["attn", "all"])
    a("--freeze-backbone", action="store_true")
    a("--compute-dtype", default=None, choices=["float32", "bfloat16"])
    a("--label-smoothing", type=float, default=0.0)
    a("--mixup-alpha", type=float, default=None)
    a("--cutmix-alpha", type=float, default=None)
    a("--drop-path", type=float, default=0.0)
    a("--patch-drop", type=float, default=0.0,
      help="drop this share of the patch tokens in every train step "
           "(patch dropout); eval runs every token")
    a("--tome-r", type=parse_tome_r, default=0,
      help="token merging in training (with --tome-train): a constant r, a "
           "per-block schedule '35,34' or 'toN'; the eval CLI's --tome-r "
           "merges at inference")
    a("--tome-train", action="store_true",
      help="train through the merging encoder (needs --tome-r)")
    a("--layerscale", type=float, default=0.0)
    a("--mlp-act", default=None,
      choices=["gelu", "gelu_tanh", "relu", "swiglu"])
    a("--pos-embed", default=None, choices=["learned", "sincos2d", "rope"])
    a("--qk-norm", action="store_true")
    a("--head-type", default=None, choices=["reference", "standard", "map"])
    a("--global-pool", default=None, choices=["cls", "gap"])
    a("--sam-rho", type=float, default=None,
      help="sharpness-aware minimization radius (~0.05): the update from "
           "the gradient at params + rho g/|g|, a second forward and "
           "backward a step")
    a("--distill-from", default=None)
    a("--distill-alpha", type=float, default=0.5)
    a("--distill-tau", type=float, default=1.0)
    a("--distill-hard", action="store_true")
    a("--distill-token", action="store_true")
    a("--grad-clip", type=float, default=None)
    a("--accum-steps", type=int, default=1)
    a("--schedule", default="const", choices=["const", "cosine"],
      help="constant lr, or linear warmup then cosine decay over the run")
    a("--warmup-steps", type=int, default=0)
    a("--ema-decay", type=float, default=None,
      help="EMA of the params (kept in the optimizer state); eval uses it")
    a("--num-registers", type=int, default=0)
    a("--llrd", type=float, default=None)
    a("--early-stop", type=int, default=None, metavar="PATIENCE",
      help="stop after this many consecutive evals without a val-accuracy "
           "gain of more than --early-stop-delta")
    a("--early-stop-delta", type=float, default=0.0)
    a("--progress", action="store_true")
    a("--steps-per-dispatch", type=int, default=1,
      help="stack k batches, place them once and issue their k steps "
           "back to back")
    a("--dp", type=int, default=None)
    a("--tp", type=int, default=1)
    a("--zero", type=int, default=0, choices=[0, 1, 2, 3])
    a("--moe-experts", type=int, default=0)
    a("--moe-blocks", type=int, default=0)
    a("--moe-slots", type=int, default=0)
    a("--ep", type=int, default=1)
    a("--sp", action="store_true")
    a("--pp", type=int, default=1)
    a("--pp-microbatches", type=int, default=4)
    a("--pp-schedule", default="gpipe", choices=("gpipe", "1f1b"))
    a("--device", default="cuda",
      help="torch device to train on (default: cuda)")
    return p


def make_datasets(spec: str, cfg: ViTConfig, seed: int):
    """(train, val) datasets of ``--data``, with vitx's sizes, seeds and
    split rules (``vitx/cli/train.py:278-351``): ``synthetic``,
    ``synthetic-ml`` (multi-label),
    ``procedural[:<ntrain>,<nval>]``, ``cifar10:DIR`` (local batches),
    ``folder:DIR`` and ``shards:DIR``. A folder or shard directory with
    ``train/`` and ``val/`` (or ``test/``; for folders also
    ``Training/`` and ``Testing/``) takes those splits whole, and they must
    name the same classes; otherwise the reference's stratified split
    (``split_indices``) divides the one directory."""
    if spec in ("synthetic", "synthetic-ml"):
        ds_cls = (SyntheticDataset if spec == "synthetic"
                  else SyntheticMultiLabelDataset)
        common = dict(image_size=cfg.image_size, num_classes=cfg.num_classes,
                      num_channels=cfg.num_channels)
        return (ds_cls(num_examples=2048, seed=seed, **common),
                ds_cls(num_examples=512, seed=seed + 1, **common))
    kind, _, arg = spec.partition(":")
    if kind == "procedural":
        n_train, n_val = 12800, 2560
        if arg:
            parts = [int(x) for x in arg.split(",")]
            n_train = parts[0]
            n_val = parts[1] if len(parts) > 1 else max(parts[0] // 5, 1)
        cache = os.environ.get("VITX_PROC_CACHE", ".procdata")
        return (ProceduralShapes(num_examples=n_train, seed=seed,
                                 image_size=cfg.image_size, cache_dir=cache),
                ProceduralShapes(num_examples=n_val, seed=seed + 1,
                                 image_size=cfg.image_size, cache_dir=cache))
    if kind == "cifar10":
        return CIFAR10(arg, train=True), CIFAR10(arg, train=False)
    if kind in ("folder", "shards"):
        # predefined split directories (the Kaggle brain-tumour layout
        # ships Training/ + Testing/) beat the internal stratified split
        ds_cls, pairs = {
            "folder": (FolderDataset, (("train", "val"), ("train", "test"),
                                       ("Training", "Testing"))),
            "shards": (ShardDataset, (("train", "val"), ("train", "test"))),
        }[kind]
        root = pathlib.Path(arg)
        for tr_name, te_name in pairs:
            tr, te = root / tr_name, root / te_name
            if tr.is_dir() and te.is_dir():
                train_ds = ds_cls(tr, test_size=None,
                                  image_size=cfg.image_size)
                eval_ds = ds_cls(te, test_size=None,
                                 image_size=cfg.image_size)
                if train_ds.classes != eval_ds.classes:
                    raise ValueError(
                        f"{tr} and {te} disagree on classes: "
                        f"{train_ds.classes} vs {eval_ds.classes}")
                return train_ds, eval_ds
        return (ds_cls(root, train=True, image_size=cfg.image_size),
                ds_cls(root, train=False, image_size=cfg.image_size))
    raise SystemExit(f"error: unknown --data spec {spec!r}")


def refuse_unported(args, parser) -> None:
    """Exit naming the ROADMAP item of the first flag set away from its
    default that the port does not take."""
    for dest, item in UNPORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"error: {flag} is not ported to vitx_torch "
                             f"yet (ROADMAP {item})")


def build_trainer(args, parser=None):
    """-> (trainer, train_loader, eval_loader) for parsed ``args``."""
    parser = parser or build_argparser()
    refuse_unported(args, parser)
    if args.config_json:
        with open(args.config_json) as f:
            cfg = ViTConfig.from_json(f.read())
    else:
        cfg = get_config(args.preset)
    if args.compute_dtype:
        cfg = cfg.replace(compute_dtype=args.compute_dtype)
    if args.image_size:
        cfg = cfg.replace(image_size=args.image_size)
    train_ds, eval_ds = make_datasets(args.data, cfg, args.seed)
    # the folder, CIFAR and shard datasets name their classes only
    n_classes = getattr(train_ds, "num_classes", len(train_ds.classes))
    if n_classes != cfg.num_classes:
        cfg = cfg.replace(num_classes=n_classes)
    if args.drop_path:
        cfg = cfg.replace(drop_path=args.drop_path)
    if args.patch_drop:
        cfg = cfg.replace(patch_drop=args.patch_drop)
    if (args.tome_train or args.tome_r) and not (args.tome_train
                                                 and args.tome_r):
        raise SystemExit("error: --tome-r and --tome-train go together "
                         "for training-time token merging (eval-time "
                         "merging is the eval CLI's --tome-r)")
    # the model's geometry, in vitx's order (vitx/cli/train.py:418-440)
    if args.layerscale:
        cfg = cfg.replace(layerscale_init=args.layerscale)
    if args.mlp_act:
        cfg = cfg.replace(mlp_act=args.mlp_act)
    if args.pos_embed:
        cfg = cfg.replace(pos_embed=args.pos_embed)
    if args.qk_norm:
        cfg = cfg.replace(qk_norm=True)
    if args.head_type:
        cfg = cfg.replace(head_type=args.head_type)
    if args.global_pool:
        cfg = cfg.replace(global_pool=args.global_pool)
    if args.distill_token:
        cfg = cfg.replace(distill_token=True)
    if args.num_registers:
        cfg = cfg.replace(num_registers=args.num_registers)
    if args.moe_experts:
        cfg = cfg.replace(moe_experts=args.moe_experts,
                          moe_blocks=args.moe_blocks,
                          moe_slots=args.moe_slots)
    if args.lora_rank:
        cfg = cfg.replace(lora_rank=args.lora_rank,
                          lora_alpha=args.lora_alpha,
                          lora_targets=args.lora_targets)
    if args.tome_train:
        # a "toN" schedule resolves against the final geometry, after
        # every knob that changes the token count, registers among them
        # (vitx/cli/train.py:442)
        tr = args.tome_r
        if isinstance(tr, str):
            tr = aligned_schedule(cfg, int(tr[2:]))
        cfg = cfg.replace(tome_r=tr, tome_train=True)
    if args.freeze_backbone and args.lora_rank:
        raise SystemExit("error: --freeze-backbone conflicts with "
                         "--lora-rank (LoRA already freezes the backbone "
                         "and trains the adapters + head)")
    # the freeze policy: LoRA implies a frozen backbone
    train_filter = ("head" if args.freeze_backbone
                    else "lora" if args.lora_rank else None)
    if args.distill_from and args.steps_per_dispatch > 1:
        raise SystemExit("error: --distill-from is a single-device "
                         "single-step path (use the library step for mesh "
                         "runs)")
    if args.distill_from and (args.mixup_alpha or args.cutmix_alpha
                              or args.sam_rho):
        raise SystemExit("error: --distill-from builds its own train step; "
                         "--mixup-alpha/--cutmix-alpha/--sam-rho are not "
                         "applied there (combine via the library API "
                         "instead)")
    if args.distill_from and train_filter is not None:
        raise SystemExit("error: --distill-from builds its own train step, "
                         "which has no freeze policy -- --lora-rank/"
                         "--freeze-backbone are not applied there")
    if args.loss == "bce":
        if args.label_smoothing or args.class_weights:
            raise SystemExit("--loss bce does not compose with "
                             "--label-smoothing / --class-weights "
                             "(single-label softmax knobs)")
        if args.distill_from or args.distill_token:
            raise SystemExit("--loss bce does not compose with "
                             "distillation (the distill step computes "
                             "single-label CE on the class head)")
    class_weights = (parse_class_weights(args.class_weights, train_ds,
                                         cfg.num_classes)
                     if args.class_weights else None)
    # mixing pairs rows of one batch: no padded remainder batch
    mixing = bool(args.mixup_alpha or args.cutmix_alpha)

    if args.device_cache:
        train_loader = DeviceBatchLoader(train_ds, args.batch_size,
                                         shuffle=True, seed=args.seed,
                                         drop_last=mixing,
                                         device=args.device)
        eval_loader = DeviceBatchLoader(eval_ds, args.batch_size,
                                        device=args.device)
        print(f"device-cache: {train_loader.nbytes / 1e9:.2f} GB train + "
              f"{eval_loader.nbytes / 1e9:.2f} GB val resident on "
              f"{train_loader.device}")
    else:
        train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                                   seed=args.seed, drop_last=mixing,
                                   cache_decoded=args.cache_decoded)
        eval_loader = BatchLoader(eval_ds, args.batch_size,
                                  cache_decoded=args.cache_decoded)
    aug = not args.no_augment
    pre = make_preprocess(
        out_size=cfg.image_size,
        mean=(0.5, 0.5, 0.5) if aug else None,
        std=(0.5, 0.5, 0.5) if aug else None,
        random_flip=aug, random_crop=args.random_crop and aug,
        color_jitter=args.color_jitter if aug else None,
        randaug_layers=(args.randaug_layers
                        if args.randaug is not None and aug else 0),
        randaug_magnitude=args.randaug if args.randaug is not None else 9.0,
        random_erase=args.random_erase if aug else None)

    from vitx_torch.train.step import (TrainState, make_optimizer,
                                       warmup_cosine)

    lr_schedule = None
    if args.schedule == "cosine":
        # the horizon in optimizer updates: accumulation ticks the schedule
        # once per accum_steps micro-batches (vitx/cli/train.py:466-480)
        lr_schedule = warmup_cosine(
            args.lr, max(1, args.epochs * len(train_loader)
                         // args.accum_steps),
            args.warmup_steps // args.accum_steps)
    optimizer = make_optimizer(
        lr=args.lr, schedule=lr_schedule, weight_decay=args.weight_decay,
        grad_clip=args.grad_clip, ema_decay=args.ema_decay,
        wd_exclude=args.wd_exclude, accum_steps=args.accum_steps,
        llrd=args.llrd, llrd_depth=cfg.depth, optimizer=args.optimizer,
        trainable=train_filter, mu_dtype=args.mu_dtype)
    init_state = None
    if args.init_from:
        from vitx_torch.train.checkpoint import (is_bare_params_npz,
                                                 transfer_params)

        if is_bare_params_npz(args.init_from):
            # a bare --export-vit npz comes from an encoder that normalises
            # its output; checkpoints and .pt keep the user's config
            # (vitx/cli/train.py:493-498)
            cfg = cfg.replace(final_norm=True)
        params = transfer_params(args.init_from, cfg, args.seed,
                                 device=args.device)
        init_state = TrainState(0, params, optimizer.init(params))
    train_step = None
    if args.distill_from:
        train_step = distill_step(args, cfg, optimizer)
    tcfg = TrainerConfig(
        loss=args.loss, class_weights=class_weights,
        epochs=args.epochs, lr=args.lr, weight_decay=args.weight_decay,
        wd_exclude=args.wd_exclude, grad_clip=args.grad_clip,
        label_smoothing=args.label_smoothing, progress=args.progress,
        checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir,
        keep_checkpoints=args.keep_checkpoints, eval_every=args.eval_every,
        log_every=args.log_every, ema_decay=args.ema_decay, seed=args.seed,
        early_stop_patience=args.early_stop,
        early_stop_min_delta=args.early_stop_delta,
        async_checkpoint=args.async_checkpoint,
        mixup_alpha=args.mixup_alpha, cutmix_alpha=args.cutmix_alpha,
        llrd=args.llrd, accum_steps=args.accum_steps,
        train_filter=train_filter, sam_rho=args.sam_rho,
        optimizer=args.optimizer, mu_dtype=args.mu_dtype,
        steps_per_dispatch=args.steps_per_dispatch)
    trainer = Trainer(cfg, tcfg, preprocess=pre, init_state=init_state,
                      optimizer=optimizer, lr_schedule=lr_schedule,
                      train_step=train_step, device=args.device)
    return trainer, train_loader, eval_loader


def parse_class_weights(spec: str, train_ds, num_classes: int) -> tuple:
    """``--class-weights`` (``vitx/cli/train.py:585-606``): "balanced",
    scikit-learn's n / (C * count_c) from the train split's labels (a
    class with no example counts 1), or C comma-separated floats."""
    if spec == "balanced":
        labels = getattr(train_ds, "labels", None)
        if labels is None:
            raise SystemExit("error: --class-weights balanced needs a "
                             "dataset exposing .labels")
        counts = np.bincount(np.asarray(labels), minlength=num_classes)
        w = len(labels) / (num_classes
                           * np.maximum(counts, 1)).astype(np.float64)
    else:
        w = np.array([float(x) for x in spec.split(",")])
        if len(w) != num_classes:
            raise SystemExit(f"error: --class-weights needs {num_classes} "
                             f"comma-separated values, got {len(w)}")
    return tuple(float(x) for x in w)


def distill_step(args, cfg: ViTConfig, optimizer):
    """The distillation step of ``--distill-from`` as ``(state, batch,
    rng) -> (state, metrics)``: the teacher's geometry from its
    checkpoint's meta, its eval params (the EMA shadow where it kept one)
    on the device; a teacher of another class count is refused
    (``vitx/cli/train.py:517-581``)."""
    from vitx_torch.train.checkpoint import peek_meta, restore_eval_params
    from vitx_torch.train.distill import make_distill_train_step

    tmeta = peek_meta(args.distill_from)
    if tmeta is None:
        raise SystemExit(f"error: no checkpoint under {args.distill_from}")
    teacher_cfg = (ViTConfig.from_json(json.dumps(tmeta["config"]))
                   if "config" in tmeta else cfg)
    if teacher_cfg.num_classes != cfg.num_classes:
        raise SystemExit(f"error: teacher has {teacher_cfg.num_classes} "
                         f"classes, student {cfg.num_classes}")
    teacher_params, _ = restore_eval_params(args.distill_from, teacher_cfg,
                                            device=args.device)
    step = make_distill_train_step(
        cfg, teacher_cfg, optimizer, alpha=args.distill_alpha,
        tau=args.distill_tau, hard=args.distill_hard,
        label_smoothing=args.label_smoothing, device=args.device)
    return lambda state, batch, rng=None: step(state, batch, teacher_params,
                                               rng)


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    trainer, train_loader, eval_loader = build_trainer(args, parser)
    try:
        history = trainer.fit(train_loader, eval_loader)
    except NonFiniteLossError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if history:
        print(json.dumps({k: v for k, v in history[-1].items()
                          if isinstance(v, (int, float, str))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
