"""Self-supervised pretraining CLI: ``python -m vitx_torch.cli.pretrain``.

The counterpart of ``vitx/cli/pretrain.py``, with its flags under the
same names and defaults plus ``--device`` (default ``cuda``):

- ``--method mae`` (default): masked autoencoding (``nn/mae.py``);
- ``--method dino``: self-distillation with an EMA teacher over 2 global
  and ``--n-local`` local crops (``nn/dino.py``); the grad clip defaults
  to 3.0 and the local size to half the image, rounded down to a patch;
- ``--method simclr``: NT-Xent over two views (``nn/simclr.py``).

Labels are ignored; any ``--data`` the train CLI takes works here, read
by a ``drop_last`` loader (no family has a per-row mask) through
``device_prefetch``, as vitx reads it. MAE's host
pipeline normalises and flips; DINO and SimCLR get raw [0, 1] images and
build their views on the device. Each epoch prints one line and writes
``{epoch}.ckpt`` (vitx's leaves, meta ``kind``); a rerun on the same
``--checkpoint-dir`` resumes. ``--export-vit`` writes the encoder (the
teacher's for DINO) as a bare fine-tune-ready ``.npz`` that vitx's
``load_vit_init``, ``cli.train --init-from`` and ``cli.probe`` read::

    python -m vitx_torch.cli.pretrain --preset tiny --data procedural:64,32 \\
        --epochs 2 --checkpoint-dir ckpt/mae --export-vit ckpt/vit.npz
    python -m vitx_torch.cli.train --preset tiny --init-from ckpt/vit.npz

Each step's draws (masking, views, dropout) come from generators seeded
by (seed, epoch, step), so a resumed run draws what an uninterrupted one
would. ``--dp N`` pretrains data-parallel over N rank processes
(``vitx_torch.parallel.spawn``, or the group ``torchrun`` describes):
the state whole on every rank, each rank loading its block of every
batch, the families' global-batch semantics kept (``nn/{mae,dino,
simclr}.py``, ``mesh=``), rank 0 printing, writing and exporting.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from vitx_torch.core.config import PRESETS, ViTConfig, get_config
from vitx_torch.core.device import resolve_device


def build_argparser():
    p = argparse.ArgumentParser(
        prog="vitx_torch.pretrain",
        description="Pretrain a ViT encoder (MAE, DINO or SimCLR) on a "
                    "CUDA device")
    a = p.add_argument
    a("--preset", default="tiny", choices=sorted(PRESETS))
    a("--config-json", default=None,
      help="path to a ViTConfig JSON (overrides --preset)")
    a("--data", default="synthetic",
      help="any --data spec of vitx_torch.cli.train (labels are ignored)")
    a("--epochs", type=int, default=10)
    a("--batch-size", type=int, default=64)
    a("--lr", type=float, default=1.5e-4)
    a("--weight-decay", type=float, default=0.05)
    a("--grad-clip", type=float, default=None,
      help="global-norm gradient clip (default: none for MAE and SimCLR, "
           "3.0 for DINO)")
    a("--method", default="mae", choices=["mae", "dino", "simclr"])
    a("--mask-ratio", type=float, default=0.75)
    a("--decoder-dim", type=int, default=512)
    a("--decoder-depth", type=int, default=8)
    a("--decoder-heads", type=int, default=16)
    a("--no-norm-pix", action="store_true",
      help="raw-pixel targets instead of per-patch normalised")
    d = p.add_argument_group("dino (--method dino)")
    d.add_argument("--local-size", type=int, default=None,
                   help="local-crop size (default: image_size // 2, "
                        "rounded down to a patch multiple)")
    d.add_argument("--n-local", type=int, default=6)
    d.add_argument("--dino-dim", type=int, default=4096,
                   help="prototype count K")
    d.add_argument("--dino-hidden", type=int, default=2048)
    d.add_argument("--dino-bottleneck", type=int, default=256)
    d.add_argument("--teacher-temp", type=float, default=0.04)
    d.add_argument("--student-temp", type=float, default=0.1)
    d.add_argument("--teacher-momentum", type=float, default=0.996,
                   help="EMA base; follows a cosine to 1.0 over the run")
    d.add_argument("--center-momentum", type=float, default=0.9)
    d.add_argument("--freeze-last-epochs", type=int, default=1,
                   help="freeze the prototype layer for the first N epochs")
    d.add_argument("--no-norm-last", action="store_true",
                   help="no weight norm on the prototype layer")
    s = p.add_argument_group("simclr (--method simclr)")
    s.add_argument("--simclr-dim", type=int, default=128)
    s.add_argument("--simclr-hidden", type=int, default=2048)
    s.add_argument("--simclr-temp", type=float, default=0.1)
    a("--checkpoint-dir", default=None)
    a("--log-dir", default=None)
    a("--log-every", type=int, default=50)
    a("--seed", type=int, default=0)
    a("--compute-dtype", default=None, choices=["float32", "bfloat16"])
    a("--export-vit", default=None,
      help="after training, write a fine-tune-ready classifier tree (npz) "
           "with the pretrained encoder's weights")
    a("--dp", type=int, default=None,
      help="data-parallel size: shard pretraining batches over a mesh "
           "(params/moments replicated)")
    a("--device", default="cuda",
      help="torch device to pretrain on (default: cuda)")
    return p


def family_config(args, cfg: ViTConfig):
    """The family config of ``args.method`` on the encoder ``cfg``, from
    the flags (``vitx/cli/pretrain.py:133-197``): DINO's local crops
    default to half the image size, rounded down to a whole patch."""
    if args.method == "dino":
        from vitx_torch.nn.dino import DINOConfig

        local = args.local_size
        if local is None:
            local = max(cfg.image_size // 2 // cfg.patch_size, 1) \
                * cfg.patch_size
        return DINOConfig(
            encoder=cfg, local_size=local, n_local=args.n_local,
            out_dim=args.dino_dim, head_hidden=args.dino_hidden,
            head_bottleneck=args.dino_bottleneck,
            student_temp=args.student_temp, teacher_temp=args.teacher_temp,
            center_momentum=args.center_momentum,
            momentum=args.teacher_momentum,
            norm_last_layer=not args.no_norm_last)
    if args.method == "simclr":
        from vitx_torch.nn.simclr import SimCLRConfig

        return SimCLRConfig(encoder=cfg, proj_hidden=args.simclr_hidden,
                            proj_dim=args.simclr_dim,
                            temperature=args.simclr_temp)
    from vitx_torch.nn.mae import MAEConfig

    return MAEConfig(encoder=cfg, decoder_dim=args.decoder_dim,
                     decoder_depth=args.decoder_depth,
                     decoder_heads=args.decoder_heads,
                     mask_ratio=args.mask_ratio,
                     norm_pix_loss=not args.no_norm_pix)


def build_family(args, cfg: ViTConfig, steps_per_epoch: int, device,
                 mesh=None):
    """-> (family config, state, step, host preprocess, train flag) for
    ``args.method`` (``vitx/cli/pretrain.py:133-197``); ``mesh``: a rank
    of a data-parallel run."""
    from vitx_torch.data import make_preprocess
    from vitx_torch.train.step import make_optimizer

    grad_clip = args.grad_clip
    if grad_clip is None and args.method == "dino":
        grad_clip = 3.0
    opt = make_optimizer(lr=args.lr, weight_decay=args.weight_decay,
                         grad_clip=grad_clip)
    fcfg = family_config(args, cfg)
    # DINO and SimCLR build their views on the device from raw [0, 1]
    # intensities (normalising after solarize, which needs [0, 1])
    raw = make_preprocess(out_size=None, mean=None, random_flip=False)
    if args.method == "dino":
        from vitx_torch.nn.dino import (create_dino_train_state,
                                        make_dino_train_step)

        state = create_dino_train_state(args.seed, fcfg, opt, device=device)
        step = make_dino_train_step(
            fcfg, opt, total_steps=args.epochs * steps_per_epoch,
            freeze_last_steps=args.freeze_last_epochs * steps_per_epoch,
            device=device, mesh=mesh)
        return fcfg, state, step, raw, False
    if args.method == "simclr":
        from vitx_torch.nn.simclr import (create_simclr_train_state,
                                          make_simclr_train_step)

        state = create_simclr_train_state(args.seed, fcfg, opt,
                                          device=device)
        return fcfg, state, make_simclr_train_step(
            fcfg, opt, device=device, mesh=mesh), raw, False
    from vitx_torch.nn.mae import create_mae_train_state, make_mae_train_step

    state = create_mae_train_state(args.seed, fcfg, opt, device=device)
    return (fcfg, state, make_mae_train_step(fcfg, opt, device=device,
                                             mesh=mesh),
            make_preprocess(out_size=cfg.image_size), True)


def export_vit(path, args, cfg: ViTConfig, state) -> None:
    """Write the encoder as a classifier tree (fresh head, ``final_norm``)
    to a bare ``.npz`` of "a/b" keys (``vitx/cli/pretrain.py:269-290``):
    the teacher's for DINO (Caron et al. 2021: the EMA teacher is the
    better encoder)."""
    from vitx_torch.nn.pretrain_common import encoder_to_vit_params
    from vitx_torch.train.step import leaf_paths, leaves

    src = state.teacher if args.method == "dino" else state.params
    vit = encoder_to_vit_params(src["encoder"], cfg.replace(final_norm=True),
                                args.seed + 2, args.method.upper(),
                                device=src["encoder"]["cls_token"].device)
    np.savez(path, **{"/".join(p): t.detach().float().cpu().numpy()
                      for p, t in zip(leaf_paths(vit), leaves(vit))})


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.dp is None:
        return run(args)
    if args.batch_size % args.dp:
        raise SystemExit(f"--batch-size {args.batch_size} must be "
                         f"divisible by --dp {args.dp}")
    import os

    from vitx_torch import parallel as par

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return rank_main(par.from_env(args.device), argv)
    argv = sys.argv[1:] if argv is None else list(argv)
    return max(par.spawn(rank_main, args.dp, (argv,), device=args.device))


def rank_main(ctx, argv) -> int:
    """One rank of ``--dp`` pretraining (``vitx_torch.parallel.spawn``)."""
    from vitx_torch.parallel import make_mesh

    args = build_argparser().parse_args(argv)
    return run(args, make_mesh(args.dp, device=ctx.device))


def run(args, mesh=None) -> int:
    """Pretrain as ``args`` say, on one device or as a rank of ``mesh``
    (a data-parallel mesh: rank 0 alone prints, logs and writes)."""
    from vitx_torch.cli.train import make_datasets
    from vitx_torch.data import BatchLoader
    from vitx_torch.data.pipeline import device_prefetch
    from vitx_torch.train.checkpoint import (find_latest, restore_latest,
                                             save_checkpoint, snapshot)
    from vitx_torch.train.logging import ScalarWriter
    from vitx_torch.train.loop import step_seed

    rank0 = mesh is None or mesh.rank == 0
    rows, stream = None, 0
    if mesh is not None:
        rows = (mesh.index("data"), mesh.dp)
        stream = 2 + rows[0]     # the host preprocessing's draws per rank
    if args.config_json:
        with open(args.config_json) as f:
            cfg = ViTConfig.from_json(f.read())
    else:
        cfg = get_config(args.preset)
    if args.compute_dtype:
        cfg = cfg.replace(compute_dtype=args.compute_dtype)
    dev = resolve_device(args.device) if mesh is None else mesh.device

    train_ds, _ = make_datasets(args.data, cfg, args.seed)
    loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                         seed=args.seed, drop_last=True, rows=rows)
    steps_per_epoch = len(loader)
    _, state, step_fn, pre, pre_train = build_family(
        args, cfg, steps_per_epoch, dev, mesh)

    start_epoch = 0
    if args.checkpoint_dir and find_latest(args.checkpoint_dir) is not None:
        state, meta = restore_latest(args.checkpoint_dir, state, False)
        start_epoch = int(meta.get("epoch", -1)) + 1
        if rank0:
            print(f"resumed {args.method.upper()} pretraining at "
                  f"epoch {start_epoch}")

    def gen(epoch: int, step: int, stream: int):
        return torch.Generator(device=dev).manual_seed(
            step_seed(args.seed, epoch, step, stream))

    writer = ScalarWriter(args.log_dir) if args.log_dir and rank0 else None
    last: dict = {}
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        losses, pending, ents, accs = [], [], [], []
        n_steps = 0
        for batch in device_prefetch(iter(loader), device=dev):
            g = int(state.step)
            images = pre(batch["image"], gen(epoch, g, stream),
                         train=pre_train)
            state, metrics = step_fn(state, {"image": images},
                                     gen(epoch, g, 1))
            pending.append(metrics["loss"])
            if "teacher_entropy" in metrics:
                ents.append(metrics["teacher_entropy"])
            if "contrast_acc" in metrics:
                accs.append(metrics["contrast_acc"])
            n_steps += 1
            if len(pending) >= args.log_every:
                losses.extend(torch.stack(pending).cpu().tolist())
                pending = []
                if writer:
                    writer.add_scalar("Loss/pretrain_batch", losses[-1],
                                      int(state.step))
        if pending:
            losses.extend(torch.stack(pending).cpu().tolist())
        dt = time.time() - t0
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        imgs_per_sec = n_steps * args.batch_size / dt if dt else 0.0
        last = {"epoch": epoch, "loss": mean_loss,
                "images_per_sec": round(imgs_per_sec, 1)}
        extra = ""
        if ents:
            ent = float(ents[-1])
            last["teacher_entropy"] = round(ent, 4)
            extra = f" teacher_H {ent:.3f}"
            if writer:
                writer.add_scalar("DINO/teacher_entropy", ent, epoch)
        if accs:
            acc = float(accs[-1])
            last["contrast_acc"] = round(acc, 4)
            extra = f" contrast_acc {acc:.3f}"
            if writer:
                writer.add_scalar("SimCLR/contrast_acc", acc, epoch)
        if rank0:
            print(f"epoch {epoch}: {args.method}_loss {mean_loss:.4f}"
                  f"{extra} ({imgs_per_sec:.0f} img/s)")
        if writer:
            writer.add_scalar("Loss/pretrain_epoch", mean_loss, epoch)
        if args.checkpoint_dir and rank0:
            save_checkpoint(args.checkpoint_dir, snapshot(state, False),
                            epoch, meta={"epoch": epoch, "loss": mean_loss,
                                         "kind": args.method})

    if args.export_vit and rank0:
        export_vit(args.export_vit, args, cfg, state)
        print(f"exported fine-tune-ready encoder to {args.export_vit} "
              f"(load with vitx_torch.cli.train --init-from)")
    if writer:
        writer.close()
    if rank0:
        print(json.dumps(last))
    return 0


if __name__ == "__main__":
    sys.exit(main())
