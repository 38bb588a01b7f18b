"""The epoch-based training driver of the port.

The counterpart of ``vitx/train/loop.py``: ``Trainer.fit`` runs epochs of
train steps over a ``BatchLoader`` or ``DeviceBatchLoader``, evaluates on
``eval_params()`` (the EMA shadow when the optimizer keeps one) every
``eval_every`` epochs (through the merging encoder when the config sets
``tome_r``, as vitx's eval step does), stops early when val accuracy
stalls, logs vitx's scalar tags, and writes a self-describing
``{epoch}.ckpt`` per epoch (meta: ``loss``, ``step``, ``config`` -- with
``tome_r`` as the resolved schedule and ``tome_train`` --, ``ema_decay``,
``schedule``, ``accum_steps``, ``train_filter``, ``partial``) that it
resumes from. A LoRA config trains its adapters and heads only
(``train_filter`` defaults to "lora"); ``llrd``, ``accum_steps`` and the
mixing knobs go to ``make_optimizer`` and the train step as in vitx. SIGTERM and SIGINT end
the epoch early and save it as ``partial``, which a resume runs again.

Randomness differs from vitx by design (torch cannot draw threefry's
streams): each step's preprocessing and dropout draw from generators
seeded by ``(seed, epoch, step)``, so a resumed run draws exactly what an
uninterrupted one would. Scalars stay on the device until a flush every
``log_every`` steps.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from typing import Any, Callable

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.metrics import confusion_to_metrics
from vitx_torch.train.checkpoint import (AsyncCheckpointWriter,
                                         restore_latest, save_checkpoint,
                                         snapshot)
from vitx_torch.train.logging import ScalarWriter
from vitx_torch.train.step import (TrainState, create_train_state,
                                   get_ema_params, make_eval_step,
                                   make_optimizer, make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    """vitx's ``TrainerConfig`` (``vitx/train/loop.py:34-132``): every field
    with its name and default. The fields ``Trainer`` does not take yet
    raise when set away from their default (``UNPORTED``)."""
    epochs: int = 10
    lr: float = 1e-4
    weight_decay: float = 1e-4
    wd_exclude: bool = False
    grad_clip: float | None = None
    label_smoothing: float = 0.0
    mixup_alpha: float | None = None
    cutmix_alpha: float | None = None
    sam_rho: float | None = None
    class_weights: tuple | None = None
    loss: str = "ce"
    optimizer: str = "adamw"
    mu_dtype: str | None = None
    train_filter: str | None = None
    early_stop_patience: int | None = None
    early_stop_min_delta: float = 0.0
    log_every: int = 50
    checkpoint_dir: str | None = None
    log_dir: str | None = None
    keep_checkpoints: int | None = None
    eval_every: int = 1
    profile_epoch: int | None = None
    progress: bool = False
    preemption_safe: bool = True
    ema_decay: float | None = None
    llrd: float | None = None
    steps_per_dispatch: int = 1
    accum_steps: int = 1
    pp_microbatches: int = 4
    pp_schedule: str = "gpipe"
    nan_abort: bool = True
    async_checkpoint: bool = False
    seed: int = 0


# TrainerConfig fields the port does not take yet -> the ROADMAP item
UNPORTED = {"sam_rho": "A12", "loss": "A12", "optimizer": "A12",
            "mu_dtype": "A12", "steps_per_dispatch": "A12",
            "profile_epoch": "A12", "pp_microbatches": "A13",
            "pp_schedule": "A13"}


class NonFiniteLossError(RuntimeError):
    """Raised by ``Trainer`` when ``nan_abort`` sees a NaN/inf train loss."""


def step_seed(seed: int, epoch: int, step: int, stream: int) -> int:
    """A 63-bit generator seed from (seed, epoch, global step, stream)."""
    state = np.random.SeedSequence([seed, epoch, step, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Trainer:
    """Epoch loop over BatchLoader-style iterables on ``device`` (a CUDA
    device by default; raises without one unless ``device="cpu"``).

    ``preprocess``: ``(u8 images, generator, train=...) -> float images``
    (``vitx_torch.data.make_preprocess``), or None to feed the batches to
    the model as they are. ``optimizer``: an ``AdamW`` built by the caller
    (e.g. with ``warmup_cosine``); by default ``make_optimizer`` from the
    config's knobs. ``init_state``: a ``TrainState`` to start from in place
    of fresh params (seed ``tcfg.seed``). ``lr_schedule``: the schedule
    logged as ``LR`` each epoch (at the optimizer's update count: a
    step's count over ``accum_steps``). ``train_step``: a step of
    ``make_train_step``'s signature to run in place of the config's (the
    train CLI's distillation step). vitx's mesh arguments wait for ROADMAP
    A13."""

    def __init__(self, cfg: ViTConfig, tcfg: TrainerConfig, *,
                 preprocess: Callable | None = None,
                 init_state: TrainState | None = None, optimizer=None,
                 lr_schedule=None, train_step=None, device="cuda"):
        default = TrainerConfig()
        for name, item in UNPORTED.items():
            if getattr(tcfg, name) != getattr(default, name):
                raise NotImplementedError(
                    f"TrainerConfig.{name}={getattr(tcfg, name)!r} is not "
                    f"ported to vitx_torch yet (ROADMAP {item})")
        if tcfg.train_filter is None and cfg.lora_rank:
            # LoRA means a frozen base (vitx/train/loop.py:173-177)
            tcfg = dataclasses.replace(tcfg, train_filter="lora")
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self._ckpt_writer = AsyncCheckpointWriter()
        self._lr_schedule = lr_schedule
        self.optimizer = optimizer if optimizer is not None else \
            make_optimizer(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                           grad_clip=tcfg.grad_clip, ema_decay=tcfg.ema_decay,
                           wd_exclude=tcfg.wd_exclude, llrd=tcfg.llrd,
                           llrd_depth=cfg.depth,
                           accum_steps=tcfg.accum_steps,
                           trainable=tcfg.train_filter)
        self._schedule = self.optimizer.schedule is not None
        self.state = (init_state if init_state is not None else
                      create_train_state(tcfg.seed, cfg, self.optimizer,
                                         device=self.device))
        self.train_step = train_step or make_train_step(
            cfg, self.optimizer, device=self.device,
            label_smoothing=tcfg.label_smoothing,
            mixup_alpha=tcfg.mixup_alpha, cutmix_alpha=tcfg.cutmix_alpha,
            class_weights=tcfg.class_weights,
            train_filter=tcfg.train_filter)
        self.eval_step = make_eval_step(cfg, device=self.device)
        self.preprocess = preprocess
        # a generator for the steps whose forward or mixing draws: dropout,
        # drop-path, patch dropout, mixup / cutmix (with none the step is
        # deterministic, the merging encoder of tome_train included)
        self._stochastic = bool(cfg.dropout or cfg.drop_path
                                or cfg.patch_drop or tcfg.mixup_alpha
                                or tcfg.cutmix_alpha)
        self.start_epoch = 0
        self.history: list[dict[str, Any]] = []
        self._preempted = False

    def _generator(self, epoch: int, step: int, stream: int):
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(step_seed(self.tcfg.seed, epoch, step, stream))

    def maybe_resume(self):
        """Resume from the newest ``{epoch}.ckpt``; a ``partial`` epoch runs
        again. Returns its meta, or None."""
        if self.tcfg.checkpoint_dir is None:
            return None
        self.state, meta = restore_latest(self.tcfg.checkpoint_dir,
                                          self.state, self._schedule)
        if meta is not None:
            self.start_epoch = int(meta["epoch"]) + (
                0 if meta.get("partial") else 1)
        return meta

    def _on_device(self, batch) -> dict:
        out = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _prep(self, batch, gen, train: bool) -> dict:
        image = batch["image"]
        if self.preprocess is not None:
            image = self.preprocess(image, gen, train=train)
        out = {"image": image, "label": batch["label"]}
        if "mask" in batch:
            out["mask"] = batch["mask"]
        return out

    def eval_params(self):
        """The EMA shadow when the optimizer keeps one, else the params."""
        ema = get_ema_params(self.state.opt_state)
        return ema if ema is not None else self.state.params

    def evaluate(self, eval_loader) -> dict:
        """One confusion matrix over the loader on ``eval_params()``, one
        host transfer at the end; the loss is weighted by each batch's
        valid rows."""
        cm = loss_sum = None
        params = self.eval_params()
        for batch in eval_loader:
            prepped = self._prep(self._on_device(batch), None, train=False)
            cm_b, loss = self.eval_step(params, prepped)
            w_loss = loss * cm_b.sum()
            cm = cm_b if cm is None else cm + cm_b
            loss_sum = w_loss if loss_sum is None else loss_sum + w_loss
        if cm is None:
            return {}
        metrics = {k: (float(v) if v.dim() == 0 else v.cpu().numpy())
                   for k, v in confusion_to_metrics(cm).items()}
        cm_host = cm.cpu().numpy()
        metrics["loss"] = float(loss_sum) / max(float(cm_host.sum()), 1.0)
        metrics["confusion_matrix"] = cm_host
        return metrics

    def _meta(self, stats: dict) -> dict:
        meta = {"loss": stats.get("loss", 0.0), "step": int(self.state.step),
                "config": json.loads(self.cfg.to_json())}
        if self.tcfg.ema_decay is not None:
            meta["ema_decay"] = self.tcfg.ema_decay
        if self.tcfg.accum_steps > 1:
            meta["accum_steps"] = self.tcfg.accum_steps
        if self.tcfg.train_filter:
            meta["train_filter"] = self.tcfg.train_filter
        if self._schedule:
            meta["schedule"] = True
        if self._preempted:
            meta["partial"] = True
        return meta

    def fit(self, train_loader, eval_loader=None) -> list:
        tcfg = self.tcfg
        writer = ScalarWriter(tcfg.log_dir) if tcfg.log_dir else None
        resumed = self.maybe_resume()
        if resumed is not None:
            print(f"resumed from epoch {resumed['epoch']}")
        old_handlers = {}
        if tcfg.preemption_safe and tcfg.checkpoint_dir is not None:
            def on_preempt(signum, frame):
                self._preempted = True
                # a second signal interrupts instead of being swallowed
                for s, h in old_handlers.items():
                    signal.signal(s, h)
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    old_handlers[sig] = signal.signal(sig, on_preempt)
                except ValueError:    # not the main thread
                    break
        best_acc, best_epoch, stale_evals = -1.0, None, 0
        stop_early = False
        try:
            for epoch in range(self.start_epoch, tcfg.epochs):
                stats = self._train_epoch(train_loader, epoch, writer)
                if eval_loader is not None and not self._preempted and \
                        (epoch + 1) % tcfg.eval_every == 0:
                    em = self.evaluate(eval_loader)
                    acc = float(em["accuracy"])
                    if acc > best_acc + tcfg.early_stop_min_delta:
                        best_acc, best_epoch, stale_evals = acc, epoch, 0
                    elif tcfg.early_stop_patience is not None:
                        stale_evals += 1
                        stop_early = stale_evals >= tcfg.early_stop_patience
                    stats.update({f"val_{k}": v for k, v in em.items()
                                  if not isinstance(v, np.ndarray)})
                    if writer:
                        writer.add_scalar("val?acc", em["accuracy"], epoch)
                        writer.add_scalar("Val/precision_weighted",
                                          em["precision_weighted"], epoch)
                        writer.add_scalar("Val/recall_weighted",
                                          em["recall_weighted"], epoch)
                if writer and self._lr_schedule is not None:
                    # the schedule's horizon is in optimizer updates: one
                    # per accum_steps micro-batches (vitx/train/loop.py:505)
                    writer.add_scalar(
                        "LR", float(self._lr_schedule(
                            self.state.step // max(1, self.tcfg.accum_steps))),
                        epoch)
                if tcfg.checkpoint_dir is not None:
                    arrays = snapshot(self.state, self._schedule)
                    kw = dict(meta=self._meta(stats),
                              keep=tcfg.keep_checkpoints, protect=best_epoch)
                    if tcfg.async_checkpoint:
                        self._ckpt_writer.save(tcfg.checkpoint_dir, arrays,
                                               epoch, **kw)
                    else:
                        save_checkpoint(tcfg.checkpoint_dir, arrays, epoch,
                                        **kw)
                self.history.append({"epoch": epoch, **stats})
                msg = ", ".join(f"{k}={v:.4f}" for k, v in stats.items()
                                if isinstance(v, (int, float)))
                print(f"epoch {epoch}: {msg}")
                if self._preempted:
                    print(f"preemption signal received: checkpointed "
                          f"epoch {epoch}, exiting cleanly")
                    break
                if stop_early:
                    print(f"early stop at epoch {epoch}: val accuracy "
                          f"stale for {stale_evals} evals "
                          f"(best {best_acc:.4f} at epoch {best_epoch})")
                    break
        finally:
            # the async writer first: a preempted run keeps its last save
            self._ckpt_writer.wait()
            if writer:
                writer.close()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        return self.history

    def _train_epoch(self, train_loader, epoch: int, writer) -> dict:
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        t0 = time.time()
        n_images, n_valid = 0, []
        running_loss, last_metrics = 0.0, None
        pending = []             # (step, metrics) still on the device
        step = int(self.state.step)
        for batch in train_loader:
            if self._preempted:
                break
            batch = self._on_device(batch)
            gen = (self._generator(epoch, step, 0)
                   if self.preprocess is not None else None)
            prepped = self._prep(batch, gen, train=True)
            rng = self._generator(epoch, step, 1) if self._stochastic \
                else None
            self.state, metrics = self.train_step(self.state, prepped, rng)
            step += 1
            if "mask" in batch:
                n_valid.append(batch["mask"].sum())
            else:
                n_images += batch["image"].shape[0]
            pending.append((step, metrics))
            if len(pending) >= self.tcfg.log_every:
                running_loss += self._flush(pending, writer)
                last_metrics = pending[-1][1]
                pending = []
                if n_valid:
                    n_images += int(torch.stack(n_valid).sum())
                    n_valid = []
                if self.tcfg.progress:
                    rate = n_images / max(time.time() - t0, 1e-9)
                    print(f"\r  epoch {epoch} step {step}: "
                          f"loss={float(last_metrics['loss']):.4f} "
                          f"{rate:.1f} img/s", end="", flush=True)
        if pending:
            running_loss += self._flush(pending, writer)
            last_metrics = pending[-1][1]
        if n_valid:
            n_images += int(torch.stack(n_valid).sum())
        if self.tcfg.progress:
            print()
        dt = time.time() - t0
        stats = {"loss": (float(last_metrics["loss"]) if last_metrics
                          else float("nan")),
                 "epoch_loss_sum": running_loss,
                 "images_per_sec": n_images / dt, "epoch_secs": dt}
        if writer:
            writer.add_scalar("Throughput/images_per_sec",
                              stats["images_per_sec"], epoch)
        return stats

    def _flush(self, pending, writer) -> float:
        """Copy the pending losses to the host in one transfer, log them
        and return their sum; raise on a non-finite one with
        ``nan_abort``."""
        losses = torch.stack([m["loss"].float() for _, m in pending]).tolist()
        for (step, _), loss in zip(pending, losses):
            if writer:
                writer.add_scalar("Loss/train_batch", loss, step)
            if self.tcfg.nan_abort and not np.isfinite(loss):
                raise NonFiniteLossError(
                    f"non-finite train loss ({loss}) at step {step}: the "
                    f"run has diverged. The last epoch-boundary checkpoint "
                    f"is intact; resume with a lower lr and/or grad_clip "
                    f"(set TrainerConfig.nan_abort=False to keep going)")
        return float(sum(losses))
