"""The epoch-based training driver of the port.

The counterpart of ``vitx/train/loop.py``: ``Trainer.fit`` runs epochs of
train steps over a ``BatchLoader`` or ``DeviceBatchLoader``, evaluates on
``eval_params()`` (the EMA shadow when the optimizer keeps one) every
``eval_every`` epochs (through the merging encoder when the config sets
``tome_r``, as vitx's eval step does; a multi-label run, ``loss="bce"``,
reports micro and macro F1 and mAP from the gathered logits), stops early
when val accuracy stalls, logs vitx's scalar tags, and writes a
self-describing ``{epoch}.ckpt`` per epoch (meta: ``loss``, ``step``,
``config`` -- with ``tome_r`` as the resolved schedule and
``tome_train`` --, ``loss_type``, ``ema_decay``, ``schedule``,
``accum_steps``, ``optimizer``, ``train_filter``, ``partial``) that it
resumes from. A LoRA config trains its adapters and heads only
(``train_filter`` defaults to "lora"); the optimizer (adamw, sgd, lion,
adafactor; ``mu_dtype``), ``llrd``, ``accum_steps``, SAM (``sam_rho``),
the loss and the mixing knobs go to ``make_optimizer`` and the train step
as in vitx. The train and eval loops read their loaders through
``device_prefetch`` (batch N+1's transfer overlaps batch N's step).
``steps_per_dispatch`` k > 1 stacks k batches on the device and runs
their k steps back to back with no host read between them (the epoch's
remainder under k runs step by step);
``profile_epoch`` writes a ``torch.profiler`` trace of that epoch (CPU
and CUDA activities) under ``log_dir``. SIGTERM and SIGINT end the epoch
early and save it as ``partial``, which a resume runs again.

On a rank of a ``mesh`` (``vitx_torch.parallel.make_mesh``; vitx's mesh
branches, ``vitx/train/loop.py:157-294``) the state is placed as the
flags say (``tp``, ``zero1``/``zero2``/``zero3``, ``sp``, ``ep``), the
steps are ``make_parallel_train_step`` / ``make_parallel_eval_step``,
the loaders are the rank's own (``BatchLoader(rows=...)``), the metrics
those of the global batch; rank 0 alone logs, prints and writes the
``.ckpt`` files, in the single-process format, from the gathered state
(every rank takes part in the gather), and a resume places the restored
state again. ``steps_per_dispatch`` > 1 is refused there, as vitx
refuses it. On a pipeline mesh (``vitx_torch.parallel.make_pp_mesh``,
a ``stage`` axis of more than one rank; vitx's stage-mesh branch,
``vitx/train/loop.py:199-233``) the state is placed by the pipeline's
specs (``tp``, ``zero1``) and the steps are ``make_pp_train_step`` /
``make_pp_eval_step`` with ``pp_microbatches`` and ``pp_schedule``;
ZeRO-2/3 and every recipe knob but label smoothing are refused there
with vitx's messages. The ``.ckpt`` files keep the single-process
(stacked) layout, and a resume places them by the pipeline's specs.

Randomness differs from vitx by design (torch cannot draw threefry's
streams): each step's preprocessing and dropout draw from generators
seeded by ``(seed, epoch, step)``, so a resumed run draws exactly what an
uninterrupted one would, and the trajectory does not depend on
``steps_per_dispatch``. Scalars stay on the device until a flush every
``log_every`` steps.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import signal
import time
from typing import Any, Callable

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.data.pipeline import device_prefetch
from vitx_torch.metrics import confusion_to_metrics, multilabel_metrics
from vitx_torch.nn.vit import model_logits
from vitx_torch.train.checkpoint import (AsyncCheckpointWriter,
                                         restore_latest, save_checkpoint,
                                         snapshot)
from vitx_torch.train.logging import ScalarWriter
from vitx_torch.train.step import (TrainState, create_train_state,
                                   get_ema_params, make_eval_step,
                                   make_optimizer, make_train_step,
                                   sigmoid_bce_loss)


@dataclasses.dataclass
class TrainerConfig:
    """vitx's ``TrainerConfig`` (``vitx/train/loop.py:34-132``): every field
    with its name and default (``pp_microbatches`` and ``pp_schedule``
    act on a pipeline mesh only, as in vitx)."""
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


@torch.no_grad()
def multilabel_eval(params, cfg: ViTConfig, batches, mesh=None,
                    param_specs=None) -> dict:
    """The multi-label evaluation of ``batches`` ((images, (B, C) labels,
    mask or None) on the params' device): the valid rows' logits and
    targets gathered to the host batch by batch, ``multilabel_metrics``
    over them, and the mean BCE loss weighted by each batch's valid rows
    (vitx's trainer and eval CLI compute the same); {} without a batch.
    On a rank of a ``mesh`` the params are its parts (``param_specs``)
    and each batch's rows are gathered from every rank first."""
    scores, targets = [], []
    loss_sum, n = 0.0, 0
    if mesh is not None:
        from vitx_torch.parallel import sharded

        params = sharded.forward_params(params, param_specs, mesh)
    for images, labels, mask in batches:
        logits = model_logits(params, images, cfg, mesh=mesh)
        if mesh is not None:
            logits, labels = (sharded.gather_batch(t, mesh)
                              for t in (logits, labels))
            if mask is not None:
                mask = sharded.gather_batch(mask, mesh)
        keep = (torch.ones(logits.shape[0], dtype=torch.bool,
                           device=logits.device) if mask is None
                else mask > 0)
        k = int(keep.sum())
        loss_sum += float(sigmoid_bce_loss(logits, labels, mask)) * k
        n += k
        scores.append(logits[keep].float().cpu().numpy())
        targets.append(labels[keep].cpu().numpy())
    if not scores:
        return {}
    metrics = multilabel_metrics(np.concatenate(scores),
                                 np.concatenate(targets))
    metrics["loss"] = loss_sum / max(n, 1)
    return metrics


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
    train CLI's distillation step). ``mesh`` and the flags after it: a
    rank of a sharded run (the module's doc); ``init_state`` is then the
    whole state, the same on every rank, and ``device`` the mesh's."""

    def __init__(self, cfg: ViTConfig, tcfg: TrainerConfig, *,
                 preprocess: Callable | None = None,
                 init_state: TrainState | None = None, optimizer=None,
                 lr_schedule=None, train_step=None, device="cuda",
                 mesh=None, tp: bool = False, zero1: bool = False,
                 zero2: bool = False, zero3: bool = False, sp: bool = False,
                 ep: bool = False):
        if tcfg.train_filter is None and cfg.lora_rank:
            # LoRA means a frozen base (vitx/train/loop.py:173-177)
            tcfg = dataclasses.replace(tcfg, train_filter="lora")
        self.cfg, self.tcfg = cfg, tcfg
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self._ckpt_writer = AsyncCheckpointWriter()
        self._lr_schedule = lr_schedule
        self.optimizer = optimizer if optimizer is not None else \
            make_optimizer(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                           grad_clip=tcfg.grad_clip, ema_decay=tcfg.ema_decay,
                           wd_exclude=tcfg.wd_exclude, llrd=tcfg.llrd,
                           llrd_depth=cfg.depth,
                           accum_steps=tcfg.accum_steps,
                           optimizer=tcfg.optimizer,
                           trainable=tcfg.train_filter,
                           mu_dtype=tcfg.mu_dtype)
        self._schedule = self.optimizer.schedule is not None
        self.state = (init_state if init_state is not None else
                      create_train_state(tcfg.seed, cfg, self.optimizer,
                                         device=self.device))
        self.specs = None
        if tcfg.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{tcfg.steps_per_dispatch}")
        if tcfg.steps_per_dispatch > 1 and mesh is not None:
            raise ValueError("steps_per_dispatch > 1 is a single-device "
                             "dispatch-overhead optimization; mesh runs are "
                             "compute-bound — use per-device batch size")
        if mesh is not None and mesh.pp > 1:
            self._place_pp(tp, zero1, zero2, zero3, train_step)
        elif mesh is not None:
            self._place(tp, zero1 or zero2, zero3, sp, ep, zero2, train_step)
        else:
            self.train_step = train_step or make_train_step(
                cfg, self.optimizer, device=self.device,
                label_smoothing=tcfg.label_smoothing,
                mixup_alpha=tcfg.mixup_alpha,
                cutmix_alpha=tcfg.cutmix_alpha, sam_rho=tcfg.sam_rho,
                class_weights=tcfg.class_weights,
                train_filter=tcfg.train_filter, loss=tcfg.loss)
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

    def _place(self, tp, zero1, zero3, sp, ep, zero2, train_step) -> None:
        """The mesh branch of ``__init__``: the whole state placed, the
        sharded steps (``vitx/train/loop.py:234-265``)."""
        from vitx_torch.parallel import sharded

        if train_step is not None:
            raise ValueError("a custom train_step does not run on a mesh "
                             "(use the library's sharded step)")
        cfg, tcfg, mesh = self.cfg, self.tcfg, self.mesh
        whole = self.state.params
        self.specs = sharded.state_sharding(self.state, cfg, mesh, tp,
                                            zero1, zero3, ep=ep)
        gshard = (sharded.grad_sharding(whole, cfg, mesh, tp, ep)
                  if zero2 and not zero3 else None)
        self.state = sharded.place_state(self.state, cfg, mesh,
                                         specs=self.specs)
        self.train_step = sharded.make_parallel_train_step(
            cfg, self.optimizer, mesh, tp=tp, zero1=zero1, zero3=zero3,
            sp=sp, ep=ep, state_shardings=self.specs, grad_shardings=gshard,
            label_smoothing=tcfg.label_smoothing,
            mixup_alpha=tcfg.mixup_alpha, cutmix_alpha=tcfg.cutmix_alpha,
            sam_rho=tcfg.sam_rho, class_weights=tcfg.class_weights,
            train_filter=tcfg.train_filter, loss=tcfg.loss)
        self.eval_step = sharded.make_parallel_eval_step(
            cfg, mesh, tp=tp, sp=sp, ep=ep, param_specs=self.specs.params)
        self.eval_cfg = sharded.ep_cfg(sharded.sp_cfg(
            sharded.tp_safe_cfg(cfg, tp), tp, sp), mesh, ep)

    def _place_pp(self, tp, zero1, zero2, zero3, train_step) -> None:
        """The stage-mesh branch of ``__init__`` (``vitx/train/loop.py:
        199-233``): vitx's refusals, the state placed by the pipeline's
        specs, the pipeline steps."""
        from vitx_torch.parallel import pipeline, sharded

        cfg, tcfg, mesh = self.cfg, self.tcfg, self.mesh
        if zero2 or zero3:
            raise ValueError("pipeline parallelism composes with dp, "
                             "tp and zero1 only (zero2/zero3 use the "
                             "pjit paths in vitx/parallel/sharded.py)")
        unsupported = [name for name, v in (
            ("mixup_alpha", tcfg.mixup_alpha),
            ("cutmix_alpha", tcfg.cutmix_alpha),
            ("sam_rho", tcfg.sam_rho),
            ("class_weights", tcfg.class_weights),
            ("train_filter", tcfg.train_filter)) if v]
        if unsupported:
            raise ValueError(
                f"pipeline-parallel training supports label_smoothing "
                f"only; unset {unsupported}")
        if tcfg.loss != "ce":
            raise ValueError("the pipeline's train step computes the "
                             "softmax cross-entropy: loss='bce' runs on "
                             "the dp/tp paths")
        if train_step is not None:
            raise ValueError("a custom train_step does not run on a mesh "
                             "(use the library's sharded step)")
        self.specs = pipeline.pp_state_sharding(self.state, cfg, mesh,
                                                zero1=zero1, tp=tp)
        self.state = sharded.place_state(self.state, cfg, mesh,
                                         specs=self.specs)
        self.train_step = pipeline.make_pp_train_step(
            cfg, self.optimizer, mesh, n_micro=tcfg.pp_microbatches,
            state_shardings=self.specs,
            label_smoothing=tcfg.label_smoothing,
            schedule=tcfg.pp_schedule)
        self.eval_step = pipeline.make_pp_eval_step(
            cfg, mesh, n_micro=tcfg.pp_microbatches)
        self.eval_cfg = cfg

    @property
    def rank0(self) -> bool:
        """Whether this process logs and writes (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def whole_state(self) -> TrainState:
        """The whole state (gathered from every rank on a mesh: each rank
        must call it)."""
        if self.mesh is None:
            return self.state
        from vitx_torch.parallel import sharded

        return sharded.gather_state(self.state, self.specs, self.mesh)

    def _generator(self, epoch: int, step: int, stream: int):
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(step_seed(self.tcfg.seed, epoch, step, stream))

    def maybe_resume(self):
        """Resume from the newest ``{epoch}.ckpt``; a ``partial`` epoch runs
        again. Returns its meta, or None."""
        if self.tcfg.checkpoint_dir is None:
            return None
        if self.mesh is not None:
            from vitx_torch.parallel import sharded

            whole, meta = restore_latest(self.tcfg.checkpoint_dir,
                                         self.whole_state(), self._schedule)
            self.state = sharded.place_state(whole, self.cfg, self.mesh,
                                             specs=self.specs)
        else:
            self.state, meta = restore_latest(self.tcfg.checkpoint_dir,
                                              self.state, self._schedule)
        if meta is not None:
            self.start_epoch = int(meta["epoch"]) + (
                0 if meta.get("partial") else 1)
        return meta

    def _prefetch(self, loader):
        """The loader's batches on ``self.device``, batch N+1's transfer
        overlapping batch N's step (``device_prefetch``, as vitx's
        ``_prefetch``, ``vitx/train/loop.py:326-332``)."""
        return device_prefetch(iter(loader), size=2, device=self.device)

    def _prep(self, batch, gen, train: bool) -> dict:
        image = batch["image"]
        if self.preprocess is not None:
            image = self.preprocess(image, gen, train=train)
        out = {"image": image, "label": batch["label"]}
        if "mask" in batch:
            out["mask"] = batch["mask"]
        return out

    def eval_params(self):
        """The EMA shadow when the optimizer keeps one, else the params
        (on a mesh: the shadow at the params' specs, its ZeRO slices
        gathered)."""
        ema = get_ema_params(self.state.opt_state)
        if ema is None:
            return self.state.params
        if self.mesh is None:
            return ema
        from vitx_torch.parallel import sharded

        return sharded.respec(ema, self.specs.opt_state.ema,
                              self.specs.params, self.mesh)

    def evaluate(self, eval_loader) -> dict:
        """One confusion matrix over the loader on ``eval_params()``, one
        host transfer at the end; the loss is weighted by each batch's
        valid rows. A multi-label run (``loss="bce"``) reports
        ``evaluate_multilabel``'s metrics instead."""
        if self.tcfg.loss == "bce":
            return self.evaluate_multilabel(eval_loader)
        cm = loss_sum = None
        params = self.eval_params()
        for batch in self._prefetch(eval_loader):
            prepped = self._prep(batch, None, train=False)
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

    def evaluate_multilabel(self, eval_loader) -> dict:
        """vitx's ``_evaluate_multilabel`` (``vitx/train/loop.py:
        419-445``): ``multilabel_eval`` of ``eval_params()`` over the
        loader."""
        def batches():
            for batch in self._prefetch(eval_loader):
                prepped = self._prep(batch, None, train=False)
                yield (prepped["image"], prepped["label"],
                       prepped.get("mask"))
        if self.mesh is None:
            return multilabel_eval(self.eval_params(), self.cfg, batches())
        return multilabel_eval(self.eval_params(), self.eval_cfg, batches(),
                               self.mesh, self.specs.params)

    def _meta(self, stats: dict) -> dict:
        meta = {"loss": stats.get("loss", 0.0), "step": int(self.state.step),
                "config": json.loads(self.cfg.to_json())}
        if self.tcfg.loss != "ce":
            meta["loss_type"] = self.tcfg.loss
        if self.tcfg.ema_decay is not None:
            meta["ema_decay"] = self.tcfg.ema_decay
        if self.tcfg.accum_steps > 1:
            meta["accum_steps"] = self.tcfg.accum_steps
        if self.tcfg.optimizer != "adamw":
            meta["optimizer"] = self.tcfg.optimizer
        if self.tcfg.train_filter:
            meta["train_filter"] = self.tcfg.train_filter
        if self._schedule:
            meta["schedule"] = True
        if self._preempted:
            meta["partial"] = True
        return meta

    def fit(self, train_loader, eval_loader=None) -> list:
        tcfg = self.tcfg
        writer = (ScalarWriter(tcfg.log_dir) if tcfg.log_dir and self.rank0
                  else None)
        resumed = self.maybe_resume()
        if resumed is not None and self.rank0:
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
        profiler = None
        try:
            for epoch in range(self.start_epoch, tcfg.epochs):
                if tcfg.profile_epoch == epoch and tcfg.log_dir:
                    profiler = self._start_profile()
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
                        if "precision_weighted" in em:
                            writer.add_scalar("Val/precision_weighted",
                                              em["precision_weighted"],
                                              epoch)
                            writer.add_scalar("Val/recall_weighted",
                                              em["recall_weighted"], epoch)
                        if "mAP" in em:        # multi-label (loss="bce")
                            writer.add_scalar("Val/mAP", em["mAP"], epoch)
                            writer.add_scalar("Val/f1_micro",
                                              em["f1_micro"], epoch)
                if writer and self._lr_schedule is not None:
                    # the schedule's horizon is in optimizer updates: one
                    # per accum_steps micro-batches (vitx/train/loop.py:505)
                    writer.add_scalar(
                        "LR", float(self._lr_schedule(
                            self.state.step // max(1, self.tcfg.accum_steps))),
                        epoch)
                if profiler is not None:
                    self._stop_profile(profiler, epoch)
                    profiler = None
                if tcfg.checkpoint_dir is not None:
                    arrays = snapshot(self.whole_state(), self._schedule)
                    kw = dict(meta=self._meta(stats),
                              keep=tcfg.keep_checkpoints, protect=best_epoch)
                    if not self.rank0:
                        pass
                    elif tcfg.async_checkpoint:
                        self._ckpt_writer.save(tcfg.checkpoint_dir, arrays,
                                               epoch, **kw)
                    else:
                        save_checkpoint(tcfg.checkpoint_dir, arrays, epoch,
                                        **kw)
                self.history.append({"epoch": epoch, **stats})
                msg = ", ".join(f"{k}={v:.4f}" for k, v in stats.items()
                                if isinstance(v, (int, float)))
                if self.rank0:
                    print(f"epoch {epoch}: {msg}")
                if self._preempted:
                    if self.rank0:
                        print(f"preemption signal received: checkpointed "
                              f"epoch {epoch}, exiting cleanly")
                    break
                if stop_early:
                    if self.rank0:
                        print(f"early stop at epoch {epoch}: val accuracy "
                              f"stale for {stale_evals} evals "
                              f"(best {best_acc:.4f} at epoch "
                              f"{best_epoch})")
                    break
        finally:
            if profiler is not None:        # an epoch that raised
                profiler.stop()
            # the async writer first: a preempted run keeps its last save
            self._ckpt_writer.wait()
            if writer:
                writer.close()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        return self.history

    def _start_profile(self):
        """A ``torch.profiler`` session of the CPU and, on a card, CUDA
        activities (vitx's ``jax.profiler.start_trace``)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler, epoch: int) -> None:
        """End the session and write its Chrome trace as
        ``{log_dir}/profile_epoch{epoch}.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        path = pathlib.Path(self.tcfg.log_dir) / f"profile_epoch{epoch}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(path))
        print(f"profile of epoch {epoch}: {path}")

    def _step(self, batch: dict, epoch: int, step: int) -> dict:
        """One train step on a placed batch, its generators seeded from
        (seed, epoch, step); -> its metrics, left on the device. On a
        mesh the preprocessing's stream is the rank's batch block's own
        (its draws are per image, not global), the step's the same on
        every rank (it draws at the global shape)."""
        stream = 0
        if self.mesh is not None:
            from vitx_torch.parallel import sharded

            stream = 2 + self.mesh.index(sharded.BATCH_AXES)
        gen = (self._generator(epoch, step, stream)
               if self.preprocess is not None else None)
        prepped = self._prep(batch, gen, train=True)
        rng = self._generator(epoch, step, 1) if self._stochastic else None
        self.state, metrics = self.train_step(self.state, prepped, rng)
        return metrics

    def dispatch_steps(self, batches: list, epoch: int, step: int) -> tuple:
        """``steps_per_dispatch``'s k steps from global step ``step``: the
        k batches (on the device) stacked on the device, as vitx's
        ``jnp.stack``, then their steps run back to back, no host read
        between them -> (the stacked batch, {name: (k,) metrics on the
        device})."""
        stacked = {key: torch.stack([b[key] for b in batches])
                   for key in batches[0]}
        ms = [self._step({key: v[i] for key, v in stacked.items()}, epoch,
                         step + i) for i in range(len(batches))]
        return stacked, {key: torch.stack([m[key] for m in ms])
                         for key in ms[0]}

    def _train_epoch(self, train_loader, epoch: int, writer) -> dict:
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        t0 = time.time()
        n_images, n_valid = 0, []
        running_loss, last_metrics = 0.0, None
        pending = []             # (step, metrics) still on the device
        step = int(self.state.step)
        k = self.tcfg.steps_per_dispatch
        buf = []

        def count(batch):
            nonlocal n_images
            if "mask" in batch:
                n_valid.append(batch["mask"].sum())
            else:
                # (B, H, W, C), or (k, B, H, W, C) stacked
                n_images += int(np.prod(batch["image"].shape[:-3]))

        for batch in self._prefetch(train_loader):
            if self._preempted_anywhere():
                break
            if k > 1:
                buf.append(batch)
                if len(buf) < k:
                    continue
                stacked, ms = self.dispatch_steps(buf, epoch, step)
                for i in range(k):
                    pending.append((step + i + 1,
                                    {key: v[i] for key, v in ms.items()}))
                step += k
                buf = []
                count(stacked)
            else:
                pending.append((step + 1, self._step(batch, epoch, step)))
                step += 1
                count(batch)
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
        # the epoch's remainder under a whole dispatch: step by step
        if not self._preempted:
            for batch in buf:
                pending.append((step + 1, self._step(batch, epoch, step)))
                step += 1
                count(batch)
        if pending:
            running_loss += self._flush(pending, writer)
            last_metrics = pending[-1][1]
        if n_valid:
            n_images += int(torch.stack(n_valid).sum())
        if self.tcfg.progress:
            print()
        dt = time.time() - t0
        if self.mesh is not None:    # every batch block's images
            from vitx_torch.parallel import sharded

            n_images *= self.mesh.size(sharded.BATCH_AXES)
        stats = {"loss": (float(last_metrics["loss"]) if last_metrics
                          else float("nan")),
                 "epoch_loss_sum": running_loss,
                 "images_per_sec": n_images / dt, "epoch_secs": dt}
        if writer:
            writer.add_scalar("Throughput/images_per_sec",
                              stats["images_per_sec"], epoch)
        return stats

    def _preempted_anywhere(self) -> bool:
        """The preemption flag; on a mesh, set on any rank (every rank
        then leaves the epoch at the same step)."""
        if self.mesh is None:
            return self._preempted
        from vitx_torch.parallel import comm

        flag = torch.tensor([float(self._preempted)], device=self.device)
        comm.all_reduce_(flag, self.mesh, self.mesh.axis_names)
        self._preempted = bool(flag.item())
        return self._preempted

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
