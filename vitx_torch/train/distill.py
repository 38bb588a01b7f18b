"""Knowledge distillation (DeiT), the port's third training family.

The counterpart of ``vitx/train/distill.py``: a student trains against
the labels and a frozen teacher's predictions. The teacher is any params
and config pair (a vitx or port checkpoint, a reference ``.pt``, an
imported timm/HF ViT) and is an argument of the step, not part of it.

- soft: KL(teacher_T || student_T) · τ² at temperature τ;
- hard: cross-entropy against the teacher's argmax.

Both DeiT forms: head distillation (one classifier, the two terms on the
same logits), and the distillation token (``cfg.distill_token``): the
cross-entropy on the CLS head, the teacher's term on the distillation
head, the metrics on their mean (what inference returns).

The teacher's forward runs under ``torch.no_grad`` (K1 and K2 without
their stash on the card). The student's runs as vitx's does, through the
model's forward with the config as given (on the card K1 with its stash
and, with ``fuse_mlp="auto"``, K2 with its stash; B2 and B3 in the
backward), then one optimizer update (B12 where the fused route
applies).
"""

from __future__ import annotations

import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.nn.vit import model_logits
from vitx_torch.train.step import (AdamW, TrainState, _check_on,
                                   _to_device, apply_gradients,
                                   cross_entropy_loss, trainable_params)


def distill_loss(student_logits, teacher_logits, labels, mask=None, *,
                 alpha: float = 0.5, tau: float = 1.0, hard: bool = False,
                 label_smoothing: float = 0.0):
    """(1 - alpha) · CE(labels) + alpha · the distillation term, in fp32
    (``vitx/train/distill.py:42-62``); ``mask`` (0/1 rows) weights both
    means."""
    ce = cross_entropy_loss(student_logits, labels, mask, label_smoothing)
    if hard:
        kd = cross_entropy_loss(student_logits,
                                teacher_logits.argmax(dim=-1), mask)
    else:
        s32, t32 = student_logits.float() / tau, teacher_logits.float() / tau
        t = torch.softmax(t32, dim=-1)
        kl = (t * (torch.log_softmax(t32, dim=-1)
                   - torch.log_softmax(s32, dim=-1))).sum(dim=-1)
        kl = kl * (tau * tau)
        if mask is None:
            kd = kl.mean()
        else:
            m = mask.float()
            kd = (kl * m).sum() / m.sum().clamp_min(1.0)
    return (1.0 - alpha) * ce + alpha * kd


def distill_train_step(state: TrainState, batch, teacher_params, rng=None, *,
                       cfg: ViTConfig, teacher_cfg: ViTConfig,
                       optimizer: AdamW, alpha: float, tau: float,
                       hard: bool, label_smoothing: float = 0.0,
                       device="cuda"):
    """One distillation step (``vitx/train/distill.py:65-124``): the
    teacher's logits without gradient, the student's loss, its gradients
    and one update. ``rng`` as ``train_step`` takes it. Returns (state,
    metrics): ``loss``, ``accuracy``, ``teacher_agreement`` (the share of
    rows whose argmax is the teacher's) and ``grad_norm``."""
    dev = resolve_device(device)
    _check_on(state.params, dev)
    batch = _to_device(batch, dev)
    image, labels, mask = batch["image"], batch["label"], batch.get("mask")
    with torch.no_grad():
        teacher_logits = model_logits(teacher_params, image, teacher_cfg)
    params, wrt = trainable_params(state.params)
    deterministic = rng is None
    if cfg.distill_token:
        cls_logits, dist_logits = model_logits(
            params, image, cfg, rng=rng, deterministic=deterministic,
            heads=True)
        ce = cross_entropy_loss(cls_logits, labels, mask, label_smoothing)
        kd = distill_loss(dist_logits, teacher_logits, labels, mask,
                          alpha=1.0, tau=tau, hard=hard)
        loss = (1.0 - alpha) * ce + alpha * kd
        logits = 0.5 * (cls_logits + dist_logits)
    else:
        logits = model_logits(params, image, cfg, rng=rng,
                              deterministic=deterministic)
        loss = distill_loss(logits, teacher_logits, labels, mask,
                            alpha=alpha, tau=tau, hard=hard,
                            label_smoothing=label_smoothing)
    with torch.no_grad():
        agree = (logits.argmax(dim=-1)
                 == teacher_logits.argmax(dim=-1)).float()
        if mask is not None:
            m = mask.float()
            agree = (agree * m).sum() / m.sum().clamp_min(1.0)
        else:
            agree = agree.mean()
    return apply_gradients(state, optimizer, loss, logits, params, wrt,
                           batch, extra={"teacher_agreement": agree})


def make_distill_train_step(cfg: ViTConfig, teacher_cfg: ViTConfig,
                            optimizer: AdamW, *, alpha: float = 0.5,
                            tau: float = 1.0, hard: bool = False,
                            label_smoothing: float = 0.0, device="cuda"):
    """``step(state, batch, teacher_params, rng=None) -> (state,
    metrics)`` bound to the configs and the optimizer (a plain closure:
    vitx jits here)."""
    def step(state, batch, teacher_params, rng=None):
        return distill_train_step(
            state, batch, teacher_params, rng, cfg=cfg,
            teacher_cfg=teacher_cfg, optimizer=optimizer, alpha=alpha,
            tau=tau, hard=hard, label_smoothing=label_smoothing,
            device=device)
    return step
