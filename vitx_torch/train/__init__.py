"""Training of the port: the counterpart of ``vitx.train``."""

from vitx_torch.train.distill import (
    distill_loss,
    distill_train_step,
    make_distill_train_step,
)
from vitx_torch.train.step import (
    TrainState,
    create_train_state,
    cross_entropy_loss,
    eval_step,
    get_ema_params,
    make_eval_step,
    make_optimizer,
    make_train_step,
    make_trainable_mask,
    train_step,
    warmup_cosine,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "cross_entropy_loss",
    "distill_loss",
    "distill_train_step",
    "make_distill_train_step",
    "make_trainable_mask",
    "eval_step",
    "get_ema_params",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "train_step",
    "warmup_cosine",
]
