"""Training of the port: the counterpart of ``vitx.train``, with the
pretraining families' states and steps (``vitx_torch.nn.{mae,dino,simclr}``)."""

from vitx_torch.train.distill import (
    distill_loss,
    distill_train_step,
    make_distill_train_step,
)
from vitx_torch.nn.dino import (
    DINOConfig,
    DINOState,
    create_dino_train_state,
    make_dino_train_step,
)
from vitx_torch.nn.mae import (
    MAEConfig,
    create_mae_train_state,
    make_mae_train_step,
)
from vitx_torch.nn.simclr import (
    SimCLRConfig,
    create_simclr_train_state,
    make_simclr_train_step,
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
    "DINOConfig",
    "DINOState",
    "MAEConfig",
    "SimCLRConfig",
    "create_dino_train_state",
    "create_mae_train_state",
    "create_simclr_train_state",
    "make_dino_train_step",
    "make_mae_train_step",
    "make_simclr_train_step",
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
