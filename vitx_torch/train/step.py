"""The train and eval steps of the port.

The counterpart of ``vitx/train/step.py``: AdamW with optax's semantics
(``make_optimizer``), the cross-entropy loss, ``train_step`` and
``eval_step``, and the closures ``make_train_step`` / ``make_eval_step``
(plain Python: no jit, no ``torch.compile``). Gradients come from autograd
through the model's forward (``vitx_torch.nn.vit.model_logits``): on a CUDA
device the attention halves run K1 with its stash and their backward runs
B2 and B3, every LayerNorm backward runs B3, and ``make_optimizer(fused=
True)`` updates every leaf with one B12 launch. The unfused update is plain
torch, as it is XLA in vitx.

The state is updated in place -- vitx's jitted step donates its state
(``make_train_step``), so the same buffers are reused there too.
``train_step`` returns the state it was given, with ``step`` advanced.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.kernels.adamw import adamw_plain, fused_adamw_multi_
from vitx_torch.metrics.metrics import confusion_matrix
from vitx_torch.nn.vit import init_params, model_logits

OPTIMIZERS = ("adamw", "sgd", "lion", "adafactor")


def _not_ported(what: str, item: str = "A12"):
    return NotImplementedError(
        f"{what} is not ported to vitx_torch yet (ROADMAP {item})")


class TrainState(NamedTuple):
    """The training state: the global step, the parameter tree and the
    optimizer state (``vitx/train/step.py:27-31``)."""
    step: int
    params: dict
    opt_state: Any


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState`` / vitx's ``FusedAdamWState``: steps
    applied, and fp32 first and second moments shaped like the params;
    with ``ema_decay``, ``ema`` holds vitx's ``EmaState`` shadow of the
    params (``vitx/train/step.py:42-69``), else None."""
    count: int
    mu: dict
    nu: dict
    ema: dict | None = None


def leaves(tree) -> list:
    """The tensors of a nested dict, keys sorted at every level (the order
    of ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# The leaves weight decay touches under ``wd_exclude``: the matrix weights
# (``vitx/train/step.py:157-172``, timm's no-decay rule). Biases, norm
# scales, LayerScale gains and token / positional embeddings are exempt.
WD_DECAY_LEAVES = frozenset({
    "kernel", "wqkv", "wo", "w1", "w2", "w3", "w",
    "wq", "wk", "wv", "wo_p", "mw1", "mw2", "ew1", "ew2", "phi",
})


def weight_decay_mask(params) -> list:
    """One bool per leaf of ``leaves(params)``: True where weight decay
    applies under ``wd_exclude`` (vitx's ``weight_decay_mask``)."""
    def names(tree, last=""):
        if isinstance(tree, dict):
            return [n for k in sorted(tree) for n in names(tree[k], k)]
        return [last]
    return [n in WD_DECAY_LEAVES or n.startswith("lora_")
            for n in names(params)]


def get_ema_params(opt_state):
    """The EMA shadow params of an ``AdamWState``, or None when the
    optimizer keeps none (``vitx/train/step.py:139-146``)."""
    return getattr(opt_state, "ema", None)


def global_norm(tensors) -> torch.Tensor:
    """fp32 sqrt of the sum of squares over all tensors (optax's
    ``global_norm``), summed leaf by leaf in order."""
    total = None
    for t in tensors:
        s = t.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


class AdamW:
    """AdamW with optax's semantics (``optax.adamw``: scale_by_adam ->
    add_decayed_weights -> scale_by_learning_rate, then apply_updates):

        p <- p - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)

    b1 0.9, b2 0.999, eps 1e-8, eps_root 0, decay on every leaf (on the
    matrix weights only with ``wd_exclude``, ``weight_decay_mask``); the
    learning rate (or schedule) is read at the pre-increment count, the bias
    corrections at the incremented one. ``grad_clip`` first scales the
    gradients to that global norm when they exceed it. ``ema_decay`` keeps
    an fp32 exponential moving average of the updated params in the state,
    last in the chain as vitx's ``params_ema``: ema <- decay * ema +
    (1 - decay) * p. ``fused`` updates
    every leaf in one in-place pass, one launch a step per gradient dtype
    (B12, ``fused_adamw_multi_``), with the order of operations of
    ``vitx/kernels/adamw.py:46-53``; otherwise the same
    arithmetic runs as plain torch (``adamw_plain``). Either way ``update``
    writes the params and moments in place and returns them.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float = 1e-4, weight_decay: float = 1e-4,
                 schedule: Callable | None = None,
                 grad_clip: float | None = None, fused: bool = False,
                 ema_decay: float | None = None, wd_exclude: bool = False):
        if fused and (ema_decay is not None or wd_exclude):
            raise ValueError("the fused update (B12) takes neither "
                             "ema_decay nor wd_exclude")
        self.lr, self.weight_decay = lr, weight_decay
        self.schedule, self.grad_clip, self.fused = schedule, grad_clip, fused
        self.ema_decay, self.wd_exclude = ema_decay, wd_exclude

    def init(self, params) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        ema = None
        if self.ema_decay is not None:
            ema = tree_map(lambda p: p.detach().float().clone(), params)
        return AdamWState(count=0, mu=zeros,
                          nu=tree_map(torch.clone, zeros), ema=ema)

    def learning_rate(self, count: int) -> float:
        """The step size at ``count`` steps applied, as fp32."""
        if self.schedule is None:
            return float(np.float32(self.lr))
        return float(np.float32(self.schedule(count)))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step over matching trees (or leaf lists, in ``leaves``
        order) of grads and params -> (params, new state)."""
        gl = grads if isinstance(grads, list) else leaves(grads)
        pl, ml, nl = leaves(params), leaves(state.mu), leaves(state.nu)
        if self.grad_clip is not None:
            g_norm = global_norm(gl)
            keep = g_norm < self.grad_clip
            gl = [torch.where(keep, g, (g / g_norm.to(g.dtype))
                              * self.grad_clip) for g in gl]
        lr = self.learning_rate(state.count)
        count = state.count + 1
        f32 = np.float32
        c1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        c2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        kw = dict(lr=lr, c1=c1, c2=c2, b1=self.b1, b2=self.b2, eps=self.eps,
                  wd=self.weight_decay)
        if self.fused:
            fused_adamw_multi_(pl, gl, ml, nl, **kw)
        else:
            decays = (weight_decay_mask(params) if self.wd_exclude
                      else [True] * len(pl))
            for p, g, mu, nu, dec in zip(pl, gl, ml, nl, decays):
                p2, mu2, nu2 = adamw_plain(
                    p, g, mu, nu, **dict(kw, wd=kw["wd"] if dec else 0.0))
                p.copy_(p2)
                mu.copy_(mu2)
                nu.copy_(nu2)
        if state.ema is not None:
            f32 = np.float32
            d, rest = float(f32(self.ema_decay)), float(
                f32(1.0 - self.ema_decay))
            for e, p in zip(leaves(state.ema), pl):
                e.copy_(e * d + p.float() * rest)
        return params, state._replace(count=count)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-4,
                   schedule=None, grad_clip: float | None = None,
                   accum_steps: int = 1, fused: bool | str = "auto",
                   ema_decay: float | None = None,
                   llrd: float | None = None, llrd_depth: int | None = None,
                   optimizer: str = "adamw", trainable: str | None = None,
                   mu_dtype: str | None = None,
                   wd_exclude: bool = False) -> AdamW:
    """AdamW as vitx builds it (``vitx/train/step.py:175-287``), with the
    same defaults: lr 1e-4, weight decay 1e-4 on every leaf (the matrix
    weights only with ``wd_exclude``), an optional ``schedule`` (e.g.
    ``warmup_cosine``), ``grad_clip`` (global norm) and ``ema_decay`` (the
    params' EMA in the state). ``fused=True`` routes the update to B12
    under vitx's conditions (``step.py:225-228``): every knob below at its
    default, no EMA and no ``wd_exclude``; otherwise, and with ``"auto"``
    or False, the plain update runs. The other optimizers and knobs are
    not ported yet and raise."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"have {', '.join(OPTIMIZERS)}")
    if mu_dtype is not None and optimizer != "adamw":
        raise ValueError("mu_dtype applies to the adamw moments only")
    unported = (
        (optimizer != "adamw", f"optimizer={optimizer!r}"),
        (accum_steps > 1, "gradient accumulation (accum_steps > 1)"),
        (llrd is not None or llrd_depth is not None,
         "layer-wise lr decay (llrd)"),
        (trainable not in (None, "all"), f"trainable={trainable!r}"),
        (mu_dtype is not None, "mu_dtype"),
    )
    for cond, what in unported:
        if cond:
            raise _not_ported(what)
    use_fused = fused is True and ema_decay is None and not wd_exclude
    return AdamW(lr=lr, weight_decay=weight_decay, schedule=schedule,
                 grad_clip=grad_clip, fused=use_fused, ema_decay=ema_decay,
                 wd_exclude=wd_exclude)


def warmup_cosine(lr: float, total_steps: int, warmup_steps: int = 0,
                  end_lr_ratio: float = 0.0):
    """Linear warmup -> cosine decay (``vitx/train/step.py:290-297``):
    optax's ``warmup_cosine_decay_schedule(0, lr, max(warmup_steps, 1),
    max(total_steps, warmup_steps + 1), lr * end_lr_ratio)``, in fp32.
    Returns ``count -> learning rate``."""
    f32 = np.float32
    warm = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warm
    if decay <= 0:
        raise ValueError(f"the cosine part needs positive decay steps, got "
                         f"{decay} (total_steps={total_steps}, "
                         f"warmup_steps={warmup_steps})")
    end = lr * end_lr_ratio
    alpha = 0.0 if lr == 0.0 else end / lr

    def schedule(count: int):
        if count < warm:                       # linear_schedule(0 -> lr)
            frac = f32(1.0) - f32(min(max(count, 0), warm)) / f32(warm)
            return f32(0.0 - lr) * frac + f32(lr)
        c = f32(min(count - warm, decay))      # cosine_decay_schedule
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / f32(decay)))
        return f32(lr) * (f32(1.0 - alpha) * cosine + f32(alpha))

    return schedule


def create_train_state(rng, cfg: ViTConfig, optimizer: AdamW, *,
                       device="cuda") -> TrainState:
    """Fresh parameters (``init_params``; ``rng`` a ``torch.Generator`` or
    an int seed) on ``device`` -- a CUDA device by default, raising when
    there is none -- and the optimizer's zero state."""
    params = init_params(rng, cfg, device=device)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def cross_entropy_loss(logits, labels, mask=None, label_smoothing=0.0,
                       class_weights=None):
    """Mean softmax cross-entropy in fp32 (``vitx/train/step.py:307-344``):
    ``mask`` (0/1 per row) excludes padding rows from the mean;
    ``label_smoothing`` mixes in the uniform target; ``class_weights`` (C,)
    scale each row by its target class's weight and normalise by their
    sum."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    denom_w = None
    if class_weights is None:
        if label_smoothing:
            s = label_smoothing
            nll = (1.0 - s) * nll + s * (-logp.mean(dim=-1))
    else:
        w = torch.as_tensor(class_weights, dtype=torch.float32,
                            device=logits.device)
        wy = w[labels]
        if label_smoothing:
            s = label_smoothing
            C = logp.shape[-1]
            nll = ((1.0 - s) * wy * nll
                   + (s / C) * (w[None, :] * (-logp)).sum(dim=-1))
        else:
            nll = wy * nll
        denom_w = wy
    if mask is None:
        if denom_w is None:
            return nll.mean()
        return nll.sum() / denom_w.sum().clamp_min(1e-9)
    mask = mask.float()
    denom = mask.sum() if denom_w is None else (denom_w * mask).sum()
    return (nll * mask).sum() / denom.clamp_min(1e-9)


def loss_fn(params, batch, cfg: ViTConfig, rng=None, *,
            label_smoothing: float = 0.0, mixup_alpha: float | None = None,
            cutmix_alpha: float | None = None, class_weights=None,
            loss: str = "ce"):
    """-> (loss, logits) (``vitx/train/step.py:399-455``). Dropout and
    drop-path run when ``rng`` (a ``torch.Generator``) is given. As in
    vitx, ``fuse_mlp="auto"`` becomes "off" under grad: the MLP halves
    train through torch products, K2 only with ``fuse_mlp="on"``."""
    if cfg.fuse_mlp == "auto":
        cfg = cfg.replace(fuse_mlp="off")
    if loss == "bce":
        raise _not_ported("the multi-label loss (loss='bce')")
    if loss != "ce":
        raise ValueError(f"unknown loss {loss!r} (have 'ce', 'bce')")
    if mixup_alpha or cutmix_alpha:
        raise _not_ported("mixup / cutmix")
    logits = model_logits(params, batch["image"], cfg, rng=rng,
                          deterministic=rng is None)
    loss_v = cross_entropy_loss(logits, batch["label"], batch.get("mask"),
                                label_smoothing, class_weights)
    return loss_v, logits


def _to_device(batch, dev) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
        out[k] = t.to(dev)
    return out


def _check_on(params, dev: torch.device):
    for t in leaves(params):
        if t.device.type != dev.type:
            raise ValueError(f"the train state lives on {t.device}, the step "
                             f"was asked to run on {dev}")


def train_step(state: TrainState, batch, rng=None, *, cfg: ViTConfig,
               optimizer: AdamW, device="cuda",
               label_smoothing: float = 0.0,
               mixup_alpha: float | None = None,
               cutmix_alpha: float | None = None,
               sam_rho: float | None = None, class_weights=None,
               grad_shardings=None, train_filter: str | None = None,
               loss: str = "ce"):
    """One optimizer step (``vitx/train/step.py:458-547``). ``batch``:
    {"image": (B, H, W, C), "label": (B,), optional "mask": (B,) 0/1},
    numpy or tensors. ``rng``: a ``torch.Generator`` on ``device`` for
    dropout/drop-path, or None for a deterministic step. The state must
    live on ``device`` (a CUDA device by default). Updates the state's
    tensors in place; returns (state, metrics) with fp32 0-dim tensors
    ``loss``, ``accuracy`` and ``grad_norm`` (the gradients' global norm,
    before clipping) left on the device."""
    dev = resolve_device(device)
    if sam_rho:
        raise _not_ported("sharpness-aware minimization (sam_rho)")
    if train_filter not in (None, "all"):
        raise _not_ported(f"train_filter={train_filter!r}")
    if grad_shardings is not None:
        raise _not_ported("sharded gradients (grad_shardings)", "A13")
    _check_on(state.params, dev)
    batch = _to_device(batch, dev)
    params = tree_map(lambda t: t.detach().requires_grad_(), state.params)
    loss_v, logits = loss_fn(params, batch, cfg, rng,
                             label_smoothing=label_smoothing,
                             mixup_alpha=mixup_alpha,
                             cutmix_alpha=cutmix_alpha,
                             class_weights=class_weights, loss=loss)
    grads = torch.autograd.grad(loss_v, leaves(params))
    grad_norm = global_norm(grads)
    new_params, opt_state = optimizer.update(list(grads), state.opt_state,
                                             state.params)
    with torch.no_grad():
        correct = (logits.argmax(dim=-1) == batch["label"].long()).float()
        if "mask" in batch:
            m = batch["mask"].float()
            acc = (correct * m).sum() / m.sum().clamp_min(1.0)
        else:
            acc = correct.mean()
    metrics = {"loss": loss_v.detach(), "accuracy": acc,
               "grad_norm": grad_norm}
    return TrainState(step=state.step + 1, params=new_params,
                      opt_state=opt_state), metrics


@torch.no_grad()
def eval_step(params, batch, *, cfg: ViTConfig, device="cuda"):
    """Forward + confusion matrix for one batch -> (cm (C, C) int32, loss)
    (``vitx/train/step.py:550-568``); ``batch["mask"]`` excludes padding
    rows."""
    dev = resolve_device(device)
    _check_on(params, dev)
    batch = _to_device(batch, dev)
    logits = model_logits(params, batch["image"], cfg)
    preds = logits.argmax(dim=-1)
    labels = batch["label"].long()
    C = cfg.num_classes
    if "mask" in batch:
        # padded rows go to (pred 0, label 0) and are subtracted there
        mask = batch["mask"].long()
        cm = confusion_matrix(preds * mask, labels * mask, C)
        cm[0, 0] -= (1 - mask).sum().to(cm.dtype)
    else:
        cm = confusion_matrix(preds, labels, C)
    loss = cross_entropy_loss(logits, labels, batch.get("mask"))
    return cm, loss


def make_train_step(cfg: ViTConfig, optimizer: AdamW, *, device="cuda",
                    label_smoothing: float = 0.0,
                    mixup_alpha: float | None = None,
                    cutmix_alpha: float | None = None,
                    sam_rho: float | None = None, class_weights=None,
                    train_filter: str | None = None, loss: str = "ce"):
    """``(state, batch, rng=None) -> (state, metrics)`` bound to the config
    and optimizer (a plain closure: vitx jits here)."""
    def step(state, batch, rng=None):
        return train_step(state, batch, rng, cfg=cfg, optimizer=optimizer,
                          device=device, label_smoothing=label_smoothing,
                          mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                          sam_rho=sam_rho, class_weights=class_weights,
                          train_filter=train_filter, loss=loss)
    return step


def make_eval_step(cfg: ViTConfig, *, device="cuda"):
    """``(params, batch) -> (cm, loss)`` bound to the config."""
    def step(params, batch):
        return eval_step(params, batch, cfg=cfg, device=device)
    return step
