"""The train and eval steps of the port.

The counterpart of ``vitx/train/step.py``: AdamW with optax's semantics
(``make_optimizer``), the cross-entropy loss, ``train_step`` and
``eval_step``, and the closures ``make_train_step`` / ``make_eval_step``
(plain Python: no jit, no ``torch.compile``); the fine-tuning knobs of
vitx's chain: a freeze policy (``make_trainable_mask``: LoRA, head-only),
layer-wise lr decay, gradient accumulation as ``optax.MultiSteps`` and
mixup / cutmix. Gradients come from autograd
through the model's forward (``vitx_torch.nn.vit.model_logits``): on a CUDA
device the attention halves run K1 with its stash and their backward runs
B2 and B3, every LayerNorm backward runs B3, and ``make_optimizer(fused=
True)`` updates every leaf with one B12 launch (vitx's conditions: no
LLRD, accumulation or freeze). The unfused update is plain torch, as it
is XLA in vitx. Frozen leaves enter the loss without ``requires_grad``,
the counterpart of vitx's ``lax.stop_gradient``: autograd forms none of
their products (K1's and K2's backward skip them too).

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
    """optax's ``ScaleByAdamState`` / vitx's ``FusedAdamWState``: updates
    applied, and fp32 first and second moments shaped like the params --
    like the trainable ones only under a freeze policy (``optax.masked``
    keeps none for frozen leaves); with ``ema_decay``, ``ema`` holds
    vitx's ``EmaState`` shadow of every param (``vitx/train/step.py:42-69``),
    else None. With ``accum_steps`` k > 1, optax's ``MultiStepsState``:
    ``acc`` the running mean of the micro-batches' gradients (every leaf)
    and ``mini_step`` the micro-batches in it; ``count`` is its
    ``gradient_step`` too."""
    count: int
    mu: dict
    nu: dict
    ema: dict | None = None
    acc: dict | None = None
    mini_step: int = 0


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


def leaf_paths(tree, prefix=()) -> list:
    """The key paths of ``leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in leaf_paths(tree[k],
                                                            prefix + (k,))]
    return [prefix]


def prune(tree, flags: list):
    """The sub-tree of ``tree`` holding the leaves whose flag (one per leaf
    of ``leaves(tree)``) is set; dicts left empty are dropped."""
    it = iter(flags)

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k in sorted(node):
                sub = walk(node[k])
                if sub is not None:
                    out[k] = sub
            return out or None
        return node if next(it) else None
    return walk(tree) or {}


HEAD_KEYS = ("head", "dist_head", "final_norm")


def make_trainable_mask(train_filter: str | None):
    """A freeze policy as a callable ``params -> list of bools``, one per
    leaf of ``leaves(params)``, True where the leaf trains
    (``vitx/train/step.py:108-137``): ``"lora"`` the adapters
    (``blocks/lora_*``) and the heads and final norm; ``"head"`` the heads
    and final norm only; None or ``"all"`` everything (returns None)."""
    if train_filter in (None, "all"):
        return None
    if train_filter not in ("lora", "head"):
        raise ValueError(f"unknown train_filter {train_filter!r}; "
                         "have 'lora', 'head', 'all'/None")

    def mask(params) -> list:
        return [path[0] in HEAD_KEYS
                or (train_filter == "lora" and path[0] == "blocks"
                    and path[-1].startswith("lora_"))
                for path in leaf_paths(params)]
    return mask


def trainable_flags(params, train_filter: str | None) -> list:
    """``make_trainable_mask(train_filter)(params)``, all True without a
    policy."""
    mask = make_trainable_mask(train_filter)
    return [True] * len(leaves(params)) if mask is None else mask(params)


def check_llrd_depth(params, depth: int) -> None:
    """vitx's layer-wise decay factors span the whole depth, so a Soft-MoE
    model, whose ``blocks`` hold only its dense blocks, fails there (a
    shape error at the first or second step); here it raises
    ``ValueError``."""
    for path, p in zip(leaf_paths(params), leaves(params)):
        if path[0] == "blocks" and p.shape[0] != depth:
            raise ValueError(
                f"llrd's per-block factors span the depth {depth}, but "
                f"blocks/{path[-1]} stacks {p.shape[0]} blocks (a "
                f"Soft-MoE model's dense blocks): vitx's layer-wise "
                f"decay does not take Soft-MoE models")


def llrd_factors(params, decay: float, depth: int) -> list:
    """Layer-wise lr decay (``vitx/train/step.py:71-106``, the BEiT/MAE
    fine-tune recipe): one factor per leaf of ``leaves(params)`` -- for a
    stacked block leaf an fp32 (depth, 1, ...) tensor of decay**(depth -
    l) for block l, 1 (None) for the heads and final norm, and
    decay**(depth + 1) for everything else (the patch embedding, the CLS,
    distillation and register tokens, the positional table, a Soft-MoE
    model's ``moe_blocks``, as vitx's rule has it). A Soft-MoE tree raises
    (``check_llrd_depth``)."""
    check_llrd_depth(params, depth)
    block = torch.tensor([decay ** (depth - i) for i in range(depth)],
                         dtype=torch.float32)
    embed = torch.tensor(decay ** (depth + 1), dtype=torch.float32)
    out = []
    for path, p in zip(leaf_paths(params), leaves(params)):
        if path[0] == "blocks":
            f = block.reshape((depth,) + (1,) * (p.dim() - 1))
        elif path[0] in HEAD_KEYS:
            f = None
        else:
            f = embed
        out.append(None if f is None else f.to(p.device))
    return out


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
    return [p[-1] in WD_DECAY_LEAVES or p[-1].startswith("lora_")
            for p in leaf_paths(params)]


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
    gradients to that global norm when they exceed it. ``trainable`` (a
    ``make_trainable_mask`` policy) keeps moments, weight decay and steps
    for the trainable leaves only and leaves the frozen ones bit-unchanged
    (vitx's ``optax.masked`` pair). ``llrd`` multiplies each leaf's whole
    update by its ``llrd_factors`` factor, after AdamW as vitx's chain
    does. ``ema_decay`` keeps
    an fp32 exponential moving average of the updated params in the state,
    last in the chain as vitx's ``params_ema``: ema <- decay * ema +
    (1 - decay) * p. ``accum_steps`` k > 1 is ``optax.MultiSteps``: each
    call folds its gradients into a running mean (Welford's form, as
    optax), and every k-th runs the chain above on that mean and clears
    it; the other calls leave the params as they are. ``fused`` updates
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
                 ema_decay: float | None = None, wd_exclude: bool = False,
                 trainable: str | None = None, llrd: float | None = None,
                 llrd_depth: int | None = None, accum_steps: int = 1):
        if fused and (ema_decay is not None or wd_exclude
                      or trainable not in (None, "all") or llrd is not None
                      or accum_steps > 1):
            raise ValueError("the fused update (B12) takes neither "
                             "ema_decay, wd_exclude, a freeze policy, llrd "
                             "nor accumulation")
        if llrd is not None and llrd_depth is None:
            raise ValueError("llrd requires llrd_depth (the encoder depth)")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        make_trainable_mask(trainable)          # validates the policy
        self.lr, self.weight_decay = lr, weight_decay
        self.schedule, self.grad_clip, self.fused = schedule, grad_clip, fused
        self.ema_decay, self.wd_exclude = ema_decay, wd_exclude
        self.trainable = None if trainable == "all" else trainable
        self.llrd, self.llrd_depth = llrd, llrd_depth
        self.accum_steps = accum_steps

    def init(self, params) -> AdamWState:
        if self.llrd is not None:
            check_llrd_depth(params, self.llrd_depth)
        train = prune(params, trainable_flags(params, self.trainable))
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         train)
        ema = acc = None
        if self.ema_decay is not None:
            ema = tree_map(lambda p: p.detach().float().clone(), params)
        if self.accum_steps > 1:
            acc = tree_map(lambda p: torch.zeros_like(p), params)
        return AdamWState(count=0, mu=zeros,
                          nu=tree_map(torch.clone, zeros), ema=ema, acc=acc)

    def learning_rate(self, count: int) -> float:
        """The step size at ``count`` steps applied, as fp32."""
        if self.schedule is None:
            return float(np.float32(self.lr))
        return float(np.float32(self.schedule(count)))

    def update_kw(self, count: int) -> dict:
        """The scalars of the update after ``count`` steps applied, as
        ``adamw_plain`` and B12 take them: the step size, the bias
        corrections at step count + 1 (fp32), the betas, eps and wd."""
        f32 = np.float32
        n = f32(count + 1)
        return dict(lr=self.learning_rate(count),
                    c1=float(f32(1.0) - f32(self.b1) ** n),
                    c2=float(f32(1.0) - f32(self.b2) ** n),
                    b1=self.b1, b2=self.b2, eps=self.eps,
                    wd=self.weight_decay)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step over matching trees (or leaf lists, in ``leaves``
        order) of grads and params -> (params, new state). A frozen leaf's
        gradient may be None (a train step computes none); a trainable
        leaf's None counts as zeros, vitx's ``stop_gradient`` gradient."""
        gl = grads if isinstance(grads, list) else leaves(grads)
        pl = leaves(params)
        flags = trainable_flags(params, self.trainable)
        gl = [torch.zeros_like(p) if g is None and f else g
              for g, p, f in zip(gl, pl, flags)]
        if self.accum_steps > 1:
            n = state.mini_step
            accs = leaves(state.acc)
            for a, g in zip(accs, gl):
                if g is not None:     # a frozen leaf's mean stays zero
                    div = torch.full((), n + 1, dtype=torch.float32,
                                     device=a.device)
                    a.copy_(a + (g.to(a.dtype) - a) / div)
            if n + 1 < self.accum_steps:
                return params, state._replace(mini_step=n + 1)
            gl = [a.clone() if f else None for a, f in zip(accs, flags)]
            for a in accs:
                a.zero_()
            state = state._replace(mini_step=0)
        if self.grad_clip is not None:
            g_norm = global_norm([g for g in gl if g is not None])
            keep = g_norm < self.grad_clip
            gl = [None if g is None else torch.where(
                keep, g, (g / g_norm.to(g.dtype)) * self.grad_clip)
                for g in gl]
        kw = self.update_kw(state.count)
        ml, nl = leaves(state.mu), leaves(state.nu)
        if self.fused:
            fused_adamw_multi_(pl, gl, ml, nl, **kw)
        else:
            decays = (weight_decay_mask(params) if self.wd_exclude
                      else [True] * len(pl))
            factors = (llrd_factors(params, self.llrd, self.llrd_depth)
                       if self.llrd is not None else [None] * len(pl))
            moments = iter(zip(ml, nl))
            for p, g, dec, f, on in zip(pl, gl, decays, factors, flags):
                if not on:
                    continue
                mu, nu = next(moments)
                p2, mu2, nu2 = adamw_plain(
                    p, g, mu, nu, factor=f,
                    **dict(kw, wd=kw["wd"] if dec else 0.0))
                p.copy_(p2)
                mu.copy_(mu2)
                nu.copy_(nu2)
        if state.ema is not None:
            f32 = np.float32
            d, rest = float(f32(self.ema_decay)), float(
                f32(1.0 - self.ema_decay))
            for e, p in zip(leaves(state.ema), pl):
                e.copy_(e * d + p.float() * rest)
        return params, state._replace(count=state.count + 1)


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
    ``warmup_cosine``), ``grad_clip`` (global norm), ``ema_decay`` (the
    params' EMA in the state), ``trainable`` (a freeze policy, vitx's
    ``optax.masked``), ``llrd`` with ``llrd_depth`` (layer-wise lr decay)
    and ``accum_steps`` (``optax.MultiSteps``). ``fused=True`` routes the
    update to B12 under vitx's conditions (``step.py:225-228``): no EMA,
    ``wd_exclude``, freeze, LLRD or accumulation; otherwise, and with
    ``"auto"`` or False, the plain update runs. The other optimizers and
    ``mu_dtype`` are not ported yet and raise."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"have {', '.join(OPTIMIZERS)}")
    if mu_dtype is not None and optimizer != "adamw":
        raise ValueError("mu_dtype applies to the adamw moments only")
    unported = (
        (optimizer != "adamw", f"optimizer={optimizer!r}"),
        (mu_dtype is not None, "mu_dtype"),
    )
    for cond, what in unported:
        if cond:
            raise _not_ported(what)
    use_fused = (fused is True and accum_steps == 1 and ema_decay is None
                 and llrd is None and trainable in (None, "all")
                 and not wd_exclude)
    return AdamW(lr=lr, weight_decay=weight_decay, schedule=schedule,
                 grad_clip=grad_clip, fused=use_fused, ema_decay=ema_decay,
                 wd_exclude=wd_exclude, trainable=trainable,
                 llrd=llrd, llrd_depth=llrd_depth, accum_steps=accum_steps)


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


def _host_rng(gen: torch.Generator) -> np.random.Generator:
    """A numpy generator seeded from ``gen``'s next draw: the mixing
    coefficients (Beta draws, which torch's generators do not give) come
    from the step's own generator."""
    seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device=gen.device)
    return np.random.default_rng(int(seed))


def _cutmix_weight_map(rs: np.random.Generator, height: int, width: int,
                       alpha: float, device) -> torch.Tensor:
    """CutMix's (1, H, W, 1) keep map (``vitx/train/step.py:361-377``): 1
    outside a box of expected area 1 - Beta(alpha, alpha), centred at a
    uniform point and clipped at the borders, 0 inside."""
    lam = rs.beta(alpha, alpha)
    cut = np.float32(np.sqrt(1.0 - lam))
    cy = np.float32(rs.uniform(0.0, height))
    cx = np.float32(rs.uniform(0.0, width))
    y0, y1 = cy - cut * height / 2, cy + cut * height / 2
    x0, x1 = cx - cut * width / 2, cx + cut * width / 2
    rows = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    inside = (rows >= float(y0)) & (rows < float(y1)) & \
        (cols >= float(x0)) & (cols < float(x1))
    return 1.0 - inside.float()[None, :, :, None]


def mix_weight_map(gen: torch.Generator, image_shape, mixup_alpha,
                   cutmix_alpha, device) -> torch.Tensor:
    """(1, H, W, 1) fp32 keep map for input and target mixing
    (``vitx/train/step.py:380-397``): mixup alone a constant Beta(a, a)
    map, cutmix alone a box map, both a 50/50 switch per batch (DeiT's
    ``mixup_switch_prob``); the target weight is the map's mean either
    way. Drawn from ``gen`` (threefry's Beta draws cannot be matched)."""
    _, height, width, _ = image_shape
    rs = _host_rng(gen)
    use_cut = bool(cutmix_alpha) and (not mixup_alpha or rs.random() < 0.5)
    if use_cut:
        return _cutmix_weight_map(rs, height, width, cutmix_alpha, device)
    lam = float(np.float32(rs.beta(mixup_alpha, mixup_alpha)))
    return torch.full((1, height, width, 1), lam, dtype=torch.float32,
                      device=device)


def loss_fn(params, batch, cfg: ViTConfig, rng=None, *,
            label_smoothing: float = 0.0, mixup_alpha: float | None = None,
            cutmix_alpha: float | None = None, class_weights=None,
            loss: str = "ce", mix=None):
    """-> (loss, logits) (``vitx/train/step.py:399-455``). Dropout and
    drop-path run when ``rng`` (a ``torch.Generator``) is given. As in
    vitx, ``fuse_mlp="auto"`` becomes "off" under grad: the MLP halves
    train through torch products, K2 only with ``fuse_mlp="on"``.

    With ``mixup_alpha`` or ``cutmix_alpha`` and a generator, the images
    mix with a permutation of the batch through ``mix_weight_map``'s map
    w, in fp32: w * x + (1 - w) * x[perm], and the loss is lam * CE(labels)
    + (1 - lam) * CE(labels[perm]) with lam = mean(w). ``mix`` = (perm,
    w) replaces the draws, so that a test can feed vitx's."""
    if cfg.fuse_mlp == "auto":
        cfg = cfg.replace(fuse_mlp="off")
    if loss == "bce":
        raise _not_ported("the multi-label loss (loss='bce')")
    if loss != "ce":
        raise ValueError(f"unknown loss {loss!r} (have 'ce', 'bce')")
    image, mask = batch["image"], batch.get("mask")
    if (mixup_alpha or cutmix_alpha) and (rng is not None or mix is not None):
        if mix is None:
            perm = torch.randperm(image.shape[0], generator=rng,
                                  device=rng.device).to(image.device)
            w = mix_weight_map(rng, image.shape, mixup_alpha, cutmix_alpha,
                               image.device)
        else:
            perm, w = (torch.as_tensor(np.array(t) if not torch.is_tensor(t)
                                       else t).to(image.device) for t in mix)
            perm = perm.long()
        lam = w.float().mean()
        image = (w * image.float() + (1.0 - w) * image[perm].float()
                 ).to(image.dtype)
        logits = model_logits(params, image, cfg, rng=rng,
                              deterministic=rng is None)
        labels = batch["label"].long()
        loss_v = (lam * cross_entropy_loss(logits, labels, mask,
                                           label_smoothing, class_weights)
                  + (1.0 - lam) * cross_entropy_loss(
                      logits, labels[perm], mask, label_smoothing,
                      class_weights))
        return loss_v, logits
    logits = model_logits(params, image, cfg, rng=rng,
                          deterministic=rng is None)
    loss_v = cross_entropy_loss(logits, batch["label"], mask,
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
               loss: str = "ce", mix=None):
    """One optimizer step (``vitx/train/step.py:458-547``). ``batch``:
    {"image": (B, H, W, C), "label": (B,), optional "mask": (B,) 0/1},
    numpy or tensors. ``rng``: a ``torch.Generator`` on ``device`` for
    dropout/drop-path and mixing, or None for a deterministic step
    (``mix`` as ``loss_fn`` takes it). The state must live on ``device``
    (a CUDA device by default). ``train_filter`` ("lora", "head"): the
    frozen leaves enter the loss without ``requires_grad`` and get no
    gradient (vitx's ``stop_gradient``); pair it with an optimizer of the
    same ``trainable``. Updates the state's tensors in place; returns
    (state, metrics) with fp32 0-dim tensors ``loss``, ``accuracy`` and
    ``grad_norm`` (the gradients' global norm, before clipping) left on
    the device."""
    dev = resolve_device(device)
    if sam_rho:
        raise _not_ported("sharpness-aware minimization (sam_rho)")
    if grad_shardings is not None:
        raise _not_ported("sharded gradients (grad_shardings)", "A13")
    _check_on(state.params, dev)
    batch = _to_device(batch, dev)
    params, wrt = trainable_params(state.params, train_filter)
    loss_v, logits = loss_fn(params, batch, cfg, rng,
                             label_smoothing=label_smoothing,
                             mixup_alpha=mixup_alpha,
                             cutmix_alpha=cutmix_alpha,
                             class_weights=class_weights, loss=loss, mix=mix)
    return apply_gradients(state, optimizer, loss_v, logits, params, wrt,
                           batch)


def trainable_params(params, train_filter: str | None = None):
    """-> (the params to differentiate, ``trainable_flags``' list): the
    trainable leaves detached with ``requires_grad``, the frozen ones
    detached without."""
    flags = trainable_flags(params, train_filter)
    it = iter(flags)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return node.detach().requires_grad_(next(it))
    return walk(params), flags


def apply_gradients(state: TrainState, optimizer: AdamW, loss_v, logits,
                    params, wrt: list, batch: dict,
                    extra: dict | None = None):
    """The gradients of ``loss_v`` for the leaves of ``params`` (the tree
    the loss read) flagged in ``wrt`` (None for the rest), one optimizer
    update of the state, and the step's metrics -> (state, metrics):
    ``loss``, ``accuracy`` of ``logits`` against ``batch["label"]``
    (masked), ``grad_norm``, and ``extra``'s entries."""
    req = [t for t, w in zip(leaves(params), wrt) if w]
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        req, torch.autograd.grad(loss_v, req, allow_unused=True))]
    grad_norm = global_norm(grads)
    it = iter(grads)
    full = [next(it) if w else None for w in wrt]
    new_params, opt_state = optimizer.update(full, state.opt_state,
                                             state.params)
    with torch.no_grad():
        correct = (logits.argmax(dim=-1) == batch["label"].long()).float()
        if "mask" in batch:
            m = batch["mask"].float()
            acc = (correct * m).sum() / m.sum().clamp_min(1.0)
        else:
            acc = correct.mean()
    metrics = {"loss": loss_v.detach(), "accuracy": acc,
               "grad_norm": grad_norm, **(extra or {})}
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
