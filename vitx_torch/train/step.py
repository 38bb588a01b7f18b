"""The train and eval steps of the port.

The counterpart of ``vitx/train/step.py``: the optimizers with optax's
semantics (``make_optimizer``: AdamW, with its first moment in bf16 under
``mu_dtype``, SGD with momentum, Lion and Adafactor, each a small state
class in plain torch), the cross-entropy and multi-label (sigmoid BCE)
losses, ``train_step`` (with sharpness-aware minimization, ``sam_rho``)
and ``eval_step``, and the closures ``make_train_step`` /
``make_eval_step`` (plain Python: no jit, no ``torch.compile``); the
fine-tuning knobs of vitx's chain, which compose with every optimizer: a
freeze policy (``make_trainable_mask``: LoRA, head-only), layer-wise lr
decay, gradient accumulation as ``optax.MultiSteps`` and mixup / cutmix.
Gradients come from autograd through the model's forward
(``vitx_torch.nn.vit.model_logits``): on a CUDA device the attention
halves run K1 with its stash and their backward runs B2 and B3, every
LayerNorm backward runs B3, and ``make_optimizer(fused=True)`` updates
every leaf with one B12 launch (vitx's conditions: AdamW without
``mu_dtype``, LLRD, accumulation or freeze). Every other update is plain
torch, as it is XLA in vitx. Frozen leaves enter the loss without
``requires_grad``, the counterpart of vitx's ``lax.stop_gradient``:
autograd forms none of their products (K1's and K2's backward skip them
too).

The state is updated in place -- vitx's jitted step donates its state
(``make_train_step``), so the same buffers are reused there too.
``train_step`` returns the state it was given, with ``step`` advanced.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.kernels.adamw import adamw_plain, fused_adamw_multi_
from vitx_torch.metrics.metrics import confusion_matrix
from vitx_torch.nn.vit import init_params, model_logits

class TrainState(NamedTuple):
    """The training state: the global step, the parameter tree and the
    optimizer state (``vitx/train/step.py:27-31``)."""
    step: int
    params: dict
    opt_state: Any


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState`` / vitx's ``FusedAdamWState``: updates
    applied, and the first and second moments shaped like the params (fp32;
    mu bf16 under ``mu_dtype="bfloat16"``) -- like the trainable ones only
    under a freeze policy (``optax.masked`` keeps none for frozen leaves);
    with ``ema_decay``, ``ema`` holds vitx's ``EmaState`` shadow of every
    param (``vitx/train/step.py:42-69``), else None. With ``accum_steps`` k
    > 1, optax's ``MultiStepsState``: ``acc`` the running mean of the
    micro-batches' gradients (every leaf) and ``mini_step`` the
    micro-batches in it; ``count`` is its ``gradient_step`` too. ``SLOTS``
    name the per-leaf trees in vitx's flatten order; ``COUNTED``: the
    optimizer keeps a count of its own (a schedule's count is another)."""
    count: int
    mu: dict
    nu: dict
    ema: dict | None = None
    acc: dict | None = None
    mini_step: int = 0
    SLOTS = ("mu", "nu")
    COUNTED = True


class SGDState(NamedTuple):
    """``SGD``'s state: optax's ``TraceState`` (the momentum trace, fp32,
    no count of its own: ``count`` is the port's, what a schedule and
    accumulation read), then ``AdamWState``'s ema, acc and mini_step."""
    count: int
    trace: dict
    ema: dict | None = None
    acc: dict | None = None
    mini_step: int = 0
    SLOTS = ("trace",)
    COUNTED = False


class LionState(NamedTuple):
    """``Lion``'s state: optax's ``ScaleByLionState(count, mu)``, then
    ``AdamWState``'s ema, acc and mini_step."""
    count: int
    mu: dict
    ema: dict | None = None
    acc: dict | None = None
    mini_step: int = 0
    SLOTS = ("mu",)
    COUNTED = True


class AdafactorState(NamedTuple):
    """``Adafactor``'s state: optax's ``FactoredState(count, v_row, v_col,
    v)`` -- a factored leaf's row and column moments with a (1,) ``v``, an
    unfactored leaf's full ``v`` with (1,) row and column placeholders --
    then ``AdamWState``'s ema, acc and mini_step."""
    count: int
    v_row: dict
    v_col: dict
    v: dict
    ema: dict | None = None
    acc: dict | None = None
    mini_step: int = 0
    SLOTS = ("v_row", "v_col", "v")
    COUNTED = True


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


def check_llrd_depth(params, depth: int, shapes=None) -> None:
    """vitx's layer-wise decay factors span the whole depth, so a Soft-MoE
    model, whose ``blocks`` hold only its dense blocks, fails there (a
    shape error at the first or second step); here it raises
    ``ValueError``. ``shapes``: the leaves' whole shapes where ``params``
    holds a rank's parts."""
    if shapes is None:
        shapes = [tuple(p.shape) for p in leaves(params)]
    for path, shape in zip(leaf_paths(params), shapes):
        if path[0] == "blocks" and shape[0] != depth:
            raise ValueError(
                f"llrd's per-block factors span the depth {depth}, but "
                f"blocks/{path[-1]} stacks {shape[0]} blocks (a "
                f"Soft-MoE model's dense blocks): vitx's layer-wise "
                f"decay does not take Soft-MoE models")


def llrd_factors(params, decay: float, depth: int, shards=None) -> list:
    """Layer-wise lr decay (``vitx/train/step.py:71-106``, the BEiT/MAE
    fine-tune recipe): one factor per leaf of ``leaves(params)`` -- for a
    stacked block leaf an fp32 (depth, 1, ...) tensor of decay**(depth -
    l) for block l, 1 (None) for the heads and final norm, and
    decay**(depth + 1) for everything else (the patch embedding, the CLS,
    distillation and register tokens, the positional table, a Soft-MoE
    model's ``moe_blocks``, as vitx's rule has it). A Soft-MoE tree raises
    (``check_llrd_depth``). ``shards`` (one ``LeafShard`` or None per
    leaf): where a leaf is a rank's part, its factor is that part of the
    whole leaf's (a pipeline stage's blocks)."""
    shards = shards or [None] * len(leaves(params))
    check_llrd_depth(params, depth, [
        tuple(p.shape) if sh is None else sh.shape
        for p, sh in zip(leaves(params), shards)])
    block = torch.tensor([decay ** (depth - i) for i in range(depth)],
                         dtype=torch.float32)
    embed = torch.tensor(decay ** (depth + 1), dtype=torch.float32)
    out = []
    for path, p, sh in zip(leaf_paths(params), leaves(params), shards):
        if path[0] == "blocks":
            f = block.reshape((depth,) + (1,) * (p.dim() - 1))
            if sh is not None:
                from vitx_torch.parallel import comm

                for d, axis in sh.dims.items():
                    if f.shape[d] > 1:
                        f = comm.chunk_of(f, sh.mesh, axis, d)
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


class _Chain:
    """What vitx's chain composes around each optimizer
    (``vitx/train/step.py:225-287``), shared by the four: ``grad_clip``
    first scales the gradients to that global norm when they exceed it;
    the learning rate (or ``schedule``) is read at the pre-increment
    count; weight decay on every leaf, or on the matrix weights only with
    ``wd_exclude`` (``weight_decay_mask``); ``trainable`` (a
    ``make_trainable_mask`` policy) keeps state, weight decay and steps
    for the trainable leaves only and leaves the frozen ones bit-unchanged
    (vitx's ``optax.masked`` pair); ``llrd`` multiplies each leaf's whole
    update by its ``llrd_factors`` factor, after the optimizer as vitx's
    chain does; ``ema_decay`` keeps an fp32 exponential moving average of
    the updated params in the state, last in the chain as vitx's
    ``params_ema``: ema <- decay * ema + (1 - decay) * p; ``accum_steps``
    k > 1 is ``optax.MultiSteps``: each call folds its gradients into a
    running mean (Welford's form, as optax), and every k-th runs the chain
    on that mean and clears it; the other calls leave the params as they
    are. ``update`` writes the params and the state's tensors in place and
    returns them.

    A subclass names its state (``State``, whose ``SLOTS`` are its
    per-leaf trees in vitx's flatten order and ``COUNTED`` whether the
    chain keeps a count of its own besides a schedule's), makes the slots
    of one leaf (``init_leaf``) and updates one leaf in place
    (``step_leaf``)."""

    fused = False
    State: type

    def __init__(self, lr: float = 1e-4, weight_decay: float = 1e-4,
                 schedule: Callable | None = None,
                 grad_clip: float | None = None,
                 ema_decay: float | None = None, wd_exclude: bool = False,
                 trainable: str | None = None, llrd: float | None = None,
                 llrd_depth: int | None = None, accum_steps: int = 1):
        if llrd is not None and llrd_depth is None:
            raise ValueError("llrd requires llrd_depth (the encoder depth)")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        make_trainable_mask(trainable)          # validates the policy
        self.lr, self.weight_decay = lr, weight_decay
        self.schedule, self.grad_clip = schedule, grad_clip
        self.ema_decay, self.wd_exclude = ema_decay, wd_exclude
        self.trainable = None if trainable == "all" else trainable
        self.llrd, self.llrd_depth = llrd, llrd_depth
        self.accum_steps = accum_steps

    def init_leaf(self, p, alloc) -> tuple:
        """The state slots of one trainable leaf, made by ``alloc(shape,
        dtype)``."""
        raise NotImplementedError

    def init(self, params, alloc=None):
        """The zero state of ``params``. ``alloc(shape, dtype, like)``
        makes each slot tensor (zeros on the leaf's device by default; a
        checkpoint template passes one that allocates nothing)."""
        if self.llrd is not None:
            check_llrd_depth(params, self.llrd_depth)
        if alloc is None:
            def alloc(shape, dtype, like):
                return torch.zeros(shape, dtype=dtype, device=like.device)
        train = prune(params, trainable_flags(params, self.trainable))
        per_leaf = tree_map(
            lambda p: self.init_leaf(p, lambda s, d: alloc(s, d, p)), train)
        slots = {name: tree_map(lambda t, i=i: t[i], per_leaf)
                 for i, name in enumerate(self.State.SLOTS)}
        ema = acc = None
        if self.ema_decay is not None:
            ema = tree_map(lambda p: p.detach().float().clone(), params)
        if self.accum_steps > 1:
            acc = tree_map(lambda p: torch.zeros_like(p), params)
        return self.State(count=0, **slots, ema=ema, acc=acc)

    def learning_rate(self, count: int) -> float:
        """The step size at ``count`` steps applied, as fp32."""
        if self.schedule is None:
            return float(np.float32(self.lr))
        return float(np.float32(self.schedule(count)))

    def scalars(self, count: int) -> dict:
        """The step's scalars after ``count`` updates, computed once a
        step: the step size (fp32)."""
        return {"lr": self.learning_rate(count)}

    def step_leaf(self, p, g, slots: tuple, count: int, wd: float, factor,
                  scalars: dict, shard=None) -> None:
        """One leaf's update in place: ``slots`` its state tensors,
        ``count`` the updates applied before, ``wd`` 0 where the mask
        exempts it, ``factor`` its LLRD factor or None, ``scalars`` the
        step's (``scalars``), ``shard`` where the leaf is a rank's part
        (``vitx_torch.parallel.sharded.LeafShard``) or None."""
        raise NotImplementedError

    def step_leaves(self, pl, gl, state, flags, params, shards=None) -> None:
        decays = (weight_decay_mask(params) if self.wd_exclude
                  else [True] * len(pl))
        shards = shards or [None] * len(pl)
        factors = (llrd_factors(params, self.llrd, self.llrd_depth, shards)
                   if self.llrd is not None else [None] * len(pl))
        scalars = self.scalars(state.count)
        slots = iter(zip(*(leaves(getattr(state, name))
                           for name in self.State.SLOTS)))
        for p, g, dec, f, on, sh in zip(pl, gl, decays, factors, flags,
                                        shards):
            if on:
                self.step_leaf(p, g.float(), next(slots), state.count,
                               self.weight_decay if dec else 0.0, f, scalars,
                               shard=sh)

    @torch.no_grad()
    def update(self, grads, state, params, *, norm=None, shards=None):
        """One step over matching trees (or leaf lists, in ``leaves``
        order) of grads and params -> (params, new state). A frozen leaf's
        gradient may be None (a train step computes none); a trainable
        leaf's None counts as zeros, vitx's ``stop_gradient`` gradient.
        On a rank of a sharded step the params and state are the rank's
        parts: ``norm`` (the gradient list -> its global norm) replaces
        the clipping norm, and ``shards`` (one per leaf) says where each
        leaf is split."""
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
            g_norm = (global_norm([g for g in gl if g is not None])
                      if norm is None else norm(gl))
            keep = g_norm < self.grad_clip
            gl = [None if g is None else torch.where(
                keep, g, (g / g_norm.to(g.dtype)) * self.grad_clip)
                for g in gl]
        self.step_leaves(pl, gl, state, flags, params, shards)
        if state.ema is not None:
            f32 = np.float32
            d, rest = float(f32(self.ema_decay)), float(
                f32(1.0 - self.ema_decay))
            for e, p in zip(leaves(state.ema), pl):
                e.copy_(e * d + p.float() * rest)
        return params, state._replace(count=state.count + 1)


class AdamW(_Chain):
    """AdamW with optax's semantics (``optax.adamw``: scale_by_adam ->
    add_decayed_weights -> scale_by_learning_rate, then apply_updates):

        p <- p - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)

    b1 0.9, b2 0.999, eps 1e-8, eps_root 0; the bias corrections at the
    incremented count; the rest of the chain is ``_Chain``'s.
    ``mu_dtype="bfloat16"`` stores the first moment in bf16 as optax's
    ``scale_by_adam(mu_dtype=...)`` does: the new moment (1 - b1) g + b1
    mu is formed in fp32 with b1 rounded to bf16 (JAX's weak-typed scalar
    takes mu's dtype; XLA keeps the product in fp32 under jit, as vitx's
    step runs), the step reads it in fp32, and it is stored rounded to
    bf16 afterwards. ``fused`` updates every leaf in one
    in-place pass, one launch a step per gradient dtype (B12,
    ``fused_adamw_multi_``), with the order of operations of
    ``vitx/kernels/adamw.py:46-53``; otherwise the same arithmetic runs as
    plain torch (``adamw_plain``).
    """

    State = AdamWState
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float = 1e-4, weight_decay: float = 1e-4,
                 schedule: Callable | None = None,
                 grad_clip: float | None = None, fused: bool = False,
                 ema_decay: float | None = None, wd_exclude: bool = False,
                 trainable: str | None = None, llrd: float | None = None,
                 llrd_depth: int | None = None, accum_steps: int = 1,
                 mu_dtype: str | None = None):
        if fused and (ema_decay is not None or wd_exclude
                      or trainable not in (None, "all") or llrd is not None
                      or accum_steps > 1 or mu_dtype is not None):
            raise ValueError("the fused update (B12) takes neither "
                             "ema_decay, wd_exclude, a freeze policy, llrd, "
                             "accumulation nor mu_dtype")
        if mu_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"unknown mu_dtype {mu_dtype!r}; have "
                             f"'float32', 'bfloat16'")
        super().__init__(lr=lr, weight_decay=weight_decay, schedule=schedule,
                         grad_clip=grad_clip, ema_decay=ema_decay,
                         wd_exclude=wd_exclude, trainable=trainable,
                         llrd=llrd, llrd_depth=llrd_depth,
                         accum_steps=accum_steps)
        self.fused, self.mu_dtype = fused, mu_dtype
        self._mu_dtype = (torch.bfloat16 if mu_dtype == "bfloat16"
                          else torch.float32)

    def init_leaf(self, p, alloc) -> tuple:
        return alloc(p.shape, self._mu_dtype), alloc(p.shape, torch.float32)

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

    def step_leaves(self, pl, gl, state, flags, params, shards=None) -> None:
        if self.fused:
            fused_adamw_multi_(pl, gl, leaves(state.mu), leaves(state.nu),
                               **self.update_kw(state.count))
            return
        super().step_leaves(pl, gl, state, flags, params, shards)

    scalars = update_kw

    def step_leaf(self, p, g, slots, count, wd, factor, scalars,
                  shard=None) -> None:
        mu, nu = slots
        kw = dict(scalars, wd=wd)
        if mu.dtype != torch.float32:
            # optax's (1 - b1) g + b1 mu as vitx's jitted step computes it:
            # b1 rounded to mu's dtype (JAX's weak-typed scalar), the
            # product and sum in fp32; b1 = 1 then passes it through
            b1 = float(torch.tensor(self.b1, dtype=mu.dtype))
            mu = (1.0 - self.b1) * g + b1 * mu.float()
            kw["b1"] = 1.0
        p2, mu2, nu2 = adamw_plain(p, g, mu, nu, factor=factor, **kw)
        p.copy_(p2)
        slots[0].copy_(mu2)
        nu.copy_(nu2)


class SGD(_Chain):
    """SGD with momentum 0.9 and decoupled weight decay
    (``vitx/train/step.py:237-245``: ``optax.trace(0.9)``, then
    ``add_decayed_weights`` (masked under ``wd_exclude``), then
    ``scale_by_learning_rate``):

        trace <- g + 0.9 trace;  p <- p - lr * (trace + wd * p)

    The trace keeps no count (optax's ``TraceState``)."""

    State = SGDState
    momentum = 0.9

    def init_leaf(self, p, alloc) -> tuple:
        return (alloc(p.shape, torch.float32),)

    def step_leaf(self, p, g, slots, count, wd, factor, scalars,
                  shard=None) -> None:
        (trace,) = slots
        trace.copy_(g + self.momentum * trace)
        step = scalars["lr"] * (trace + wd * p)
        p.copy_(p - (step if factor is None else step * factor))


class Lion(_Chain):
    """Lion (``optax.lion``, ``vitx/train/step.py:246-248``): b1 0.9, b2
    0.99, the sign of the interpolated momentum, then decoupled weight
    decay and the learning rate:

        p <- p - lr * (sign((1 - b1) g + b1 mu) + wd * p)
        mu <- (1 - b2) g + b2 mu"""

    State = LionState
    b1, b2 = 0.9, 0.99

    def init_leaf(self, p, alloc) -> tuple:
        return (alloc(p.shape, torch.float32),)

    def step_leaf(self, p, g, slots, count, wd, factor, scalars,
                  shard=None) -> None:
        (mu,) = slots
        direction = torch.sign((1.0 - self.b1) * g + self.b1 * mu)
        mu.copy_((1.0 - self.b2) * g + self.b2 * mu)
        step = scalars["lr"] * (direction + wd * p)
        p.copy_(p - (step if factor is None else step * factor))


def factored_dims(shape) -> tuple | None:
    """optax's ``_factored_dims`` with vitx's settings (factored, at least
    128): (d1, d0), the second largest and the largest axis, or None when
    the leaf has under two axes or its second largest is below 128."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < Adafactor.min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Chain):
    """Adafactor as vitx builds it (``optax.adafactor`` with
    ``multiply_by_parameter_scale=False``, ``clipping_threshold=None``,
    ``weight_decay_rate=weight_decay or None``; ``vitx/train/step.py:
    249-256``): optax's ``scale_by_factored_rms`` (decay 1 - (t+1)^-0.8 at
    t updates applied, eps 1e-30 added to g², factored second moments on
    leaves whose two largest axes are at least 128: a row and a column
    mean, the full moment elsewhere), then the learning rate, then
    decoupled weight decay (not scaled by lr, as optax's order has it),
    then the sign flip:

        p <- p - (lr * g * rsqrt(v) + wd * p)

    The state is optax's ``FactoredState(count, v_row, v_col, v)``, with
    (1,) placeholders where a leaf keeps the other form. On a rank that
    holds a part of a leaf (``shard``), the factoring follows the whole
    leaf's shape and the row and column means over a split dim are
    averaged across its ranks; each moment is then the part of the whole
    one that the rank's part of the leaf reads."""

    State = AdafactorState
    decay_rate, eps = 0.8, 1e-30
    min_dim_size_to_factor = 128

    def init_leaf(self, p, alloc) -> tuple:
        dims = factored_dims(tuple(p.shape))
        one = (1,)
        if dims is None:
            return alloc(one, p.dtype), alloc(one, p.dtype), \
                alloc(p.shape, p.dtype)
        d1, d0 = dims
        shape = list(p.shape)
        return (alloc(tuple(np.delete(shape, d0)), p.dtype),
                alloc(tuple(np.delete(shape, d1)), p.dtype),
                alloc(one, p.dtype))

    def step_leaf(self, p, g, slots, count, wd, factor, scalars,
                  shard=None) -> None:
        v_row, v_col, v = slots
        t = torch.full((), count + 1, dtype=torch.float32, device=p.device)
        rate = 1.0 - t ** (-self.decay_rate)
        grad_sqr = g * g + self.eps
        dims = factored_dims(tuple(p.shape) if shard is None
                             else shard.shape)
        if dims is None:
            v.copy_(rate * v + (1.0 - rate) * grad_sqr)
            u = g * v ** -0.5
        else:
            d1, d0 = dims

            def mean(x, d, part, keepdim=False):
                return (x.mean(dim=d, keepdim=keepdim) if part is None
                        else part.mean(x, d, keepdim))
            v_row.copy_(rate * v_row + (1.0 - rate) * mean(grad_sqr, d0,
                                                           shard))
            v_col.copy_(rate * v_col + (1.0 - rate) * mean(grad_sqr, d1,
                                                           shard))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = mean(v_row, reduced_d1, None if shard is None
                                else shard.without(d0), keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        u = scalars["lr"] * u
        if self.weight_decay:
            u = u + wd * p
        p.copy_(p - (u if factor is None else u * factor))


OPTIMIZERS = {"adamw": AdamW, "sgd": SGD, "lion": Lion,
              "adafactor": Adafactor}


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-4,
                   schedule=None, grad_clip: float | None = None,
                   accum_steps: int = 1, fused: bool | str = "auto",
                   ema_decay: float | None = None,
                   llrd: float | None = None, llrd_depth: int | None = None,
                   optimizer: str = "adamw", trainable: str | None = None,
                   mu_dtype: str | None = None,
                   wd_exclude: bool = False) -> _Chain:
    """The optimizer as vitx builds it (``vitx/train/step.py:175-287``),
    with the same defaults: ``optimizer`` "adamw" (``AdamW``), "sgd"
    (``SGD``), "lion" (``Lion``) or "adafactor" (``Adafactor``), lr 1e-4,
    weight decay 1e-4 on every leaf (the matrix weights only with
    ``wd_exclude``), an optional ``schedule`` (e.g. ``warmup_cosine``),
    ``grad_clip`` (global norm), ``ema_decay`` (the params' EMA in the
    state), ``trainable`` (a freeze policy, vitx's ``optax.masked``),
    ``llrd`` with ``llrd_depth`` (layer-wise lr decay), ``accum_steps``
    (``optax.MultiSteps``) and, for adamw, ``mu_dtype`` (the first
    moment's storage). ``fused=True`` routes the update to B12 under
    vitx's conditions (``step.py:225-228``): adamw with no EMA,
    ``wd_exclude``, freeze, LLRD, accumulation or ``mu_dtype``; otherwise,
    and with ``"auto"`` or False, the plain update runs."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"have {', '.join(OPTIMIZERS)}")
    if mu_dtype is not None and optimizer != "adamw":
        raise ValueError("mu_dtype applies to the adamw moments only")
    kw = dict(lr=lr, weight_decay=weight_decay, schedule=schedule,
              grad_clip=grad_clip, ema_decay=ema_decay,
              wd_exclude=wd_exclude, trainable=trainable, llrd=llrd,
              llrd_depth=llrd_depth, accum_steps=accum_steps)
    if optimizer != "adamw":
        return OPTIMIZERS[optimizer](**kw)
    use_fused = (fused is True and accum_steps == 1 and ema_decay is None
                 and llrd is None and trainable in (None, "all")
                 and mu_dtype is None and not wd_exclude)
    return AdamW(fused=use_fused, mu_dtype=mu_dtype, **kw)


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


def create_train_state(rng, cfg: ViTConfig, optimizer: _Chain, *,
                       device="cuda") -> TrainState:
    """Fresh parameters (``init_params``; ``rng`` a ``torch.Generator`` or
    an int seed) on ``device`` -- a CUDA device by default, raising when
    there is none -- and the optimizer's zero state."""
    params = init_params(rng, cfg, device=device)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def cross_entropy_loss(logits, labels, mask=None, label_smoothing=0.0,
                       class_weights=None, reduce=None):
    """Mean softmax cross-entropy in fp32 (``vitx/train/step.py:307-344``):
    ``mask`` (0/1 per row) excludes padding rows from the mean;
    ``label_smoothing`` mixes in the uniform target; ``class_weights`` (C,)
    scale each row by its target class's weight and normalise by their
    sum. ``reduce``: a rank's share of a global mean -- the rows' sum over
    ``reduce(the local denominator)``, the global one
    (``vitx_torch.parallel.sharded.denominator``)."""
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
    if reduce is not None:
        m = torch.ones_like(nll) if mask is None else mask.float()
        denom = m.sum() if denom_w is None else (denom_w * m).sum()
        return (nll * m).sum() / reduce(denom).clamp_min(1e-9)
    if mask is None:
        if denom_w is None:
            return nll.mean()
        return nll.sum() / denom_w.sum().clamp_min(1e-9)
    mask = mask.float()
    denom = mask.sum() if denom_w is None else (denom_w * mask).sum()
    return (nll * mask).sum() / denom.clamp_min(1e-9)


def sigmoid_bce_loss(logits, targets, mask=None, reduce=None):
    """The multi-label loss (``vitx/train/step.py:347-358``): sigmoid
    binary cross-entropy in fp32 against (B, C) multi-hot (or mixed, soft)
    targets, optax's ``-t log sigmoid(x) - (1 - t) log sigmoid(-x)``,
    averaged over the classes, then over the rows (``mask`` excludes
    padding rows; ``reduce`` as ``cross_entropy_loss`` takes it)."""
    x = logits.float()
    t = targets.float()
    per = -t * F.logsigmoid(x) - (1.0 - t) * F.logsigmoid(-x)
    per = per.mean(dim=-1)
    if reduce is not None:
        m = torch.ones_like(per) if mask is None else mask.float()
        return (per * m).sum() / reduce(m.sum()).clamp_min(1e-9)
    if mask is None:
        return per.mean()
    m = mask.float()
    return (per * m).sum() / m.sum().clamp_min(1e-9)


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
            loss: str = "ce", mix=None, mesh=None):
    """-> (loss, logits) (``vitx/train/step.py:399-455``). Dropout and
    drop-path run when ``rng`` (a ``torch.Generator``) is given. As in
    vitx, ``fuse_mlp="auto"`` becomes "off" under grad: the MLP halves
    train through torch products, K2 only with ``fuse_mlp="on"``.

    With ``mixup_alpha`` or ``cutmix_alpha`` and a generator, the images
    mix with a permutation of the batch through ``mix_weight_map``'s map
    w, in fp32: w * x + (1 - w) * x[perm], and the loss is lam * CE(labels)
    + (1 - lam) * CE(labels[perm]) with lam = mean(w). ``mix`` = (perm,
    w) replaces the draws, so that a test can feed vitx's. ``loss="bce"``
    takes (B, C) multi-hot labels through ``sigmoid_bce_loss`` (mixing
    mixes the targets) and refuses label smoothing and class weights, as
    vitx does. ``mesh``: a rank of a sharded step with its rows of the
    batch -- the loss is its share of the global mean, the permutation
    one of the global batch (``perm`` indexes it; the partner rows are
    gathered from the other ranks), and the model runs the rank's
    shards."""
    if cfg.fuse_mlp == "auto":
        cfg = cfg.replace(fuse_mlp="off")
    if loss == "bce":
        if label_smoothing or class_weights is not None:
            raise ValueError("loss='bce' does not compose with "
                             "label_smoothing / class_weights")
    elif loss != "ce":
        raise ValueError(f"unknown loss {loss!r} (have 'ce', 'bce')")
    image, mask = batch["image"], batch.get("mask")
    reduce = rows = None
    if mesh is not None:
        from vitx_torch.parallel import sharded

        if mesh.size(sharded.BATCH_AXES) > 1:
            reduce = sharded.denominator(mesh)
            rows = sharded.batch_rows(mesh, image.shape[0])
    if (mixup_alpha or cutmix_alpha) and (rng is not None or mix is not None):
        n = image.shape[0] if rows is None else rows[1]
        if mix is None:
            perm = torch.randperm(n, generator=rng,
                                  device=rng.device).to(image.device)
            w = mix_weight_map(rng, image.shape, mixup_alpha, cutmix_alpha,
                               image.device)
        else:
            perm, w = (torch.as_tensor(np.array(t) if not torch.is_tensor(t)
                                       else t).to(image.device) for t in mix)
            perm = perm.long()

        def partner(t):
            if rows is None:
                return t[perm]
            whole = sharded.gather_batch(t, mesh)
            return whole[perm[rows[0]:rows[0] + image.shape[0]]]
        lam = w.float().mean()
        image = (w * image.float() + (1.0 - w) * partner(image).float()
                 ).to(image.dtype)
        logits = model_logits(params, image, cfg, rng=rng,
                              deterministic=rng is None, mesh=mesh)
        if loss == "bce":
            # BCE is affine in the target: mix the multi-hot targets
            t = batch["label"].float()
            mixed = lam * t + (1.0 - lam) * partner(t)
            return sigmoid_bce_loss(logits, mixed, mask, reduce), logits
        labels = batch["label"].long()
        loss_v = (lam * cross_entropy_loss(logits, labels, mask,
                                           label_smoothing, class_weights,
                                           reduce)
                  + (1.0 - lam) * cross_entropy_loss(
                      logits, partner(labels), mask, label_smoothing,
                      class_weights, reduce))
        return loss_v, logits
    logits = model_logits(params, image, cfg, rng=rng,
                          deterministic=rng is None, mesh=mesh)
    if loss == "bce":
        return sigmoid_bce_loss(logits, batch["label"], mask, reduce), logits
    loss_v = cross_entropy_loss(logits, batch["label"], mask,
                                label_smoothing, class_weights, reduce)
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
               optimizer: _Chain, device="cuda",
               label_smoothing: float = 0.0,
               mixup_alpha: float | None = None,
               cutmix_alpha: float | None = None,
               sam_rho: float | None = None, class_weights=None,
               grad_shardings=None, train_filter: str | None = None,
               loss: str = "ce", mix=None, mesh=None, state_specs=None):
    """One optimizer step (``vitx/train/step.py:458-547``). ``batch``:
    {"image": (B, H, W, C), "label": (B,) -- (B, C) multi-hot with
    ``loss="bce"`` --, optional "mask": (B,) 0/1}, numpy or tensors.
    ``rng``: a ``torch.Generator`` on ``device`` for dropout/drop-path and
    mixing, or None for a deterministic step (``mix`` as ``loss_fn``
    takes it). The state must live on ``device`` (a CUDA device by
    default). ``train_filter`` ("lora", "head"): the frozen leaves enter
    the loss without ``requires_grad`` and get no gradient (vitx's
    ``stop_gradient``); pair it with an optimizer of the same
    ``trainable``. ``sam_rho``: sharpness-aware minimization, the update
    from the gradient at p + rho * g / (|g| + 1e-12) (``sam_gradients``).
    Updates the state's tensors in place; returns (state, metrics) with
    fp32 0-dim tensors ``loss``, ``accuracy`` (per element of the 0.5
    decisions for multi-hot labels) and ``grad_norm`` (the clean
    gradients' global norm, before clipping) left on the device.

    ``mesh`` (``vitx_torch.parallel.make_mesh``): one rank of a sharded
    step (``vitx_torch.parallel.sharded.sharded_train_step``) -- the
    state this rank's parts (``place_state``) with ``state_specs`` their
    specs, the batch its rows, the device the mesh's; ``grad_shardings``
    (``grad_sharding``) reduce-scatters the gradients onto ZeRO-2's
    slices."""
    if mesh is not None:
        from vitx_torch.parallel.sharded import sharded_train_step

        return sharded_train_step(
            state, batch, rng, cfg=cfg, optimizer=optimizer, mesh=mesh,
            state_specs=state_specs, label_smoothing=label_smoothing,
            mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
            sam_rho=sam_rho, class_weights=class_weights,
            grad_shardings=grad_shardings, train_filter=train_filter,
            loss=loss, mix=mix)
    if grad_shardings is not None:
        raise ValueError("grad_shardings split the gradients over a mesh's "
                         "data axis: pass the rank's mesh")
    dev = resolve_device(device)
    _check_on(state.params, dev)
    batch = _to_device(batch, dev)
    params, wrt = trainable_params(state.params, train_filter)
    # SAM's second pass draws the same dropout, drop-path and mixing
    rng_state = rng.get_state() if sam_rho and rng is not None else None

    def loss_of(p):
        return loss_fn(p, batch, cfg, rng, label_smoothing=label_smoothing,
                       mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                       class_weights=class_weights, loss=loss, mix=mix)

    loss_v, logits = loss_of(params)
    grads = gradients(loss_v, params, wrt)
    grad_norm = global_norm(grads)
    if sam_rho:
        grads = sam_gradients(loss_of, state.params, wrt, grads, grad_norm,
                              sam_rho, rng, rng_state)
    return finish_step(state, optimizer, grads, grad_norm, loss_v, logits,
                       wrt, batch)


def sam_gradients(loss_of, params, wrt: list, grads: list, grad_norm,
                  rho: float, rng=None, rng_state=None) -> list:
    """First-order SAM (``vitx/train/step.py:511-519``): the gradients of
    ``loss_of`` at the ascent point p + (rho / (|g| + 1e-12) * g) cast to
    p's dtype, for the leaves flagged in ``wrt`` (``grads`` theirs at p,
    ``grad_norm`` their global norm); frozen leaves stay where they are,
    as vitx's zero gradients leave them. ``rng`` is set back to
    ``rng_state`` first, so the second pass draws the clean pass's
    dropout, drop-path and mixing."""
    scale = rho / (grad_norm + 1e-12)
    it = iter(grads)

    def ascend(p, w):
        if not w:
            return p.detach()
        return (p.detach() + (scale * next(it)).to(p.dtype)).requires_grad_()
    flat = iter(zip(leaves(params), wrt))

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return ascend(*next(flat))
    adv = walk(params)
    if rng is not None:
        rng.set_state(rng_state)
    loss_adv, _ = loss_of(adv)
    return gradients(loss_adv, adv, wrt)


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


def gradients(loss_v, params, wrt: list) -> list:
    """The gradients of ``loss_v`` for the leaves of ``params`` flagged in
    ``wrt``, in ``leaves`` order (zeros where the loss does not reach a
    leaf)."""
    req = [t for t, w in zip(leaves(params), wrt) if w]
    return [torch.zeros_like(t) if g is None else g for t, g in zip(
        req, torch.autograd.grad(loss_v, req, allow_unused=True))]


def apply_gradients(state: TrainState, optimizer: _Chain, loss_v, logits,
                    params, wrt: list, batch: dict,
                    extra: dict | None = None):
    """The gradients of ``loss_v`` for the leaves of ``params`` (the tree
    the loss read) flagged in ``wrt`` (None for the rest), one optimizer
    update of the state, and the step's metrics (``finish_step``)."""
    grads = gradients(loss_v, params, wrt)
    return finish_step(state, optimizer, grads, global_norm(grads), loss_v,
                       logits, wrt, batch, extra)


def finish_step(state: TrainState, optimizer: _Chain, grads: list,
                grad_norm, loss_v, logits, wrt: list, batch: dict,
                extra: dict | None = None):
    """One optimizer update of the state from ``grads`` (the flagged
    leaves' gradients), and the step's metrics -> (state, metrics):
    ``loss``, ``accuracy`` of ``logits`` against ``batch["label"]``
    (masked; for (B, C) multi-hot labels the mean agreement of the logits'
    signs with the labels' 0.5 decisions, vitx's multi-label accuracy),
    ``grad_norm`` and ``extra``'s entries."""
    it = iter(grads)
    full = [next(it) if w else None for w in wrt]
    new_params, opt_state = optimizer.update(full, state.opt_state,
                                             state.params)
    with torch.no_grad():
        labels = batch["label"]
        if labels.dim() == 2:
            correct = ((logits > 0) == (labels > 0.5)).float().mean(dim=-1)
        else:
            correct = (logits.argmax(dim=-1) == labels.long()).float()
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


def make_train_step(cfg: ViTConfig, optimizer: _Chain, *, device="cuda",
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
