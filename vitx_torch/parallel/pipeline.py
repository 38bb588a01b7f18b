"""Pipeline parallelism: GPipe and 1F1B over a (data, stage[, model]) mesh
of rank processes.

The counterpart of ``vitx/parallel/pipeline.py``. The encoder's stacked
blocks are split over the ``stage`` axis -- stage s holds layers
[s L/S, (s + 1) L/S) -- and each rank's rows of the global batch stream
through the stages in microbatches. vitx writes the whole schedule as one
``shard_map`` over a ``lax.scan`` of ticks, hands activations on with
``lax.ppermute`` and lets autodiff mirror it; here each rank is a process
that runs its own stage only, and the schedules are written out:

- the stage boundary carries ``x + pending`` (what ``run_blocks`` returns)
  and the next stage starts from it with pending 0, which is exact, as in
  vitx; the handoff is ``comm.send_stage`` / ``comm.recv_stage``;
- GPipe (``schedule="gpipe"``): every microbatch's forward, then their
  backwards in reverse order, each rank holding its microbatches' graphs
  (activation memory O(M)); the last stage's backward starts from its
  share of the loss, the others' from the cotangent the next stage sent,
  and each stage sends its input's gradient back;
- 1F1B (``schedule="1f1b"``, PipeDream's flush variant): vitx's timeline
  of ticks, each a forward slot (microbatch t - s, without grad, its
  input kept in a ring of 2S - 1 stage inputs) and a backward slot
  (microbatch t - (2S - 2 - s): the stage's forward recomputed from the
  kept input under grad, then its backward); activation memory O(S);
- vitx's warm-up and drain slots run zeros through every stage and carry
  no gradient; the ranks here skip them and compute only their real
  microbatches, which gives the same values. A 1F1B tick's handoffs go
  after both slots, link by link in the order of the stages, the
  forward's before the backward's on each link: every pair of ranks meets
  its transfers in one order, so no blocking pair waits on another;
- the embedding runs on stage 0 only and the head (final norm, classifier,
  loss) on the last stage; the loss is a rank's share of the global
  masked mean (its rows' sum over the global count of rows over
  ``data``), so the block gradients sum over ``data`` and the replicated
  leaves' over (data, stage) (``sharded.Plan.reduce``), and the update is
  the sharded one (``sharded.Plan``: the global grad norm over the
  stage-split blocks, ZeRO-1 splitting the moments over ``data``);
- with a ``model`` axis each stage's blocks run tensor-parallel
  (``vitx_torch.nn.vit._tp_block``, Megatron's f/g with the biases added
  after the reduce, as vitx's manual stage block), the fusions "auto"
  turned off as under tp;
- without one, the stages keep the config's fusions: ``fuse_mlp="auto"``
  stays "auto" under grad (vitx's stages call ``run_blocks`` directly,
  not ``loss_fn``), so on a card the blocks' MLP halves are K2 with its
  stash;
- dropout, drop-path and patch dropout draw from one generator per
  (data row, embed, microbatch) and per (data row, stage, microbatch),
  seeded from one draw of the step's generator by a fixed rule
  (``draw_seed``), vitx's fold_in rule with seeds for keys: the 1F1B
  recompute draws the forward slot's masks again.

``pp_schedule_ticks`` and ``pp_bubble_fraction`` are vitx's lockstep
accounting; the ranks here idle only where a stage has no real slot.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from vitx_torch.core.config import ViTConfig
from vitx_torch.nn.layers import dropout
from vitx_torch.nn.vit import (_final_norm, _patch_drop, classify,
                               embed_tokens, run_blocks, unstack)
from vitx_torch.parallel import comm, sharded
from vitx_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS,
                                      Mesh, rank_device)

__all__ = ["STAGE_AXIS", "make_pp_mesh", "pp_param_pspecs",
           "pp_state_sharding", "place_pp_state",
           "pp_schedule_ticks", "pp_bubble_fraction", "make_pp_train_step",
           "make_pp_eval_step"]

# the seed rule's tags (vitx's _EMBED_TAG / _BLOCK_TAG)
_EMBED_TAG = 0xE4B
_BLOCK_TAG = 0xB10C


def make_pp_mesh(dp: int | None = None, pp: int = 2, tp: int = 1, *,
                 device="cuda") -> Mesh:
    """A (data, stage[, model]) mesh over the initialised default process
    group, rank-major in that order, with vitx's defaults and messages
    (``vitx/parallel/pipeline.py:62-89``): dp defaults to world // (pp *
    tp); the model axis only with tp > 1. Every rank of the group takes
    part. ``device``: the rank's device (``mesh.rank_device``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs an initialised process "
                           "group (vitx_torch.parallel.launch)")
    n = dist.get_world_size()
    if dp is None:
        if n % (pp * tp):
            raise ValueError(f"{n} devices not divisible by "
                             f"pp={pp} x tp={tp}")
        dp = n // (pp * tp)
    need = dp * pp * tp
    if need > n:
        raise ValueError(f"need {need} devices (dp={dp} x pp={pp} x "
                         f"tp={tp}), have {n}")
    if need < n:
        raise ValueError(f"dp={dp} x pp={pp} x tp={tp} uses {need} of the "
                         f"group's {n} ranks; every rank takes part")
    shape = {DATA_AXIS: dp, STAGE_AXIS: pp}
    if tp > 1:
        shape[MODEL_AXIS] = tp
    return Mesh(shape, dist.get_rank(), rank_device(device),
                dist.get_backend())


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def pp_param_pspecs(cfg: ViTConfig, tp: bool = False) -> dict:
    """``sharded.param_pspecs`` with every stacked (L, ...) block leaf
    split over ``stage`` on its layer dim (``pipeline.py:92-111``); with
    ``tp`` the model-axis splits compose on the other dims."""
    if cfg.moe_experts:
        raise ValueError(
            "pipeline parallelism over Soft-MoE models is unsupported: pp "
            "splits the homogeneous dense block stack across stages; use "
            "dp/tp/ep for MoE configs (vitx/parallel/sharded.py)")
    specs = sharded.param_pspecs(cfg, tp)
    specs["blocks"] = {k: sharded.P(STAGE_AXIS, *tuple(s)[1:])
                       for k, s in specs["blocks"].items()}
    return specs


def pp_state_sharding(state, cfg: ViTConfig, mesh, zero1: bool = False,
                      tp: bool = False):
    """A ``TrainState``'s specs under pp: the params ``pp_param_pspecs``,
    each optimizer tensor its param's, split over ``data`` too with
    ``zero1`` (``pipeline.py:120-126``); ``state`` the whole one."""
    return sharded.state_sharding(state, cfg, mesh, zero1=zero1,
                                  pshard=pp_param_pspecs(cfg, tp))


def place_pp_state(state, cfg: ViTConfig, mesh, zero1: bool = False,
                   tp: bool = False):
    """A whole ``TrainState`` -> this rank's part of it under
    ``pp_state_sharding``: its stage's blocks (its model shards of them)."""
    return sharded.place_state(state, cfg, mesh, specs=pp_state_sharding(
        state, cfg, mesh, zero1=zero1, tp=tp))


def _check_pp_cfg(cfg: ViTConfig, pp: int, for_train: bool,
                  tp: int = 0) -> None:
    """vitx's refusals (``pipeline.py:135-161``); ``tp`` the model axis's
    size (0 or 1: none)."""
    if cfg.depth % pp:
        raise ValueError(f"depth={cfg.depth} not divisible by pp={pp}")
    if cfg.distill_token:
        raise ValueError("pipeline parallelism does not support "
                         "distill_token models")
    if tp > 1:
        if cfg.num_heads % tp or (cfg.mlp_ratio * cfg.embed_dim) % tp:
            raise ValueError(
                f"pp x tp needs num_heads ({cfg.num_heads}) and the MLP "
                f"hidden dim ({cfg.mlp_ratio * cfg.embed_dim}) divisible "
                f"by tp={tp}")
        bad = [name for name, v in (
            ("lora_rank", cfg.lora_rank),
            ("parity='bug_exact'", cfg.parity == "bug_exact"),
            ("tome_r", cfg.tome_r),
            ("dropout", for_train and cfg.dropout),
            ("drop_path", for_train and cfg.drop_path),
            ("patch_drop", for_train and cfg.patch_drop)) if v]
        if bad:
            raise ValueError(
                f"pp x tp runs the manual Megatron stage block "
                f"(pipeline.py::_tp_block) which does not support: {bad}")


def pp_schedule_ticks(schedule: str, stages: int, n_micro: int) -> int:
    """vitx's pipeline length in ticks (``pipeline.py:504-513``): GPipe
    M + S - 1 forward ticks, 1F1B M + 2S - 2 ticks of a forward and a
    backward slot each."""
    if schedule == "gpipe":
        return n_micro + stages - 1
    if schedule == "1f1b":
        return n_micro + 2 * stages - 2
    raise ValueError(f"unknown pipeline schedule {schedule!r} "
                     f"(expected 'gpipe' or '1f1b')")


def pp_bubble_fraction(schedule: str, stages: int, n_micro: int) -> float:
    """vitx's lockstep bubble (``pipeline.py:516-521``): (ticks - M) /
    ticks."""
    ticks = pp_schedule_ticks(schedule, stages, n_micro)
    return (ticks - n_micro) / ticks


# ---------------------------------------------------------------------------
# The seed rule
# ---------------------------------------------------------------------------

def step_base(rng: torch.Generator) -> int:
    """The root of a step's seeds: one draw from the step's generator
    (seeded alike on every rank, so every rank draws the same)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=rng,
                             device=rng.device).item())


def draw_seed(base: int, *coords: int) -> int:
    """The 63-bit seed of (base, coords): the embedding's of data row d,
    microbatch m is ``draw_seed(base, d, _EMBED_TAG, m)``; stage s's
    blocks' ``draw_seed(base, d, _BLOCK_TAG, s, m)``."""
    state = np.random.SeedSequence([base, *coords])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def seeded_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def embed_microbatch(params, images, cfg: ViTConfig, gen=None):
    """Images -> the first block's tokens, then (with a generator) patch
    dropout and embedding dropout, as ``encode`` applies them."""
    x = embed_tokens(params, images, cfg)
    if gen is None:
        return x
    if cfg.patch_drop:
        x = _patch_drop(x, cfg, gen)
    return dropout(x, cfg.dropout, gen, deterministic=False)


def stage_rates(cfg: ViTConfig, stage: int, pp: int) -> list:
    """Stage ``stage``'s slice of the whole depth's drop-path rates (block
    l's rate does not depend on which stage holds it)."""
    k = cfg.depth // pp
    rates = torch.linspace(0.0, cfg.drop_path, cfg.depth).tolist()
    return rates[stage * k:(stage + 1) * k]


def stage_forward(blocks: dict, x, cfg: ViTConfig, mesh=None, gen=None,
                  rates=None):
    """A stage's stacked blocks over x -> x + pending (the boundary
    value); tensor-parallel on a mesh with a model axis."""
    y, _ = run_blocks(unstack(blocks), x, cfg, rng=gen,
                      deterministic=gen is None, mesh=mesh, rates=rates)
    return y


def stage_head(params, y, cfg: ViTConfig):
    """The last stage's encoder output -> fp32 logits (final norm and the
    classifier)."""
    return classify(params, _final_norm(params, y, cfg), cfg)


# ---------------------------------------------------------------------------
# One rank's part of a step
# ---------------------------------------------------------------------------

class _Rank:
    """A rank's view of one step: its stage, its rows in microbatches,
    the seeds, and the pieces the schedules compose."""

    def __init__(self, cfg: ViTConfig, mesh, params, batch, n_micro: int,
                 base: int | None, label_smoothing: float = 0.0):
        from vitx_torch.train.step import _to_device

        batch = _to_device(batch, mesh.device)
        self.cfg, self.mesh, self.params = cfg, mesh, params
        self.S, self.s = mesh.pp, mesh.coords[STAGE_AXIS]
        self.d = mesh.index(DATA_AXIS)
        self.M = n_micro
        self.base = base
        self.label_smoothing = label_smoothing
        b_local = batch["image"].shape[0]
        if b_local % n_micro:
            raise ValueError(f"per-data-shard batch {b_local} not divisible "
                             f"by n_micro={n_micro}")
        mb = b_local // n_micro
        self.images = batch["image"].split(mb)
        self.labels = batch["label"].split(mb)
        mask = batch.get("mask")
        self.masks = (mask.split(mb) if mask is not None
                      else [None] * n_micro)
        count = (mask.float().sum() if mask is not None else
                 torch.tensor(float(b_local), device=mesh.device))
        # the global count of rows: every stage of a data row holds its
        # rows, so the sum over data counts each once
        self.n = comm.all_reduce_(count.reshape(1).clone(), mesh,
                                  DATA_AXIS)[0]
        tokens = cfg.seq_len
        if base is not None and cfg.patch_drop:
            tokens -= cfg.num_patches - cfg.patch_keep_count
        self.shape = (mb, tokens, cfg.embed_dim)
        self.dtype = cfg.cdtype()
        self.rates = (stage_rates(cfg, self.s, self.S)
                      if base is not None and cfg.drop_path else None)
        self.held = 0

    @property
    def first(self) -> bool:
        return self.s == 0

    @property
    def last(self) -> bool:
        return self.s == self.S - 1

    def embed(self, m: int):
        gen = (None if self.base is None else seeded_generator(
            draw_seed(self.base, self.d, _EMBED_TAG, m), self.mesh.device))
        return embed_microbatch(self.params, self.images[m], self.cfg, gen)

    def blocks(self, x, m: int):
        gen = (None if self.base is None else seeded_generator(
            draw_seed(self.base, self.d, _BLOCK_TAG, self.s, m),
            self.mesh.device))
        return stage_forward(self.params["blocks"], x, self.cfg, self.mesh,
                             gen, self.rates)

    def head_loss(self, y, m: int) -> tuple:
        """Microbatch m's share of the global mean loss (differentiable)
        and of the accuracy."""
        from vitx_torch.train.step import cross_entropy_loss

        logits = stage_head(self.params, y, self.cfg)
        labels, mask = self.labels[m].long(), self.masks[m]
        loss = cross_entropy_loss(logits, labels, mask,
                                  self.label_smoothing,
                                  reduce=lambda _: self.n)
        with torch.no_grad():
            correct = (logits.argmax(dim=-1) == labels).float()
            if mask is not None:
                correct = correct * mask.float()
            acc = correct.sum() / self.n.clamp_min(1.0)
        return loss, acc

    def recv(self, step: int):
        return comm.recv_stage(self.shape, self.dtype, self.mesh, step)

    def send(self, x, step: int) -> None:
        comm.send_stage(x, self.mesh, step)


def _gpipe(r: _Rank) -> tuple:
    """GPipe on one rank -> (its loss share, its accuracy share); the
    gradients accumulate into the params' ``.grad``."""
    kept = []
    for m in range(r.M):
        x = r.embed(m) if r.first else r.recv(-1).requires_grad_()
        y = r.blocks(x, m)
        if not r.last:
            r.send(y, 1)
        kept.append((x, y))
    r.held = len(kept)
    loss = acc = torch.zeros((), device=r.mesh.device)
    for m in reversed(range(r.M)):
        x, y = kept[m]
        kept[m] = None
        if r.last:
            loss_m, acc_m = r.head_loss(y, m)
            loss_m.backward()
            loss, acc = loss + loss_m.detach(), acc + acc_m
        else:
            torch.autograd.backward(y, r.recv(1))
        if not r.first:
            r.send(x.grad, -1)
    return loss, acc


def _one_f_one_b(r: _Rank) -> tuple:
    """1F1B on one rank (vitx's timeline, ``pipeline.py:524-657``) ->
    (its loss share, its accuracy share); gradients into ``.grad``. The
    last stage's forward slot feeds no stage: its backward slot, the same
    tick and microbatch, computes the forward."""
    S, s, M = r.S, r.s, r.M
    ring = [None] * (2 * S - 1)
    x_recv = g_recv = None
    loss = acc = torch.zeros((), device=r.mesh.device)
    for t in range(pp_schedule_ticks("1f1b", S, M)):
        m_f = t - s
        y = None
        if 0 <= m_f < M:
            with torch.no_grad():
                x_in = r.embed(m_f) if r.first else x_recv
                ring[m_f % len(ring)] = x_in
                r.held = max(r.held, sum(k is not None for k in ring))
                if not r.last:
                    y = r.blocks(x_in, m_f)
        m_b = t - (2 * S - 2 - s)
        dx = None
        if 0 <= m_b < M:
            x_leaf = ring[m_b % len(ring)].detach().requires_grad_()
            ring[m_b % len(ring)] = None
            y_b = r.blocks(x_leaf, m_b)
            if r.last:
                loss_m, acc_m = r.head_loss(y_b, m_b)
                loss_m.backward()
                loss, acc = loss + loss_m.detach(), acc + acc_m
            else:
                torch.autograd.backward(y_b, g_recv)
            dx = x_leaf.grad
            if r.first:
                # the embedding's gradient from the stage input's; the
                # recompute draws microbatch m_b's masks again
                torch.autograd.backward(r.embed(m_b), dx)
        # the tick's handoffs, link by link in stage order, on each link
        # the forward's first
        x_recv = g_recv = None
        if not r.first:
            if 0 <= t - (s - 1) < M:
                x_recv = r.recv(-1)
            if dx is not None:
                r.send(dx, -1)
        if not r.last:
            if y is not None:
                r.send(y, 1)
            if 0 <= t - (2 * S - 3 - s) < M:
                g_recv = r.recv(1)
    return loss, acc


SCHEDULES = {"gpipe": _gpipe, "1f1b": _one_f_one_b}


class PPTrainStep:
    """``(state, batch, rng=None) -> (state, metrics)`` on one rank of a
    pipeline mesh (``make_pp_train_step``). ``held`` is the most stage
    inputs (1F1B's ring) or microbatch graphs (GPipe) the rank held at
    once in its last step."""

    def __init__(self, cfg: ViTConfig, optimizer, mesh, n_micro: int,
                 state_shardings, label_smoothing: float, schedule: str):
        tp = mesh.tp
        _check_pp_cfg(cfg, mesh.pp, for_train=True, tp=tp)
        pp_schedule_ticks(schedule, mesh.pp, n_micro)   # the name
        self.cfg = sharded.tp_safe_cfg(cfg, tp > 1)
        self.optimizer, self.mesh = optimizer, mesh
        self.n_micro, self.specs = n_micro, state_shardings
        self.label_smoothing, self.schedule = label_smoothing, schedule
        self.stochastic = bool(cfg.dropout or cfg.drop_path
                               or cfg.patch_drop)
        self.held = 0

    def __call__(self, state, batch, rng=None):
        from vitx_torch.train.step import (TrainState, leaves,
                                           trainable_params)

        mesh = self.mesh
        if self.stochastic and rng is None:
            raise ValueError(
                "cfg has stochastic regularizers (dropout/drop_path/"
                "patch_drop): the pp train step needs an rng")
        if self.specs is None:
            self.specs = pp_state_sharding(state, self.cfg, mesh,
                                           tp=mesh.tp > 1)
        plan = sharded.Plan(self.specs, mesh, state.params)
        params, wrt = trainable_params(state.params)
        base = step_base(rng) if self.stochastic else None
        r = _Rank(self.cfg, mesh, params, batch, self.n_micro, base,
                  self.label_smoothing)
        loss, acc = SCHEDULES[self.schedule](r)
        self.held = r.held
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves(params)]
        grads, gspecs = plan.reduce(grads, wrt, final=True)
        grad_norm = plan.norm(grads, gspecs)
        new_params, opt_state = plan.apply(self.optimizer, state, grads,
                                           gspecs, wrt)
        both = (DATA_AXIS, STAGE_AXIS)
        metrics = {"loss": comm.all_reduce_(loss.float().clone(), mesh, both),
                   "accuracy": comm.all_reduce_(acc.float().clone(), mesh,
                                                both),
                   "grad_norm": grad_norm}
        return TrainState(state.step + 1, new_params, opt_state), metrics


def make_pp_train_step(cfg: ViTConfig, optimizer, mesh, n_micro: int = 4,
                       state_shardings=None, label_smoothing: float = 0.0,
                       schedule: str = "gpipe") -> PPTrainStep:
    """The pipeline train step on one rank of ``mesh`` (``make_pp_mesh``;
    ``pipeline.py:660-756``): ``n_micro`` microbatches of each data row's
    rows through the stages by ``schedule`` ("gpipe" or "1f1b", the
    module's doc); ``state_shardings`` the placed state's specs
    (``pp_state_sharding``; by default those without zero1). The step
    takes the rank's placed state and its rows, and an ``rng`` (a
    generator seeded alike on every rank) when the config draws; the
    metrics are the global batch's, the same on every rank."""
    return PPTrainStep(cfg, optimizer, mesh, n_micro, state_shardings,
                       label_smoothing, schedule)


def make_pp_eval_step(cfg: ViTConfig, mesh, n_micro: int = 4):
    """``(params, batch) -> (confusion matrix, loss)`` on one rank
    (``pipeline.py:759-806``): the microbatches' forwards through the
    stages, the last stage's confusion matrix and masked loss reduced
    over (data, stage), the same on every rank."""
    from vitx_torch.metrics.metrics import confusion_matrix
    from vitx_torch.train.step import cross_entropy_loss

    tp = mesh.tp
    _check_pp_cfg(cfg, mesh.pp, for_train=False, tp=tp)
    if cfg.tome_r:
        raise ValueError("pp eval runs the full-token encoder; tome_r is "
                         "unsupported (use the dp path)")
    run_cfg = sharded.tp_safe_cfg(cfg, tp > 1)

    @torch.no_grad()
    def step(params, batch):
        r = _Rank(run_cfg, mesh, params, batch, n_micro, None)
        logits = []
        for m in range(r.M):
            x = r.embed(m) if r.first else r.recv(-1)
            y = r.blocks(x, m)
            if r.last:
                logits.append(stage_head(params, y, run_cfg))
            else:
                r.send(y, 1)
        C = run_cfg.num_classes
        dev = mesh.device
        cm = torch.zeros((C, C), dtype=torch.int32, device=dev)
        loss_sum = torch.zeros((), device=dev)
        if r.last:
            logits = torch.cat(logits)
            labels = torch.cat(r.labels).long()
            preds = logits.argmax(dim=-1)
            mask = (torch.cat(r.masks).long() if r.masks[0] is not None
                    else None)
            if mask is not None:
                cm = confusion_matrix(preds * mask, labels * mask, C)
                cm[0, 0] -= (1 - mask).sum().to(cm.dtype)
                count = mask.float().sum()
            else:
                cm = confusion_matrix(preds, labels, C)
                count = torch.tensor(float(labels.shape[0]), device=dev)
            loss_sum = cross_entropy_loss(logits, labels, mask) * count
        both = (DATA_AXIS, STAGE_AXIS)
        cm = comm.all_reduce_(cm.contiguous(), mesh, both)
        loss_sum = comm.all_reduce_(loss_sum.float().clone(), mesh, both)
        return cm, loss_sum / r.n.clamp_min(1.0)
    return step
