"""Sharded train and eval steps over a (data, model[, expert]) mesh.

The counterpart of ``vitx/parallel/sharded.py``. vitx writes shardings
(PartitionSpecs) and lets XLA's partitioner derive the collectives; the
port keeps the same specs -- here tuples with one entry per leading dim,
an axis name or None -- and runs the collectives itself
(``vitx_torch.parallel.comm``), one process per rank:

- data parallelism: each rank runs its rows of the global batch; the
  loss is its rows' share of the global mean (the global count of rows,
  masked rows excluded, divides every rank's sum), so the gradients of
  the rows sum to the global batch's; they are all-reduced over ``data``
  (and ``expert``, which carries rows too outside the Soft-MoE experts);
- tensor parallelism (``tp``): the blocks' heads and MLP hidden dim split
  over ``model`` (``vitx_torch.nn.vit._tp_block``), with sequence
  parallelism (``sp``) between blocks; expert parallelism (``ep``): the
  Soft-MoE experts split over ``expert`` (``vitx_torch.nn.moe``);
- ZeRO: ``zero1`` splits the optimizer state over ``data`` (each rank
  updates its slice of every leaf of at least 1024 elements, on the
  largest free dim dp divides, ``_data_shard``, then the slices are
  all-gathered into the params); ``grad_shardings`` (ZeRO-2) also
  reduce-scatters the gradients onto those slices instead of
  all-reducing them; ``zero3`` keeps the params themselves split, all-
  gathered at the start of each step (backward: reduce-scattered
  gradients) -- every leaf at once, where XLA's scan gathers one layer
  at a time.

The gradient norm (the metric, clipping, SAM's ascent) sums each leaf's
squares over the axes it is split on, so a replicated leaf counts once.
Random draws are made at the global shape and sliced to the rank's rows
(``vitx_torch.core.draws``): a sharded run with a generator of the same
seed draws what the single-process run draws. Mixup and cutmix permute the
global batch (the rows are gathered from the other ranks).
"""

from __future__ import annotations

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.draws import ShardedGenerator
from vitx_torch.parallel import comm
from vitx_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS,
                                      STAGE_AXIS)

BATCH_AXES = (DATA_AXIS, EXPERT_AXIS)
# the axes a leaf's gradient sums over where the leaf is not split on
# them: the rows' and, on a pipeline mesh, the stages' (a replicated
# leaf's gradient lives on the stage that reads it)
REDUCE_AXES = BATCH_AXES + (STAGE_AXIS,)


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------

def P(*axes) -> tuple:
    """A sharding spec: one entry per leading dim, an axis name or None
    (vitx's ``PartitionSpec``); dims past its length are whole."""
    return tuple(axes)


def _block_specs(cfg: ViTConfig, tp: bool) -> dict:
    """The specs of the stacked (L, ...) block leaves
    (``vitx/parallel/sharded.py:38-92``)."""
    m = MODEL_AXIS if tp else None
    specs = {
        "ln1_scale": P(), "ln1_bias": P(),
        "wqkv": P(None, None, None, m, None),     # (L, E, 3, H, D): heads
        "wo": P(None, m, None),                   # rows: the heads' outputs
        "ln2_scale": P(), "ln2_bias": P(),
        "w1": P(None, None, m), "b1": P(None, m),  # the hidden dim
        "w2": P(None, m, None), "b2": P(),
    }
    if cfg.mlp_act == "swiglu":
        specs["w3"] = P(None, None, m)
        specs["b3"] = P(None, m)
    if cfg.layerscale_init:
        specs["ls1"] = P()
        specs["ls2"] = P()
    if cfg.qkv_bias:
        specs["bqkv"] = P(None, None, m, None)
    if cfg.qk_norm:
        specs["lnq_scale"] = P(None, m, None)
        specs["lnk_scale"] = P(None, m, None)
    if cfg.proj_bias:
        specs["bo"] = P()
    if cfg.lora_rank:
        from vitx_torch.nn.lora import target_names

        lora_b = {"wqkv": P(None, None, None, m, None), "wo": P(),
                  "w1": P(None, None, m), "w2": P()}
        lora_a = {"wqkv": P(), "wo": P(None, m, None),
                  "w1": P(), "w2": P(None, m, None)}
        for name in target_names(cfg):
            specs[f"lora_{name}_a"] = lora_a[name]
            specs[f"lora_{name}_b"] = lora_b[name]
    return specs


def _moe_block_specs(cfg: ViTConfig, tp: bool, ep: bool) -> dict:
    """The Soft-MoE blocks' specs (``vitx/parallel/sharded.py:95-112``):
    the expert dim over ``expert``, the hidden dim over ``model``."""
    specs = _block_specs(cfg, tp)
    for name in ("w1", "b1", "w2", "b2"):
        specs.pop(name)
    e = EXPERT_AXIS if ep else None
    m = MODEL_AXIS if tp else None
    specs["phi"] = P()
    specs["router_scale"] = P()
    specs["ew1"] = P(None, e, None, m)        # (k, n, E, M)
    specs["eb1"] = P(None, e, m)              # (k, n, M)
    specs["ew2"] = P(None, e, m, None)        # (k, n, M, E)
    specs["eb2"] = P(None, e, None)           # (k, n, E)
    return specs


def param_pspecs(cfg: ViTConfig, tp: bool = False, ep: bool = False) -> dict:
    """The spec tree of ``init_params``' structure
    (``vitx/parallel/sharded.py:115-160``)."""
    if cfg.stem == "conv":
        n = cfg.patch_size.bit_length() - 1
        embed = {f"conv{i}": {"kernel": P(), "bias": P()} for i in range(n)}
        embed["proj"] = {"kernel": P(), "bias": P()}
    else:
        embed = {"kernel": P(), "bias": P()}
    specs = {"patch_embed": embed, "cls_token": P(),
             "blocks": _block_specs(cfg, tp)}
    if cfg.pos_embed == "learned":
        specs["pos_embed"] = P()
    if cfg.moe_experts:
        specs["moe_blocks"] = _moe_block_specs(cfg, tp, ep)
    if cfg.distill_token:
        specs["dist_token"] = P()
        specs["dist_head"] = {"ln_scale": P(), "ln_bias": P(),
                              "w": P(), "b": P()}
    if cfg.num_registers:
        specs["reg_tokens"] = P()
    if cfg.final_norm:
        specs["final_norm"] = {"scale": P(), "bias": P()}
    if cfg.head_type == "reference":
        specs["head"] = {"w1": P(), "b1": P(), "ln_scale": P(),
                         "ln_bias": P(), "w2": P(), "b2": P()}
    elif cfg.head_type == "map":
        specs["head"] = {k: P() for k in (
            "in_ln_scale", "in_ln_bias",
            "probe", "wq", "wk", "wv", "wo_p", "bo_p",
            "mlp_ln_scale", "mlp_ln_bias", "mw1", "mb1", "mw2", "mb2",
            "ln_scale", "ln_bias", "w", "b")}
    else:
        specs["head"] = {"ln_scale": P(), "ln_bias": P(), "w": P(), "b": P()}
    return specs


def _data_shard(spec: tuple, shape, dp: int) -> tuple:
    """``spec`` with a ``data`` split of the largest free dim that dp
    divides (``vitx/parallel/sharded.py:170-179``); as it is when it
    already splits over ``data`` or no free dim divides."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    if DATA_AXIS in spec:
        return tuple(spec)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if spec[d] is None and shape[d] % dp == 0:
            spec[d] = DATA_AXIS
            return tuple(spec)
    return tuple(spec)


def _tree_map2(fn, specs, tree):
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, specs[k], v) for k, v in tree.items()}
    return fn(specs, tree)


def _shape(x) -> tuple:
    return tuple(x.shape)


def grad_sharding(params, cfg: ViTConfig, mesh, tp: bool = False,
                  ep: bool = False) -> dict:
    """The gradients' specs for ZeRO-2 (``vitx/parallel/sharded.py:
    182-202``): each leaf of at least 1024 elements its param's spec
    plus a ``data`` split of the largest free dim."""
    dp = mesh.shape[DATA_AXIS]
    return _tree_map2(
        lambda s, p: (_data_shard(s, _shape(p), dp)
                      if int(np.prod(_shape(p))) >= 1024 else s),
        param_pspecs(cfg, tp, ep), params)


def _slot_spec(spec: tuple, pshape: tuple, sshape: tuple,
               name: str) -> tuple:
    """The spec of the optimizer slot ``name`` of a leaf of spec ``spec``
    and shape ``pshape``: the leaf's own where the slot has its shape, a
    (1,) placeholder whole, Adafactor's factored row (column) moment the
    spec without the dim it averages (``factored_dims``)."""
    from vitx_torch.train.step import factored_dims

    spec = tuple(spec) + (None,) * (len(pshape) - len(spec))
    if sshape == pshape:
        return spec
    if sshape == (1,):
        return P()
    d1, d0 = factored_dims(pshape)
    d = {"v_row": d0, "v_col": d1}[name]
    return spec[:d] + spec[d + 1:]


def _moment_spec(spec: tuple, shape: tuple, dp: int, zero1: bool) -> tuple:
    """A per-leaf optimizer tensor's spec: its leaf's, with a ``data``
    split under ``zero1`` for tensors of at least 1024 elements
    (``vitx/parallel/sharded.py:249-259``)."""
    if not zero1 or len(shape) == 0 or int(np.prod(shape)) < 1024:
        return spec
    return _data_shard(spec, shape, dp)


def state_sharding(state, cfg: ViTConfig, mesh, tp: bool = False,
                   zero1: bool = False, zero3: bool = False, pshard=None,
                   ep: bool = False):
    """The specs of a whole ``TrainState`` (``vitx/parallel/sharded.py:
    205-266``): params as ``param_pspecs`` (``pshard`` in their place),
    split over ``data`` too under ``zero3``; every per-leaf optimizer
    tensor (moments, EMA shadow, accumulated gradients) its leaf's spec,
    with ``_data_shard`` under ``zero1`` (implied by ``zero3``) for those
    of at least 1024 elements; scalars whole."""
    from vitx_torch.train.step import TrainState

    zero1 = zero1 or zero3
    dp = mesh.shape[DATA_AXIS]
    if pshard is None:
        pshard = param_pspecs(cfg, tp, ep)
    if zero3:
        pshard = _tree_map2(
            lambda s, p: (_data_shard(s, _shape(p), dp)
                          if int(np.prod(_shape(p))) >= 1024 else s),
            pshard, state.params)
    return TrainState(step=P(), params=pshard, opt_state=opt_state_specs(
        state.opt_state, state.params, pshard, dp, zero1))


def opt_state_specs(opt_state, params, pshard, dp: int, zero1: bool):
    """The specs of an optimizer state (``state_sharding``'s rule): its
    class with a spec tree in place of each per-leaf tree."""
    def slot_tree(tree, ptree, stree, name):
        if isinstance(tree, dict):
            return {k: slot_tree(v, ptree[k], stree[k], name)
                    for k, v in tree.items()}
        pspec = _moment_spec(stree, _shape(ptree), dp, zero1)
        return _slot_spec(pspec, _shape(ptree), _shape(tree), name)

    fields = {}
    for name in opt_state._fields:
        v = getattr(opt_state, name)
        fields[name] = (slot_tree(v, params, pshard, name)
                        if isinstance(v, dict) else v)
    return type(opt_state)(**fields)


def spec_dims(spec: tuple) -> dict:
    """dim -> axis of a spec's split dims."""
    return {d: a for d, a in enumerate(spec) if a is not None}


def local_part(x, spec: tuple, mesh):
    """This rank's part of a whole tensor under ``spec``: an owned,
    contiguous copy."""
    for d, a in spec_dims(spec).items():
        x = comm.chunk_of(x, mesh, a, d)
    return x.contiguous().clone()


def gather_part(x, spec: tuple, mesh):
    """The whole tensor from every rank's part under ``spec``."""
    for d, a in sorted(spec_dims(spec).items(), reverse=True):
        x = comm.all_gather_cat(x, mesh, a, d)
    return x


def _map_state(fn, state, specs):
    """``fn(tensor, spec)`` over a ``TrainState``'s params and per-leaf
    optimizer trees (scalars and None as they are)."""
    from vitx_torch.train.step import TrainState

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return fn(t, s) if torch.is_tensor(t) else t

    opt = state.opt_state
    fields = {n: walk(getattr(opt, n), getattr(specs.opt_state, n))
              if isinstance(getattr(opt, n), dict) else getattr(opt, n)
              for n in opt._fields}
    return TrainState(state.step, walk(state.params, specs.params),
                      type(opt)(**fields))


def place_state(state, cfg: ViTConfig, mesh, tp: bool = False,
                zero1: bool = False, zero3: bool = False, ep: bool = False,
                specs=None):
    """A whole ``TrainState`` (the same on every rank) -> this rank's
    local one, on its device (``vitx/parallel/sharded.py:325-330``);
    ``specs`` from ``state_sharding`` in place of the flags'."""
    if specs is None:
        specs = state_sharding(state, cfg, mesh, tp, zero1, zero3, ep=ep)
    return _map_state(lambda t, s: local_part(t.to(mesh.device), s, mesh),
                      state, specs)


def gather_state(state, specs, mesh):
    """Every rank's local ``TrainState`` -> the whole one (on every
    rank), for checkpoints and tests."""
    return _map_state(lambda t, s: gather_part(t, s, mesh), state, specs)


def respec(tree, from_specs, to_specs, mesh):
    """A tree held under ``from_specs`` -> held under ``to_specs``, which
    split a subset of its dims: the other splits gathered (an EMA shadow
    of zero1's slices at its params' specs)."""
    def walk(t, a, b):
        if isinstance(t, dict):
            return {k: walk(v, a[k], b[k]) for k, v in t.items()}
        want = _pad(b, t.dim())
        for d, axis in sorted(spec_dims(a).items(), reverse=True):
            if want[d] != axis:
                t = comm.all_gather_cat(t, mesh, axis, d)
        return t
    return walk(tree, from_specs, to_specs)


# ---------------------------------------------------------------------------
# Batches and configs
# ---------------------------------------------------------------------------

def _batch_axes(mesh) -> tuple:
    """The batch splits over ``data`` -- over data x expert on an expert
    mesh (``vitx/parallel/sharded.py:269-278``)."""
    if EXPERT_AXIS in mesh.axis_names:
        return (DATA_AXIS, EXPERT_AXIS)
    return (DATA_AXIS,)


def batch_rows(mesh, local_rows: int) -> tuple:
    """(start, total): this rank's first row in the global batch and the
    global batch's rows, for ``local_rows`` rows a rank."""
    axes = _batch_axes(mesh)
    return mesh.index(axes) * local_rows, mesh.size(axes) * local_rows


def shard_batch(batch, mesh) -> dict:
    """A whole host batch -> this rank's rows (a contiguous block; the
    ranks of a model group get the same rows)
    (``vitx/parallel/sharded.py:286-291``)."""
    axes = _batch_axes(mesh)
    n = mesh.size(axes)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v) if not torch.is_tensor(v) else v
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} rows does not split "
                             f"over {n} ranks")
        step = v.shape[0] // n
        i = mesh.index(axes)
        out[k] = v[i * step:(i + 1) * step]
    return out


def shard_host_batch(batch, mesh) -> dict:
    """Multi-process batch placement (``vitx/parallel/sharded.py:
    294-313``): each rank loads only its rows of the global batch
    (``BatchLoader(rows=...)``), so its batch is already its shard."""
    return dict(batch)


def sp_cfg(cfg: ViTConfig, tp: bool, sp: bool) -> ViTConfig:
    """Sequence parallelism (``vitx/parallel/sharded.py:333-343``): only
    under tp."""
    if not sp:
        return cfg
    if not tp:
        raise ValueError("sp=True requires tp (sequence parallelism shards "
                         "the residual stream over the model axis)")
    return cfg.replace(sp=True)


def ep_cfg(cfg: ViTConfig, mesh, ep: bool) -> ViTConfig:
    """Expert parallelism (``vitx/parallel/sharded.py:346-360``)."""
    if not ep:
        return cfg
    if not cfg.moe_experts:
        raise ValueError("ep=True requires a MoE config (moe_experts > 0)")
    if EXPERT_AXIS not in mesh.axis_names:
        raise ValueError("ep=True requires an expert mesh axis "
                         "(make_mesh(ep=...))")
    if cfg.moe_experts % mesh.shape[EXPERT_AXIS]:
        raise ValueError(
            f"moe_experts {cfg.moe_experts} not divisible by the expert "
            f"axis size {mesh.shape[EXPERT_AXIS]}")
    return cfg.replace(ep=True)


def tp_safe_cfg(cfg: ViTConfig, tp: bool) -> ViTConfig:
    """Under tp an "auto" fusion goes to the composed path, whose products
    split Megatron-style; an explicit "on" gathers the rank's weight
    shards (``vitx/parallel/sharded.py:363-378``)."""
    if not tp:
        return cfg
    rep = {}
    if cfg.fuse_mha == "auto":
        rep["fuse_mha"] = "off"
    if cfg.fuse_mlp == "auto":
        rep["fuse_mlp"] = "off"
    return cfg.replace(**rep) if rep else cfg


def _check_tp(mesh, tp: bool) -> None:
    if tp != (mesh.tp > 1):
        raise ValueError(f"tp={tp} on a mesh whose model axis has "
                         f"{mesh.tp} rank(s): a model axis of more than one "
                         f"rank splits the blocks (tp=True)")


# ---------------------------------------------------------------------------
# The step's pieces
# ---------------------------------------------------------------------------

class LeafShard:
    """Where one leaf's update runs split (``_Chain.update``'s
    ``shards``): the leaf's whole ``shape`` and dim -> axis of its splits.
    ``mean`` averages over a dim across the ranks that split it (what
    Adafactor's factored moments need); ``without`` describes a tensor
    with one dim averaged away."""

    def __init__(self, shape: tuple, dims: dict, mesh):
        self.shape, self.dims, self.mesh = tuple(shape), dict(dims), mesh

    def mean(self, t, dim: int, keepdim: bool = False):
        m = t.mean(dim=dim, keepdim=keepdim)
        axis = self.dims.get(dim)
        if axis is None:
            return m
        return comm.all_reduce_(m.contiguous(), self.mesh, axis) / \
            self.mesh.size(axis)

    def without(self, dim: int) -> "LeafShard":
        return LeafShard(
            self.shape[:dim] + self.shape[dim + 1:],
            {(d if d < dim else d - 1): a for d, a in self.dims.items()
             if d != dim}, self.mesh)


def full_shape(t, spec: tuple, mesh) -> tuple:
    """The whole shape of a leaf held as ``t`` under ``spec``."""
    shape = list(t.shape)
    for d, a in spec_dims(spec).items():
        shape[d] *= mesh.size(a)
    return tuple(shape)


class Plan:
    """How a rank holds, reduces and updates each leaf of a state placed
    by ``place_state`` (``leaves`` order): ``param`` the params' specs,
    ``update`` the specs the optimizer update runs at (the moments':
    the params' with ZeRO's ``data`` split), ``grad`` the reduced
    gradients' under ZeRO-2 (``grad_shardings``), else the params'."""

    def __init__(self, specs, mesh, params, grad_specs=None):
        from vitx_torch.train.step import leaves

        self.mesh = mesh
        self.param_tree = specs.params
        self.param = _spec_leaves(specs.params)
        held = leaves(params)
        self.shapes = [full_shape(t, s, mesh)
                       for t, s in zip(held, self.param)]
        zero1 = _splits_data(specs.opt_state, specs.params)
        dp = mesh.shape[DATA_AXIS]
        self.update = [_moment_spec(_pad(s, len(shp)), shp, dp, zero1)
                       for s, shp in zip(self.param, self.shapes)]
        self.grad = ([_pad(s, len(shp)) for s, shp in
                      zip(_spec_leaves(grad_specs), self.shapes)]
                     if grad_specs is not None else list(self.param))

    def reduce(self, grads: list, wrt: list, final: bool) -> tuple:
        """The rank's gradients (``wrt``'s leaves) summed over the rows'
        axes (and the stages, ``REDUCE_AXES``) that the leaf is not split
        on -> (gradients, their specs). ``final`` gradients go onto
        ZeRO-2's splits by reduce-scatter; the others (SAM's first pass)
        are all-reduced whole."""
        mesh = self.mesh
        out, specs = [], []
        it = iter(grads)
        for i, w in enumerate(wrt):
            if not w:
                continue
            g = next(it)
            spec = _pad(self.param[i], len(self.shapes[i]))
            axes = [a for a in REDUCE_AXES if a not in spec]
            gspec = self.grad[i]
            split = [d for d, a in spec_dims(gspec).items()
                     if a == DATA_AXIS and spec[d] != DATA_AXIS]
            if final and split:
                g = comm.reduce_scatter_cat(g, mesh, DATA_AXIS, split[0])
                axes = [a for a in axes if a != DATA_AXIS]
                spec = gspec
            g = comm.all_reduce_(g.contiguous(), mesh, tuple(axes))
            out.append(g)
            specs.append(spec)
        return out, specs

    def norm(self, grads: list, specs: list):
        """fp32 global norm of gradients held under ``specs``: each leaf's
        squares summed over the axes it is split on, so a replicated leaf
        counts once."""
        parts: dict = {}
        for g, s in zip(grads, specs):
            if g is None:
                continue
            axes = tuple(sorted(set(a for a in s if a is not None
                                    and self.mesh.size(a) > 1)))
            sq = g.float().square().sum()
            # summed leaf by leaf, in order, as ``global_norm``: a mesh of
            # one rank gives the single-process norm bit for bit
            parts[axes] = sq if axes not in parts else parts[axes] + sq
        total = None
        for axes in sorted(parts):
            part = comm.all_reduce_(parts[axes], self.mesh, axes)
            total = part if total is None else total + part
        return torch.sqrt(total)

    def apply(self, optimizer, state, grads: list, gspecs: list,
              wrt: list):
        """One optimizer update of ``state`` (in place) from the reduced
        gradients -> (params, opt_state): each leaf updated at its
        ``update`` spec (a ZeRO slice an owned contiguous copy, gathered
        back into the param after), the clipping norm over every rank."""
        from vitx_torch.train.step import leaf_paths, leaves

        mesh = self.mesh
        held = leaves(state.params)
        units, gl, gathers, shards, uspecs = [], [], [], [], []
        it = iter(zip(grads, gspecs))
        for i, (p, w) in enumerate(zip(held, wrt)):
            spec = _pad(self.param[i], len(self.shapes[i]))
            uspec = self.update[i]
            extra = [d for d, a in spec_dims(uspec).items()
                     if a == DATA_AXIS and spec[d] != DATA_AXIS]
            unit = p
            if extra:
                unit = comm.chunk_of(p, mesh, DATA_AXIS, extra[0]) \
                    .contiguous().clone()
                gathers.append((p, unit, extra[0]))
            units.append(unit)
            shards.append(LeafShard(self.shapes[i], spec_dims(uspec), mesh))
            uspecs.append(uspec)
            g = None
            if w:
                g, gs = next(it)
                if gs != uspec:
                    g = comm.chunk_of(g, mesh, DATA_AXIS, extra[0]) \
                        .contiguous()
            gl.append(g)
        tree = _rebuild(state.params, leaf_paths(state.params), units)

        def norm(gs):
            return self.norm(gs, uspecs)
        _, opt_state = optimizer.update(gl, state.opt_state, tree,
                                        norm=norm, shards=shards)
        with torch.no_grad():
            for p, unit, d in gathers:
                p.copy_(comm.all_gather_cat(unit, mesh, DATA_AXIS, d))
        return state.params, opt_state


def _pad(spec: tuple, n: int) -> tuple:
    return tuple(spec) + (None,) * (n - len(spec))


def _spec_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _spec_leaves(tree[k])]
    return [tuple(tree)]


def _splits_data(opt_specs, param_specs) -> bool:
    """Whether a state's specs split the optimizer tensors over ``data``
    (zero1), read off its per-leaf trees."""
    pl = _spec_leaves(param_specs)
    for name in opt_specs._fields:
        tree = getattr(opt_specs, name)
        if isinstance(tree, dict):
            if any(DATA_AXIS in s for s in _spec_leaves(tree)):
                return True
    return any(DATA_AXIS in s for s in pl)


def _rebuild(tree, paths: list, tensors: list):
    out: dict = {}
    for path, t in zip(paths, tensors):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def forward_params(params, specs, mesh):
    """The params the forward reads: the leaves split over ``data``
    (ZeRO-3) all-gathered along that dim (backward: the gradients
    reduce-scattered onto the rank's part); the rest as held."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        for d, a in spec_dims(s).items():
            if a == DATA_AXIS:
                return comm.gather(t, mesh, DATA_AXIS, d)
        return t
    return walk(params, specs)


def family_step_parts(rng, rows_local: int, mesh):
    """The pretraining families' dp step on one rank: -> (generator, the
    loss's denominator hook): the generator a ``ShardedGenerator`` over
    the rank's rows (None without ``rng``)."""
    rows = batch_rows(mesh, rows_local)
    gen = None if rng is None else ShardedGenerator.following(rng, rows)
    return gen, denominator(mesh)


def all_reduce_grads(grads: list, mesh) -> list:
    """Replicated leaves' gradients summed over the batch's ranks (the
    families' dp-only layout)."""
    return [comm.all_reduce_(g.contiguous(), mesh, BATCH_AXES)
            for g in grads]


def gather_batch(t, mesh):
    """Every rank's rows of a batch tensor, in global order (no
    gradient: the rows mixup pairs with)."""
    return comm.all_gather_cat(t.detach(), mesh, _batch_axes(mesh), 0)


def global_sum(x, mesh):
    """x (detached, fp32) summed over the batch's ranks."""
    return comm.all_reduce_(x.detach().float().clone(), mesh, BATCH_AXES)


def denominator(mesh):
    """The loss's hook for a global mean: a rank's denominator -> the sum
    of every rank's (no gradient flows through a count)."""
    return lambda d: global_sum(d, mesh)


def sharded_train_step(state, batch, rng=None, *, cfg: ViTConfig,
                       optimizer, mesh, state_specs=None,
                       label_smoothing: float = 0.0,
                       mixup_alpha: float | None = None,
                       cutmix_alpha: float | None = None,
                       sam_rho: float | None = None, class_weights=None,
                       grad_shardings=None, train_filter: str | None = None,
                       loss: str = "ce", mix=None):
    """``train_step`` on one rank of ``mesh`` (``train_step(mesh=...)``):
    ``state`` this rank's (``place_state``), ``batch`` its rows,
    ``state_specs`` the state's specs (``state_sharding``; the params'
    ``param_pspecs`` with the mesh's tp and ``cfg.ep`` by default), ``rng``
    a generator seeded alike on every rank. Returns (state, metrics), the
    metrics those of the global batch, the same on every rank."""
    from vitx_torch.train import step as S

    if state_specs is None:
        state_specs = state_sharding(state, cfg, mesh, tp=mesh.tp > 1,
                                     ep=bool(cfg.ep))
    plan = Plan(state_specs, mesh, state.params, grad_shardings)
    batch = S._to_device(batch, mesh.device)
    rows = batch_rows(mesh, batch["image"].shape[0])
    gen = None if rng is None else ShardedGenerator.following(rng, rows)
    params, wrt = S.trainable_params(state.params, train_filter)
    rng_state = gen.get_state() if sam_rho and gen is not None else None

    def loss_of(p):
        return S.loss_fn(forward_params(p, plan.param_tree, mesh), batch,
                         cfg, gen, label_smoothing=label_smoothing,
                         mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                         class_weights=class_weights, loss=loss, mix=mix,
                         mesh=mesh)

    loss_v, logits = loss_of(params)
    grads, gspecs = plan.reduce(S.gradients(loss_v, params, wrt), wrt,
                                final=not sam_rho)
    grad_norm = plan.norm(grads, gspecs)
    if sam_rho:
        grads = S.sam_gradients(loss_of, state.params, wrt, grads,
                                grad_norm, sam_rho, gen, rng_state)
        grads, gspecs = plan.reduce(grads, wrt, final=True)
    new_params, opt_state = plan.apply(optimizer, state, grads, gspecs, wrt)
    if rng is not None:
        rng.set_state(gen.get_state())
    metrics = {"loss": global_sum(loss_v, mesh),
               "accuracy": _accuracy(logits, batch, mesh),
               "grad_norm": grad_norm}
    return S.TrainState(state.step + 1, new_params, opt_state), metrics


@torch.no_grad()
def _accuracy(logits, batch, mesh):
    labels = batch["label"]
    if labels.dim() == 2:
        correct = ((logits > 0) == (labels > 0.5)).float().mean(dim=-1)
    else:
        correct = (logits.argmax(dim=-1) == labels.long()).float()
    m = batch["mask"].float() if "mask" in batch else \
        torch.ones_like(correct)
    return global_sum((correct * m).sum(), mesh) / \
        global_sum(m.sum(), mesh).clamp_min(1.0)


@torch.no_grad()
def sharded_eval_step(params, batch, *, cfg: ViTConfig, mesh,
                      param_specs=None):
    """``eval_step`` on one rank: its rows' forward, the confusion matrix
    summed over every rank (the same on each, ``vitx/parallel/
    sharded.py:404-418``) and the global mean loss."""
    from vitx_torch.metrics.metrics import confusion_matrix
    from vitx_torch.nn.vit import model_logits
    from vitx_torch.train.step import _to_device, cross_entropy_loss

    if param_specs is None:
        param_specs = param_pspecs(cfg, mesh.tp > 1, bool(cfg.ep))
    batch = _to_device(batch, mesh.device)
    p = forward_params(params, param_specs, mesh)
    logits = model_logits(p, batch["image"], cfg, mesh=mesh)
    preds = logits.argmax(dim=-1)
    labels = batch["label"].long()
    C = cfg.num_classes
    if "mask" in batch:
        mask = batch["mask"].long()
        cm = confusion_matrix(preds * mask, labels * mask, C)
        cm[0, 0] -= (1 - mask).sum().to(cm.dtype)
    else:
        cm = confusion_matrix(preds, labels, C)
    cm = comm.all_reduce_(cm.contiguous(), mesh, BATCH_AXES)
    loss = cross_entropy_loss(logits, labels, batch.get("mask"),
                              reduce=denominator(mesh))
    return cm, global_sum(loss, mesh)


def make_parallel_train_step(cfg: ViTConfig, optimizer, mesh,
                             tp: bool = False, zero1: bool = False,
                             zero3: bool = False, state_shardings=None,
                             label_smoothing: float = 0.0,
                             mixup_alpha: float | None = None,
                             cutmix_alpha: float | None = None,
                             sam_rho: float | None = None,
                             class_weights=None, grad_shardings=None,
                             train_filter: str | None = None,
                             sp: bool = False, ep: bool = False,
                             loss: str = "ce"):
    """``(state, batch, rng=None) -> (state, metrics)`` on one rank of
    ``mesh`` (``vitx/parallel/sharded.py:381-438``): the config through
    ``tp_safe_cfg``, ``sp_cfg`` and ``ep_cfg``; ``state_shardings``
    (``state_sharding``) the placed state's specs, by default those of
    the flags; ``grad_shardings`` (``grad_sharding``) for ZeRO-2."""
    _check_tp(mesh, tp)
    cfg = ep_cfg(sp_cfg(tp_safe_cfg(cfg, tp), tp, sp), mesh, ep)
    specs = state_shardings

    def step(state, batch, rng=None):
        nonlocal specs
        if specs is None:
            specs = state_sharding(state, cfg, mesh, tp, zero1, zero3, ep=ep)
        return sharded_train_step(
            state, batch, rng, cfg=cfg, optimizer=optimizer, mesh=mesh,
            state_specs=specs, label_smoothing=label_smoothing,
            mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
            sam_rho=sam_rho, class_weights=class_weights,
            grad_shardings=grad_shardings, train_filter=train_filter,
            loss=loss)
    return step


def make_parallel_eval_step(cfg: ViTConfig, mesh, tp: bool = False,
                            sp: bool = False, ep: bool = False,
                            param_specs=None):
    """``(params, batch) -> (cm, loss)`` on one rank, the confusion matrix
    all-reduced (``vitx/parallel/sharded.py:441-454``); ``param_specs``
    the held params' (ZeRO-3's), by default ``param_pspecs``."""
    _check_tp(mesh, tp)
    cfg = ep_cfg(sp_cfg(tp_safe_cfg(cfg, tp), tp, sp), mesh, ep)
    specs = param_specs or param_pspecs(cfg, tp, ep)

    def step(params, batch):
        return sharded_eval_step(params, batch, cfg=cfg, mesh=mesh,
                                 param_specs=specs)
    return step
