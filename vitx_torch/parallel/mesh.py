"""The rank mesh over an initialised ``torch.distributed`` process group.

The counterpart of ``vitx/parallel/mesh.py``. vitx lays its devices out as
a ``jax.sharding.Mesh`` with a ``data`` axis (batch and gradient
parallelism), a ``model`` axis (attention heads and the MLP hidden dim,
Megatron tensor parallelism) and, when asked, an ``expert`` axis (Soft-MoE
expert parallelism) or a ``stage`` axis (pipeline parallelism,
``vitx_torch.parallel.pipeline.make_pp_mesh``); XLA's partitioner inserts
the collectives. Here each rank is one process: ``make_mesh`` gives it its
coordinates on the same axes, row-major over (data, model[, expert]) --
(data, stage[, model]) for a pipeline -- as vitx's device array, and the
process sub-groups the collectives of ``vitx_torch.parallel.comm`` run
over, with one two-rank group per link between neighbouring stages (the
stage handoff's). Every rank builds every sub-group, in the same order, as
``dist.new_group`` requires.
"""

from __future__ import annotations

import itertools
import math
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"


class Mesh:
    """One rank's view of a (data, model[, expert]) mesh: ``shape`` (axis
    -> size, in mesh order), ``coords`` (axis -> this rank's index),
    ``device`` (the rank's device), ``backend`` (the process group's) and
    a process group per set of axes (``group``)."""

    def __init__(self, shape: dict, rank: int, device, backend: str):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.world = math.prod(self.shape.values())
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self._stride = {}
        s = 1
        for axis in reversed(self.axis_names):
            self._stride[axis] = s
            s *= self.shape[axis]
        self.coords = {a: (rank // self._stride[a]) % self.shape[a]
                       for a in self.axis_names}
        self._groups = {}
        self._links = {}
        if dist.is_initialized():
            self._build_groups()
            self._build_links()

    def _members(self, axes: frozenset, coords: dict) -> list:
        """The ranks that share ``coords`` off ``axes``, ascending (which
        is row-major over ``axes``: the order of a group's ranks)."""
        ranges = [range(self.shape[a]) if a in axes else [coords[a]]
                  for a in self.axis_names]
        return sorted(sum(c * self._stride[a] for a, c in
                          zip(self.axis_names, idx))
                      for idx in itertools.product(*ranges))

    def _build_groups(self) -> None:
        busy = [a for a in self.axis_names if self.shape[a] > 1]
        for r in range(1, len(busy) + 1):
            for sub in itertools.combinations(busy, r):
                axes = frozenset(sub)
                fixed = [a for a in self.axis_names if a not in axes]
                for idx in itertools.product(
                        *(range(self.shape[a]) for a in fixed)):
                    coords = dict(zip(fixed, idx))
                    ranks = self._members(axes, {**self.coords, **coords})
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = group

    def _build_links(self) -> None:
        """One group per pair of neighbouring stages (s, s + 1) at every
        other coordinate, in row-major order of the lower rank."""
        n = self.shape.get(STAGE_AXIS, 1)
        if n < 2:
            return
        stride = self._stride[STAGE_AXIS]
        for low in range(self.world):
            if (low // stride) % n == n - 1:
                continue
            group = dist.new_group([low, low + stride])
            if self.rank == low:
                self._links[1] = group
            elif self.rank == low + stride:
                self._links[-1] = group

    def stage_link(self, step: int) -> tuple:
        """(the two-rank group, the peer's rank) of the link to the stage
        ``step`` (+1 the next, -1 the previous) on from this rank's."""
        if step not in self._links:
            raise ValueError(f"stage {self.coords.get(STAGE_AXIS, 0)} has "
                             f"no neighbour {step:+d} stage(s) on")
        return self._links[step], self.rank + step * self._stride[STAGE_AXIS]

    def _busy(self, axes) -> frozenset:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return frozenset(a for a in axes
                         if a in self.shape and self.shape[a] > 1)

    def group(self, axes):
        """The process group over ``axes`` (a name or names) that holds
        this rank, or None where their sizes multiply to 1."""
        busy = self._busy(axes)
        return self._groups[busy] if busy else None

    def size(self, axes) -> int:
        """The product of the sizes of ``axes`` (absent ones count 1)."""
        return math.prod(self.shape[a] for a in self._busy(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (its rank in
        ``group(axes)``)."""
        i = 0
        for a in self.axis_names:
            if a in self._busy(axes):
                i = i * self.shape[a] + self.coords[a]
        return i

    @property
    def tp(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def dp(self) -> int:
        return self.shape.get(DATA_AXIS, 1)

    @property
    def ep(self) -> int:
        return self.shape.get(EXPERT_AXIS, 1)

    @property
    def pp(self) -> int:
        return self.shape.get(STAGE_AXIS, 1)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords="
                f"{self.coords}, device={self.device}, "
                f"backend={self.backend})")


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:{local_rank % device_count}`` for
    CUDA (``LOCAL_RANK``, else the global rank), ``device`` as given
    otherwise."""
    from vitx_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(dp: int | None = None, tp: int = 1, ep: int = 1, *,
              device="cuda") -> Mesh:
    """A (data, model) mesh -- (data, model, expert) when ``ep > 1`` --
    over the initialised default process group, with vitx's defaults and
    messages: dp defaults to world // (tp * ep). Every rank of the group
    takes part. ``device``: the rank's device (``rank_device``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(vitx_torch.parallel.launch)")
    n = dist.get_world_size()
    if dp is None:
        if n % (tp * ep):
            raise ValueError(f"{n} devices not divisible by "
                             f"tp={tp} x ep={ep}")
        dp = n // (tp * ep)
    need = dp * tp * ep
    if need > n:
        raise ValueError(f"need {need} devices (dp={dp} x tp={tp} x "
                         f"ep={ep}), have {n}")
    if need < n:
        raise ValueError(f"dp={dp} x tp={tp} x ep={ep} uses {need} of the "
                         f"group's {n} ranks; every rank takes part")
    shape = {DATA_AXIS: dp, MODEL_AXIS: tp}
    if ep > 1:
        shape[EXPERT_AXIS] = ep
    return Mesh(shape, dist.get_rank(), rank_device(device),
                dist.get_backend())
