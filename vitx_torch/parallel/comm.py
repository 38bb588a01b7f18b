"""The collectives of the sharded steps, plain and differentiable.

vitx gets its collectives from XLA's SPMD partitioner; the port writes
them out as ``torch.distributed`` calls, the differentiable ones as
``torch.autograd.Function`` pairs -- the conjugate pairs vitx writes by
hand for its pipeline stages (``vitx/parallel/pipeline.py:175-203``,
``_tp_g``/``_tp_f``):

- ``copy_to`` (Megatron's f): identity forward, all-reduce backward;
- ``reduce_from`` (Megatron's g): all-reduce forward, identity backward;
- ``all_reduce_sum``: all-reduce both ways (a sum whose every rank's
  downstream holds its own share of the loss, e.g. global batch moments);
- ``gather`` / ``reduce_scatter``: all-gather along a dim and its
  conjugate (sequence parallelism, ZeRO-3's parameters);
- ``scatter``: keep this rank's chunk, all-gather backward (entering
  the token-sharded region);
- ``gather_replicated``: all-gather whose backward keeps this rank's
  slice of the gradient (a gather every rank consumes the same way:
  SimCLR's global negatives, leaving the token-sharded region);
- ``all_to_all``: chunks of one dim out, the ranks' chunks along another
  dim in, and the reverse backward (expert parallelism);
- ``send_stage`` / ``recv_stage``: the pipeline's stage handoff, a
  point-to-point shift to the next stage (vitx's ``ppermute`` with
  ``perm = [(i, i + 1)]``, ``vitx/parallel/pipeline.py:407,425``) or, for
  cotangents, to the previous one (``pipeline.py:578,646``). They are
  not differentiable: the pipeline's schedules call them between their
  forwards and backwards, in an order they fix.

Every op takes the ``Mesh`` and a set of its axes; over axes of size 1 it
is the identity. A rank's chunk along a dim is its index in the group
(``Mesh.index``), the order of the group's ranks.

On the ``gloo`` backend (ranks that share a card, or the CPU), every
collective takes the tensors themselves -- gloo accepts CUDA tensors for
all-reduce, all-gather, reduce-scatter and broadcast in the torch the
card runs (2.11) -- except all-to-all, which gloo does not implement
there: on gloo it is an all-gather of each rank's whole input, of which
each rank keeps the chunks addressed to it (``all_to_all_cat``), on every
call. ``nccl`` runs the all-to-all itself. The stage handoff takes one
route on every backend: a ``broadcast`` from the sender over the link's
two-rank group (``Mesh.stage_link``), which gloo takes on CUDA tensors
there, as nccl does; gloo's ``send``/``recv`` is not relied on.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_(x, mesh, axes):
    """Sum ``x`` in place over ``axes``; returns it."""
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather_cat(x, mesh, axes, dim: int = 0):
    """The group's tensors along ``dim``, in rank order."""
    group = mesh.group(axes)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_cat(x, mesh, axes, dim: int = 0):
    """This rank's chunk along ``dim`` of the group's sum of ``x``."""
    group = mesh.group(axes)
    if group is None:
        return x
    n = mesh.size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) "
                         f"over {n} ranks")
    chunks = [c.contiguous() for c in x.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def all_to_all_cat(x, mesh, axes, split_dim: int, cat_dim: int):
    """Chunk ``split_dim`` into one piece per rank of the group, send
    piece j to rank j, and concatenate what arrives along ``cat_dim``,
    in rank order. On gloo: every rank's input all-gathered, this rank's
    chunk of each kept (the module's doc)."""
    group = mesh.group(axes)
    if group is None:
        return x
    n = mesh.size(axes)
    if mesh.backend == "gloo":
        x = x.contiguous()
        whole = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(whole, x, group=group)
        me = mesh.index(axes)
        return torch.cat([w.chunk(n, dim=split_dim)[me] for w in whole],
                         dim=cat_dim)
    ins = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=group)
    return torch.cat(outs, dim=cat_dim)


def chunk_of(x, mesh, axes, dim: int):
    """This rank's chunk of ``x`` along ``dim`` (no communication)."""
    n = mesh.size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not split over "
                         f"{n} ranks")
    return x.chunk(n, dim=dim)[mesh.index(axes)]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axes), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axes), \
            None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather_cat(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_cat(g, ctx.mesh, ctx.axes, ctx.dim), \
            None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter_cat(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.mesh, ctx.axes, ctx.dim), \
            None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return chunk_of(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.mesh, ctx.axes, ctx.dim), \
            None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather_cat(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, cat_dim):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.split_dim, ctx.cat_dim = split_dim, cat_dim
        return all_to_all_cat(x, mesh, axes, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_cat(g, ctx.mesh, ctx.axes, ctx.cat_dim,
                              ctx.split_dim), None, None, None, None


def _op(fn, x, mesh, axes, *args):
    if mesh is None or mesh.size(axes) == 1:
        return x
    return fn.apply(x, mesh, axes, *args)


def copy_to(x, mesh, axes):
    """Megatron's f: x as it is; its gradient summed over ``axes``."""
    return _op(_CopyTo, x, mesh, axes)


def reduce_from(x, mesh, axes):
    """Megatron's g: x summed over ``axes``; its gradient as it is."""
    return _op(_ReduceFrom, x, mesh, axes)


def all_reduce_sum(x, mesh, axes):
    """x summed over ``axes``, its gradient summed likewise."""
    return _op(_AllReduceSum, x, mesh, axes)


def gather(x, mesh, axes, dim: int):
    """All-gather along ``dim``; backward reduce-scatter."""
    return _op(_Gather, x, mesh, axes, dim)


def reduce_scatter(x, mesh, axes, dim: int):
    """Reduce-scatter along ``dim``; backward all-gather."""
    return _op(_ReduceScatter, x, mesh, axes, dim)


def scatter(x, mesh, axes, dim: int):
    """This rank's chunk along ``dim``; backward all-gather."""
    return _op(_Scatter, x, mesh, axes, dim)


def gather_replicated(x, mesh, axes, dim: int):
    """All-gather along ``dim``; backward this rank's slice."""
    return _op(_GatherReplicated, x, mesh, axes, dim)


def all_to_all(x, mesh, axes, split_dim: int, cat_dim: int):
    """``all_to_all_cat`` with the reverse exchange as its backward."""
    return _op(_AllToAll, x, mesh, axes, split_dim, cat_dim)


def send_stage(x, mesh, step: int) -> None:
    """Send ``x`` to the rank ``step`` (+1 or -1) stages on, at this
    rank's other coordinates; it calls ``recv_stage(..., -step)``. Blocks
    until the link has taken it."""
    group, _ = mesh.stage_link(step)
    dist.broadcast(x.detach().contiguous(), src=mesh.rank, group=group)


def recv_stage(shape, dtype, mesh, step: int):
    """What the rank ``step`` (-1 or +1) stages on sends this rank
    (``send_stage(..., -step)``): a new tensor of ``shape`` and ``dtype``
    on the mesh's device."""
    group, peer = mesh.stage_link(step)
    out = torch.empty(shape, dtype=dtype, device=mesh.device)
    dist.broadcast(out, src=peer, group=group)
    return out
