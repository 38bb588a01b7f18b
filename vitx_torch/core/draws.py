"""Random draws that a sharded step makes at the global shape.

A rank of a data- or sequence-parallel step holds some rows (and, under
sequence parallelism, some tokens) of the global batch. So that a sharded
run draws what one process running the whole batch would, each rank
draws every per-row mask and per-image parameter at the global shape from
the same stream and keeps its own part: a ``ShardedGenerator`` (a
``torch.Generator`` that knows the rank's rows) passed where a generator
goes, and ``rand`` at every per-row draw site (dropout, drop-path, patch
dropout, MAE's masking noise, the pretraining views' draws).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class ShardedGenerator(torch.Generator):
    """A generator whose per-row draws (``rand``) are made for the rows
    ``rows = (start, total)`` of a global batch of ``total`` rows and
    sliced to this rank's ``start:start + n``."""

    rows: tuple | None = None

    @classmethod
    def following(cls, gen: torch.Generator, rows: tuple):
        """A sharded copy of ``gen``'s current state for ``rows``."""
        out = cls(device=gen.device)
        out.set_state(gen.get_state())
        out.rows = rows
        return out


def rand(shape, gen, device, *, tokens: tuple | None = None):
    """``torch.rand(shape)`` from ``gen``. Under a ``ShardedGenerator``
    the draw is made at the global row count and sliced to this rank's
    rows; ``tokens = (start, total)`` says dim 1 holds the tokens
    ``start:start + shape[1]`` of ``total`` (zero-padded past ``total``,
    the sequence-parallel carrier's padding) and draws all ``total``."""
    rows = getattr(gen, "rows", None)
    if rows is None and tokens is None:
        return torch.rand(shape, generator=gen, device=device)
    full = list(shape)
    if rows is not None:
        full[0] = rows[1]
    if tokens is not None:
        full[1] = tokens[1]
    u = torch.rand(full, generator=gen, device=device)
    if rows is not None:
        u = u[rows[0]:rows[0] + shape[0]]
    if tokens is not None:
        start, total = tokens
        end = start + shape[1]
        if end > total:
            u = F.pad(u, (0, 0) * (u.dim() - 2) + (0, end - total))
        u = u[:, start:end]
    return u
