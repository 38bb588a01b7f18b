"""Deployment programs (``.pt2``): the inference forward as a
``torch.export`` program with the parameters baked in.

The counterpart of ``vitx/export.py``, which serialises vitx's forward as
StableHLO with its Pallas kernels inside. ``export_forward`` traces the
port's production forward -- the card's routes, with K1 and K2 in every
block (B8 under ToMe, B5 in the composed path of a QKV-bias model) as the
``vitx_torch::`` custom ops of ``vitx_torch/kernels/ops.py`` -- into a
``torch.export.ExportedProgram`` whose state holds the parameters. The
batch is symbolic (one program, any batch), except under ToMe, whose
token counts are static per block: those programs pin the batch, as
vitx's do. The program runs on the device it was traced on (its constants
and factory calls carry it); traced on the card, its ops launch the
kernels and count them as the wrappers do, and on the CPU they run their
plain versions.

``save_exported`` writes the program (``torch.export.save``) and the same
``<path>.json`` sidecar as vitx (config, batch_size, with_softmax), so
``serve --checkpoint m.pt2`` and ``resolve_artifact_config`` read it.
``.pt2`` and vitx's ``.stablehlo`` do not interchange: each is its own
framework's program, and each package refuses the other's.
"""

from __future__ import annotations

import json
import os

import torch

from vitx_torch.core.config import ViTConfig

SUFFIX = ".pt2"
# the example batch of a symbolic-batch trace: at least 2, so that the
# batch does not specialise to 1
_TRACE_BATCH = 2


class _Forward(torch.nn.Module):
    """images -> fp32 logits (or probabilities) of one parameter tree,
    held as buffers so that the program's state carries them."""

    def __init__(self, params, cfg: ViTConfig, with_softmax: bool):
        super().__init__()
        self.cfg = cfg
        self.with_softmax = with_softmax
        self._paths = []
        from vitx_torch.train.checkpoint import _sorted_leaves

        for path, leaf in _sorted_leaves(params):
            name = "__".join(path)
            self.register_buffer(name, leaf.detach())
            self._paths.append((path, name))

    def params(self) -> dict:
        tree: dict = {}
        for path, name in self._paths:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, name)
        return tree

    def forward(self, images):
        from vitx_torch.nn.vit import model_logits

        logits = model_logits(self.params(), images, self.cfg).float()
        if self.with_softmax:
            return torch.softmax(logits, dim=-1)
        return logits


def export_forward(params, cfg: ViTConfig, *, batch_size: int | None = None,
                   with_softmax: bool = False):
    """Export the inference forward with ``params`` baked in, traced on
    the parameters' device (``vitx/export.py:31-58``).

    batch_size None: a symbolic batch dimension, one program for any
    batch (no ToMe: its merges are traced at static token counts); an int
    pins the batch. Returns a ``torch.export.ExportedProgram``; its
    ``module()`` is the callable.
    """
    if batch_size is None and cfg.tome_r:
        raise ValueError("tome_r exports need a pinned batch_size (the "
                         "merge scatter shapes depend on it)")
    module = _Forward(params, cfg, with_softmax)
    dev = next(iter(module.buffers())).device
    b = batch_size or _TRACE_BATCH
    example = torch.zeros((b, cfg.image_size, cfg.image_size,
                           cfg.num_channels), dtype=cfg.cdtype(), device=dev)
    dynamic = None if batch_size else ({0: torch.export.Dim("batch", min=1)},)
    with torch.no_grad():
        return torch.export.export(module, (example,),
                                   dynamic_shapes=dynamic)


def save_exported(path, params, cfg: ViTConfig, **kw):
    """Write ``export_forward``'s program to ``path`` and a ``<path>.json``
    sidecar (config + export options, as vitx's); returns the file's byte
    count."""
    torch.export.save(export_forward(params, cfg, **kw), path)
    sidecar = {"config": json.loads(cfg.to_json()),
               "batch_size": kw.get("batch_size"),
               "with_softmax": bool(kw.get("with_softmax", False))}
    with open(f"{path}.json", "w") as f:
        json.dump(sidecar, f)
    return os.path.getsize(path)


def peek_meta(path):
    """An artifact's ``<path>.json`` sidecar (None if absent); vitx's
    ``.stablehlo`` sidecars are the same JSON."""
    side = f"{path}.json"
    if not os.path.exists(side):
        return None
    with open(side) as f:
        return json.load(f)


def load_exported(path):
    """Load a ``.pt2`` program (an ``ExportedProgram``; ``.module()(images)``
    runs it). The ``vitx_torch::`` ops are registered first."""
    import vitx_torch.kernels.ops  # noqa: F401  the program's kernel ops

    return torch.export.load(path)
