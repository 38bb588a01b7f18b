"""Device selection: the port runs on a CUDA device unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (the port never falls back to the CPU on its
    own: pass ``device="cpu"`` for the plain torch versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vitx_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain torch versions "
            "of its kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"vitx_torch runs on cuda or cpu, not {dev}")
    return dev


def card_routes(x) -> bool:
    """Whether the model takes the card's routes (the kernels and the
    rules that choose them) for the tensor ``x``: ``x`` lies on a CUDA
    device, or a ``torch.export`` trace is running. An exported program is
    the card's forward wherever it is traced, as vitx exports the TPU's;
    on the CPU its kernel ops run their plain versions."""
    return x.is_cuda or torch.compiler.is_exporting()
