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
