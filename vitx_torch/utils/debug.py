"""Parameter inspection: the counterpart of ``vitx/utils/debug.py``.

Prints every tensor of a parameter tree with its path, shape, dtype and
value statistics, or its full values where it is small, in the same text
as vitx's for the same parameters (dtypes by their numpy names,
``float32``).
"""

from __future__ import annotations

import numpy as np
import torch


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _host32(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, dtype=np.float32)


def param_summary(params) -> str:
    """One line per tensor: path, shape, dtype, mean/std/min/max."""
    lines = []
    total = 0
    for path, leaf in _walk(params):
        arr = _host32(leaf)
        total += arr.size
        lines.append(
            f"{path:50s} {str(arr.shape):18s} {_dtype_name(leaf):9s} "
            f"mean={arr.mean():+.4f} std={arr.std():.4f} "
            f"min={arr.min():+.4f} max={arr.max():+.4f}")
    lines.append(f"{'TOTAL':50s} {total:,} parameters")
    return "\n".join(lines)


def dump_params(params, *, max_full: int = 64, file=None) -> None:
    """Print the summary; tensors with at most ``max_full`` elements print
    in full (bfloat16 ones as their float32 values)."""
    print(param_summary(params), file=file)
    for path, leaf in _walk(params):
        if torch.is_tensor(leaf):
            arr = (leaf.detach().float() if leaf.dtype == torch.bfloat16
                   else leaf.detach()).cpu().numpy()
        else:
            arr = np.asarray(leaf)
        if arr.size <= max_full:
            print(f"\n{path} =\n{np.array2string(arr, precision=4)}",
                  file=file)
