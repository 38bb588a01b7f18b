"""Weight-only int8 artifacts (``.quant.npz``), the format vitx writes.

The counterpart of ``vitx/quant.py``; a file either package writes loads
in the other. Symmetric int8 for every matmul weight, by leaf name
(``_WEIGHT_NAMES``: block ``wqkv``/``wo``/``w1``/``w2``/``w3``, the
patch-embed ``kernel``, the head's ``w``/``w1``/``w2``), with one fp32
scale per output channel (per layer for the stacked block leaves);
embeddings, LayerNorm parameters and biases stay as they are. The file is
a flat npz of ``q::<path>`` int8 tensors, ``s::<path>`` fp32 scales,
``f::<path>`` float leaves and ``__meta__`` (JSON as uint8 bytes:
``{"dtypes": {path: numpy dtype name}, "user": {...}}``), the paths in
vitx's order (``blocks/wqkv``, ``head/w1``, ...: sorted keys joined by
``/``).

The quantization runs on the host in numpy, as vitx's does (``np.round``
rounds half to even). A bfloat16 leaf is no numpy float, so vitx stores
it unquantized, and so does the port: it goes into the npz as its 2-byte
bit pattern, which numpy reads back as void (``|V2``), as it reads vitx's
bfloat16 members; ``load_quantized`` reinterprets those bits. Loading
dequantizes to a float parameter tree, so the forward, the server and the
CLIs take it unchanged: an artifact is a storage format, 1/4 of the fp32
size, not an int8 runtime (vitx measured one slower and retired it).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from vitx_torch.core.device import resolve_device

SUFFIX = ".quant.npz"

# matmul weights, by leaf name: an allowlist, because the block leaves are
# stacked (depth, ...) and an ndim rule would take the (L, E) LayerNorm
# parameters and biases too (vitx/quant.py:37-44)
_WEIGHT_NAMES = frozenset({"wqkv", "wo", "w1", "w2", "w3", "w", "kernel"})


def _walk(tree, prefix=""):
    """(path, leaf) in vitx's order: sorted keys, joined by "/"."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype ("float32", "bfloat16")."""
    return str(t.dtype).removeprefix("torch.")


def _host(t: torch.Tensor) -> np.ndarray:
    """A leaf as the numpy array vitx writes: bfloat16 as its 2-byte bit
    pattern (``|V2``), anything else as is."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


# the dtypes numpy counts as floating (vitx's np.issubdtype test): a
# bfloat16 leaf is not one, so vitx stores it as it is, and so does the port
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _should_quantize(path_s: str, t: torch.Tensor) -> bool:
    if t.dim() < 2 or t.dtype not in _NUMPY_FLOATS:
        return False
    return path_s.rsplit("/", 1)[-1] in _WEIGHT_NAMES


def _scale_axes(path_s: str, ndim: int) -> tuple:
    """The input (contraction) axes, reduced so that every output channel
    keeps its own scale (``vitx/quant.py:54-66``): axis 1 of the stacked
    (depth, in, out...) block leaves, every axis but the last elsewhere."""
    if path_s.startswith("blocks/"):
        return (1,)
    return tuple(range(ndim - 1))


def quantize_leaf(w, path_s: str):
    """(int8 q, fp32 scale) with w ~ q * scale (symmetric, zero-point 0);
    ``w`` a numpy array or a tensor."""
    if torch.is_tensor(w):
        w = w.detach().float().cpu().numpy()
    w32 = np.asarray(w, dtype=np.float32)
    axes = _scale_axes(path_s, w32.ndim)
    amax = np.max(np.abs(w32), axis=axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w32 / scale), -127, 127).astype(np.int8)
    return q, scale


def save_quantized(path, params, meta: dict | None = None):
    """Write an int8 artifact of the parameter tree ``params``; ``meta``
    (e.g. the config JSON) is stored as ``__meta__``'s "user". Returns the
    path."""
    path = pathlib.Path(path)
    flat, dtypes = {}, {}
    for ps, leaf in _walk(params):
        dtypes[ps] = _dtype_name(leaf)
        if _should_quantize(ps, leaf):
            q, s = quantize_leaf(leaf, ps)
            flat[f"q::{ps}"] = q
            flat[f"s::{ps}"] = s
        else:
            flat[f"f::{ps}"] = _host(leaf)
    flat["__meta__"] = np.frombuffer(json.dumps(
        {"dtypes": dtypes, "user": meta or {}}).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **flat)
    return path


def _float_leaf(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored float leaf as a tensor of ``dtype_name``: 2-byte void
    members (bfloat16 written by either package) by their bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if dtype_name != "bfloat16":
            raise ValueError(f"a 2-byte void member recorded as "
                             f"{dtype_name!r}, not bfloat16")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        getattr(torch, dtype_name))


def _template_shape(leaf) -> tuple:
    """A template leaf's shape: a tensor, or ``param_spec``'s (shape,
    init)."""
    return tuple(leaf.shape) if torch.is_tensor(leaf) else tuple(leaf[0])


def load_quantized(path, template, *, device="cuda"):
    """Dequantize an artifact into the structure of ``template`` (the
    port's ``param_spec(cfg)`` or a parameter tree of the same config),
    each leaf in the dtype the artifact records, on ``device``. Returns
    (params, user_meta)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    dtypes = meta["dtypes"]

    def rebuild(ps, leaf):
        if f"q::{ps}" in arrays:
            w = torch.from_numpy(arrays[f"q::{ps}"].astype(np.float32)
                                 * arrays[f"s::{ps}"]).to(
                getattr(torch, dtypes[ps]))
        elif f"f::{ps}" in arrays:
            w = _float_leaf(arrays[f"f::{ps}"], dtypes[ps])
        else:
            raise KeyError(f"artifact is missing parameter {ps!r}")
        if tuple(w.shape) != _template_shape(leaf):
            raise ValueError(f"{ps}: artifact shape {tuple(w.shape)} != "
                             f"model shape {_template_shape(leaf)}")
        return w.to(dev)

    def build(node, prefix=""):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict)
                else rebuild(f"{prefix}{k}", v) for k, v in node.items()}

    return build(template), meta["user"]


def peek_meta(path) -> dict:
    """An artifact's user meta (e.g. the stored config JSON), without
    dequantizing anything."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())["user"]


def quantization_error(params) -> dict:
    """Per-leaf max |w - dequant(quant(w))| / amax over the quantized
    leaves: at most 1/254 for symmetric int8 (``vitx/quant.py:146-158``)."""
    out = {}
    for ps, leaf in _walk(params):
        if not _should_quantize(ps, leaf):
            continue
        arr = leaf.detach().float().cpu().numpy()
        q, s = quantize_leaf(arr, ps)
        err = np.max(np.abs(arr - q.astype(np.float32) * s))
        amax = float(np.max(np.abs(arr)))
        out[ps] = float(err / amax) if amax else 0.0
    return out
