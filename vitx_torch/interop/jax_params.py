"""vitx parameters and optimizer states -> the port's.

vitx keeps its parameters as a nested dict of arrays (``vitx/nn/vit.py:100``)
and ``vitx.cli.pretrain --export-vit`` writes them to a bare ``.npz`` of
flat ``"a/b/c"`` keys (``vitx/cli/pretrain.py:286-288``). The port uses the
same tree, so conversion is a copy into torch tensors with the shapes
checked against ``param_spec``. The optimizers' states -- AdamW's
moments (mu fp32 or bf16), SGD's trace, Lion's momentum, Adafactor's
factored moments -- are trees of the same keys (``opt_state_from_jax``).
An export read into a config of another image size gets its positional
grid resized, as vitx's ``load_vit_init`` does
(``vitx/cli/pretrain.py:306-368``).
"""

from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.interop.pretrained import resize_pos_embed
from vitx_torch.nn.vit import init_leaf, param_spec


def _walk(spec, prefix=()):
    for key, node in spec.items():
        if isinstance(node, dict):
            yield from _walk(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def _put(tree, path, leaf):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _leaf(arr, cfg: ViTConfig, dev):
    # a copy: the train step updates its params in place, and the caller's
    # arrays must not change with them
    return torch.tensor(np.asarray(arr, np.float32)).to(cfg.pdtype()).to(dev)


def _resized_pos_embed(saved, cfg: ViTConfig):
    """A saved (1, prefix + g², E) table (an array, or a tensor on any
    device) resized in fp32 to ``cfg``'s grid, or None where the mismatch
    is not a pure change of square grid (``vitx/cli/pretrain.py:306-328``). ``parity="bug_exact"`` stores the
    CLS row after the patches, which the resize would blend into the grid,
    so it keeps the fresh init too."""
    if cfg.parity == "bug_exact":
        return None
    if (saved.ndim != 3 or saved.shape[0] != 1
            or saved.shape[2] != cfg.embed_dim):
        return None
    n_patches = saved.shape[1] - cfg.num_prefix_tokens
    g = math.isqrt(max(n_patches, 0))
    if g <= 0 or g * g != n_patches or g == cfg.grid_size:
        return None
    cfg_from = cfg.replace(image_size=g * cfg.patch_size)
    table = torch.as_tensor(saved).float()
    return resize_pos_embed({"pos_embed": table}, cfg_from,
                            cfg)["pos_embed"]


def params_from_jax(tree, cfg: ViTConfig, device="cuda", rng=0) -> dict:
    """The port's parameter tree from vitx's.

    ``tree`` is either vitx's nested dict (leaves: numpy arrays, or
    anything ``np.asarray`` reads) or the path of a bare params ``.npz``
    written by ``--export-vit``. The dict must hold exactly the leaves
    ``cfg`` has, each of its shape. From a ``.npz``, as in vitx's
    ``load_vit_init``, a ``pos_embed`` of another square grid (a 224²
    export read into a 512² config) is resized bilinearly to ``cfg``'s
    grid (``resize_pos_embed``) with a warning naming the two position
    counts; any other leaf the file lacks or holds in another shape --
    and a table that is no pure grid change, or any table under
    ``parity="bug_exact"`` -- keeps a fresh init drawn from ``rng`` (a
    seed or a ``torch.Generator``), named in one warning.
    """
    dev = resolve_device(device)
    spec = param_spec(cfg)
    out: dict = {}
    if isinstance(tree, (str, os.PathLike)):
        gen = rng if isinstance(rng, torch.Generator) else \
            torch.Generator().manual_seed(int(rng))
        fresh = []
        with np.load(tree) as data:
            for path, (shape, init) in _walk(spec):
                key = "/".join(path)
                if key in data.files and data[key].shape == tuple(shape):
                    _put(out, path, _leaf(data[key], cfg, dev))
                    continue
                if key == "pos_embed" and key in data.files:
                    resized = _resized_pos_embed(data[key], cfg)
                    if resized is not None:
                        warnings.warn(
                            f"{tree}: pos_embed resized from "
                            f"{data[key].shape[1]} to {cfg.pos_len} "
                            f"positions (grid {cfg.grid_size}x"
                            f"{cfg.grid_size})")
                        _put(out, path, resized.to(cfg.pdtype()).to(dev))
                        continue
                fresh.append(key)
                _put(out, path, init_leaf(shape, init, cfg, gen).to(dev))
        if fresh:
            warnings.warn(f"{tree}: fresh init kept for {fresh} (missing or "
                          f"shape-mismatched in the file)")
        return out

    seen = set()
    for path, (shape, _) in _walk(spec):
        node = tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"vitx params lack {'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, the "
                             f"config needs {tuple(shape)}")
        seen.add(path)
        _put(out, path, _leaf(arr, cfg, dev))
    extra = sorted("/".join(p) for p, _ in _walk(tree) if p not in seen)
    if extra:
        raise ValueError(f"vitx params carry leaves the config does not "
                         f"have (or the port lacks): {extra}")
    return out


# the optimizer nodes of vitx's chains, by the fields of their optax
# state: -> (the port's optimizer name, the slot fields)
_OPT_NODES = (("adafactor", ("count", "v_row", "v_col", "v")),
              ("adamw", ("count", "mu", "nu")),
              ("lion", ("count", "mu")),
              ("sgd", ("trace",)))


def _opt_node(state):
    """(name, node): the optimizer's own state inside an optax state --
    optax's ``ScaleByAdamState`` or vitx's ``FusedAdamWState``,
    ``TraceState``, ``ScaleByLionState`` or ``FactoredState`` -- found by
    its fields wherever the chain nests it; None when there is none."""
    have = set(getattr(state, "_fields", ()))
    for name, fields in _OPT_NODES:
        if have.issuperset(fields):
            return name, state
    if isinstance(state, (tuple, list)):
        found = [n for n in (_opt_node(s) for s in state) if n is not None]
        if len(found) > 1:
            raise ValueError("the optimizer state holds more than one "
                             "optimizer state")
        return found[0] if found else None
    return None


def _slot_tree(tree, dtype, dev):
    """A slot tree (nested dict of arrays, shapes as they are) as tensors
    of ``dtype`` on ``dev``."""
    if isinstance(tree, dict):
        return {k: _slot_tree(v, dtype, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32)).to(dtype).to(dev)


def opt_state_from_jax(opt_state, cfg: ViTConfig, device="cuda"):
    """The port's optimizer state from the state of vitx's
    ``make_optimizer(optimizer=...)``: an ``AdamWState`` (plain or
    ``fused=True``; mu fp32, or bf16 under ``mu_dtype="bfloat16"``), an
    ``SGDState``, a ``LionState`` or an ``AdafactorState``. A schedule and
    ``grad_clip`` keep no state of their own; the count of an SGD trace,
    which keeps none, is 0. The slots must be fp32 trees of the params'
    shapes (Adafactor's factored and placeholder shapes as the port's
    ``init`` makes them for ``cfg``)."""
    from vitx_torch.train.step import leaf_paths, leaves, make_optimizer

    found = _opt_node(opt_state)
    if found is None:
        raise ValueError("no optimizer state (adamw, sgd, lion or "
                         "adafactor) in the optimizer state")
    name, node = found
    dev = resolve_device(device)
    mu_dtype = None
    if name == "adamw":
        dt = {np.asarray(a).dtype.name for _, a in _walk(node.mu)}
        if dt == {"bfloat16"}:
            mu_dtype = "bfloat16"
        elif dt != {"float32"}:
            raise ValueError(f"mu must be float32 or bfloat16, got "
                             f"{sorted(dt)}")
    def shapes(spec):
        return {k: shapes(v) if isinstance(v, dict) else
                torch.empty(v[0], dtype=torch.float32, device="meta")
                for k, v in spec.items()}
    template = make_optimizer(optimizer=name, mu_dtype=mu_dtype).init(
        shapes(param_spec(cfg)))
    slots = {}
    for field in template.SLOTS:
        want = getattr(template, field)
        got = getattr(node, field)
        for path, t in zip(leaf_paths(want), leaves(want)):
            arr = got
            for k in path:
                arr = arr[k]
            if tuple(np.asarray(arr).shape) != tuple(t.shape):
                raise ValueError(f"{field}/{'/'.join(path)}: shape "
                                 f"{np.asarray(arr).shape}, the config "
                                 f"needs {tuple(t.shape)}")
        dtype = (torch.bfloat16 if field == "mu" and mu_dtype
                 else torch.float32)
        slots[field] = _slot_tree(got, dtype, dev)
    count = int(np.asarray(node.count)) if template.COUNTED else 0
    return type(template)(count=count, **slots)


def adamw_state_from_jax(opt_state, cfg: ViTConfig, device="cuda"):
    """``opt_state_from_jax`` for vitx's ``make_optimizer()`` AdamW state
    (the name the port's callers use)."""
    return opt_state_from_jax(opt_state, cfg, device)
