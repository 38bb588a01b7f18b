"""vitx's ``.ckpt`` checkpoints, written and read without JAX.

The counterpart of the npz half of ``vitx/train/checkpoint.py``: one file
per epoch, ``{epoch}.ckpt``, newest = the largest integer stem. A file is
an npz of ``leaf_{i}`` arrays plus ``__meta__`` (JSON as uint8 bytes). The
leaves are vitx's ``TrainState(step, params, opt_state)`` in
``jax.tree_util.tree_flatten`` order, which for the chains vitx's
``make_optimizer`` builds (clipping, adamw, sgd, lion or adafactor with a
constant lr or a schedule, masked weight decay or not, a freeze policy's
``optax.masked``, layer-wise lr decay, the EMA link last, all inside
``optax.MultiSteps`` with accumulation) is:

    step, params..., [mini_step, gradient_step], [count], slots...,
    [schedule count], [ema...], [acc_grads...]

with the optimizer's own state in the middle:

    adamw      count, mu..., nu...                (ScaleByAdamState)
    sgd        trace...                           (TraceState: no count)
    lion       count, mu...                       (ScaleByLionState)
    adafactor  count, v_row..., v_col..., v...    (FactoredState)

every tree's leaves in sorted-key order (``leaves``), the counts and the
step int32 scalars, everything else fp32 except a ``mu_dtype="bfloat16"``
first moment, which is stored as vitx's ``np.savez`` stores a JAX
bfloat16 array: its 2-byte bit pattern, read back as void (``|V2``).
Adafactor keeps (1,) placeholders: ``v`` on a factored leaf, ``v_row``
and ``v_col`` on the others. Clipping, the weight-decay mask, LLRD and
the masks' ``MaskedNode``s keep no leaves, so under a freeze policy the
slots hold the trainable leaves only; the EMA and the accumulated
gradients hold every leaf. A port state (``AdamWState``, ``SGDState``,
``LionState``, ``AdafactorState``, whose ``SLOTS`` and ``COUNTED`` give
the middle part) has one count, which stands for vitx's optimizer count,
schedule count and ``gradient_step``, which no chain lets differ.
``tests/test_torch_checkpoint.py``, ``tests/test_torch_finetune_knobs.py``
and ``tests/test_torch_optim.py`` derive the order from vitx's own
flatten for each chain and round-trip files both ways. (vitx cannot read
a ``|V2`` leaf back: its restore casts each array with ``astype``, which
numpy refuses for void; the port reads it as bfloat16.)

Writes are atomic (a temporary file, then a rename); ``keep`` prunes to
the newest files, never the ``protect``ed epoch; ``restore_latest``
quarantines an unreadable file as ``<name>.corrupt`` and tries the epoch
before. vitx's orbax directories (``{epoch}.orbax``) are listed but not
read: they need the JAX stack.

The reference model's ``.pt`` files are written and read here too
(``save_reference_pt``, ``load_reference_pt``), and ``transfer_params``
starts a fine-tune from any of these artifacts at a new geometry.
"""

from __future__ import annotations

import json
import pathlib
import re
import threading
import warnings
import zipfile

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.train.step import AdamWState, TrainState, leaves

_STEM_RE = re.compile(r"^(\d+)$")
SUFFIX = ".ckpt"
ORBAX_SUFFIX = ".orbax"
# what reading a torn or foreign file raises
_UNREADABLE = (zipfile.BadZipFile, OSError, EOFError, ValueError,
               json.JSONDecodeError)


def _orbax_error(path) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: orbax checkpoints need the JAX stack (vitx); vitx_torch "
        f"reads and writes the npz .ckpt format only")


def state_leaves(state: TrainState, schedule: bool) -> list:
    """The leaves of ``state`` in vitx's checkpoint order (module
    docstring); ``schedule``: the chain has an lr schedule, whose count
    leaf follows the optimizer's own state."""
    opt = state.opt_state
    out = [state.step, *leaves(state.params)]
    if opt.acc is not None:
        out += [opt.mini_step, opt.count]
    if opt.COUNTED:
        out.append(opt.count)
    for name in opt.SLOTS:
        out += leaves(getattr(opt, name))
    if schedule:
        out.append(opt.count)
    if opt.ema is not None:
        out += leaves(opt.ema)
    if opt.acc is not None:
        out += leaves(opt.acc)
    return out


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array vitx's ``np.savez`` writes: a bfloat16
    tensor (a ``mu_dtype`` moment) as its 2-byte bit pattern (``|V2``),
    as numpy stores JAX's bfloat16 arrays; ints as int32."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A saved leaf as a tensor: a ``|V2`` array (bfloat16 bits) as
    bfloat16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


def snapshot(state: TrainState, schedule: bool) -> list:
    """The state's leaves copied to host numpy arrays (int32 step and
    counts): what a save writes, taken before the next step changes the
    tensors in place."""
    return [_host(x) for x in state_leaves(state, schedule)]


def _ckpt_path(ckpt_dir, epoch: int) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    orbax = ckpt_dir / f"{epoch}{ORBAX_SUFFIX}"
    return orbax if orbax.is_dir() else ckpt_dir / f"{epoch}{SUFFIX}"


def save_checkpoint(ckpt_dir, arrays: list, epoch: int,
                    meta: dict | None = None, keep: int | None = None,
                    protect: int | None = None) -> pathlib.Path:
    """Write ``{epoch}.ckpt`` from ``arrays`` (``snapshot``'s list) and
    ``meta`` (JSON-serialisable; ``epoch`` is added), atomically. ``keep``:
    then delete all but the newest ``keep`` checkpoints, except the epoch
    ``protect``."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    meta = dict(meta or {}, epoch=epoch)
    payload = {"__meta__": np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)}
    payload.update({f"leaf_{i}": np.asarray(a) for i, a in enumerate(arrays)})
    path = ckpt_dir / f"{epoch}{SUFFIX}"
    tmp = path.with_suffix(".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    tmp.replace(path)
    if keep is not None:
        for old in list_checkpoints(ckpt_dir)[:-keep]:
            if old == protect:
                continue
            stale = _ckpt_path(ckpt_dir, old)
            if stale.is_dir():
                import shutil

                shutil.rmtree(stale)
            else:
                stale.unlink(missing_ok=True)
    return path


class AsyncCheckpointWriter:
    """``save_checkpoint`` on a background thread, one save in flight: a
    second ``save`` waits for the first. The caller hands over host arrays
    (``snapshot``). ``wait()`` drains the writer and re-raises its error;
    call it before exit."""

    def __init__(self):
        self._thread = None
        self._exc = None

    def save(self, ckpt_dir, arrays: list, epoch: int, **kw):
        self.wait()

        def run():
            try:
                save_checkpoint(ckpt_dir, arrays, epoch, **kw)
            except BaseException as e:  # noqa: BLE001 -- re-raised in wait()
                self._exc = e

        self._thread = threading.Thread(
            target=run, name=f"ckpt-writer-{epoch}", daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def list_checkpoints(ckpt_dir) -> list[int]:
    """The epochs with a ``{epoch}.ckpt`` file or ``{epoch}.orbax``
    directory, ascending."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    out = set()
    for p in ckpt_dir.glob(f"*{SUFFIX}"):
        if _STEM_RE.match(p.stem):
            out.add(int(p.stem))
    for p in ckpt_dir.glob(f"*{ORBAX_SUFFIX}"):
        if _STEM_RE.match(p.stem) and p.is_dir():
            out.add(int(p.stem))
    return sorted(out)


def find_latest(ckpt_dir) -> int | None:
    """The newest epoch in the directory, or None."""
    found = list_checkpoints(ckpt_dir)
    return found[-1] if found else None


def _read_meta(path) -> dict:
    path = pathlib.Path(path)
    if path.is_dir():
        raise _orbax_error(path)
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def _newest_readable(ckpt_dir):
    """(path, meta) of the newest readable checkpoint, skipping unreadable
    ones with a warning and touching nothing, or (None, None)."""
    for epoch in reversed(list_checkpoints(ckpt_dir)):
        path = _ckpt_path(ckpt_dir, epoch)
        try:
            return path, _read_meta(path)
        except (KeyError, *_UNREADABLE) as e:
            warnings.warn(f"checkpoint {path} is unreadable "
                          f"({type(e).__name__}); skipping")
    return None, None


def peek_meta(path_or_dir):
    """The meta of a ``.ckpt`` file, or of the newest readable one in a
    directory, without a template state; None when there is none."""
    p = pathlib.Path(path_or_dir)
    if p.suffix == ORBAX_SUFFIX:
        raise _orbax_error(p)
    if p.is_file():
        try:
            return _read_meta(p)
        except (KeyError, *_UNREADABLE):
            return None
    return _newest_readable(p)[1]


def _read(path):
    """(meta, leaf arrays) of a ``.ckpt`` file; a torn or foreign file
    raises one of ``_UNREADABLE`` (or ``KeyError`` without ``__meta__``)."""
    path = pathlib.Path(path)
    if path.is_dir():
        raise _orbax_error(path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        return meta, [z[f"leaf_{i}"] for i in range(n)]


def _fill(template: TrainState, arrays: list, schedule: bool, path):
    """``arrays`` in ``template``'s structure: new tensors of its dtypes on
    its devices. Raises ``KeyError`` on another leaf count and
    ``ValueError`` on another shape: another model or optimizer chain."""
    tmpl = state_leaves(template, schedule)
    if len(arrays) != len(tmpl):
        raise KeyError(f"{path} holds {len(arrays)} leaves, the template "
                       f"{len(tmpl)}: another model or optimizer chain")
    for i, (a, t) in enumerate(zip(arrays, tmpl)):
        shape = tuple(t.shape) if torch.is_tensor(t) else ()
        if a.shape != shape:
            raise ValueError(f"{path}: leaf_{i} has shape {a.shape}, the "
                             f"template {shape}")
    it = iter(arrays)

    def take_tree(tree):
        if isinstance(tree, dict):
            return {k: take_tree(tree[k]) for k in sorted(tree)}
        return _tensor(next(it)).to(device=tree.device, dtype=tree.dtype)

    opt = template.opt_state
    step = int(next(it))
    params = take_tree(template.params)
    counts, mini_step = [], 0
    if opt.acc is not None:
        mini_step = int(next(it))
        counts.append(int(next(it)))        # MultiSteps' gradient_step
    if opt.COUNTED:
        counts.append(int(next(it)))
    slots = {name: take_tree(getattr(opt, name)) for name in opt.SLOTS}
    if schedule:
        counts.append(int(next(it)))
    if any(c != counts[0] for c in counts):
        raise ValueError(f"{path}: the chain's counts {counts} differ")
    ema = take_tree(opt.ema) if opt.ema is not None else None
    acc = take_tree(opt.acc) if opt.acc is not None else None
    # an SGD chain without a schedule or accumulation keeps no count: the
    # step is the number of updates applied
    count = counts[0] if counts else step
    return TrainState(step, params, type(opt)(
        count=count, **slots, ema=ema, acc=acc, mini_step=mini_step))


def restore_checkpoint(path, template: TrainState, schedule: bool):
    """Load ``path`` into ``template``'s structure (its tensors are
    replaced, not written) -> (state, meta): the leaves cast to the
    template's dtypes on its devices; the chain's counts must agree."""
    meta, arrays = _read(path)
    return _fill(template, arrays, schedule, path), meta


def restore_latest(ckpt_dir, template: TrainState, schedule: bool):
    """Resume from the newest checkpoint -> (state, meta), or (template,
    None) when there is none. A file that cannot be read is quarantined as
    ``<name>.corrupt`` and the previous epoch tried; one that reads but
    does not fit the template raises: that is another model or optimizer,
    not corruption."""
    for epoch in reversed(list_checkpoints(ckpt_dir)):
        path = _ckpt_path(ckpt_dir, epoch)
        try:
            meta, arrays = _read(path)
        except _UNREADABLE as e:
            quarantine = path.with_name(path.name + ".corrupt")
            warnings.warn(
                f"checkpoint {path} is unreadable ({type(e).__name__}: {e});"
                f" quarantined to {quarantine.name}, trying epoch {epoch - 1}")
            try:
                path.replace(quarantine)
            except OSError:
                pass
            continue
        return _fill(template, arrays, schedule, path), meta
    return template, None


def _params_template(cfg: ViTConfig, device):
    from vitx_torch.nn.vit import param_spec

    def build(spec):
        return {k: build(v) if isinstance(v, dict) else
                torch.empty(v[0], dtype=cfg.pdtype(), device=device)
                for k, v in spec.items()}
    return build(param_spec(cfg))


def state_template(params, *, ema: bool = False,
                   train_filter: str | None = None, accum_steps: int = 1,
                   optimizer: str = "adamw",
                   mu_dtype: str | None = None) -> TrainState:
    """A ``TrainState`` whose structure (not values) is that of a run with
    these knobs: what ``restore_checkpoint`` fills. Its tensors hold no
    memory of their own: the params' own, and expanded 0-dim tensors of
    the optimizer's slot shapes."""
    from vitx_torch.train.step import make_optimizer

    opt = make_optimizer(optimizer=optimizer, trainable=train_filter,
                         mu_dtype=mu_dtype)

    def alloc(shape, dtype, like):
        return torch.empty((), dtype=dtype, device=like.device).expand(
            tuple(shape))
    state = opt.init(params, alloc)
    return TrainState(0, params, state._replace(
        ema=params if ema else None,
        acc=params if accum_steps > 1 else None))


def restore_eval_params(path_or_dir, cfg: ViTConfig, device="cuda"):
    """-> (params, meta) for evaluation or serving: the EMA shadow when the
    run kept one, else the live params; (None, None) when nothing is
    there (``vitx/train/checkpoint.py:289-369``). A directory gives its
    newest readable checkpoint, touching nothing. Where the meta omits
    ``ema_decay`` or ``schedule``, the leaf count decides, as in vitx: the
    EMA adds one leaf per param leaf, a schedule one count. A freeze
    policy (``train_filter``) and accumulation (``accum_steps``) shape the
    template as they shaped the run's state."""
    dev = resolve_device(device)
    path = pathlib.Path(path_or_dir)
    if not path.exists():
        return None, None
    if path.suffix == ORBAX_SUFFIX:
        raise _orbax_error(path)
    if path.is_dir():
        path, meta = _newest_readable(path)
        if path is None:
            return None, None
    else:
        meta = _read_meta(path)
    params = _params_template(cfg, dev)
    n_params = len(leaves(params))
    has_ema = meta.get("ema_decay") is not None
    has_schedule = bool(meta.get("schedule"))
    knobs = dict(train_filter=meta.get("train_filter"),
                 accum_steps=meta.get("accum_steps", 1),
                 optimizer=meta.get("optimizer", "adamw"))
    if not has_ema or not has_schedule:
        with np.load(path) as z:
            n_saved = sum(1 for k in z.files if k.startswith("leaf_"))
        plain = state_template(params, **knobs)
        extra = n_saved - len(state_leaves(plain, False))
        if extra > 0:
            has_ema = has_ema or extra >= n_params
            has_schedule = has_schedule or extra % n_params == 1
    # the template's tensors give only shapes, dtypes and the device
    template = state_template(params, ema=has_ema, **knobs)
    state, meta = restore_checkpoint(path, template, has_schedule)
    ema = state.opt_state.ema
    return (ema if ema is not None else state.params), meta


def _refuse_unported(path: pathlib.Path) -> None:
    """Raise for the artifacts that hold no parameters the port can read:
    vitx's ``.stablehlo`` programs (JAX only; the port's deployment
    program is a ``.pt2``), ``.pt2`` programs themselves (the logits
    program alone, as vitx's ``.stablehlo``: serve one, evaluate the
    checkpoint it was exported from) and orbax directories."""
    if path.suffix == ".stablehlo":
        raise NotImplementedError(
            f"{path}: .stablehlo artifacts are StableHLO programs that only "
            f"JAX runs; vitx_torch's deployment program is a torch.export "
            f".pt2 (vitx_torch.export, `eval --export-pt2`), made from the "
            f"checkpoint the .stablehlo was exported from")
    if path.suffix == ".pt2":
        raise ValueError(
            f"{path}: a .pt2 program bakes only the logits program -- there "
            f"are no parameters to load; evaluate or probe the checkpoint "
            f"it was exported from (serving it works: serve --checkpoint "
            f"m.pt2)")
    if path.suffix == ORBAX_SUFFIX:
        raise _orbax_error(path)


def save_reference_pt(path, params, cfg: ViTConfig, *, epoch: int,
                      loss: float = 0.0, step: int = 0, batch_size: int = 1,
                      opt_state: AdamWState | None = None, lr: float = 1e-4,
                      weight_decay: float = 1e-4) -> None:
    """Write a reference-layout ``{epoch}.pt``: ``{'epoch',
    'model_state_dict', 'optimizer_state_dict', 'loss', 'step'}``
    (``vitx/train/checkpoint.py:372-427``), tensors on the CPU. With
    ``opt_state`` (an ``AdamWState``) the AdamW moments go out in the
    reference's layout, so its resume (``train.py:73``) continues with the
    same state; without, a fresh AdamW state dict (its param group, no
    moments). LoRA adapters fold into the dense weights first and the
    moments are dropped, as vitx does (``checkpoint.py:393-401``): they
    describe the adapters, not the merged weights. Params the reference
    layout has no slot for raise ``ValueError``
    (``export_reference_state_dict``)."""
    from vitx_torch.interop.torch_ref import (
        export_reference_optimizer_state, export_reference_state_dict,
        optimizer_param_groups)
    from vitx_torch.nn.lora import merge_lora_params

    if cfg.lora_rank:
        params, cfg = merge_lora_params(params, cfg)
        opt_state = None

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    sd = host(export_reference_state_dict(params, cfg,
                                          batch_size=batch_size))
    if opt_state is not None:
        osd = export_reference_optimizer_state(
            opt_state, cfg, lr=lr, weight_decay=weight_decay,
            batch_size=batch_size)
        osd["state"] = {i: host(st) for i, st in osd["state"].items()}
    else:
        osd = {"state": {}, "param_groups": optimizer_param_groups(
            cfg, lr=lr, weight_decay=weight_decay)}
    torch.save({"epoch": epoch, "model_state_dict": sd,
                "optimizer_state_dict": osd, "loss": loss, "step": step},
               path)


def load_reference_pt(path, cfg: ViTConfig, device="cuda"):
    """A reference ``.pt`` (a ``torch.save`` dict with
    ``model_state_dict``, or a bare state dict) -> (params, meta): the
    tree imported on ``device`` at ``cfg``'s geometry
    (``import_reference_state_dict``) in ``cfg.param_dtype``, and the
    file's epoch, loss and step. The file is read with ``weights_only``:
    tensors and plain containers, never code."""
    from vitx_torch.interop.torch_ref import import_reference_state_dict

    dev = resolve_device(device)
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    params = import_reference_state_dict(sd, cfg)

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.to(cfg.pdtype())
                for k, v in tree.items()}
    meta = {k: ckpt[k] for k in ("epoch", "loss", "step") if k in ckpt}
    return cast(params), meta


def resolve_artifact_config(checkpoint, config_json=None, preset="tiny",
                            tome_r=0) -> ViTConfig:
    """The config rule eval and serve share
    (``vitx/train/checkpoint.py:445-490``): an explicit ``config_json``
    wins, then the config a checkpoint's meta records (with the train-time
    ToMe knobs dropped: merging at inference is the caller's ``tome_r``),
    then the preset (a bare ``.npz`` and a reference ``.pt`` record none).
    ``tome_r`` (a ``parse_tome_r`` value) applies last."""
    from vitx_torch.core.config import get_config
    from vitx_torch.nn.tome import aligned_schedule

    if config_json:
        with open(config_json) as f:
            cfg = ViTConfig.from_json(f.read())
    else:
        cfg = get_config(preset)
    if checkpoint and not config_json:
        p = pathlib.Path(checkpoint)
        if p.name.endswith(".quant.npz"):
            from vitx_torch.quant import peek_meta as peek_quant_meta

            saved = peek_quant_meta(p)
        elif p.suffix in (".stablehlo", ".pt2"):
            # the program's <path>.json sidecar, either package's
            from vitx_torch.export import peek_meta as peek_export_meta

            saved = peek_export_meta(p)
        elif p.suffix == ORBAX_SUFFIX:
            raise _orbax_error(p)
        else:
            saved = None if p.suffix in (".npz", ".pt") else peek_meta(p)
        if saved and "config" in saved:
            cfg = ViTConfig.from_json(json.dumps(saved["config"]))
            if cfg.tome_r or cfg.tome_train:
                cfg = cfg.replace(tome_r=0, tome_train=False)
    if isinstance(tome_r, str):
        tome_r = aligned_schedule(cfg, target_tokens=int(tome_r[2:]))
    return cfg.replace(tome_r=tome_r) if tome_r else cfg


def is_bare_params_npz(checkpoint) -> bool:
    """An ``--export-vit`` file: flat "a/b/c" leaves with ``pos_embed``
    and no ``__meta__``. The one rule for a bare ``.npz`` in eval, serve,
    ``transfer_params`` and the train CLI's ``final_norm``: an ``.npz``
    that carries ``__meta__`` is a checkpoint and transfers through the
    config it records, where vitx's suffix test in ``transfer_params``
    would graft nothing from it."""
    p = pathlib.Path(checkpoint)
    if p.suffix != ".npz" or not p.is_file():
        return False
    with np.load(p) as data:
        return "__meta__" not in data.files and "pos_embed" in data.files


def load_artifact_params(checkpoint, cfg: ViTConfig, device="cuda"):
    """-> (params, meta) from a checkpoint directory or ``{epoch}.ckpt``
    (``restore_eval_params``: the EMA shadow where there is one), an int8
    ``.quant.npz`` artifact (``load_quantized``, dequantized), a bare
    params ``.npz`` (``params_from_jax``) or a reference ``.pt``
    (``load_reference_pt``, at ``cfg``'s geometry); raises
    ``FileNotFoundError`` when nothing is there, ``ValueError`` for a
    ``.pt2`` program and ``NotImplementedError`` for vitx's ``.stablehlo``
    and orbax artifacts (``vitx/train/checkpoint.py:493-528``)."""
    from vitx_torch.interop.jax_params import params_from_jax

    p = pathlib.Path(checkpoint)
    _refuse_unported(p)
    if p.name.endswith(".quant.npz"):
        from vitx_torch.nn.vit import param_spec
        from vitx_torch.quant import load_quantized

        params, user = load_quantized(p, param_spec(cfg), device=device)
        return params, {"epoch": user.get("epoch", -1)}
    if p.suffix == ".pt":
        return load_reference_pt(p, cfg, device=device)
    if is_bare_params_npz(p):
        return params_from_jax(p, cfg, device=device), {"epoch": -1}
    params, meta = restore_eval_params(p, cfg, device=device)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint under {p}")
    return params, meta


def _key_path(path) -> tuple:
    """A leaf's path as vitx's ``tree_leaves_with_path`` keys print."""
    return tuple(f"[{k!r}]" for k in path)


def soup_params(params, cfg: ViTConfig, extra_checkpoints, device="cuda"):
    """A uniform model soup (Wortsman et al. 2022;
    ``vitx/train/checkpoint.py:530-561``): ``params`` averaged with the
    params of ``extra_checkpoints`` -- any artifact
    ``load_artifact_params`` reads, of the same geometry. Each leaf is the
    fp32 sum of the ingredients in order, divided by their count and cast
    back to the leaf's dtype; an ingredient of another tree is refused
    with vitx's message (a checkpoint that records its config is read at
    that geometry first)."""
    def shapes(tree):
        return {_key_path(path): tuple(leaf.shape)
                for path, leaf in _sorted_leaves(tree)}

    base = shapes(params)
    trees = [params]
    for c in extra_checkpoints:
        # a checkpoint is read at the geometry it records, so that one of
        # another geometry is named as vitx names it, not failed on read
        saved = (peek_meta(c) if pathlib.Path(c).suffix in ("", SUFFIX)
                 else None)
        src_cfg = (ViTConfig.from_json(json.dumps(saved["config"]))
                   if saved and "config" in saved else cfg)
        extra, _ = load_artifact_params(c, src_cfg, device=device)
        other = shapes(extra)
        if other != base:
            only_b = sorted(set(base) - set(other))[:3]
            only_o = sorted(set(other) - set(base))[:3]
            mismatched = sorted(k for k in base
                                if k in other and base[k] != other[k])[:3]
            raise ValueError(
                f"soup ingredient {c} has a different parameter tree "
                f"(missing: {only_b}, extra: {only_o}, shape mismatches: "
                f"{mismatched}) — soup models must share one geometry")
        trees.append(extra)
    n = float(len(trees))

    def avg(path):
        xs = []
        for tree in trees:
            node = tree
            for k in path:
                node = node[k]
            xs.append(node)
        acc = 0
        for x in xs:
            acc = acc + x.float().to(xs[0].device)
        return (acc / n).to(xs[0].dtype)

    out: dict = {}
    for path, _ in _sorted_leaves(params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = avg(path)
    return out


def _sorted_leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _sorted_leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _graft(key: str, node, leaf, src_cfg: ViTConfig, cfg: ViTConfig, p):
    """The source leaf ``node`` as the target's ``leaf`` (shape and dtype),
    or None where it does not transfer."""
    if tuple(node.shape) == tuple(leaf.shape):
        return node.to(device=leaf.device, dtype=leaf.dtype)
    if key == "pos_embed":
        from vitx_torch.interop.jax_params import _resized_pos_embed

        resized = _resized_pos_embed(node, cfg)
        if resized is not None:
            warnings.warn(f"transfer from {p}: pos_embed resized from "
                          f"{node.shape[1]} to {cfg.pos_len} positions "
                          f"(grid {cfg.grid_size}x{cfg.grid_size})")
            return resized.to(device=leaf.device, dtype=leaf.dtype)
    if (key == "patch_embed/kernel"
            and src_cfg.stem == "patch" and cfg.stem == "patch"
            and src_cfg.num_channels == cfg.num_channels
            and node.ndim == 2 and node.shape[1] == leaf.shape[1]
            and node.shape[0] == src_cfg.patch_size ** 2
            * src_cfg.num_channels):
        from vitx_torch.nn.flexivit import pi_resize_patch_kernel

        warnings.warn(f"transfer from {p}: patchify kernel PI-resized from "
                      f"patch {src_cfg.patch_size} to {cfg.patch_size}")
        return pi_resize_patch_kernel(node, src_cfg.patch_size,
                                      cfg.patch_size, cfg.num_channels).to(
            device=leaf.device, dtype=leaf.dtype)
    return None


def transfer_params(checkpoint, cfg: ViTConfig, rng=0, *, device="cuda"):
    """A ``cfg``-shaped param tree from any artifact the port reads, for
    transfer fine-tuning: a new class head, image size or patch size
    (``vitx/train/checkpoint.py:565-665``). ``rng`` (a seed or a
    ``torch.Generator``) draws the fresh init.

    The source's geometry is the config its meta records; a reference
    ``.pt`` records none and is imported at ``cfg``'s geometry, and a
    source with no config raises ``ValueError``. A bare params ``.npz``
    goes to ``params_from_jax``'s file route (vitx's ``load_vit_init``).
    Leaves graft by (path, shape). A ``pos_embed`` of another square grid
    is resized bilinearly, except across parities (``bug_exact`` stores
    the CLS row last, so the same shape holds other rows: it stays
    fresh); the patchify kernel is PI-resized across patch sizes; every
    other leaf keeps its fresh init, named in one warning."""
    from vitx_torch.interop.jax_params import params_from_jax
    from vitx_torch.nn.vit import init_params

    p = pathlib.Path(checkpoint)
    _refuse_unported(p)
    if not p.exists():
        raise FileNotFoundError(f"transfer from {p}: no such artifact")
    if is_bare_params_npz(p):
        return params_from_jax(p, cfg, device=device, rng=rng)
    if p.suffix == ".pt":
        src_cfg = cfg
    else:
        if p.name.endswith(".quant.npz"):
            from vitx_torch.quant import peek_meta as peek_quant_meta

            saved = peek_quant_meta(p)
        else:
            saved = peek_meta(p)
        if not saved or "config" not in saved:
            raise ValueError(
                f"transfer from {p}: the artifact records no model config "
                f"(e.g. an MAE pretraining checkpoint directory: export a "
                f"fine-tune init with `pretrain --export-vit` instead), so "
                f"the source geometry cannot be restored safely")
        src_cfg = ViTConfig.from_json(json.dumps(saved["config"]))
    src, _ = load_artifact_params(p, src_cfg, device=device)
    out = init_params(rng, cfg, device=device)
    fresh = []
    for path, leaf in _sorted_leaves(out):
        key = "/".join(path)
        node = src
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        if key == "pos_embed" and src_cfg.parity != cfg.parity:
            node = None
        got = None if node is None else _graft(key, node, leaf, src_cfg,
                                               cfg, p)
        if got is None:
            fresh.append(key)
            continue
        tree = out
        for k in path[:-1]:
            tree = tree[k]
        tree[path[-1]] = got
    if fresh:
        warnings.warn(f"transfer from {p}: fresh init kept for {fresh} "
                      "(missing or shape-mismatched in the source)")
    return out
