"""The rank functions of ``tests/test_torch_parallel*.py``.

Spawned rank processes import this module afresh, so it imports no JAX:
the test files hold vitx's references and hand each world of ranks one
payload (the config as JSON, the weights and the global batch as numpy)
and a list of cases; every case runs in the same processes, one mesh
after another, and rank 0 returns what the tests compare.
"""

from __future__ import annotations

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.nn.tome import encode_tome
from vitx_torch.parallel import make_mesh, sharded
from vitx_torch.train.step import (TrainState, _to_device, gradients,
                                   leaf_paths, leaves, loss_fn,
                                   make_optimizer, trainable_params)

LR = 1e-3
WD = 1e-4

# case -> its mesh and knobs; "world" the ranks it takes
CASES = {
    "dp2": dict(world=2, dp=2),
    "dp4": dict(world=4, dp=4),
    "zero1": dict(world=2, dp=2, zero=1),
    "zero2": dict(world=2, dp=2, zero=2),
    "zero3": dict(world=2, dp=2, zero=3),
    "tp2": dict(world=2, dp=1, tp=2),
    "tp2_sp": dict(world=2, dp=1, tp=2, sp=True),
    "dp2_tp2": dict(world=4, dp=2, tp=2),
    "ep2": dict(world=2, dp=1, ep=2, moe=True),
    # the merging encoder on a model axis: the split route, and B8 and K2
    # over gathered weights; fused halves under sp and under tp x ep
    "tp2_tome": dict(world=2, dp=1, tp=2,
                     over=dict(tome_r=4, tome_train=True)),
    "tp2_tome_fused": dict(world=2, dp=1, tp=2,
                           over=dict(tome_r=4, tome_train=True,
                                     fuse_mha="on", fuse_mlp="on")),
    "tp2_sp_fused": dict(world=2, dp=1, tp=2, sp=True,
                         over=dict(fuse_mha="on", fuse_mlp="on")),
    "tp2_ep2_fused": dict(world=4, dp=1, tp=2, ep=2, moe=True,
                          over=dict(fuse_mha="on")),
    # two stochastic ToMe-train steps at tp2 from a seeded generator
    "tp2_tome_draws": dict(world=2, dp=1, tp=2, draws=2,
                           over=dict(tome_r=4, tome_train=True, dropout=0.1,
                                     drop_path=0.2)),
}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def flat(tree) -> dict:
    """{"a/b": numpy} of a tree of tensors."""
    return {"/".join(p): t.detach().float().cpu().numpy().copy()
            for p, t in zip(leaf_paths(tree), leaves(tree))}


def case_setup(case: dict, payload: dict, device="cpu"):
    """-> (mesh, cfg, optimizer, whole state, specs, grad specs, flags)
    of one case on this rank."""
    mesh = make_mesh(case["dp"], case.get("tp", 1), case.get("ep", 1),
                     device=device)
    tp, sp = case.get("tp", 1) > 1, bool(case.get("sp"))
    ep = case.get("ep", 1) > 1
    cfg = ViTConfig.from_json(payload["moe_cfg" if case.get("moe")
                                      else "cfg"]).replace(
                                          **case.get("over", {}))
    cfg = sharded.ep_cfg(sharded.sp_cfg(sharded.tp_safe_cfg(cfg, tp), tp,
                                        sp), mesh, ep)
    opt = make_optimizer(lr=LR, weight_decay=WD, **payload.get("opt", {}))
    params = _to(to_torch(payload["moe_params" if case.get("moe")
                                  else "params"]), mesh.device)
    whole = TrainState(0, params, opt.init(params))
    zero = case.get("zero", 0)
    specs = sharded.state_sharding(whole, cfg, mesh, tp, zero1=zero in (1, 2),
                                   zero3=zero == 3, ep=ep)
    gspecs = (sharded.grad_sharding(params, cfg, mesh, tp, ep)
              if zero == 2 else None)
    return mesh, cfg, opt, whole, specs, gspecs, (tp, sp, ep, zero)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def run_case(case: dict, payload: dict, device="cpu"):
    """One sharded step of a case -> (rank 0) its loss, grad_norm and
    accuracy, the reduced gradients gathered whole, the params after the
    step, the eval step's confusion matrix and loss; None elsewhere."""
    mesh, cfg, opt, whole, specs, gspecs, (tp, sp, ep, zero) = \
        case_setup(case, payload, device)
    state = sharded.place_state(whole, cfg, mesh, specs=specs)
    if case.get("draws"):
        return draw_steps(mesh, cfg, opt, state, specs, payload,
                          case["draws"])
    batch = sharded.shard_batch(payload["batch"], mesh)
    sources = None
    if cfg.tome_r:
        # every rank's merges: the partition of the tokens (sizes are its
        # row sums)
        with torch.no_grad():
            _, sources = encode_tome(
                sharded.forward_params(state.params, specs.params, mesh),
                torch.from_numpy(batch["image"]), cfg, return_sources=True,
                mesh=mesh)
        sources = sources.numpy()
    placed = {"params": flat(state.params),
              "slots": {f"{name}/{k}": v.shape for name in
                        state.opt_state.SLOTS for k, v in
                        flat(getattr(state.opt_state, name)).items()}}
    plan = sharded.Plan(specs, mesh, state.params, gspecs)
    train_filter = payload.get("opt", {}).get("trainable")
    p, wrt = trainable_params(state.params, train_filter)
    loss_v, _ = loss_fn(sharded.forward_params(p, specs.params, mesh),
                        _to_device(batch, mesh.device), cfg, mesh=mesh)
    grads, gs = plan.reduce(gradients(loss_v, p, wrt), wrt, final=False)
    grads = [sharded.gather_part(g, s, mesh) for g, s in zip(grads, gs)]
    step = sharded.make_parallel_train_step(
        cfg, opt, mesh, tp=tp, zero1=zero in (1, 2), zero3=zero == 3,
        state_shardings=specs, grad_shardings=gspecs, sp=sp, ep=ep,
        train_filter=train_filter)
    state, m = step(state, batch)
    cm, eloss = sharded.make_parallel_eval_step(
        cfg, mesh, tp=tp, sp=sp, ep=ep, param_specs=specs.params)(
            state.params, batch)
    out = sharded.gather_state(state, specs, mesh)
    if mesh.rank:
        return {"placed": placed, "sources": sources}
    names = ["/".join(q) for q, w in zip(leaf_paths(out.params), wrt) if w]
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "accuracy": float(m["accuracy"]),
            "grads": {n: g.float().cpu().numpy()
                      for n, g in zip(names, grads)},
            "params": flat(out.params), "cm": cm.cpu().numpy(),
            "eval_loss": float(eloss), "placed": placed, "sources": sources}


def draw_steps(mesh, cfg, opt, state, specs, payload: dict, steps: int,
               **knobs):
    """``steps`` sharded steps (``knobs``: the step's) from a generator
    seeded with ``payload["seed"]``, the same on every rank -> (rank 0)
    their losses and grad norms and the params after them."""
    step = sharded.make_parallel_train_step(
        cfg, opt, mesh, tp=mesh.tp > 1, state_shardings=specs,
        sp=bool(cfg.sp), ep=bool(cfg.ep), **knobs)
    gen = torch.Generator(device=mesh.device).manual_seed(payload["seed"])
    batch = sharded.shard_batch(payload["batch"], mesh)
    hist = []
    for _ in range(steps):
        state, m = step(state, batch, gen)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    out = sharded.gather_state(state, specs, mesh)
    return None if mesh.rank else {"hist": hist, "params": flat(out.params)}


def run_cases(ctx, names: list, payload: dict) -> dict:
    """Every case of ``names`` on this rank, one after another."""
    return {n: run_case(CASES[n], payload) for n in names}


def run_draws(ctx, payload: dict, steps: int = 2):
    """dp over the world with dropout, drop-path, patch dropout and mixup
    drawn from a generator seeded alike on every rank -> (rank 0) the
    losses and grad norms and the params after ``steps`` steps."""
    mesh = make_mesh(ctx.world, device="cpu")
    cfg = ViTConfig.from_json(payload["cfg"])
    opt = make_optimizer(lr=LR, weight_decay=WD)
    params = to_torch(payload["params"])
    whole = TrainState(0, params, opt.init(params))
    specs = sharded.state_sharding(whole, cfg, mesh)
    state = sharded.place_state(whole, cfg, mesh, specs=specs)
    return draw_steps(mesh, cfg, opt, state, specs, payload, steps,
                      **payload["knobs"])


class GradCapture:
    """An optimizer whose update keeps the step's gradients and leaves
    the params as they are."""
    grads: list = []

    def init(self, params):
        return None

    def update(self, grads, state, params, **kw):
        GradCapture.grads = [g.detach().clone() for g in grads]
        return params, state


def family_setup(family: str, payload: dict):
    """-> (config, make_step, state maker) of a pretraining family."""
    from vitx_torch.nn import dino, mae, simclr

    enc = ViTConfig.from_json(payload["cfg"])
    kw = payload["family_kw"]
    if family == "mae":
        fc = mae.MAEConfig(encoder=enc, **kw)
        make = lambda opt, mesh: mae.make_mae_train_step(  # noqa: E731
            fc, opt, device="cpu", mesh=mesh)
    elif family == "dino":
        fc = dino.DINOConfig(encoder=enc, **kw)
        make = lambda opt, mesh: dino.make_dino_train_step(  # noqa: E731
            fc, opt, payload["total_steps"], device="cpu", mesh=mesh)
    else:
        fc = simclr.SimCLRConfig(encoder=enc, **kw)
        make = lambda opt, mesh: simclr.make_simclr_train_step(  # noqa: E731
            fc, opt, device="cpu", mesh=mesh)

    def state(opt):
        params = to_torch(payload["params"])
        if family != "dino":
            return TrainState(0, params, opt.init(params))
        return dino.DINOState(0, params, opt.init(params),
                              to_torch(payload["teacher"]),
                              torch.from_numpy(payload["center"]))
    return fc, make, state


def _rows(x, start: int, n: int):
    """Rows start:start + n of an array, or of every field of a
    ``ViewDraws``, or of each of a list of them."""
    if isinstance(x, list):
        return [_rows(d, start, n) for d in x]
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{k: None if v is None else v[start:start + n]
                          for k, v in vars(x).items()})
    return x[start:start + n]


def run_family(ctx, family: str, payload: dict, mesh_world: int | None = None):
    """One data-parallel step of a pretraining family on this rank, fed
    the global batch's draws (``payload["draws"]``: MAE's noise, the
    views' ``ViewDraws``) -> (rank 0) its metrics and gradients (one
    step through ``GradCapture``) and the params after one AdamW step."""
    mesh = make_mesh(mesh_world or ctx.world, device="cpu")
    fc, make, state = family_setup(family, payload)
    x = payload["images"]
    n = x.shape[0] // mesh.dp
    start = mesh.index("data") * n
    batch = {"image": x[start:start + n]}
    kw = {"noise" if family == "mae" else "draws":
          _rows(payload["draws"], start, n)}
    _, m = make(GradCapture(), mesh)(state(GradCapture()), batch, None, **kw)
    grads = GradCapture.grads
    opt = make_optimizer(lr=LR, weight_decay=0.05)
    st, _ = make(opt, mesh)(state(opt), batch, None, **kw)
    if mesh.rank:
        return None
    names = ["/".join(q) for q in leaf_paths(st.params)]
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: g.float().numpy() for k, g in zip(names, grads)},
            "params": flat(st.params)}


def run_families(ctx, families: list, payloads: dict) -> dict:
    return {f: run_family(ctx, f, payloads[f]) for f in families}


def run_trainer(ctx, payload: dict) -> dict | None:
    """The Trainer on a dp x tp mesh with ZeRO-3 over synthetic data (each
    rank's loader its block of every batch): ``epochs`` epochs straight
    into ``a``, then one epoch into ``b`` and a resume to ``epochs`` ->
    (rank 0) both runs' params and the last ``.ckpt``'s meta."""
    from vitx_torch.data import BatchLoader, SyntheticDataset
    from vitx_torch.parallel.sharded import BATCH_AXES
    from vitx_torch.train.checkpoint import peek_meta
    from vitx_torch.train.loop import Trainer, TrainerConfig

    mesh = make_mesh(payload["dp"], payload["tp"], device="cpu")
    cfg = ViTConfig.from_json(payload["cfg"])
    ds = SyntheticDataset(num_examples=24, image_size=cfg.image_size,
                          num_classes=cfg.num_classes)
    rows = (mesh.index(BATCH_AXES), mesh.size(BATCH_AXES))

    def fit(ckpt, epochs):
        tcfg = TrainerConfig(epochs=epochs, lr=1e-3, checkpoint_dir=ckpt,
                             log_every=2, seed=3)
        tr = Trainer(cfg, tcfg, mesh=mesh, tp=payload["tp"] > 1,
                     zero3=True, sp=payload["tp"] > 1)
        tr.fit(BatchLoader(ds, 8, shuffle=True, seed=3, rows=rows),
               BatchLoader(ds, 8, rows=rows))
        return tr

    a = fit(payload["a"], payload["epochs"])
    fit(payload["b"], 1)
    b = fit(payload["b"], payload["epochs"])
    pa, pb = flat(a.whole_state().params), flat(b.whole_state().params)
    if mesh.rank:
        return None
    return {"a": pa, "b": pb, "meta": peek_meta(payload["b"]),
            "history": b.history}
