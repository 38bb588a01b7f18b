"""The rank functions of ``tests/test_torch_pipeline*.py``.

Spawned rank processes import this module afresh, so it imports no JAX:
the test files hold vitx's references and hand one world of ranks a
payload (the config as JSON, the weights and the batches as numpy) and
its cases; every case runs in the same processes, one mesh after
another, and rank 0 returns what the tests compare. ``emulate_step`` is
the single-process replay of the pipeline's seed rule that the
stochastic cases are held to.
"""

from __future__ import annotations

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.parallel import pipeline as pl
from vitx_torch.parallel import sharded
from vitx_torch.train.step import (TrainState, gradients, global_norm,
                                   leaf_paths, leaves, make_optimizer,
                                   trainable_params)

LR = 1e-3
STEPS = 3

# case -> its mesh and knobs (every case takes the world's 4 ranks)
CASES = {
    "gpipe_dp2_pp2": dict(dp=2, pp=2, n_micro=2, schedule="gpipe"),
    "1f1b_dp2_pp2": dict(dp=2, pp=2, n_micro=2, schedule="1f1b"),
    "gpipe_pp4": dict(dp=1, pp=4, n_micro=4, schedule="gpipe"),
    "1f1b_pp4": dict(dp=1, pp=4, n_micro=4, schedule="1f1b"),
    "gpipe_pp2_tp2": dict(dp=1, pp=2, tp=2, n_micro=2, schedule="gpipe"),
    "1f1b_pp2_tp2": dict(dp=1, pp=2, tp=2, n_micro=2, schedule="1f1b"),
    "zero1": dict(dp=2, pp=2, n_micro=2, schedule="gpipe", zero1=True),
    "masked": dict(dp=2, pp=2, n_micro=2, schedule="1f1b", mask=True),
    "smoothing": dict(dp=2, pp=2, n_micro=2, schedule="gpipe",
                      label_smoothing=0.1),
    "llrd": dict(dp=2, pp=2, n_micro=2, schedule="1f1b",
                 opt=dict(llrd=0.75, llrd_depth=4)),
}
EVAL_CASES = {
    "eval_dp2_pp2": dict(dp=2, pp=2, n_micro=4, mask=True),
    "eval_pp2_tp2": dict(dp=1, pp=2, tp=2, n_micro=2),
}
STOCH_CASES = {
    "stoch_gpipe": dict(dp=2, pp=2, n_micro=2, schedule="gpipe"),
    "stoch_1f1b": dict(dp=2, pp=2, n_micro=2, schedule="1f1b"),
}
# (schedule, pp, n_micro) -> the stage inputs or microbatch graphs a rank
# holds at once, counted over one step
HELD_CASES = [(s, pp, m) for s in ("gpipe", "1f1b") for pp, m in
              ((2, 2), (2, 4), (2, 8), (4, 8))]


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def flat(tree) -> dict:
    return {"/".join(p): t.detach().float().cpu().numpy().copy()
            for p, t in zip(leaf_paths(tree), leaves(tree))}


def batch_of(payload: dict, i: int, masked: bool = False) -> dict:
    b = {k: payload["batches"][i][k] for k in ("image", "label")}
    if masked:
        b["mask"] = payload["mask"]
    return b


def _setup(case: dict, payload: dict, cfg_key: str = "cfg"):
    mesh = pl.make_pp_mesh(case["dp"], case["pp"], case.get("tp", 1),
                           device="cpu")
    cfg = ViTConfig.from_json(payload[cfg_key])
    opt = make_optimizer(lr=LR, **case.get("opt", {}))
    params = to_torch(payload["params"])
    whole = TrainState(0, params, opt.init(params))
    specs = pl.pp_state_sharding(whole, cfg, mesh,
                                 zero1=bool(case.get("zero1")),
                                 tp=case.get("tp", 1) > 1)
    return mesh, cfg, opt, whole, specs


def run_case(case: dict, payload: dict, cfg_key: str = "cfg",
             seed: int | None = None) -> dict:
    """``STEPS`` pipeline steps of a case -> (rank 0) the loss, accuracy
    and grad_norm of each and the params after them, gathered whole;
    every rank its placed state's parts."""
    mesh, cfg, opt, whole, specs = _setup(case, payload, cfg_key)
    state = sharded.place_state(whole, cfg, mesh, specs=specs)
    placed = {"params": flat(state.params),
              "slots": {f"{n}/{k}": v.shape for n in state.opt_state.SLOTS
                        for k, v in flat(getattr(state.opt_state, n)).items()}}
    step = pl.make_pp_train_step(
        cfg, opt, mesh, n_micro=case["n_micro"], state_shardings=specs,
        label_smoothing=case.get("label_smoothing", 0.0),
        schedule=case["schedule"])
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    hist = []
    for i in range(STEPS):
        batch = sharded.shard_batch(batch_of(payload, i, case.get("mask")),
                                    mesh)
        state, m = step(state, batch, gen)
        hist.append([float(m[k]) for k in ("loss", "accuracy",
                                          "grad_norm")])
    out = sharded.gather_state(state, specs, mesh)
    if mesh.rank:
        return {"placed": placed}
    return {"hist": hist, "params": flat(out.params), "placed": placed}


def run_eval(case: dict, payload: dict) -> dict | None:
    mesh, cfg, opt, whole, specs = _setup(case, payload)
    state = sharded.place_state(whole, cfg, mesh, specs=specs)
    cm, loss = pl.make_pp_eval_step(cfg, mesh, n_micro=case["n_micro"])(
        state.params, sharded.shard_batch(batch_of(payload, 0,
                                                   case.get("mask")), mesh))
    return None if mesh.rank else {"cm": cm.numpy(), "loss": float(loss)}


def run_held(schedule: str, pp: int, n_micro: int, payload: dict) -> int:
    """One step -> the most stage inputs (1F1B) or microbatch graphs
    (GPipe) any rank held at once."""
    case = dict(dp=4 // pp, pp=pp, n_micro=n_micro, schedule=schedule)
    mesh, cfg, opt, whole, specs = _setup(case, payload)
    state = sharded.place_state(whole, cfg, mesh, specs=specs)
    step = pl.make_pp_train_step(cfg, opt, mesh, n_micro=n_micro,
                                 state_shardings=specs, schedule=schedule)
    step(state, sharded.shard_batch(batch_of(payload, 0), mesh))
    held = torch.tensor([step.held])
    torch.distributed.all_reduce(held, op=torch.distributed.ReduceOp.MAX)
    return int(held)


def run_world(ctx, payload: dict) -> dict:
    """Every case of the module's tables on this rank, in order."""
    out = {n: run_case(c, payload) for n, c in CASES.items()}
    out.update({n: run_eval(c, payload) for n, c in EVAL_CASES.items()})
    out.update({n: run_case(c, payload, "stoch_cfg", payload["seed"])
                for n, c in STOCH_CASES.items()})
    out["held"] = {k: run_held(*k, payload) for k in HELD_CASES}
    return out


def emulate_step(state, batch, gen, cfg: ViTConfig, opt, dp: int, pp: int,
                 n_micro: int):
    """One step of the pipeline's seed rule in one process: each data row
    d's microbatch m embedded with ``draw_seed(base, d, _EMBED_TAG, m)``'s
    generator, through each stage s's blocks with ``draw_seed(base, d,
    _BLOCK_TAG, s, m)``'s and that stage's drop-path rates, the mean loss
    over the global batch -> (state, loss, grad_norm)."""
    from vitx_torch.train.step import cross_entropy_loss

    params, wrt = trainable_params(state.params)
    base = pl.step_base(gen)
    images = torch.from_numpy(np.asarray(batch["image"]))
    labels = torch.from_numpy(np.asarray(batch["label"])).long()
    B = images.shape[0]
    rows, k = B // dp, cfg.depth // pp
    mb = rows // n_micro
    total = torch.zeros(())
    for d in range(dp):
        for m in range(n_micro):
            lo = d * rows + m * mb
            x = pl.embed_microbatch(
                params, images[lo:lo + mb], cfg, pl.seeded_generator(
                    pl.draw_seed(base, d, pl._EMBED_TAG, m), "cpu"))
            for s in range(pp):
                blocks = {n: t[s * k:(s + 1) * k]
                          for n, t in params["blocks"].items()}
                x = pl.stage_forward(
                    blocks, x, cfg, gen=pl.seeded_generator(
                        pl.draw_seed(base, d, pl._BLOCK_TAG, s, m), "cpu"),
                    rates=pl.stage_rates(cfg, s, pp))
            logits = pl.stage_head(params, x, cfg)
            total = total + cross_entropy_loss(
                logits, labels[lo:lo + mb]) * mb / B
    grads = gradients(total, params, wrt)
    norm = global_norm(grads)
    new_params, opt_state = opt.update(grads, state.opt_state, state.params)
    return TrainState(state.step + 1, new_params, opt_state), \
        float(total.detach()), float(norm)


def run_mesh_server(ctx, payload: dict):
    """A data mesh of the world's ranks: the split forward's logits
    (``serve.mesh_logits``) of a batch, then a mesh server on rank 0
    answering ``payload["images"]`` while the others run
    ``serve_worker`` -> (rank 0) the logits and answers, (others) the
    batches they ran."""
    from vitx_torch.parallel import make_mesh
    from vitx_torch.serve import InferenceServer, mesh_logits, serve_worker

    mesh = make_mesh(ctx.world, device="cpu")
    cfg = ViTConfig.from_json(payload["cfg"])
    params = to_torch(payload["params"])
    with torch.inference_mode():
        logits = mesh_logits(params, torch.from_numpy(payload["images"]),
                             cfg, mesh)
    if mesh.rank:
        return serve_worker(params, cfg, mesh, payload["batch_size"])
    with InferenceServer(params, cfg, batch_size=payload["batch_size"],
                         mesh=mesh, max_delay_ms=1.0) as server:
        answers = [server.predict(im) for im in payload["images"]]
    return {"logits": logits.numpy(), "answers": answers}
