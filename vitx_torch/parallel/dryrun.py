"""One step of every sharded path on tiny shapes over N rank processes.

The counterpart of ``__graft_entry__.py::dryrun_multichip``::

    python -m vitx_torch.parallel.dryrun 4               # ranks on CUDA
    python -m vitx_torch.parallel.dryrun 4 --device cpu  # gloo on the CPU

It runs, depth 2 at image 16: a (data x model) mesh -- tp 2 when N is
even and at least 4 -- with sequence parallelism and SAM, then the
sharded eval (the confusion matrix counts the whole batch); ZeRO-3 at
dp = N; ZeRO-2 (reduce-scattered gradients, zero1 moments) at dp = N;
GPipe on (N/2 data x 2 stage) at 2 microbatches (pp 1 for odd N), then
1F1B on the same mesh, then pp x tp 1F1B on (N/4 data x 2 stage x 2
model) when 8 divides N (``nan`` otherwise, as vitx prints it); a
Soft-MoE model on data x model x expert (ep 2 when 4 divides N). Every
loss that runs must be finite; the last line is one summary, as vitx's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.parallel import launch, make_mesh, pipeline, sharded
from vitx_torch.train.step import create_train_state, make_optimizer


def _batch(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
            "label": rng.integers(0, 4, n).astype(np.int32)}


def _check(loss: float, what: str) -> float:
    if not np.isfinite(loss):
        raise RuntimeError(f"{what}: non-finite loss {loss}")
    return loss


def _state(cfg, opt, mesh, **flags):
    whole = create_train_state(0, cfg, opt, device=mesh.device)
    specs = sharded.state_sharding(whole, cfg, mesh, **flags)
    return sharded.place_state(whole, cfg, mesh, specs=specs), specs


def dryrun_rank(ctx, n: int) -> dict | None:
    """The dryrun's work on one rank -> (rank 0) the losses."""
    dev = ctx.device.type
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // tp
    cfg = ViTConfig(image_size=16, patch_size=4, num_classes=4, embed_dim=32,
                    depth=2, num_heads=2 * tp, compute_dtype="float32")
    opt = make_optimizer(lr=1e-3)
    gen = ctx.generator(2)
    out = {"dp": dp, "tp": tp}

    mesh = make_mesh(dp, tp, device=dev)
    state, specs = _state(cfg, opt, mesh, tp=tp > 1)
    step = sharded.make_parallel_train_step(
        cfg, opt, mesh, tp=tp > 1, sp=tp > 1, sam_rho=0.05,
        state_shardings=specs)
    B = 2 * dp
    batch = sharded.shard_batch(_batch(B, 1), mesh)
    state, m = step(state, batch, gen)
    out["loss"] = _check(float(m["loss"]), "dp x tp")
    cm, eval_loss = sharded.make_parallel_eval_step(
        cfg, mesh, tp=tp > 1, sp=tp > 1, param_specs=specs.params)(
            state.params, batch)
    if int(cm.sum()) != B:
        raise RuntimeError(f"eval counted {int(cm.sum())} of {B} rows")
    out["eval_loss"] = _check(float(eval_loss), "eval")

    mesh_dp = make_mesh(n, 1, device=dev)
    batch3 = sharded.shard_batch(_batch(2 * n, 3), mesh_dp)
    state3, specs3 = _state(cfg, opt, mesh_dp, zero3=True)
    step3 = sharded.make_parallel_train_step(cfg, opt, mesh_dp, zero3=True,
                                             state_shardings=specs3)
    _, m3 = step3(state3, batch3, gen)
    out["zero3_loss"] = _check(float(m3["loss"]), "zero3")

    state2, specs2 = _state(cfg, opt, mesh_dp, zero1=True)
    whole = create_train_state(0, cfg, opt, device=mesh_dp.device)
    step2 = sharded.make_parallel_train_step(
        cfg, opt, mesh_dp, zero1=True, state_shardings=specs2,
        grad_shardings=sharded.grad_sharding(whole.params, cfg, mesh_dp))
    _, m2 = step2(state2, batch3, gen)
    out["zero2_loss"] = _check(float(m2["loss"]), "zero2")

    pp = 2 if n % 2 == 0 else 1
    dp_pp = n // pp
    mesh_pp = pipeline.make_pp_mesh(dp_pp, pp, device=dev)
    batch_pp = sharded.shard_batch(_batch(4 * dp_pp, 5), mesh_pp)
    out["pp_mesh"] = (dp_pp, pp)
    for key, schedule in (("pp_loss", "gpipe"), ("1f1b_loss", "1f1b")):
        whole = create_train_state(0, cfg, opt, device=mesh_pp.device)
        specs_pp = pipeline.pp_state_sharding(whole, cfg, mesh_pp)
        step_pp = pipeline.make_pp_train_step(
            cfg, opt, mesh_pp, n_micro=2, state_shardings=specs_pp,
            schedule=schedule)
        _, mpp = step_pp(sharded.place_state(whole, cfg, mesh_pp,
                                             specs=specs_pp), batch_pp)
        out[key] = _check(float(mpp["loss"]), schedule)
    out["pp_x_tp_1f1b_loss"] = float("nan")
    if n % 8 == 0:
        mesh_pt = pipeline.make_pp_mesh(n // 4, 2, 2, device=dev)
        whole = create_train_state(0, cfg, opt, device=mesh_pt.device)
        specs_pt = pipeline.pp_state_sharding(whole, cfg, mesh_pt, tp=True)
        step_pt = pipeline.make_pp_train_step(
            cfg, opt, mesh_pt, n_micro=2, state_shardings=specs_pt,
            schedule="1f1b")
        _, mpt = step_pt(sharded.place_state(whole, cfg, mesh_pt,
                                             specs=specs_pt),
                         sharded.shard_batch(_batch(n, 6), mesh_pt))
        out["pp_x_tp_1f1b_loss"] = _check(float(mpt["loss"]), "pp x tp")

    ep = 2 if n % 4 == 0 else 1
    out["moe_loss"], out["moe_mesh"] = float("nan"), None
    if ep > 1:
        dp_e = n // (2 * ep)
        mesh_ep = make_mesh(dp_e, 2, ep, device=dev)
        cfg_moe = cfg.replace(num_heads=4, moe_experts=2 * ep, moe_blocks=1)
        state_e, specs_e = _state(cfg_moe, opt, mesh_ep, tp=True, ep=True)
        step_e = sharded.make_parallel_train_step(
            cfg_moe, opt, mesh_ep, tp=True, sp=True, ep=True,
            state_shardings=specs_e)
        batch_e = sharded.shard_batch(_batch(2 * dp_e * ep, 4), mesh_ep)
        _, me = step_e(state_e, batch_e, gen)
        out["moe_loss"] = _check(float(me["loss"]), "moe")
        out["moe_mesh"] = (dp_e, 2, ep)
    return out if ctx.rank == 0 else None


def summary(out: dict) -> str:
    """The one line vitx's dryrun prints."""
    moe = out["moe_mesh"]
    where = (f"moe {moe[0]} data x {moe[1]} model x {moe[2]} expert"
             if moe else "moe skipped: 4 does not divide the ranks")
    dp_pp, pp = out["pp_mesh"]
    return (f"dryrun_multichip ok: mesh=({out['dp']} data x {out['tp']} "
            f"model), loss={out['loss']:.4f}, "
            f"eval_loss={out['eval_loss']:.4f}, "
            f"zero3_loss={out['zero3_loss']:.4f}, "
            f"zero2_loss={out['zero2_loss']:.4f}, "
            f"pp_loss={out['pp_loss']:.4f} (pipeline {dp_pp} data x {pp} "
            f"stage; 1f1b_loss={out['1f1b_loss']:.4f}; "
            f"pp_x_tp_1f1b_loss={out['pp_x_tp_1f1b_loss']:.4f} at 2 data x "
            f"2 stage x 2 model), "
            f"moe_loss={out['moe_loss']:.4f} ({where})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vitx_torch.parallel.dryrun",
                                description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, help="rank processes")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; ranks share the cards there are) "
                        "or cpu")
    args = p.parse_args(argv)
    out = launch.spawn(dryrun_rank, args.n, (args.n,),
                       device=args.device)[0]
    print(summary(out), flush=True)
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
