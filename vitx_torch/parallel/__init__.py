"""Data, ZeRO, tensor, sequence, expert and pipeline parallelism on
``torch.distributed``: the counterpart of ``vitx.parallel``'s SPMD paths
(``mesh.py``, ``sharded.py``, ``pipeline.py``). One process per rank
(``launch``), a (data, model[, expert]) or (data, stage[, model]) mesh of
process groups (``mesh``), the collectives and the stage handoff written
out (``comm``), the sharded steps (``sharded``) and the pipeline's
(``pipeline``); ``python -m vitx_torch.parallel.dryrun N`` drives them
all once.
"""

from vitx_torch.parallel.launch import (RankContext, RankError,
                                        choose_backend, from_env, lead,
                                        spawn)
from vitx_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS,
                                      STAGE_AXIS, Mesh, make_mesh)

_SHARDED = (
    "batch_rows", "ep_cfg", "gather_state", "grad_sharding",
    "make_parallel_eval_step", "make_parallel_train_step", "param_pspecs",
    "place_state", "shard_batch", "shard_host_batch", "sp_cfg",
    "state_sharding", "tp_safe_cfg",
)

_PIPELINE = (
    "make_pp_eval_step", "make_pp_mesh", "make_pp_train_step",
    "place_pp_state", "pp_bubble_fraction", "pp_param_pspecs",
    "pp_schedule_ticks", "pp_state_sharding",
)

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "STAGE_AXIS", "Mesh",
           "RankContext", "RankError", "choose_backend", "from_env", "lead",
           "make_mesh", "spawn", *_SHARDED, *_PIPELINE]


def __getattr__(name):
    # the sharded and pipeline steps import the model, which imports this
    # package's collectives: load them on first use
    if name in _SHARDED:
        from vitx_torch.parallel import sharded

        return getattr(sharded, name)
    if name in _PIPELINE:
        from vitx_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)
