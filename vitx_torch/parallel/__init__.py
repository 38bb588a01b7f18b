"""Data, ZeRO, tensor, sequence and expert parallelism on
``torch.distributed``: the counterpart of ``vitx.parallel``'s SPMD paths
(``mesh.py``, ``sharded.py``). One process per rank (``launch``), a
(data, model[, expert]) mesh of process groups (``mesh``), the
collectives written out (``comm``) and the sharded steps (``sharded``);
``python -m vitx_torch.parallel.dryrun N`` drives them all once.
Pipeline parallelism (vitx's ``pipeline.py``) waits for ROADMAP A13.2.
"""

from vitx_torch.parallel.launch import (RankContext, RankError,
                                        choose_backend, from_env, spawn)
from vitx_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS,
                                      Mesh, make_mesh)

_SHARDED = (
    "batch_rows", "ep_cfg", "gather_state", "grad_sharding",
    "make_parallel_eval_step", "make_parallel_train_step", "param_pspecs",
    "place_state", "shard_batch", "shard_host_batch", "sp_cfg",
    "state_sharding", "tp_safe_cfg",
)

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "Mesh", "RankContext",
           "RankError", "choose_backend", "from_env", "make_mesh", "spawn",
           *_SHARDED]


def __getattr__(name):
    # the sharded steps import the model, which imports this package's
    # collectives: load them on first use
    if name in _SHARDED:
        from vitx_torch.parallel import sharded

        return getattr(sharded, name)
    raise AttributeError(name)
