"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

- ``fused_mha_block`` (K1, ``csrc/mha_block.cu``): LN -> QKV -> attention
  -> out-projection; replaces ``vitx/kernels/mha_block.py::_kernel``.
- ``fused_mlp_block`` (K2, ``csrc/mlp_block.cu``): LN -> W1 -> act -> W2;
  replaces ``vitx/kernels/mlp_block.py::_kernel``.

Each wrapper launches its kernel for CUDA tensors (building it with nvcc at
first use, ``_build.py``) and counts the launches in its ``launches``
attribute; for CPU tensors it runs the plain torch version beside it.
"""

from vitx_torch.kernels.mha_block import fused_mha_block, mha_block_plain
from vitx_torch.kernels.mlp_block import fused_mlp_block, mlp_block_plain

__all__ = ["fused_mha_block", "mha_block_plain", "fused_mlp_block",
           "mlp_block_plain"]
