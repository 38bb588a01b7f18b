"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

- ``fused_mha_block`` (K1, ``csrc/mha_block.cu``): LN -> QKV -> attention
  -> out-projection, with its stash and a backward;
  replaces ``vitx/kernels/mha_block.py::_kernel``.
- ``fused_mha_block_with_mean_probs`` (B7, ``csrc/mha_block.cu``): K1 plus
  the head-mean attention probabilities (in bf16 at D = 32, 64 or 128
  K1's sm90 attention, then ``csrc/attention_probs_sm90.cuh``); replaces
  ``vitx/kernels/mha_block.py::_kernel_hchunk`` (mean-probs mode).
- ``fused_mha_block_tome`` (B8, ``csrc/mha_block.cu``): K1 with a QKV
  bias and a per-key logit bias, plus the head-mean key; replaces
  ``vitx/kernels/mha_block.py::_kernel_tome`` and serves the function of
  ``_kernel_hchunk_tome`` (B9) at every shape.
- ``flash_attention``, ``flash_attention_with_probs``,
  ``flash_attention_with_mean_probs`` (B5, ``csrc/flash_attention_fwd.cu``,
  with ``attention_fwd.cuh`` shared with K1 and B7): the attention forward
  without probs, with full probs and with head-mean probs; replace
  ``vitx/kernels/flash_attention.py::_fwd_kernel``. In bf16
  at D = 32, 64 or 128 ``flash_attention`` and the probability modes
  run ``csrc/flash_attention_sm90.cu`` (wgmma, TMA, an online
  softmax): ``flash_attention`` also returns the row statistics to its
  backward, the probability modes hand them to
  ``csrc/attention_probs_sm90.cuh``'s pass (``probs_route``).
- ``fused_mlp_block`` (K2, ``csrc/mlp_block.cu``): LN -> W1 -> act -> W2,
  with its stash and a backward; replaces
  ``vitx/kernels/mlp_block.py::_kernel``.
- ``attention_bwd`` (B2, ``csrc/attention_bwd_sm90.cu`` in bf16 at D = 32,
  64 or 128,
  ``csrc/flash_attention_bwd.cu`` otherwise): the attention backward at
  every T; replaces ``vitx/kernels/flash_attention.py::_bwd_kernel_nq1``
  and, past T = 1024, the q-chunked ``_bwd_kernel`` (B6).
  ``attention_stats_plain`` makes the row statistics its sm90 route reads.
- ``ln_bwd`` (B3, ``csrc/layer_norm_bwd.cu``): the LayerNorm backward,
  one pass over x and dy where E is a multiple of the 16-byte vector and
  at most 4096 (``ln_bwd_route``); replaces
  ``vitx/kernels/layer_norm.py::_ln_bwd3_kernel``, and serves the function
  of ``_ln_bwd_kernel`` (B11, the 2-D backward of the entries below).
- ``fused_layer_norm``, ``fused_add_layer_norm`` (B10,
  ``csrc/layer_norm_fwd.cu``): the LayerNorm forward, plain and after a
  residual add, each row read once into registers where E is a multiple
  of the 16-byte vector and at most 4096 (``ln_fwd_route``), with B11
  (through ``ln_bwd``) as backward; replace
  ``vitx/kernels/layer_norm.py::_ln_kernel``.
- ``fused_adamw_multi_`` (B12, ``csrc/adamw.cu``): one in-place AdamW pass
  over a list of fp32 leaves, one launch per gradient dtype, and
  ``fused_adamw_``, the same over one leaf; replace
  ``vitx/kernels/adamw.py::_kernel``.

``ops`` registers the inference entries of K1, K2, B8 and B5 as
``torch.library`` custom ops (``vitx_torch::mha_block``, ``mlp_block``,
``mha_block_tome``, ``attention_fwd``), which the wrappers call inside a
``torch.export`` trace, so that an exported program carries the kernels.

Each wrapper launches its kernel for CUDA tensors (building it with nvcc at
first use, ``_build.py``) and counts the launches in its ``launches``
attribute (``attention_bwd``, the three B5 entries and the blocks count
their sm90 route in ``launches_sm90`` as well, B7 and B8 their sm90
attention in ``launches_attn_sm90``, ``ln_bwd`` and the two B10 entries
their one-pass route in ``launches_onepass``); for CPU tensors it runs
the plain
torch version beside it.
"""

from vitx_torch.kernels.adamw import (adamw_multi_plain, adamw_plain,
                                     fused_adamw_, fused_adamw_multi_)
from vitx_torch.kernels.flash_attention import (
    attention_bwd, attention_bwd_plain, attention_stats_plain,
    flash_attention,
    flash_attention_fwd_plain, flash_attention_with_mean_probs,
    flash_attention_with_probs)
from vitx_torch.kernels.layer_norm import (fused_add_layer_norm,
                                          fused_layer_norm,
                                          layer_norm_fwd_plain, ln_bwd,
                                          ln_bwd_plain)
from vitx_torch.kernels.mha_block import (composed_tome, fused_mha_block,
                                          fused_mha_block_tome,
                                          fused_mha_block_with_mean_probs,
                                          mha_block_mean_probs_plain,
                                          mha_block_plain,
                                          mha_block_tome_plain)
from vitx_torch.kernels.mlp_block import fused_mlp_block, mlp_block_plain
# registers the vitx_torch:: custom ops the wrappers call inside a trace
from vitx_torch.kernels import ops  # noqa: E402,F401  isort: skip

__all__ = ["fused_mha_block", "mha_block_plain",
           "fused_mha_block_with_mean_probs", "mha_block_mean_probs_plain",
           "fused_mha_block_tome", "mha_block_tome_plain", "composed_tome",
           "fused_mlp_block", "mlp_block_plain", "flash_attention",
           "flash_attention_with_probs", "flash_attention_with_mean_probs",
           "flash_attention_fwd_plain", "attention_bwd",
           "attention_bwd_plain", "attention_stats_plain", "ln_bwd",
           "ln_bwd_plain",
           "fused_layer_norm", "fused_add_layer_norm",
           "layer_norm_fwd_plain", "fused_adamw_", "adamw_plain",
           "fused_adamw_multi_", "adamw_multi_plain"]
