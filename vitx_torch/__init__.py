"""vitx_torch -- the PyTorch / CUDA port of vitx for NVIDIA Hopper.

A second implementation of the ``vitx`` package beside it, held against it
part by part: the same configs, parameter tree and layouts (NHWC images,
``wqkv`` as (E, 3, H, D)), fp32 parameters and compute in
``cfg.compute_dtype``. The fused attention and MLP halves of every encoder
block are hand-written CUDA kernels for sm_90a (``vitx_torch.kernels``),
and so are the attention and LayerNorm backwards and the fused AdamW
update of the train step (``vitx_torch.train``) and the attention forwards
with probabilities behind ``forward_with_attn``, ``forward_with_rollout``
and the server's ``/explain``, and ToMe's attention half behind
``encode_tome`` (token merging, ``cfg.tome_r``), and the LayerNorm
forward behind ``fused_layer_norm`` / ``fused_add_layer_norm``; the rest
is plain torch. A 224² export fine-tunes at a larger image size
(``params_from_jax`` resizes its positional grid, ``resize_pos_embed``);
the attention backward takes every sequence length (ViT-B/16 at 512²,
T 1025). vitx's training driver runs on the card too: procedural data
resident there, RandAugment as torch ops (``vitx_torch.data``), the EMA
and the weight-decay mask, ``Trainer`` with vitx's ``.ckpt`` files
(``vitx_torch.train``), and the train and eval CLIs; so do vitx's
on-disk sources (class folders, CIFAR-10, tar shards and the pack CLI)
and transfer fine-tuning from any vitx or reference ``.pt`` artifact
(``train.checkpoint.transfer_params``). It ships models in vitx's forms
and its own: int8 ``.quant.npz`` artifacts both packages read
(``vitx_torch.quant``) and ``torch.export`` programs that carry the
kernels as custom ops (``vitx_torch.export``, ``.pt2``), and it has
vitx's probe, tune and bench CLIs. vitx's model families run through all
of it: the conv stem, register tokens, the MAP head, the sincos2d and
RoPE positions and Soft-MoE blocks (``vitx_torch.nn.moe``), and a model
runs at another patch size (``nn.flexivit.resize_patch_embed``). It
imports neither ``jax`` nor ``vitx``.

Entry points run on a CUDA device unless the caller passes
``device="cpu"``, where the kernels' plain torch versions run instead.

Importing the package switches off TF32 for float32 matrix products and
convolutions, and reduced-precision reductions in bf16 products, so that
float32 means float32 and a bf16 product accumulates in fp32 -- the
contract every comparison with vitx rests on.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from vitx_torch.core.config import PRESETS, ViTConfig, get_config  # noqa: E402
from vitx_torch.interop.jax_params import (  # noqa: E402
    adamw_state_from_jax, opt_state_from_jax, params_from_jax)
from vitx_torch.interop.pretrained import resize_pos_embed  # noqa: E402
from vitx_torch.kernels.layer_norm import (  # noqa: E402
    fused_add_layer_norm, fused_layer_norm, layer_norm_fwd_plain)
from vitx_torch.nn.rollout import attention_rollout  # noqa: E402
from vitx_torch.nn.saliency import grad_cam  # noqa: E402
from vitx_torch.nn.tome import (aligned_schedule, encode_tome,  # noqa: E402
                                merge_tokens, parse_tome_r,
                                tome_patch_assignment)
from vitx_torch.nn.lora import merge_lora_params  # noqa: E402
from vitx_torch.nn.vit import (classify, classify_dist,  # noqa: E402
                               encode, forward, forward_features,
                               forward_heads, forward_with_attn,
                               forward_with_rollout, init_params)

__version__ = "0.1.0"

__all__ = [
    "ViTConfig",
    "PRESETS",
    "get_config",
    "init_params",
    "forward",
    "forward_features",
    "forward_with_attn",
    "forward_with_rollout",
    "attention_rollout",
    "grad_cam",
    "encode",
    "classify",
    "classify_dist",
    "forward_heads",
    "merge_lora_params",
    "encode_tome",
    "merge_tokens",
    "aligned_schedule",
    "parse_tome_r",
    "tome_patch_assignment",
    "params_from_jax",
    "adamw_state_from_jax",
    "opt_state_from_jax",
    "resize_pos_embed",
    "fused_layer_norm",
    "fused_add_layer_norm",
    "layer_norm_fwd_plain",
]
