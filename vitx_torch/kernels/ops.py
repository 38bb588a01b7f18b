"""The inference entries of four kernels as ``torch.library`` custom ops.

``torch.export`` traces a program with tensors that have no data, so a
kernel launched through ``ctypes`` cannot be a node of its graph. These
ops make it one:

- ``vitx_torch::mha_block``: K1 without its stash (``fused_mha_block``);
- ``vitx_torch::mlp_block``: K2 without its stash (``fused_mlp_block``);
- ``vitx_torch::mha_block_tome``: B8 (``fused_mha_block_tome``), (out,
  k_mean);
- ``vitx_torch::attention_fwd``: B5 without probabilities
  (``flash_attention``), which the composed path runs for QKV-bias blocks.

The CUDA implementation of each is the wrapper's own launch, counted as
the wrapper counts it; the CPU implementation is the plain version. The
host checks that read data pointers (``_build.aligned``, the routes) run
inside the launch, and every output is a fresh tensor. The wrappers call
these ops only inside a trace (``_build.tracing``): an eager call goes to
the launch directly. Importing ``vitx_torch.kernels`` registers them;
``vitx_torch.export.load_exported`` does so before it loads a program.
"""

from __future__ import annotations

import importlib

import torch

# the modules (the package's flash_attention is the wrapper function)
_flash = importlib.import_module("vitx_torch.kernels.flash_attention")
_mha = importlib.import_module("vitx_torch.kernels.mha_block")
_mlp = importlib.import_module("vitx_torch.kernels.mlp_block")

Tensor = torch.Tensor


@torch.library.custom_op("vitx_torch::mha_block", mutates_args=(),
                         device_types="cuda")
def mha_block(x: Tensor, wqkv: Tensor, wo: Tensor, bo: Tensor, g: Tensor,
              b: Tensor, eps: float) -> Tensor:
    return _mha._infer(x, wqkv, wo, bo, g, b, eps)


@mha_block.register_kernel("cpu")
def _(x, wqkv, wo, bo, g, b, eps):
    return _mha.mha_block_plain(x, wqkv, wo, bo, g, b, eps=eps)


@mha_block.register_fake
def _(x, wqkv, wo, bo, g, b, eps):
    return torch.empty_like(x)


@torch.library.custom_op("vitx_torch::mlp_block", mutates_args=(),
                         device_types="cuda")
def mlp_block(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
              g: Tensor, b: Tensor, act: str, eps: float) -> Tensor:
    return _mlp._forward(x, w1, b1, w2, b2, g, b, act, eps, stash=False)


@mlp_block.register_kernel("cpu")
def _(x, w1, b1, w2, b2, g, b, act, eps):
    return _mlp.mlp_block_plain(x, w1, b1, w2, b2, g, b, act=act, eps=eps)


@mlp_block.register_fake
def _(x, w1, b1, w2, b2, g, b, act, eps):
    return torch.empty_like(x)


@torch.library.custom_op("vitx_torch::mha_block_tome", mutates_args=(),
                         device_types="cuda")
def mha_block_tome(x: Tensor, wqkv: Tensor, bqkv: Tensor, wo: Tensor,
                   bo: Tensor, g: Tensor, b: Tensor, log_size: Tensor,
                   eps: float) -> tuple[Tensor, Tensor]:
    return _mha._forward_tome(x, wqkv, bqkv, wo, bo, g, b, log_size, eps)


@mha_block_tome.register_kernel("cpu")
def _(x, wqkv, bqkv, wo, bo, g, b, log_size, eps):
    return _mha.mha_block_tome_plain(x, wqkv, bqkv, wo, bo, g, b, log_size,
                                     eps=eps)


@mha_block_tome.register_fake
def _(x, wqkv, bqkv, wo, bo, g, b, log_size, eps):
    B, T, _ = x.shape
    return torch.empty_like(x), x.new_empty((B, T, wqkv.shape[3]))


@torch.library.custom_op("vitx_torch::attention_fwd", mutates_args=(),
                         device_types="cuda")
def attention_fwd(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    return _flash._fwd(q, k, v, None, _flash.flash_attention)


@attention_fwd.register_kernel("cpu")
def _(q, k, v):
    return _flash.flash_attention_fwd_plain(q, k, v)


@attention_fwd.register_fake
def _(q, k, v):
    return torch.empty_like(q)
