"""Interchange with the JAX package's parameters, and the positional
table's resize for fine-tuning at another image size."""

from vitx_torch.interop.jax_params import adamw_state_from_jax, params_from_jax
from vitx_torch.interop.pretrained import resize_pos_embed

__all__ = ["params_from_jax", "adamw_state_from_jax", "resize_pos_embed"]
