"""Interchange with the JAX package's parameters and the reference model's
state dicts, and the positional table's resize for fine-tuning at another
image size."""

from vitx_torch.interop.jax_params import adamw_state_from_jax, params_from_jax
from vitx_torch.interop.pretrained import resize_pos_embed
from vitx_torch.interop.torch_ref import (export_reference_optimizer_state,
                                          export_reference_state_dict,
                                          import_reference_state_dict,
                                          reference_parameter_order)

__all__ = ["params_from_jax", "adamw_state_from_jax", "resize_pos_embed",
           "import_reference_state_dict", "export_reference_state_dict",
           "export_reference_optimizer_state", "reference_parameter_order"]
