"""Interchange with the JAX package's parameters, the reference model's
state dicts, public pretrained ViTs (timm, HuggingFace), the C oracle's
binary files, the positional table's resize for fine-tuning at another
image size, and a sharded vitx state's parts as a rank's local state."""

from vitx_torch.interop.jax_params import (adamw_state_from_jax,
                                           local_state_from_jax,
                                           opt_state_from_jax, params_from_jax)
from vitx_torch.interop.pretrained import (detect_format,
                                           import_hf_state_dict,
                                           import_pretrained_state_dict,
                                           import_timm_state_dict,
                                           resize_pos_embed,
                                           vit_config_for_pretrained)
from vitx_torch.interop.torch_ref import (export_reference_optimizer_state,
                                          export_reference_state_dict,
                                          import_reference_state_dict,
                                          reference_parameter_order)

__all__ = ["params_from_jax", "adamw_state_from_jax", "opt_state_from_jax",
           "local_state_from_jax",
           "resize_pos_embed",
           "import_reference_state_dict", "export_reference_state_dict",
           "export_reference_optimizer_state", "reference_parameter_order",
           "vit_config_for_pretrained", "detect_format",
           "import_timm_state_dict", "import_hf_state_dict",
           "import_pretrained_state_dict"]
