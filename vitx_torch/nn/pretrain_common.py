"""What the three pretraining families share in the port.

The headless encoder tree that MAE, DINO and SimCLR pretrain, its
transfer into a classifier tree for fine-tuning, and the fp32 helpers of
the DINO and SimCLR heads. vitx keeps these inside each family's module
(``vitx/nn/{mae,dino,simclr}.py``); the port keeps one copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vitx_torch.core.config import ViTConfig
from vitx_torch.nn.vit import Params, init_params, param_spec


def encoder_spec(cfg: ViTConfig, family: str) -> dict:
    """The headless encoder of the pretraining families as ``param_spec``
    entries: the classifier's tree without its head, with a final norm
    whatever ``cfg.final_norm`` says (the families always normalise the
    encoder's output). ``cfg`` must use the learned positional table,
    which the families gather from or resize."""
    if cfg.pos_embed != "learned":
        raise ValueError(f"{family} pretraining requires pos_embed='learned'"
                         " (its encoder gathers/resizes the positional table)")
    spec = param_spec(cfg)
    spec.pop("head")
    E = cfg.embed_dim
    spec.setdefault("final_norm", {"scale": ((E,), 1.0), "bias": ((E,), 0.0)})
    return spec


ENCODER_KEYS = ("patch_embed", "cls_token", "pos_embed", "blocks",
                "final_norm")


def encoder_to_vit_params(encoder: Params, cfg: ViTConfig, rng, family: str,
                          device="cuda") -> Params:
    """A classifier tree for fine-tuning: the pretrained encoder's patch
    embedding, CLS token, positions, blocks and final norm carried over as
    they are, every other leaf (the head) fresh from ``rng``. ``cfg``
    must describe the same encoder with ``final_norm=True``."""
    if not cfg.final_norm:
        raise ValueError(f"fine-tune cfg must set final_norm=True to match "
                         f"the {family} encoder")
    out = dict(init_params(rng, cfg, device=device))
    for key in ENCODER_KEYS:
        out[key] = encoder[key]
    return out


def gelu(x):
    # jax.nn.gelu's default is the tanh form
    return F.gelu(x, approximate="tanh")


def l2_normalize(x, dim: int):
    return x * torch.rsqrt(x.square().sum(dim=dim, keepdim=True) + 1e-12)
