"""The port's HF import against ``transformers`` itself, on the CPU.

A ``ViTForImageClassification`` with random weights (depth 2, E 64, 4
heads, 32² images in 8² patches, its LayerNorm eps 1e-12) is imported
through its own state dict (``import_pretrained_state_dict``); the port's
fp32 logits are held to HF's at 2e-4 (max |a - b| over max |b|), as
``tests/test_pretrained.py`` holds vitx's. Apart from
``tests/test_torch_pretrained.py`` because importing ``transformers``
alone takes most of this file's time.
"""

import pytest
import torch

from tests.test_torch_pretrained import C, E, H, L, P, S, cfgs, images, rel_err
from vitx_torch import forward
from vitx_torch.interop import pretrained as tpre

torch.set_num_threads(1)


def test_hf_transformers_oracle():
    """A ``transformers`` ViTForImageClassification with random weights,
    imported through its own state dict: the port's logits within 2e-4 of
    HF's."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.ViTForImageClassification(transformers.ViTConfig(
        hidden_size=E, num_hidden_layers=L, num_attention_heads=H,
        intermediate_size=4 * E, image_size=S, patch_size=P, num_labels=C,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)).eval()
    _, tcfg = cfgs(eps=model.config.layer_norm_eps)
    params = tpre.import_pretrained_state_dict(model.state_dict(), tcfg,
                                               device="cpu")
    x = images()
    with torch.no_grad():
        ref = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits
    got = forward(params, x, tcfg, device="cpu")
    assert rel_err(got.numpy(), ref.numpy()) <= 2e-4
