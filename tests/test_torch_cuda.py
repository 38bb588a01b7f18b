"""vitx_torch's CUDA kernels on the card (marker ``cuda``).

Each test skips where no CUDA device is present: a CUDA kernel has no CPU
mode, and the CPU tests hold the kernels' plain versions to vitx's Pallas
kernels instead (``tests/test_torch_kernels.py``). This file imports no
JAX, so on a machine with a card it runs without the JAX package:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars, as max |kernel - plain| over max |plain|: float32 1e-4 (TF32 off);
bfloat16 2e-2 -- both sides accumulate in fp32 in another order, which
moves a few bf16 roundings of the intermediates by one ulp (2**-8).
"""

import numpy as np
import pytest
import torch

import vitx_torch
from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                mha_block_plain, mlp_block_plain)
from vitx_torch.nn.vit import params_to

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def rel_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def block_args(B, T, E, H, dtype, device, seed=3):
    rng = np.random.default_rng(seed)
    D, M = E // H, 4 * E
    dt = getattr(torch, dtype)

    def n(*shape, scale=1.0, shift=0.0, vec=False):
        a = (shift + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(device, torch.float32 if vec else dt)

    x = n(B, T, E)
    mha = (x, n(E, 3, H, D, scale=0.04), n(E, E, scale=0.04),
           n(E, scale=0.1, vec=True), n(E, scale=0.1, shift=1.0, vec=True),
           n(E, scale=0.1, vec=True))
    mlp = (x, n(E, M, scale=0.04), n(M, scale=0.1, vec=True),
           n(M, E, scale=0.04), n(E, scale=0.1, vec=True),
           n(E, scale=0.1, shift=1.0, vec=True), n(E, scale=0.1, vec=True))
    return mha, mlp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 197, 768, 12), (3, 65, 64, 4),
                                  (2, 50, 36, 4), (1, 40, 256, 1)])
def test_kernels_match_plain(cuda, dims, dtype):
    """K1 and K2 against their plain versions, at ViT-B/16 width, the tiny
    preset's, a ragged one (E=36, D=9: the kernels' scalar paths) and one
    head of D=256 (the largest the attention kernel takes)."""
    mha, mlp = block_args(*dims, dtype, cuda)
    n = fused_mha_block.launches
    out = fused_mha_block(*mha)
    torch.cuda.synchronize()
    assert fused_mha_block.launches == n + 1
    assert out.dtype == mha[0].dtype and bool(torch.isfinite(out).all())
    assert rel_err(out, mha_block_plain(*mha)) <= TOL[dtype]
    for act in ("gelu", "gelu_tanh", "relu"):
        out = fused_mlp_block(*mlp, act=act)
        torch.cuda.synchronize()
        assert rel_err(out, mlp_block_plain(*mlp, act=act)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_on_card_matches_cpu(cuda, dtype):
    """The tiny preset end to end: kernels on the card, plain on the CPU,
    and exactly one launch of each kernel per block."""
    cfg = vitx_torch.get_config("tiny", compute_dtype=dtype)
    params = vitx_torch.init_params(0, cfg, device=cuda)
    x = np.random.default_rng(0).standard_normal(
        (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    n1, n2 = fused_mha_block.launches, fused_mlp_block.launches
    out = vitx_torch.forward(params, x, cfg)
    torch.cuda.synchronize()
    assert fused_mha_block.launches - n1 == cfg.depth
    assert fused_mlp_block.launches - n2 == cfg.depth
    ref = vitx_torch.forward(params_to(params, "cpu"), x, cfg, device="cpu")
    assert rel_err(out, ref) < (1e-4 if dtype == "float32" else 0.05)


@pytest.mark.cuda
def test_composed_attention_raises_on_card(cuda):
    cfg = vitx_torch.get_config("tiny", qkv_bias=True)
    params = vitx_torch.init_params(0, cfg, device=cuda)
    x = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
    with pytest.raises(NotImplementedError, match="B5"):
        vitx_torch.forward(params, x, cfg)
