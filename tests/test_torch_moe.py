"""Soft-MoE (``vitx_torch/nn/moe.py``) against vitx's (``vitx/nn/moe.py``),
on the CPU.

``soft_moe_mlp`` alone on the same numpy-seeded tokens and weights, in
fp32 (1e-4) and bf16 (0.05), and its gradients against ``jax.grad`` in
fp32; a model whose every block is a MoE block (no dense segment); the
parameter tree and count of bench 10's model (``base16``, 8 experts over
the last 6 blocks) against vitx's, without allocating it. vitx's bf16
einsums run through ``test_torch_families.fp32_dots``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from test_torch_families import (configs, fp32_dots, images, port, rel_err,
                                 vitx_call, vitx_params)
from vitx.nn.moe import soft_moe_mlp as jsoft_moe_mlp
from vitx_torch.nn.moe import soft_moe_mlp
from vitx_torch.nn.vit import param_spec

torch.set_num_threads(1)

B, T, E, N, S, M = 2, 13, 64, 4, 3, 128


def moe_inputs(seed=0):
    """Tokens (B, T, E) and one MoE block's leaves, numpy fp32."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    bp = {"phi": r(E, N, S, scale=1.0), "router_scale": np.float32(1.7),
          "ew1": r(N, E, M), "eb1": r(N, M), "ew2": r(N, M, E),
          "eb2": r(N, E)}
    return r(B, T, E, scale=1.0), bp


def cfgs(dtype):
    return configs({"moe_experts": N, "moe_slots": S}, dtype, mlp_ratio=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_soft_moe_mlp_matches_vitx(dtype):
    jcfg, tcfg = cfgs(dtype)
    h, bp = moe_inputs()
    want = vitx_call(lambda x, p: jsoft_moe_mlp(x, p, jcfg),
                     jnp.asarray(h, jcfg.cdtype()), bp)
    got = soft_moe_mlp(torch.from_numpy(h).to(tcfg.cdtype()),
                       {k: torch.as_tensor(v) for k, v in bp.items()}, tcfg)
    assert got.dtype == tcfg.cdtype() and got.shape == (B, T, E)
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= \
        {"float32": 1e-4, "bfloat16": 0.05}[dtype]


def test_soft_moe_mlp_grads_match_vitx():
    """d sum(out * w) / d (tokens, every leaf), fp32, against jax.grad."""
    jcfg, tcfg = cfgs("float32")
    h, bp = moe_inputs(1)
    w = np.random.default_rng(2).standard_normal((B, T, E)).astype(
        np.float32)

    def jloss(x, p):
        return jnp.sum(jsoft_moe_mlp(x, p, jcfg) * w)
    with fp32_dots():
        jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(h, bp)
    th = torch.from_numpy(h).requires_grad_()
    tbp = {k: torch.as_tensor(v).clone().requires_grad_()
           for k, v in bp.items()}
    out = (soft_moe_mlp(th, tbp, tcfg) * torch.from_numpy(w)).sum()
    names = sorted(tbp)
    grads = torch.autograd.grad(out, [th] + [tbp[k] for k in names])
    assert rel_err(grads[0], jg[0]) <= 1e-4
    for k, g in zip(names, grads[1:]):
        assert rel_err(g, jg[1][k]) <= 1e-4, k


def test_all_moe_blocks_forward_matches_vitx():
    """``moe_blocks`` = depth: an empty dense stack, then the MoE one."""
    jcfg, tcfg = configs({"moe_experts": 2, "moe_blocks": 2})
    params = vitx_params(jcfg)
    assert params["blocks"]["wqkv"].shape[0] == 0
    x = images(jcfg)
    want = vitx_call(functools.partial(vitx.forward, cfg=jcfg), params, x)
    got = vitx_torch.forward(port(params, tcfg), x, tcfg, device="cpu")
    assert rel_err(got, want) <= 1e-4


def test_bench10_model_tree_is_vitx_tree():
    """base16 with 8 experts over the last 6 blocks: 24 slots an expert,
    every leaf vitx's shape, 290.4 M parameters (3.2x dense base16's
    91.2 M)."""
    kw = dict(moe_experts=8, moe_blocks=6)
    jcfg = vitx.get_config("base16", **kw)
    tcfg = vitx_torch.get_config("base16", **kw)
    assert tcfg.moe_slot_count == 24 and tcfg.dense_block_count == 6
    want = {jax.tree_util.keystr(k): v.shape for k, v in
            jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                functools.partial(vitx.init_params, cfg=jcfg),
                jax.random.PRNGKey(0)))}

    def walk(node, prefix=""):
        for k in sorted(node):
            if isinstance(node[k], dict):
                yield from walk(node[k], f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", node[k][0]
    got = dict(walk(param_spec(tcfg)))
    assert got == want
    count = sum(int(np.prod(s)) for s in got.values())
    dense = sum(int(np.prod(s)) for _, s in walk(param_spec(
        vitx_torch.get_config("base16"))))
    assert (count, dense) == (290_437_870, 91_210_984)
