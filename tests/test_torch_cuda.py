"""vitx_torch's CUDA kernels on the card (marker ``cuda``).

Each test skips where no CUDA device is present: a CUDA kernel has no CPU
mode, and the CPU tests hold the kernels' plain versions to vitx's Pallas
kernels instead (``tests/test_torch_kernels.py``). This file imports no
JAX, so on a machine with a card it runs without the JAX package:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars, as max |kernel - plain| over max |plain|: float32 1e-4 (TF32 off);
bfloat16 2e-2 -- both sides accumulate in fp32 in another order, which
moves a few bf16 roundings of the intermediates by one ulp (2**-8). B5's
probabilities in bf16: 1e-3 -- kernel and plain read the same bf16 q and
k and differ only in the fp32 order of the logits' sums.
"""

import importlib
import threading

import numpy as np
import pytest
import torch

import vitx_torch
from vitx_torch.kernels import (adamw_multi_plain, adamw_plain,
                                attention_bwd,
                                attention_bwd_plain, attention_stats_plain,
                                flash_attention,
                                flash_attention_fwd_plain,
                                flash_attention_with_mean_probs,
                                flash_attention_with_probs,
                                fused_add_layer_norm, fused_adamw_,
                                fused_adamw_multi_,
                                fused_layer_norm, fused_mha_block,
                                fused_mha_block_tome,
                                fused_mha_block_with_mean_probs,
                                fused_mlp_block, layer_norm_fwd_plain, ln_bwd,
                                ln_bwd_plain, mha_block_mean_probs_plain,
                                mha_block_plain, mha_block_tome_plain,
                                mlp_block_plain)
from vitx_torch.nn.vit import params_to
from vitx_torch.train import step as tstep

tmha = importlib.import_module("vitx_torch.kernels.mha_block")
tmlp = importlib.import_module("vitx_torch.kernels.mlp_block")
tln = importlib.import_module("vitx_torch.kernels.layer_norm")

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROBS_BF16_TOL = 1e-3


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
def test_composed_attention_runs_on_card(cuda):
    """The composed path (a QKV bias, attn_impl="flash") runs on the card
    through B5, one launch per block, and agrees with the CPU; a train
    step of it runs B5 forward and B2 backward."""
    cfg = vitx_torch.get_config("tiny", qkv_bias=True, attn_impl="flash",
                                compute_dtype="float32")
    host = vitx_torch.init_params(0, cfg, device="cpu")
    params = params_to(host, cuda)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(
        np.float32)
    n = flash_attention.launches
    out = vitx_torch.forward(params, x, cfg)
    torch.cuda.synchronize()
    assert flash_attention.launches - n == cfg.depth
    ref = vitx_torch.forward(host, x, cfg, device="cpu")
    assert rel_err(out, ref) < 1e-4
    opt = tstep.make_optimizer(lr=1e-3)
    batch = {"image": x, "label": rng.integers(0, cfg.num_classes, 2)
             .astype(np.int32)}
    n, nb = flash_attention.launches, attention_bwd.launches
    _, m_card = tstep.train_step(tstep.TrainState(0, params,
                                                  opt.init(params)),
                                 batch, cfg=cfg, optimizer=opt)
    torch.cuda.synchronize()
    assert flash_attention.launches - n == cfg.depth
    assert attention_bwd.launches - nb == cfg.depth
    _, m_ref = tstep.train_step(tstep.TrainState(0, host, opt.init(host)),
                                batch, cfg=cfg, optimizer=opt, device="cpu")
    for k in ("loss", "grad_norm"):
        assert rel_err(m_card[k], m_ref[k]) <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 12, 197, 64), (2, 16, 577, 64),
                                  (1, 2, 1100, 64), (3, 4, 65, 16),
                                  (2, 3, 50, 9)])
def test_flash_attention_matches_plain(cuda, dims, dtype):
    """B5 in its three modes against its plain version, at base16's and
    large16_384's shapes, a T above 1024, tiny's and a ragged head (D=9);
    the head mean twice, bit for bit, rows summing to 1."""
    q, k, v = (seeded(dims, s, 1.5, dtype=dtype, device=cuda)
               for s in (1, 2, 3))
    ptol = 1e-4 if dtype == "float32" else 1e-3
    for fn, mode in ((flash_attention, None),
                     (flash_attention_with_probs, "full"),
                     (flash_attention_with_mean_probs, "mean")):
        n = fn.launches
        out = fn(q, k, v)
        torch.cuda.synchronize()
        assert fn.launches == n + 1
        ref = flash_attention_fwd_plain(q, k, v, mode)
        if mode is None:
            out, ref = (out,), (ref,)
        assert out[0].dtype == q.dtype
        assert rel_err(out[0], ref[0]) <= TOL[dtype]
        if mode is not None:
            assert out[1].dtype == torch.float32
            assert rel_err(out[1], ref[1]) <= ptol
            rows = out[1].double().sum(-1)
            assert float((rows - 1).abs().max()) <= 1e-5
        if mode == "mean":
            assert torch.equal(fn(q, k, v)[1], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 197, 768, 12), (2, 577, 1024, 16),
                                  (3, 65, 64, 4)])
def test_mha_mean_probs_matches_plain(cuda, dims, dtype):
    """B7 against its plain version at base16, large16_384 and tiny
    shapes; repeated calls agree bit for bit. Where B7 takes the sm90
    attention and its head-mean pass (bf16 at D 64) its out equals K1's on
    K1's full route, the same GEMMs and attention body; elsewhere K1's on
    the attention body they share (``k1_on_shared_attention``)."""
    mha, _ = block_args(*dims, dtype, cuda)
    f = fused_mha_block_with_mean_probs
    n, n1, n90 = f.launches, fused_mha_block.launches, f.launches_attn_sm90
    out, probs = f(*mha)
    torch.cuda.synchronize()
    assert f.launches == n + 1
    assert fused_mha_block.launches == n1
    sm90 = dtype == "bfloat16" and dims[2] // dims[3] == 64
    assert f.launches_attn_sm90 == n90 + sm90
    ref_out, ref_probs = mha_block_mean_probs_plain(*mha)
    assert rel_err(out, ref_out) <= TOL[dtype]
    assert rel_err(probs, ref_probs) <= TOL[dtype]
    assert float((probs.double().sum(-1) - 1).abs().max()) <= 1e-5
    again = f(*mha)
    assert torch.equal(again[1], probs) and torch.equal(again[0], out)
    if sm90:
        assert torch.equal(fused_mha_block(*mha), out)
    else:
        assert torch.equal(k1_on_shared_attention(*mha), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(2, 577, 1024, 16), (8, 577, 1024, 16),
                                  (2, 197, 768, 12)])
def test_mha_mean_probs_sm90_matches_plain(cuda, dims):
    """B7 in bf16 on the sm90 attention and its head-mean pass, against its
    plain version (out 2e-2; probs 2e-2 as a block, and 1e-3 against the
    plain head mean of the kernel's own q and k), against its GEMM-only route
    (the sm90 GEMM with attention_fwd.cuh) and the earlier kernels on the
    same inputs; twice bit for bit; its out bit-equal to K1's."""
    mha, _ = block_args(*dims, "bfloat16", cuda)
    out, probs, q, k, v, route = tmha._launch_mean_probs(*mha, 1e-5)
    torch.cuda.synchronize()
    assert route == tmha.ROUTE_GEMM_SM90 | tmha.ROUTE_ATTN_SM90
    ref_out, ref_probs = mha_block_mean_probs_plain(*mha)
    assert rel_err(out, ref_out) <= TOL["bfloat16"]
    assert rel_err(probs, ref_probs) <= TOL["bfloat16"]
    own = flash_attention_fwd_plain(q, k, v, "mean")[1]
    assert rel_err(probs, own) <= PROBS_BF16_TOL
    assert float((probs.double().sum(-1) - 1).abs().max()) <= 1e-5
    for r in (tmha.ROUTE_GEMM_SM90, 0):
        was = tmha._launch_mean_probs(*mha, 1e-5, route=r)
        assert rel_err(was[0], ref_out) <= TOL["bfloat16"]
        assert rel_err(was[1], ref_probs) <= TOL["bfloat16"]
    again = fused_mha_block_with_mean_probs(*mha)
    assert torch.equal(again[0], out) and torch.equal(again[1], probs)
    assert torch.equal(fused_mha_block(*mha), out)


@pytest.mark.cuda
def test_rollout_runs_b7_on_the_sm90_attention(cuda):
    """forward_with_rollout at large16_384 in bf16: B7 in every one of the
    24 blocks, each on the sm90 attention and its head-mean pass."""
    cfg = vitx_torch.get_config("large16_384")
    params = vitx_torch.init_params(0, cfg, device=cuda)
    x = np.random.default_rng(1).standard_normal(
        (1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    f = fused_mha_block_with_mean_probs
    n, n90 = f.launches, f.launches_attn_sm90
    logits, weights = vitx_torch.forward_with_rollout(params, x, cfg)
    torch.cuda.synchronize()
    assert (f.launches - n, f.launches_attn_sm90 - n90) == (24, 24)
    assert bool(torch.isfinite(logits).all())
    assert float((weights.double().sum(-1) - 1).abs().max()) <= 1e-4


def k1_on_shared_attention(x, wqkv, wo, bo, g, b):
    """K1's out on its own route but with the attention on
    ``attention_fwd.cuh``, the body B7 and B8 run: in bf16 at D 64 K1's
    own route takes B5's sm90 body instead, whose p is rounded after
    exp(s - running max), so bit equality holds only on the shared body."""
    B, T, E = x.shape
    H = wqkv.shape[2]
    route = tmha.mha_route(x.dtype, E, H, tensors=(x, wqkv, wo))
    st = torch.empty((2, B, H, T), dtype=torch.float32, device=x.device)
    return tmha._launch(x, wqkv, wo, bo, g, b, 1e-5, extra=(st,),
                        route=route & ~tmha.ROUTE_ATTN_SM90)[0]


def seeded(shape, seed, scale=1.0, shift=0.0, dtype="float32",
           device="cpu"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(shift + scale * a).to(device,
                                                  getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 12, 197, 64), (3, 4, 65, 16),
                                  (2, 4, 50, 9), (1, 1, 40, 128),
                                  (128, 6, 197, 64)])
def test_attention_bwd_matches_plain(cuda, dims, dtype):
    """B2 at ViT-B/16 shapes, tiny's, a ragged head (D=9), the largest
    head it takes (D=128) and the small16 recipe's train batch, given the
    forward's o and statistics (bf16 at D 64 takes the sm90 kernel, which
    needs them)."""
    q, k, v = (seeded(dims, s, 1.5, dtype=dtype, device=cuda)
               for s in (1, 2, 3))
    do = seeded(dims, 4, 0.1, dtype=dtype, device=cuda)
    n = attention_bwd.launches
    out = attention_bwd(q, k, v, do, *fwd_residuals(q, k, v))
    torch.cuda.synchronize()
    assert attention_bwd.launches == n + 1
    for o, r in zip(out, attention_bwd_plain(q, k, v, do)):
        assert o.dtype == q.dtype and bool(torch.isfinite(o).all())
        assert rel_err(o, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 197, 768), (2, 3072), (3, 5, 36),
                                   (130, 64)])
def test_ln_bwd_matches_plain(cuda, shape, dtype):
    """B3 on the route ``ln_bwd_route`` gives (the one-pass route, counted
    in launches_onepass, except bf16 at E 36, not a multiple of 8)."""
    x = seeded(shape, 5, 2.0, 0.5, dtype=dtype, device=cuda)
    dy = seeded(shape, 6, 0.1, dtype=dtype, device=cuda)
    sc = seeded(shape[-1:], 7, 0.1, 1.0, device=cuda)
    n, n1 = ln_bwd.launches, ln_bwd.launches_onepass
    out = ln_bwd(x, sc, dy)
    torch.cuda.synchronize()
    assert ln_bwd.launches == n + 1
    onepass = tln.ln_bwd_route(x.dtype, shape[-1], (x, dy)) == 1
    assert onepass == (dtype == "float32" or shape[-1] % 8 == 0)
    assert ln_bwd.launches_onepass == n1 + onepass
    for o, r in zip(out, ln_bwd_plain(x, sc, dy)):
        assert rel_err(o, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 197, 768), (32, 1025, 768),
                                   (8, 577, 1024), (128, 3072), (32, 4096),
                                   (50432, 768), (128, 197, 384),
                                   (128, 1536)])
def test_ln_bwd_onepass_matches_plain(cuda, shape, dtype):
    """B3's one-pass route at the train and fine-tune steps' tokens, E
    1024, the reference head's (B, 4E), B11's (R, E) view and the small16
    recipe's tokens and head (E 384, 4E 1536): against the
    plain version and the earlier kernel on the same inputs, twice bit for
    bit."""
    x = seeded(shape, 15, 2.0, 0.5, dtype=dtype, device=cuda)
    dy = seeded(shape, 16, 0.1, dtype=dtype, device=cuda)
    sc = seeded(shape[-1:], 17, 0.1, 1.0, device=cuda)
    n1 = ln_bwd.launches_onepass
    out = ln_bwd(x, sc, dy)
    torch.cuda.synchronize()
    assert ln_bwd.launches_onepass == n1 + 1
    ref = ln_bwd_plain(x, sc, dy)
    E = shape[-1]
    was = tln._launch(x.reshape(-1, E), sc, dy.reshape(-1, E), 1e-5, 0)
    for o, w, r in zip(out, was, ref):
        assert rel_err(o, r) <= TOL[dtype]
        assert rel_err(w.reshape(r.shape), r) <= TOL[dtype]
    assert all(torch.equal(a, b) for a, b in zip(ln_bwd(x, sc, dy), out))


@pytest.mark.cuda
def test_ln_bwd_refuses_what_the_onepass_route_cannot_take(cuda):
    """The entry refuses the one-pass route, before any launch, at a width
    off the 16-byte vector or past 4096, or on rows off 16 bytes."""
    for E, off in ((100, 0), (4104, 0), (768, 1)):
        buf = seeded((4 * E + off,), 18, dtype="bfloat16", device=cuda)
        x = buf[off:off + 4 * E].view(4, E)
        sc = seeded((E,), 19, device=cuda)
        with pytest.raises(RuntimeError, match="refused the route"):
            tln._launch(x, sc, x, 1e-5, tln.LN_ROUTE_ONEPASS)


@pytest.mark.cuda
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("numel", [65536, 1000, 1])
def test_fused_adamw_matches_plain(cuda, numel, gdtype):
    p = seeded((numel,), 8, 0.02, device=cuda)
    g = seeded((numel,), 9, 1e-3, dtype=gdtype, device=cuda)
    mu = seeded((numel,), 10, 1e-4, device=cuda)
    nu = seeded((numel,), 11, 1e-6, device=cuda).abs()
    kw = dict(lr=1e-3, c1=0.19, c2=0.001999, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    ref = adamw_plain(p, g, mu, nu, **kw)
    n = fused_adamw_.launches
    fused_adamw_(p, g, mu, nu, **kw)
    torch.cuda.synchronize()
    assert fused_adamw_.launches == n + 1
    for o, r in zip((p, mu, nu), ref):
        assert rel_err(o, r) <= TOL["float32"]


def ragged_leaves(offset, device, gdtypes=("float32", "bfloat16")):
    """AdamW leaves of ragged sizes as views ``offset`` elements into
    their buffers (p, mu, nu), the gradients at other offsets and in
    turn of ``gdtypes``: scalar heads and tails, and pointers that are not
    co-aligned."""
    sizes = (1, 3, 5, 1025, 65536 + 5, 4 * 768 + 2)

    def leaf(i, m, seed, scale, dtype="float32", o=offset):
        return seeded((m + 4,), seed + i, scale, dtype=dtype,
                      device=device)[o:o + m]

    ps = [leaf(i, m, 100, 0.02) for i, m in enumerate(sizes)]
    gs = [leaf(i, m, 110, 1e-3, gdtypes[i % len(gdtypes)], (offset + i) % 3)
          for i, m in enumerate(sizes)]
    mus = [leaf(i, m, 120, 1e-4) for i, m in enumerate(sizes)]
    nus = [leaf(i, m, 130, 1e-6).abs() for i, m in enumerate(sizes)]
    return ps, gs, mus, nus


@pytest.mark.cuda
@pytest.mark.parametrize("gdtypes", [("float32",), ("bfloat16",),
                                     ("float32", "bfloat16")],
                         ids=["f32", "bf16", "mixed"])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_fused_adamw_multi_matches_plain(cuda, offset, gdtypes):
    """B12's multi-leaf kernel bit for bit against ``adamw_multi_plain``
    over views at an element offset, one launch per gradient dtype."""
    ps, gs, mus, nus = ragged_leaves(offset, cuda, gdtypes)
    kw = dict(lr=1e-3, c1=0.19, c2=0.001999, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    ref = adamw_multi_plain(ps, gs, mus, nus, **kw)
    n = fused_adamw_multi_.launches
    fused_adamw_multi_(ps, gs, mus, nus, **kw)
    torch.cuda.synchronize()
    assert fused_adamw_multi_.launches == n + len(gdtypes)
    for got, want in zip((ps, mus, nus), ref):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_fused_adamw_multi_refuses_what_it_cannot_take(cuda):
    """A leaf the kernel cannot take raises before any launch: fp64 or
    non-contiguous moments, a leaf on the CPU."""
    ps, gs, mus, nus = ragged_leaves(0, cuda)
    kw = dict(lr=1e-3, c1=0.19, c2=0.001999)
    n = fused_adamw_multi_.launches
    for bad in (dict(mus=mus[:-1] + [mus[-1].double()]),
                dict(nus=nus[:-1] + [torch.zeros(2 * nus[-1].numel(),
                                                 device=cuda)[::2]]),
                dict(ps=ps[:-1] + [ps[-1].cpu()])):
        lists = {**dict(ps=ps, gs=gs, mus=mus, nus=nus), **bad}
        with pytest.raises((TypeError, ValueError)):
            fused_adamw_multi_(lists["ps"], lists["gs"], lists["mus"],
                               lists["nus"], **kw)
    assert fused_adamw_multi_.launches == n


@pytest.mark.cuda
def test_adamw_plain_divides_as_on_cpu(cuda):
    """adamw_plain on the card gives the CPU's bits: its bias corrections
    divide (a Python divisor would make torch multiply by the reciprocal on
    the card), as vitx's update and the kernels do."""
    ps, gs, mus, nus = ragged_leaves(0, cuda)
    kw = dict(lr=1e-3, c1=0.19, c2=0.001999, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    for p, g, mu, nu in zip(ps, gs, mus, nus):
        card = adamw_plain(p, g, mu, nu, **kw)
        host = adamw_plain(p.cpu(), g.cpu(), mu.cpu(), nu.cpu(), **kw)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(card, host))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stash_matches_plain(cuda, dtype):
    mha, mlp = block_args(2, 197, 768, 12, dtype, cuda)
    for o, r in zip(fused_mha_block(*mha, stash=True),
                    mha_block_plain(*mha, stash=True)):
        assert o.shape == r.shape and rel_err(o, r) <= TOL[dtype]
    for o, r in zip(fused_mlp_block(*mlp, act="gelu_tanh", stash=True),
                    mlp_block_plain(*mlp, act="gelu_tanh", stash=True)):
        assert o.shape == r.shape and rel_err(o, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_mlp", ["auto", "on"])
def test_train_step_on_card_matches_cpu(cuda, fuse_mlp):
    """One fp32 tiny step, kernels on the card and plain versions on the
    CPU, from the same params: the loss, grad_norm and params, and the
    launches the routing gives (K2 only with fuse_mlp="on"). Params are
    held in units of lr: Adam's first step is about +-lr whatever |g|, so
    an element whose gradient is small against its leaf's rounding may
    land anywhere within 2 lr; a wrong update moves a large share."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32",
                                fuse_mlp=fuse_mlp)
    opt = tstep.make_optimizer(lr=1e-3, fused=True)
    host = vitx_torch.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal(
        (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        "label": rng.integers(0, cfg.num_classes, 4).astype(np.int32)}
    names = ("fused_mha_block", "fused_mlp_block", "attention_bwd",
             "ln_bwd", "fused_adamw_", "fused_adamw_multi_")
    fns = (fused_mha_block, fused_mlp_block, attention_bwd, ln_bwd,
           fused_adamw_, fused_adamw_multi_)
    before = [f.launches for f in fns]
    on_card = params_to(host, cuda)
    card, m_card = tstep.train_step(
        tstep.TrainState(0, on_card, opt.init(on_card)), batch, cfg=cfg,
        optimizer=opt)
    torch.cuda.synchronize()
    k2 = cfg.depth if fuse_mlp == "on" else 0
    # B12: one launch over every leaf (the gradients are fp32, as the
    # params), none a leaf
    assert {n: f.launches - b for n, f, b in zip(names, fns, before)} == {
        "fused_mha_block": cfg.depth, "fused_mlp_block": k2,
        "attention_bwd": cfg.depth, "ln_bwd": 2 * cfg.depth + 1,
        "fused_adamw_": 0, "fused_adamw_multi_": 1}
    ref, m_ref = tstep.train_step(
        tstep.TrainState(0, host, opt.init(host)), batch, cfg=cfg,
        optimizer=opt, device="cpu")
    for k in ("loss", "grad_norm"):
        assert rel_err(m_card[k], m_ref[k]) <= 1e-4, k
    dp = torch.cat([(a.cpu() - b).abs().flatten() for a, b in zip(
        tstep.leaves(card.params), tstep.leaves(ref.params))]) / 1e-3
    assert float(dp.max()) <= 2.0
    assert float((dp > 0.01).float().mean()) <= 1e-3


def tome_args(B, T, E, H, dtype, device, bias=True, seed=5, sizes=6.0):
    """B8's inputs: block_args' attention half plus bqkv (3, H, D) and
    log_size (B, T) in [0, log ``sizes``], or zeros for both."""
    (x, wqkv, wo, bo, g, b), _ = block_args(B, T, E, H, dtype, device, seed)
    rng = np.random.default_rng(seed + 1)
    bqkv = seeded((3, H, E // H), seed + 2, 0.1, device=device)
    ls = torch.from_numpy(np.log(1.0 + (sizes - 1.0) * rng.random(
        (B, T))).astype(np.float32)).to(device)
    if not bias:
        bqkv, ls = torch.zeros_like(bqkv), torch.zeros_like(ls)
    return x, wqkv, bqkv, wo, bo, g, b, ls


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [197, 54, 41, 13])
def test_tome_block_matches_plain(cuda, T, dtype, bias):
    """B8 against its plain version at base16's ToMe block shapes (T 197
    and 54, the first and last r=13 blocks; 41, the tokens leaving the
    last; and 13), with and without the QKV and key biases; k_mean twice,
    bit for bit."""
    args = tome_args(2, T, 768, 12, dtype, cuda, bias)
    n = fused_mha_block_tome.launches
    out, k_mean = fused_mha_block_tome(*args)
    torch.cuda.synchronize()
    assert fused_mha_block_tome.launches == n + 1
    ref_out, ref_km = mha_block_tome_plain(*args)
    assert out.dtype == k_mean.dtype == args[0].dtype
    assert k_mean.shape == (2, T, 64)
    assert rel_err(out, ref_out) <= TOL[dtype]
    assert rel_err(k_mean, ref_km) <= TOL[dtype]
    assert torch.equal(fused_mha_block_tome(*args)[1], k_mean)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 197, 768, 12), (3, 65, 64, 4)])
def test_tome_block_zero_biases_equal_k1(cuda, dims, dtype):
    """With zero bqkv and log_size, B8's out is K1's bit for bit, K1 on its
    own full route: B8 takes K1's GEMM and attention (in bf16 at D 64 the
    sm90 body, whose KBIAS form adds a zero)."""
    x, wqkv, bqkv, wo, bo, g, b, ls = tome_args(*dims, dtype, cuda, False)
    out, _ = fused_mha_block_tome(x, wqkv, bqkv, wo, bo, g, b, ls)
    B, T, E = x.shape
    st = torch.empty((2, B, wqkv.shape[2], T), device=cuda)
    assert torch.equal(out, tmha._launch(x, wqkv, wo, bo, g, b, 1e-5,
                                         extra=(st,))[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(768, 12), (1024, 16)],
                         ids=["base16", "large16_384"])
@pytest.mark.parametrize("T", [1, 48, 63, 65, 197, 416, 577])
def test_tome_block_sm90_matches_plain(cuda, T, dims):
    """B8 in bf16 at D 64 on the sm90 attention (one launch counted in
    ``launches_attn_sm90``) against its plain version, with log(size) from
    log 1 to log 40 -- a row's max moves between key tiles -- at T on
    either side of the 64-key tile and ToMe's shapes of both models; the
    last image's keys end the bias buffer, so a read past T would fault
    or show; k_mean twice, bit for bit."""
    E, H = dims
    args = tome_args(3, T, E, H, "bfloat16", cuda, seed=T, sizes=40.0)
    n = fused_mha_block_tome.launches_attn_sm90
    out, k_mean = fused_mha_block_tome(*args)
    torch.cuda.synchronize()
    assert fused_mha_block_tome.launches_attn_sm90 == n + 1
    ref_out, ref_km = mha_block_tome_plain(*args)
    assert rel_err(out, ref_out) <= TOL["bfloat16"]
    assert rel_err(k_mean, ref_km) <= TOL["bfloat16"]
    assert torch.equal(fused_mha_block_tome(*args)[1], k_mean)


@pytest.mark.cuda
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_tome_forward_on_card_matches_cpu(cuda, qkv_bias):
    """A tiny ToMe forward (r=4) in fp32: B8 and K2 once per block, K1
    never; the logits and the merge's sources agree with the CPU."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32", tome_r=4,
                                qkv_bias=qkv_bias)
    host = vitx_torch.init_params(0, cfg, device="cpu")
    if qkv_bias:
        host["blocks"]["bqkv"] = seeded(host["blocks"]["bqkv"].shape, 9, 0.1)
    params = params_to(host, cuda)
    x = np.random.default_rng(0).standard_normal(
        (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    fns = (fused_mha_block_tome, fused_mlp_block, fused_mha_block)
    before = [f.launches for f in fns]
    out = vitx_torch.forward(params, x, cfg)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [
        cfg.depth, cfg.depth, 0]
    assert rel_err(out, vitx_torch.forward(host, x, cfg, device="cpu")) < 1e-4
    with torch.inference_mode():
        _, src = vitx_torch.encode_tome(params, torch.from_numpy(x).to(cuda),
                                        cfg, return_sources=True)
        _, ref = vitx_torch.encode_tome(host, torch.from_numpy(x), cfg,
                                        return_sources=True)
    assert torch.equal(src.cpu(), ref)


def fwd_residuals(q, k, v):
    """The forward's o and row statistics, from their plain versions."""
    return flash_attention_fwd_plain(q, k, v), attention_stats_plain(q, k)


# every shape chip_smoke.py's grad and kernels phases hold B2 and B5 at, at
# a batch that fits a test, ragged T among them; the forward also at T 1
# (one key: the backward's gradients are 0 there, so its relative error
# has no scale)
SM90_DIMS = [(2, 12, 197, 64), (1, 16, 577, 64), (2, 12, 1025, 64),
             (1, 16, 1100, 64), (1, 12, 2048, 64), (3, 4, 65, 64),
             (2, 2, 3, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", SM90_DIMS)
def test_attention_bwd_sm90_matches_plain(cuda, dims):
    """B2's sm90 kernel (bf16, D 64) against the plain version; two calls
    equal bit for bit; do and o read in the fused block's (B, T, H, D)
    layouts and dq, dk, dv written into one (B, T, 3, H, D) buffer give
    the same bits."""
    q, k, v = (seeded(dims, s, 1.5, dtype="bfloat16", device=cuda)
               for s in (21, 22, 23))
    do = seeded(dims, 24, 0.1, dtype="bfloat16", device=cuda)
    o, stats = fwd_residuals(q, k, v)
    n, n90 = attention_bwd.launches, attention_bwd.launches_sm90
    out = attention_bwd(q, k, v, do, o, stats)
    torch.cuda.synchronize()
    assert (attention_bwd.launches, attention_bwd.launches_sm90) == (
        n + 1, n90 + 1)
    for a, r in zip(out, attention_bwd_plain(q, k, v, do)):
        assert a.dtype == q.dtype and bool(torch.isfinite(a).all())
        assert rel_err(a, r) <= TOL["bfloat16"]
    again = attention_bwd(q, k, v, do, o, stats)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    B, H, T, D = dims
    buf = torch.empty((B, T, 3, H, D), dtype=q.dtype, device=cuda)
    views = tuple(buf[:, :, i].transpose(1, 2) for i in range(3))
    bthd = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (do, o)]
    attention_bwd(q, k, v, *bthd, stats, out=views)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(views, out))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", SM90_DIMS + [(3, 2, 1, 64)])
def test_flash_attention_sm90_matches_plain(cuda, dims):
    """B5 without probs on its sm90 route (bf16, D 64): o and the row
    statistics its backward reads against their plain versions; two calls
    equal bit for bit; autograd through it runs B2's sm90 kernel."""
    q, k, v = (seeded(dims, s, 1.5, dtype="bfloat16", device=cuda)
               for s in (25, 26, 27))
    n90 = flash_attention.launches_sm90
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_sm90 == n90 + 1
    assert rel_err(out, flash_attention_fwd_plain(q, k, v)) <= TOL["bfloat16"]
    assert torch.equal(flash_attention(q, k, v), out)
    if dims[2] == 1:
        return
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    do = seeded(dims, 28, 0.1, dtype="bfloat16", device=cuda)
    nb = attention_bwd.launches_sm90
    grads = torch.autograd.grad(flash_attention(*ins), ins, do)
    torch.cuda.synchronize()
    assert attention_bwd.launches_sm90 == nb + 1
    for a, r in zip(grads, attention_bwd_plain(q, k, v, do)):
        assert rel_err(a, r) <= TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("float32", 64), ("bfloat16", 16),
                                     ("bfloat16", 128)])
def test_attention_earlier_routes_unchanged(cuda, dtype, D):
    """fp32 and other head widths keep the earlier kernels: launches count,
    launches_sm90 does not, and the results match the plain versions;
    the backward takes no statistics there."""
    dims = (2, 3, 197, D)
    q, k, v = (seeded(dims, s, 1.5, dtype=dtype, device=cuda)
               for s in (31, 32, 33))
    do = seeded(dims, 34, 0.1, dtype=dtype, device=cuda)
    n, n90 = flash_attention.launches, flash_attention.launches_sm90
    o = flash_attention(q, k, v)
    nb, nb90 = attention_bwd.launches, attention_bwd.launches_sm90
    out = attention_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_sm90) == (
        n + 1, n90)
    assert (attention_bwd.launches, attention_bwd.launches_sm90) == (
        nb + 1, nb90)
    assert rel_err(o, flash_attention_fwd_plain(q, k, v)) <= TOL[dtype]
    for a, r in zip(out, attention_bwd_plain(q, k, v, do)):
        assert rel_err(a, r) <= TOL[dtype]


@pytest.mark.cuda
def test_attention_bwd_sm90_needs_the_forward_residuals(cuda):
    q = seeded((1, 2, 65, 64), 35, 1.0, dtype="bfloat16", device=cuda)
    with pytest.raises(ValueError, match="takes the forward's o and stats"):
        attention_bwd(q, q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 12, 1025, 64), (1, 2, 2048, 64),
                                  (1, 3, 1100, 16)])
def test_attention_bwd_long_sequences_match_plain(cuda, dims, dtype):
    """B2's kernel where vitx runs its q-chunked backward (B6): ViT-B/16
    at 512² (T 1025: a last tile of one query and one key), T 2048 (32
    tiles) and a ragged T with D 16."""
    q, k, v = (seeded(dims, s, 1.5, dtype=dtype, device=cuda)
               for s in (11, 12, 13))
    do = seeded(dims, 14, 0.1, dtype=dtype, device=cuda)
    n = attention_bwd.launches
    out = attention_bwd(q, k, v, do, *fwd_residuals(q, k, v))
    torch.cuda.synchronize()
    assert attention_bwd.launches == n + 1
    for o, r in zip(out, attention_bwd_plain(q, k, v, do)):
        assert bool(torch.isfinite(o).all())
        assert rel_err(o, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 197, 768), (394, 100), (1, 3072),
                                   (3, 5, 64), (7, 36)])
def test_fused_layer_norm_matches_plain(cuda, shape, dtype):
    """B10 in both variants against its plain version, at a block's
    shape, a width off the 16-byte vectors (100, 36), one row of the
    head's 3072 and tiny's 64: the sum equal bit for bit, two calls
    likewise."""
    E = shape[-1]
    x = seeded(shape, 15, 3.0, 0.5, dtype=dtype, device=cuda)
    r = seeded(shape, 16, 1.0, dtype=dtype, device=cuda)
    sc = seeded((E,), 17, 0.1, 1.0, device=cuda)
    bi = seeded((E,), 18, 0.1, device=cuda)
    n, na = fused_layer_norm.launches, fused_add_layer_norm.launches
    y = fused_layer_norm(x, sc, bi)
    s, ya = fused_add_layer_norm(x, r, sc, bi)
    torch.cuda.synchronize()
    assert fused_layer_norm.launches == n + 1
    assert fused_add_layer_norm.launches == na + 1
    assert y.dtype == ya.dtype == s.dtype == x.dtype
    assert rel_err(y, layer_norm_fwd_plain(x, sc, bi)) <= TOL[dtype]
    ref_s, ref_y = layer_norm_fwd_plain(x, sc, bi, r)
    assert torch.equal(s, ref_s) and torch.equal(s, x + r)
    assert rel_err(ya, ref_y) <= TOL[dtype]
    assert torch.equal(fused_layer_norm(x, sc, bi), y)
    assert torch.equal(fused_add_layer_norm(x, r, sc, bi)[1], ya)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 197, 768), (3, 5, 100)])
def test_fused_layer_norm_backward_matches_plain(cuda, shape, dtype):
    """B11 through B3's kernel: the entries' gradients on the card against
    ``ln_bwd_plain`` on the 2-D view, the add variant's sum cotangent
    added to dx for both x and r."""
    E = shape[-1]
    x = seeded(shape, 19, 2.0, 0.5, dtype=dtype, device=cuda)
    r = seeded(shape, 20, 1.0, dtype=dtype, device=cuda)
    dy = seeded(shape, 21, 0.1, dtype=dtype, device=cuda)
    ds = seeded(shape, 22, 0.1, dtype=dtype, device=cuda)
    sc = seeded((E,), 23, 0.1, 1.0, device=cuda)
    bi = seeded((E,), 24, 0.1, device=cuda)
    ts = [t.detach().requires_grad_() for t in (x, sc, bi)]
    n = ln_bwd.launches
    grads = torch.autograd.grad(fused_layer_norm(*ts), ts, dy)
    torch.cuda.synchronize()
    assert ln_bwd.launches == n + 1
    dx, dsc, dbi = ln_bwd_plain(x.reshape(-1, E), sc, dy.reshape(-1, E))
    for g, ref in zip(grads, (dx.reshape(shape), dsc, dbi)):
        assert rel_err(g, ref) <= TOL[dtype]
    ta = [t.detach().requires_grad_() for t in (x, r, sc, bi)]
    s, y = fused_add_layer_norm(*ta)
    grads = torch.autograd.grad((s, y), ta, (ds, dy))
    dx, dsc, dbi = ln_bwd_plain(s.detach().reshape(-1, E), sc,
                                dy.reshape(-1, E))
    dx = dx.reshape(shape) + ds
    assert torch.equal(grads[0], grads[1])
    for g, ref in zip(grads[1:], (dx, dsc, dbi)):
        assert rel_err(g, ref) <= TOL[dtype]


@pytest.mark.cuda
def test_finetune_step_on_card_matches_cpu(cuda, tmp_path):
    """Fine-tuning ViT-B/16 at 512² (T 1025) at depth 2, fp32, batch 1,
    from a 224² export whose positional grid is resized: one step on the
    card against the CPU's, and the launches per step (K1 and B2's kernel
    once a block, B3 for both LayerNorms of a block and the head's)."""
    src = vitx_torch.get_config("base16", depth=2, compute_dtype="float32")
    cfg = src.replace(image_size=512)
    host = vitx_torch.init_params(0, src, device="cpu")
    leaves = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                leaves[prefix + k] = v.numpy()

    walk(host, "")
    path = tmp_path / "base16_224.npz"
    np.savez(path, **leaves)
    with pytest.warns(UserWarning, match="resized from 197 to 1025"):
        on_card = vitx_torch.params_from_jax(path, cfg, device=cuda)
    with pytest.warns(UserWarning, match="resized from 197 to 1025"):
        on_host = vitx_torch.params_from_jax(path, cfg, device="cpu")
    assert torch.equal(on_card["pos_embed"].cpu(), on_host["pos_embed"])
    opt = tstep.make_optimizer(lr=1e-4)
    rng = np.random.default_rng(1)
    batch = {"image": rng.standard_normal((1, 512, 512, 3)).astype(
        np.float32), "label": np.array([7], np.int32)}
    fns = (fused_mha_block, attention_bwd, ln_bwd, fused_mlp_block)
    before = [f.launches for f in fns]
    _, m_card = tstep.train_step(
        tstep.TrainState(0, on_card, opt.init(on_card)), batch, cfg=cfg,
        optimizer=opt)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [2, 2, 5, 0]
    _, m_host = tstep.train_step(
        tstep.TrainState(0, on_host, opt.init(on_host)), batch, cfg=cfg,
        optimizer=opt, device="cpu")
    for k in ("loss", "grad_norm"):
        assert rel_err(m_card[k], m_host[k]) <= 1e-4, k


# --- K1, K2, B7 and B8 on the sm90 GEMM (csrc/gemm_sm90.cuh), K1's
# attention on B5's sm90 body (csrc/attention_fwd_sm90.cuh) ----------------

# base16 at batch 8 and at a ragged M (3 x 197 rows), tiny's widths (QKV N
# 192, the MLP's 256), large16_384's (E 1024, M 4096), an odd head width
# on the sm90 GEMM (E 72, D 9: the QKV scatter's scalar stores) and the
# small16 recipe's (E 384, 6 heads, M 1536: QKV N 1152 and the
# out-projection's and W2's N 384, ragged against 256-wide tiles) at its
# train batch and a ragged M
BLOCK_SM90_DIMS = [(8, 197, 768, 12), (3, 197, 768, 12), (2, 65, 64, 4),
                   (2, 577, 1024, 16), (1, 40, 72, 8), (128, 197, 384, 6),
                   (3, 197, 384, 6)]
# the attention's row statistics against attention_stats_plain on the
# kernel's own q and k: the same bf16 values in fp32, summed in another
# order (chip_smoke.py STATS_TOL)
STATS_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dims", BLOCK_SM90_DIMS)
def test_k1_sm90_matches_plain(cuda, dims):
    """K1 in bf16 on its sm90 route against its plain version, every stash
    output included (q, k, v, o_all and the attention's statistics, which
    the sm90 body writes at D 64); launches_sm90 counts; two calls equal
    bit for bit."""
    B, T, E, H = dims
    mha, _ = block_args(*dims, "bfloat16", cuda)
    assert tmha.mha_route(torch.bfloat16, E, H) & tmha.ROUTE_GEMM_SM90
    n, n90 = fused_mha_block.launches, fused_mha_block.launches_sm90
    got = tmha._forward(*mha, 1e-5)
    torch.cuda.synchronize()
    assert (fused_mha_block.launches, fused_mha_block.launches_sm90) == (
        n + 1, n90 + 1)
    ref = mha_block_plain(*mha, stash=True)
    for a, r in zip(got[:5], ref):
        assert a.shape == r.shape and bool(torch.isfinite(a).all())
        assert rel_err(a, r) <= TOL["bfloat16"]
    want = attention_stats_plain(got[1], got[2])   # from the kernel's q, k
    assert rel_err(got[5][0], want[0]) <= STATS_TOL
    assert rel_err(got[5][1], want[1]) <= STATS_TOL
    again = tmha._forward(*mha, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", BLOCK_SM90_DIMS)
def test_k2_sm90_matches_plain(cuda, dims):
    """K2 in bf16 on the sm90 GEMM in its three activations against its
    plain version, out and the stash hp; launches_sm90 counts; two calls
    equal bit for bit."""
    _, mlp = block_args(*dims, "bfloat16", cuda)
    for act in ("gelu", "gelu_tanh", "relu"):
        n90 = fused_mlp_block.launches_sm90
        got = fused_mlp_block(*mlp, act=act, stash=True)
        torch.cuda.synchronize()
        assert fused_mlp_block.launches_sm90 == n90 + 1
        for a, r in zip(got, mlp_block_plain(*mlp, act=act, stash=True)):
            assert a.shape == r.shape and rel_err(a, r) <= TOL["bfloat16"]
        again = fused_mlp_block(*mlp, act=act, stash=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(2, 197, 768, 12), (2, 577, 1024, 16),
                                  (3, 41, 64, 4)])
def test_b7_b8_on_the_sm90_gemm_match_plain(cuda, dims):
    """B7 and B8 in bf16: their projections on the sm90 GEMM; their
    attention at D 64 on the sm90 body (B7's with its head-mean pass, B8's
    with the key bias), at D 16 on attention_fwd.cuh."""
    B, T, E, H = dims
    mha, _ = block_args(*dims, "bfloat16", cuda)
    n7 = fused_mha_block_with_mean_probs.launches_sm90
    a7 = fused_mha_block_with_mean_probs.launches_attn_sm90
    out = fused_mha_block_with_mean_probs(*mha)
    torch.cuda.synchronize()
    assert fused_mha_block_with_mean_probs.launches_sm90 == n7 + 1
    assert fused_mha_block_with_mean_probs.launches_attn_sm90 == a7 + (
        E // H == 64)
    for a, r in zip(out, mha_block_mean_probs_plain(*mha)):
        assert rel_err(a, r) <= TOL["bfloat16"]
    bqkv = seeded((3, H, E // H), 41, 0.1, device=cuda)
    log_size = seeded((B, T), 42, 0.5, 1.0, device=cuda)
    args = (mha[0], mha[1], bqkv, *mha[2:], log_size)
    n8 = fused_mha_block_tome.launches_sm90
    a8 = fused_mha_block_tome.launches_attn_sm90
    out = fused_mha_block_tome(*args)
    torch.cuda.synchronize()
    assert fused_mha_block_tome.launches_sm90 == n8 + 1
    assert fused_mha_block_tome.launches_attn_sm90 == a8 + (E // H == 64)
    for a, r in zip(out, mha_block_tome_plain(*args)):
        assert rel_err(a, r) <= TOL["bfloat16"]


@pytest.mark.cuda
def test_block_routes_are_counted_or_refused(cuda):
    """fp32 and a bf16 width TMA cannot take (E 36) run the earlier
    kernels, counted in launches and not in launches_sm90; a route the
    inputs cannot take is refused by the C entry, before any launch: the
    sm90 GEMM in fp32, K1's and B7's sm90 attention at D 16, and B7's
    without the scratch for its row statistics."""
    for dims, dtype in (((2, 50, 768, 12), "float32"),
                        ((2, 50, 36, 4), "bfloat16")):
        mha, mlp = block_args(*dims, dtype, cuda)
        counts = [(f.launches, f.launches_sm90)
                  for f in (fused_mha_block, fused_mlp_block)]
        fused_mha_block(*mha)
        fused_mlp_block(*mlp)
        torch.cuda.synchronize()
        assert [(f.launches, f.launches_sm90) for f in (
            fused_mha_block, fused_mlp_block)] == [(a + 1, b)
                                                   for a, b in counts]
    def stats(H):   # K1's statistics output
        return (torch.empty((2, 2, H, 50), device=cuda),)

    mha, mlp = block_args(2, 50, 768, 12, "float32", cuda)
    with pytest.raises(RuntimeError, match="refused the route"):
        tmha._launch(*mha, 1e-5, extra=stats(12),
                     route=tmha.ROUTE_GEMM_SM90)
    with pytest.raises(RuntimeError, match="refused the route"):
        tmlp._launch(*mlp, "gelu", 1e-5, False, route=tmlp.ROUTE_SM90)
    mha, _ = block_args(2, 50, 64, 4, "bfloat16", cuda)
    with pytest.raises(RuntimeError, match="refused the route"):
        tmha._launch(*mha, 1e-5, extra=stats(4), route=tmha.ROUTE_ATTN_SM90)
    probs = torch.empty((2, 50, 50), device=cuda)
    with pytest.raises(RuntimeError, match="refused the route"):
        tmha._launch(*mha, 1e-5, "mha_block_mean_probs",
                     (probs, stats(4)[0]), route=tmha.ROUTE_ATTN_SM90)
    mha, _ = block_args(2, 50, 768, 12, "bfloat16", cuda)
    with pytest.raises(RuntimeError, match="refused the route"):
        tmha._launch(*mha, 1e-5, "mha_block_mean_probs", (probs, None),
                     route=tmha.ROUTE_GEMM_SM90 | tmha.ROUTE_ATTN_SM90)


tflash = importlib.import_module("vitx_torch.kernels.flash_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(2, 16, 577, 64), (2, 12, 197, 64),
                                  (1, 16, 1100, 64), (2, 4, 65, 64),
                                  (3, 2, 1, 64)])
def test_flash_attention_probs_sm90_match_plain(cuda, dims):
    """B5's two probability modes on their sm90 route (bf16, D 64): o and
    the probabilities against the plain version, rows summing to 1,
    launches_sm90 one a call, two calls equal bit for bit, o bit-equal to
    flash_attention's sm90 o, the full mode's head mean (head order, / H)
    within 1e-6 of the mean mode's; the earlier kernel on the same
    inputs."""
    q, k, v = (seeded(dims, s, 1.5, dtype="bfloat16", device=cuda)
               for s in (41, 42, 43))
    o90 = flash_attention(q, k, v)
    got = {}
    for fn, mode in ((flash_attention_with_probs, "full"),
                     (flash_attention_with_mean_probs, "mean")):
        n, n90 = fn.launches, fn.launches_sm90
        out = fn(q, k, v)
        torch.cuda.synchronize()
        assert (fn.launches, fn.launches_sm90) == (n + 1, n90 + 1)
        ref = flash_attention_fwd_plain(q, k, v, mode)
        assert rel_err(out[0], ref[0]) <= TOL["bfloat16"]
        assert rel_err(out[1], ref[1]) <= PROBS_BF16_TOL
        rows = out[1].double().sum(-1)
        assert float((rows - 1).abs().max()) <= 1e-5
        again = fn(q, k, v)
        assert torch.equal(again[0], out[0]) and torch.equal(again[1], out[1])
        assert torch.equal(out[0], o90)
        was = tflash._launch_probs(q, k, v, mode, route=0)
        assert was[2] == 0
        assert rel_err(was[0], ref[0]) <= TOL["bfloat16"]
        assert rel_err(was[1], ref[1]) <= PROBS_BF16_TOL
        got[mode] = out[1]
    acc = got["full"][:, 0]
    for h in range(1, dims[1]):
        acc = acc + got["full"][:, h]
    assert rel_err(acc / dims[1], got["mean"]) <= 1e-6


@pytest.mark.cuda
def test_flash_attention_probs_off_the_sm90_route(cuda):
    """fp32, another head width and a q that is not 16-byte aligned keep
    the earlier kernel: launches count, launches_sm90 does not."""
    base = seeded((2 * 3 * 65 * 64 + 1,), 44, 1.5, dtype="bfloat16",
                  device=cuda)
    for q in (seeded((2, 3, 65, 64), 45, 1.5, device=cuda),
              seeded((2, 3, 65, 32), 46, 1.5, dtype="bfloat16", device=cuda),
              base[1:].view(2, 3, 65, 64)):
        for fn, mode in ((flash_attention_with_probs, "full"),
                         (flash_attention_with_mean_probs, "mean")):
            n, n90 = fn.launches, fn.launches_sm90
            out = fn(q, q, q)
            torch.cuda.synchronize()
            assert (fn.launches, fn.launches_sm90) == (n + 1, n90)
            ref = flash_attention_fwd_plain(q, q, q, mode)
            tol = TOL["float32"] if q.dtype == torch.float32 else \
                PROBS_BF16_TOL
            assert rel_err(out[1], ref[1]) <= tol


@pytest.mark.cuda
def test_rollout_with_qkv_bias_runs_b5_mean_on_sm90(cuda):
    """forward_with_rollout at large16_384 with QKV biases, bf16, depth 2:
    the composed block in both, B5's head mean on its sm90 route and K2;
    the rollout weights against the kernel-free route on the card."""
    cfg = vitx_torch.get_config("large16_384", depth=2, qkv_bias=True)
    params = vitx_torch.init_params(0, cfg, device=cuda)
    params["blocks"]["bqkv"] = seeded(params["blocks"]["bqkv"].shape, 47,
                                      0.1, device=cuda)
    x = np.random.default_rng(2).standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    fns = (flash_attention_with_mean_probs, fused_mlp_block,
           fused_mha_block_with_mean_probs)
    before = [(f.launches, f.launches_sm90) for f in fns]
    logits, weights = vitx_torch.forward_with_rollout(params, x, cfg)
    torch.cuda.synchronize()
    assert [(f.launches - a, f.launches_sm90 - b)
            for f, (a, b) in zip(fns, before)] == [(2, 2), (2, 2), (0, 0)]
    ref_cfg = cfg.replace(attn_impl="reference", fuse_mha="off",
                          fuse_mlp="off")
    ref_logits, ref_w = vitx_torch.forward_with_rollout(params, x, ref_cfg)
    assert rel_err(logits, ref_logits) < 0.05
    assert rel_err(weights, ref_w) < 0.05
    assert float((weights.double().sum(-1) - 1).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 197, 768), (1025, 1024), (3, 3072),
                                   (2, 9, 4096)])
def test_fused_layer_norm_onepass_matches_plain(cuda, shape, dtype):
    """B10's one-pass route at the models' widths, the reference head's
    3072 and the widest it takes: counted in launches_onepass, against the
    plain version, the sum equal to x + r, two calls equal bit for bit; the
    earlier kernel on the same inputs."""
    E = shape[-1]
    x = seeded(shape, 48, 3.0, 0.5, dtype=dtype, device=cuda)
    r = seeded(shape, 49, 1.0, dtype=dtype, device=cuda)
    sc = seeded((E,), 50, 0.1, 1.0, device=cuda)
    bi = seeded((E,), 51, 0.1, device=cuda)
    n = (fused_layer_norm.launches_onepass,
         fused_add_layer_norm.launches_onepass)
    y = fused_layer_norm(x, sc, bi)
    s, ya = fused_add_layer_norm(x, r, sc, bi)
    torch.cuda.synchronize()
    assert (fused_layer_norm.launches_onepass,
            fused_add_layer_norm.launches_onepass) == (n[0] + 1, n[1] + 1)
    assert rel_err(y, layer_norm_fwd_plain(x, sc, bi)) <= TOL[dtype]
    ref_s, ref_y = layer_norm_fwd_plain(x, sc, bi, r)
    assert torch.equal(s, ref_s) and torch.equal(s, x + r)
    assert rel_err(ya, ref_y) <= TOL[dtype]
    assert torch.equal(fused_layer_norm(x, sc, bi), y)
    assert torch.equal(fused_add_layer_norm(x, r, sc, bi)[1], ya)
    was_y = tln._launch_fwd(x, None, sc, bi, 1e-5, route=0)[0]
    assert rel_err(was_y, layer_norm_fwd_plain(x, sc, bi)) <= TOL[dtype]


@pytest.mark.cuda
def test_fused_layer_norm_routes_are_counted_or_refused(cuda):
    """A width off the 16-byte vector keeps the earlier kernel (not
    counted in launches_onepass); the C entry refuses the one-pass route
    for it before any launch."""
    x = seeded((3, 100), 52, dtype="bfloat16", device=cuda)
    sc, bi = torch.ones(100, device=cuda), torch.zeros(100, device=cuda)
    n, n1 = fused_layer_norm.launches, fused_layer_norm.launches_onepass
    fused_layer_norm(x, sc, bi)
    torch.cuda.synchronize()
    assert (fused_layer_norm.launches, fused_layer_norm.launches_onepass) \
        == (n + 1, n1)
    with pytest.raises(RuntimeError, match="refused the route"):
        tln._launch_fwd(x, None, sc, bi, 1e-5, route=tln.LN_ROUTE_ONEPASS)


def unaligned(shape, seed, dtype, device, scale=1.0):
    """A contiguous seeded tensor whose data starts one element past a
    16-byte boundary (a view into a larger buffer)."""
    n = int(np.prod(shape))
    buf = seeded((n + 1,), seed, scale, dtype=dtype, device=device)
    t = buf[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.cuda
def test_kernels_take_inputs_off_a_16_byte_boundary(cuda):
    """Fault C4 (ROADMAP): contiguous inputs whose data does not start on
    a 16-byte boundary reached kernels that read rows in 16-byte vectors
    from the base pointer (the earlier attention kernels, the earlier
    GEMM of K1 and K2) and faulted with a misaligned address; vitx takes
    any array. Each wrapper against its plain version on such views."""
    for dtype, D in (("float32", 64), ("bfloat16", 64), ("bfloat16", 32)):
        q, k, v = (unaligned((2, 3, 65, D), 53 + i, dtype, cuda, 1.5)
                   for i in range(3))
        do = unaligned((2, 3, 65, D), 56, dtype, cuda, 0.1)
        tol = TOL[dtype]
        assert rel_err(flash_attention(q, k, v),
                       flash_attention_fwd_plain(q, k, v)) <= tol
        for fn, mode in ((flash_attention_with_probs, "full"),
                         (flash_attention_with_mean_probs, "mean")):
            out, ref = fn(q, k, v), flash_attention_fwd_plain(q, k, v, mode)
            assert rel_err(out[0], ref[0]) <= tol
            assert rel_err(out[1], ref[1]) <= (
                PROBS_BF16_TOL if dtype == "bfloat16" else tol)
        res = flash_attention_fwd_plain(q, k, v), attention_stats_plain(q, k)
        for a, r in zip(attention_bwd(q, k, v, do, *res),
                        attention_bwd_plain(q, k, v, do)):
            assert rel_err(a, r) <= tol
        torch.cuda.synchronize()
    for dtype in ("float32", "bfloat16"):
        mha, mlp = block_args(2, 50, 768, 12, dtype, cuda)
        x = unaligned(tuple(mha[0].shape), 57, dtype, cuda)
        assert rel_err(fused_mha_block(x, *mha[1:]),
                       mha_block_plain(x, *mha[1:])) <= TOL[dtype]
        assert rel_err(fused_mlp_block(x, *mlp[1:], act="gelu"),
                       mlp_block_plain(x, *mlp[1:], act="gelu")) <= TOL[dtype]
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_sm90_kernels_launch_from_a_fresh_thread(cuda):
    """Fault C5 (ROADMAP): the sm90 kernels encode their TMA maps with a
    driver call that needs a current context, which a thread has only
    after its first runtime call that makes one (autograd's backward
    thread had none when its first work was B2's sm90 kernel and its
    buffers came from the caching allocator). B5, B2, K1 and K2 on the
    sm90 route from a new thread, after the same calls on this one, equal
    to them bit for bit."""
    dims = (2, 4, 197, 64)
    q, k, v = (seeded(dims, s, 1.5, dtype="bfloat16", device=cuda)
               for s in (61, 62, 63))
    do = seeded(dims, 64, 0.1, dtype="bfloat16", device=cuda)
    res = fwd_residuals(q, k, v)
    mha, mlp = block_args(2, 197, 768, 12, "bfloat16", cuda)

    def calls():
        return (flash_attention(q, k, v),
                *attention_bwd(q, k, v, do, *res), fused_mha_block(*mha),
                fused_mlp_block(*mlp, act="gelu"))

    calls()
    torch.cuda.synchronize()   # the caching allocator keeps these blocks
    got, errors = [], []

    def worker():
        try:
            got.extend(calls())
            torch.cuda.synchronize()
        except Exception as e:   # raised in the thread, asserted below
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert not errors, errors
    want = calls()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --- the training driver on the card (procedural data, the device cache,
# RandAugment, the EMA, .ckpt) ---------------------------------------------

@pytest.mark.cuda
def test_device_loader_on_card_matches_cpu(cuda):
    """DeviceBatchLoader on the card: the batches of the CPU loader, bit
    for bit, the ragged tail's padding zeroed."""
    from vitx_torch.data import DeviceBatchLoader, ProceduralShapes

    ds = ProceduralShapes(num_examples=10, image_size=32, seed=1)
    card = DeviceBatchLoader(ds, 4, shuffle=True, seed=2, device=cuda)
    host = DeviceBatchLoader(ds, 4, shuffle=True, seed=2, device="cpu")
    for epoch in (0, 1):
        card.set_epoch(epoch)
        host.set_epoch(epoch)
        for a, b in zip(card, host):
            assert a["image"].is_cuda
            for k in ("image", "label", "mask"):
                assert torch.equal(a[k].cpu(), b[k]), k


@pytest.mark.cuda
def test_recipe_epoch_on_card(cuda, tmp_path):
    """One epoch of the recipe's Trainer (small16 widths at depth 2, bf16,
    RandAugment, EMA, wd_exclude, cosine) on the card: finite losses, K1,
    B2 and B3 a step on their sm90 and one-pass routes, a .ckpt whose EMA
    the eval path restores."""
    from vitx_torch.data import DeviceBatchLoader, ProceduralShapes, \
        make_preprocess
    from vitx_torch.train import checkpoint as tckpt
    from vitx_torch.train.loop import Trainer, TrainerConfig

    cfg = vitx_torch.get_config("small16", depth=2, num_classes=10)
    train = DeviceBatchLoader(ProceduralShapes(num_examples=64, seed=0),
                              32, shuffle=True, device=cuda)
    val = DeviceBatchLoader(ProceduralShapes(num_examples=32, seed=1), 32,
                            device=cuda)
    sched = tstep.warmup_cosine(3e-4, 2, 1)
    opt = tstep.make_optimizer(lr=3e-4, schedule=sched, weight_decay=0.05,
                               ema_decay=0.999, wd_exclude=True)
    tcfg = TrainerConfig(epochs=1, lr=3e-4, weight_decay=0.05,
                         wd_exclude=True, ema_decay=0.999, log_every=1,
                         checkpoint_dir=str(tmp_path))
    pre = make_preprocess(out_size=224, mean=(0.5,) * 3, std=(0.5,) * 3,
                          randaug_layers=2, randaug_magnitude=5.0)
    tr = Trainer(cfg, tcfg, preprocess=pre, optimizer=opt,
                 lr_schedule=sched)
    fns = (fused_mha_block, attention_bwd, ln_bwd, fused_mlp_block)
    before = [(f.launches, getattr(f, "launches_sm90",
                                   getattr(f, "launches_onepass", 0)))
              for f in fns]
    hist = tr.fit(train, val)
    torch.cuda.synchronize()
    got = [(f.launches - a, getattr(f, "launches_sm90",
                                    getattr(f, "launches_onepass", 0)) - b)
           for f, (a, b) in zip(fns, before)]
    # 2 steps of 2 blocks; one eval batch: K1 and K2 in both blocks
    assert got == [(6, 6), (4, 4), (10, 10), (2, 2)]
    assert np.isfinite(hist[0]["loss"]) and hist[0]["val_accuracy"] >= 0
    params, meta = tckpt.restore_eval_params(tmp_path, cfg)
    assert meta["ema_decay"] == 0.999 and meta["schedule"]
    for a, b in zip(tstep.leaves(params), tstep.leaves(tr.eval_params())):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tome", "pdrop"])
def test_recipe_variant_epoch_on_card(cuda, tmp_path, variant):
    """One epoch of the recipe's two variants (small16 widths at depth 2,
    bf16): ToMe-train at (35, 34) runs B8 a block under grad (kernel
    forward, composed backward with B3), no K1 or B2, and merges in the
    eval (B8 and K2); patch drop runs K1 and B2 at T 99 and every token
    in the eval. Finite losses."""
    from vitx_torch.data import DeviceBatchLoader, ProceduralShapes, \
        make_preprocess
    from vitx_torch.nn.tome import aligned_schedule
    from vitx_torch.train.loop import Trainer, TrainerConfig

    cfg = vitx_torch.get_config("small16", depth=2, num_classes=10)
    cfg = (cfg.replace(tome_r=aligned_schedule(cfg, 128), tome_train=True)
           if variant == "tome" else cfg.replace(patch_drop=0.5))
    train = DeviceBatchLoader(ProceduralShapes(num_examples=64, seed=0),
                              32, shuffle=True, device=cuda)
    val = DeviceBatchLoader(ProceduralShapes(num_examples=32, seed=1), 32,
                            device=cuda)
    opt = tstep.make_optimizer(lr=3e-4, weight_decay=0.05, ema_decay=0.999,
                               wd_exclude=True)
    tcfg = TrainerConfig(epochs=1, lr=3e-4, weight_decay=0.05,
                         wd_exclude=True, ema_decay=0.999, log_every=1,
                         checkpoint_dir=str(tmp_path))
    pre = make_preprocess(out_size=224, mean=(0.5,) * 3, std=(0.5,) * 3)
    tr = Trainer(cfg, tcfg, preprocess=pre, optimizer=opt)
    fns = (fused_mha_block_tome, fused_mha_block, attention_bwd, ln_bwd,
           fused_mlp_block)
    attr = ("launches_sm90", "launches_sm90", "launches_sm90",
            "launches_onepass", "launches_sm90")

    def now():
        return [(f.launches, getattr(f, a)) for f, a in zip(fns, attr)]

    before = now()
    hist = tr.fit(train, val)
    torch.cuda.synchronize()
    got = [(a - c, b - d) for (a, b), (c, d) in zip(now(), before)]
    # 2 steps of 2 blocks (B3: both LayerNorms a block and the head's);
    # one eval batch
    want = {"tome": [(6, 6), (0, 0), (0, 0), (10, 10), (2, 2)],
            "pdrop": [(0, 0), (6, 6), (4, 4), (10, 10), (2, 2)]}[variant]
    assert got == want
    assert np.isfinite(hist[0]["loss"]) and hist[0]["val_accuracy"] >= 0


@pytest.mark.cuda
def test_tome_backward_from_autograds_thread(cuda):
    """B8's backward recomputes ``composed_tome`` on autograd's device
    thread, where its LayerNorm's B3 may be that thread's first work
    (fault C5's setting): the gradients equal those of composed_tome's own
    autograd on the same bf16 inputs, bit for bit."""
    from vitx_torch.kernels import composed_tome

    mha, _ = block_args(4, 162, 384, 6, "bfloat16", cuda)
    x, wqkv, wo, bo, g, b = mha
    bqkv = torch.zeros(3, 6, 64, device=cuda)
    log_size = torch.log(1.0 + 3.0 * torch.rand(4, 162, device=cuda))
    w_out = seeded((4, 162, 384), 71, 0.1, dtype="bfloat16", device=cuda)
    grads = []
    for fn in (fused_mha_block_tome, composed_tome):
        ins = [t.detach().clone().requires_grad_() for t in (x, wqkv, wo)]
        out, _ = fn(ins[0], ins[1], bqkv, ins[2], bo, g, b, log_size)
        (out.float() * w_out.float()).sum().backward()
        grads.append([t.grad for t in ins])
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*grads))


def _op_cases(cuda):
    """(wrapper's counter, op call, the wrapper's eager call) per op of
    ``vitx_torch/kernels/ops.py``, at base16's block widths in bf16."""
    bf = torch.bfloat16
    rng = np.random.default_rng(40)

    def t(shape, scale=1.0, dt=bf, shift=0.0):
        a = shift + scale * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(cuda, dt)

    B, T, E, H, M = 4, 197, 768, 12, 3072
    x = t((B, T, E))
    mha = (t((E, 3, H, E // H), 0.03), t((E, E), 0.03),
           t((E,), 0.1, torch.float32), t((E,), 0.1, torch.float32, 1.0),
           t((E,), 0.1, torch.float32))
    mlp = (t((E, M), 0.03), t((M,), 0.1, torch.float32), t((M, E), 0.03),
           t((E,), 0.1, torch.float32), t((E,), 0.1, torch.float32, 1.0),
           t((E,), 0.1, torch.float32))
    bqkv = t((3, H, E // H), 0.1, torch.float32)
    log_size = t((B, T), 0.5, torch.float32).abs()
    q, k, v = (t((B, H, T, E // H)) for _ in range(3))
    ops = torch.ops.vitx_torch
    return {
        "mha_block": (fused_mha_block, lambda: ops.mha_block(x, *mha, 1e-6),
                      lambda: fused_mha_block(x, *mha, eps=1e-6)),
        "mlp_block": (fused_mlp_block,
                      lambda: ops.mlp_block(x, *mlp, "gelu_tanh", 1e-6),
                      lambda: fused_mlp_block(x, *mlp, act="gelu_tanh",
                                              eps=1e-6)),
        "mha_block_tome": (
            fused_mha_block_tome,
            lambda: ops.mha_block_tome(x, mha[0], bqkv, *mha[1:], log_size,
                                       1e-6),
            lambda: fused_mha_block_tome(x, mha[0], bqkv, *mha[1:], log_size,
                                         eps=1e-6)),
        "attention_fwd": (flash_attention, lambda: ops.attention_fwd(q, k, v),
                          lambda: flash_attention(q, k, v)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mha_block", "mlp_block", "mha_block_tome",
                                  "attention_fwd"])
def test_kernel_op_is_its_wrappers_launch(cuda, name):
    """Each ``vitx_torch::`` op on CUDA tensors launches its kernel once,
    counted as the wrapper counts it, and returns the wrapper's output bit
    for bit, in fresh tensors."""
    counter, op, eager = _op_cases(cuda)[name]
    n = counter.launches
    got = op()
    torch.cuda.synchronize()
    assert counter.launches == n + 1
    want = eager()
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_exported_program_runs_the_kernels(cuda, tmp_path):
    """A depth-2 base16 program exported on the card, saved and loaded:
    K1 and K2 twice a call (on the sm90 GEMM), logits within 2e-2 of the
    eager forward at batches 1 and 3."""
    from vitx_torch.export import load_exported, save_exported

    cfg = vitx_torch.get_config("base16", depth=2)
    params = vitx_torch.init_params(0, cfg)
    save_exported(tmp_path / "m.pt2", params, cfg)
    module = load_exported(tmp_path / "m.pt2").module()
    for b in (1, 3):
        x = torch.randn(b, 224, 224, 3, device=cuda).to(torch.bfloat16)
        k1, k2 = fused_mha_block.launches_sm90, fused_mlp_block.launches_sm90
        out = module(x)
        torch.cuda.synchronize()
        assert (fused_mha_block.launches_sm90 - k1,
                fused_mlp_block.launches_sm90 - k2) == (2, 2)
        assert rel_err(out, vitx_torch.forward(params, x, cfg)) < 2e-2


# --- vitx's other model families ------------------------------------------

FAMILIES = {
    "conv_stem": {"stem": "conv"},
    "registers": {"num_registers": 4},
    "map_head": {"head_type": "map"},
    "sincos2d": {"pos_embed": "sincos2d"},
    "rope": {"pos_embed": "rope"},
    "soft_moe": {"moe_experts": 2, "moe_blocks": 1},
    "registers_map_sincos2d": {"num_registers": 4, "head_type": "map",
                               "pos_embed": "sincos2d"},
}


def _nudged(params, seed):
    g = torch.Generator().manual_seed(seed)
    return tstep.tree_map(
        lambda t: t + 0.02 * torch.randn(t.shape, generator=g), params)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_card_vs_cpu(cuda, family):
    """Each family at small16's widths, depth 2, fp32: the logits and the
    gradients of one batch's loss on the card (its kernels) against the
    CPU's plain versions, 1e-4 of each leaf's largest."""
    cfg = vitx_torch.get_config("small16", depth=2, num_classes=10,
                                compute_dtype="float32", **FAMILIES[family])
    host = _nudged(vitx_torch.init_params(0, cfg, device="cpu"), 1)
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.standard_normal(
        (2, 224, 224, 3)).astype(np.float32)),
             "label": torch.tensor([1, 7])}
    out = {}
    for dev in ("cpu", cuda):
        p = tstep.tree_map(lambda t: t.detach().to(dev).requires_grad_(),
                           host)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, logits = tstep.loss_fn(p, b, cfg)
        out[str(dev)] = [logits.detach(),
                         *torch.autograd.grad(loss, tstep.leaves(p))]
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        assert rel_err(a, b) <= 1e-4, i


@pytest.mark.cuda
def test_bench10_forward_on_the_kernels(cuda):
    """bench 10's Soft-MoE ViT-B in bf16 at batch 2: K1 in all 12 blocks
    and K2 in the 6 dense ones, on their sm90 routes; logits within 0.05
    of the CPU's plain forward."""
    cfg = vitx_torch.get_config("base16", moe_experts=8, moe_blocks=6)
    host = _nudged(vitx_torch.init_params(0, cfg, device="cpu"), 3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 224, 224, 3)).astype(np.float32))
    card = params_to(host, cuda)
    before = [(f.launches, f.launches_sm90)
              for f in (fused_mha_block, fused_mlp_block)]
    logits = vitx_torch.forward(card, x, cfg, device=cuda)
    torch.cuda.synchronize()
    got = [(f.launches - a, f.launches_sm90 - b) for f, (a, b) in
           zip((fused_mha_block, fused_mlp_block), before)]
    assert got == [(12, 12), (6, 6)]
    want = vitx_torch.forward(host, x, cfg, device="cpu")
    assert rel_err(logits, want) <= 0.05


@pytest.mark.cuda
def test_block_kernels_at_registers_t201(cuda):
    """K1 with its stash and K2 at base16's widths with 4 registers (T
    201), bf16 on the sm90 route, against their plain versions."""
    mha, mlp = block_args(4, 201, 768, 12, "bfloat16", cuda)
    n = fused_mha_block.launches_sm90
    out = fused_mha_block(*mha, eps=1e-6)
    assert fused_mha_block.launches_sm90 == n + 1
    assert rel_err(out, mha_block_plain(*mha, eps=1e-6)) <= TOL["bfloat16"]
    out = fused_mlp_block(*mlp, act="gelu_tanh", eps=1e-6)
    assert rel_err(out, mlp_block_plain(*mlp, act="gelu_tanh", eps=1e-6)) \
        <= TOL["bfloat16"]


@pytest.mark.cuda
def test_rope_step_runs_b5_and_b2(cuda):
    """A RoPE model's train step (base16 widths, depth 2, bf16, b4): its
    attention takes the composed path, B5 forward and B2 backward, both
    on their sm90 routes; no K1."""
    cfg = vitx_torch.get_config("base16", depth=2, pos_embed="rope")
    opt = tstep.make_optimizer(lr=1e-4)
    state = tstep.create_train_state(0, cfg, opt, device=cuda)
    batch = {"image": torch.randn((4, 224, 224, 3), device=cuda),
             "label": torch.arange(4, device=cuda)}
    fns = (flash_attention, attention_bwd, fused_mha_block)
    before = [(f.launches, getattr(f, "launches_sm90", 0)) for f in fns]
    _, m = tstep.train_step(state, batch, cfg=cfg, optimizer=opt,
                            device=cuda)
    torch.cuda.synchronize()
    got = [(f.launches - a, getattr(f, "launches_sm90", 0) - b)
           for f, (a, b) in zip(fns, before)]
    assert got == [(2, 2), (2, 2), (0, 0)]
    assert np.isfinite(float(m["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("remat,k1_per_block", [
    ("none", 1), ("block", 2), ("dots", 2), ("save_stash", 1)])
def test_remat_on_card(cuda, remat, k1_per_block):
    """Each remat policy on the card (tiny, fp32, dropout and drop-path
    0.1 from a card generator): K1 runs once a block, twice where the
    policy recomputes it; loss and gradients within 1e-6 of "none"'s;
    the generator's stream where "none" leaves it."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32", dropout=0.1,
                                drop_path=0.1)
    params = vitx_torch.init_params(0, cfg, device=cuda)
    b = {"image": torch.randn((4, 64, 64, 3), device=cuda),
         "label": torch.arange(4, device=cuda)}
    out = []
    for mode in ("none", remat):
        req = tstep.tree_map(lambda t: t.detach().requires_grad_(), params)
        gen = torch.Generator(device=cuda).manual_seed(3)
        n = fused_mha_block.launches
        loss = tstep.loss_fn(req, b, cfg.replace(remat=mode), gen)[0]
        grads = torch.autograd.grad(loss, tstep.leaves(req))
        torch.cuda.synchronize()
        out.append((loss, grads, gen.get_state(),
                    fused_mha_block.launches - n))
    (l0, g0, s0, _), (l1, g1, s1, k1) = out
    assert k1 == k1_per_block * cfg.depth
    assert rel_err(l1, l0) <= 1e-6
    assert all(rel_err(a, c) <= 1e-6 for a, c in zip(g1, g0))
    assert torch.equal(s1, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer,mu_dtype", [
    ("sgd", None), ("lion", None), ("adafactor", None),
    ("adamw", "bfloat16")])
def test_optimizer_on_card_replays_on_cpu(cuda, optimizer, mu_dtype):
    """Three tiny fp32 steps of each optimizer on the card, each from the
    CPU's state: every step's params equal the CPU's update of the card's
    gradients from that state within 1e-4 lr and an ulp, and B12 never
    runs (vitx's rule: only plain AdamW takes it)."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32")
    opt = tstep.make_optimizer(lr=1e-3, optimizer=optimizer,
                               mu_dtype=mu_dtype, fused=True)
    host = vitx_torch.init_params(0, cfg, device="cpu")
    state = tstep.TrainState(0, host, opt.init(host))
    rng = np.random.default_rng(1)
    n12 = fused_adamw_multi_.launches
    for _ in range(3):
        batch = {"image": rng.standard_normal((4, 64, 64, 3)).astype(
            np.float32), "label": rng.integers(0, 4, 4).astype(np.int32)}
        card = tstep.TrainState(state.step, params_to(
            tstep.tree_map(torch.clone, state.params), cuda),
            state.opt_state._replace(**{
                n: tstep.tree_map(lambda t: t.to(cuda, copy=True),
                                  getattr(state.opt_state, n))
                for n in state.opt_state.SLOTS}))
        seen = {}

        class Recording:
            def update(self, grads, st, params):
                seen["g"] = [g.cpu() for g in grads]
                return opt.update(grads, st, params)

            def __getattr__(self, name):
                return getattr(opt, name)
        card, _ = tstep.train_step(card, batch, cfg=cfg,
                                   optimizer=Recording(), device=cuda)
        params, opt_state = opt.update(seen["g"], state.opt_state,
                                       state.params)
        state = tstep.TrainState(card.step, params, opt_state)
        for a, p in zip(tstep.leaves(card.params),
                        tstep.leaves(state.params)):
            ulp = torch.nextafter(p.abs(), torch.full_like(p, np.inf)) \
                - p.abs()
            assert bool(((a.cpu() - p).abs() <= 1e-7 + ulp).all())
    assert fused_adamw_multi_.launches == n12


@pytest.mark.cuda
def test_sam_on_card_doubles_the_passes(cuda):
    """A SAM step on the card (tiny bf16, fused AdamW): two forward and
    backward passes -- K1 and B2 twice a block, B3 twice its LayerNorms --
    and one B12 launch; loss and grad_norm the clean pass's."""
    cfg = vitx_torch.get_config("tiny")
    opt = tstep.make_optimizer(lr=1e-3, fused=True)
    state = tstep.create_train_state(0, cfg, opt, device=cuda)
    b = {"image": torch.randn((4, 64, 64, 3), device=cuda).to(cfg.cdtype()),
         "label": torch.arange(4, device=cuda)}
    req = tstep.tree_map(lambda t: t.detach().requires_grad_(),
                         state.params)
    plain = tstep.loss_fn(req, b, cfg)[0]
    fns = (fused_mha_block, attention_bwd, ln_bwd, fused_adamw_multi_)
    before = [f.launches for f in fns]
    _, m = tstep.train_step(state, b, cfg=cfg, optimizer=opt, device=cuda,
                            sam_rho=0.05)
    torch.cuda.synchronize()
    got = [f.launches - n for f, n in zip(fns, before)]
    assert got == [2 * cfg.depth, 2 * cfg.depth, 2 * (2 * cfg.depth + 1), 1]
    assert float(m["loss"]) == float(plain)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["block", "dots", "save_stash"])
def test_remat_on_the_composed_path(cuda, remat):
    """A QKV-bias model takes the composed path (B5 forward, B2 backward)
    and every policy recomputes it whole (vitx's names save nothing
    there): B5 twice a block, loss and gradients within 1e-6 of "none"'s
    -- B5's backward unpacks its saved tensors once, as checkpointing
    requires."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32",
                                qkv_bias=True, attn_impl="flash")
    params = vitx_torch.init_params(0, cfg, device=cuda)
    b = {"image": torch.randn((4, 64, 64, 3), device=cuda),
         "label": torch.arange(4, device=cuda)}
    out = []
    for mode in ("none", remat):
        req = tstep.tree_map(lambda t: t.detach().requires_grad_(), params)
        n = flash_attention.launches
        loss = tstep.loss_fn(req, b, cfg.replace(remat=mode))[0]
        grads = torch.autograd.grad(loss, tstep.leaves(req))
        torch.cuda.synchronize()
        out.append((loss, grads, flash_attention.launches - n))
    (l0, g0, n0), (l1, g1, n1) = out
    assert (n0, n1) == (cfg.depth, 2 * cfg.depth)
    assert rel_err(l1, l0) <= 1e-6
    assert all(rel_err(a, c) <= 1e-6 for a, c in zip(g1, g0))
