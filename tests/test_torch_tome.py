"""ToMe token merging in the port (vitx_torch.nn.tome, kernel B8) against
vitx's (vitx.nn.tome, vitx.kernels.mha_block), on the CPU.

The same inputs, made with ``numpy.random.default_rng``, go through both.
On the CPU the port's B8 wrapper runs its plain version, held here to
vitx's ``_kernel_tome`` and ``_kernel_hchunk_tome`` (B9) in Pallas
interpret mode; the head chunk of the latter is forced to 1 and 2 heads so
that its accumulation across chunks really runs. Geometry: vitx's ToMe
tests' (``tests/test_tome.py:12-13``: image 32, patch 4, E 32, depth 3, 2
heads, 64 patches), and a depth-2 ``large16_384`` copy for width.

Bars, as max |a - b| over max |b|: float32 1e-4, the repo's parity bar
(``tests/test_parity_torch.py:58``); bfloat16 logits 0.05
(``tests/test_parity_torch.py:80``); B8's bf16 outputs 2e-2 (both sides
accumulate in fp32 in another order, so a few bf16 roundings land one ulp
apart). The merge is held tighter: merged tokens within 1e-6, sizes and
sources exactly, the selection equal under ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.kernels import mha_block as jmha
from vitx.nn import tome as jtome
from vitx_torch.kernels import (composed_tome, fused_mha_block_tome,
                                mha_block_tome_plain)

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=4, num_classes=4, embed_dim=32,
            depth=3, num_heads=2, compute_dtype="float32")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# vitx's forward and ToMe encoder compiled once per config: eager dispatch
# compiles every op of every block's token count anew
VITX_FORWARD = jax.jit(vitx.forward, static_argnums=2)
VITX_ENCODE_TOME = jax.jit(jtome.encode_tome, static_argnums=(2, 3))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def f32(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


def normal(rng, shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def configs(**over):
    kw = dict(TINY, **over)
    return vitx.ViTConfig(**kw), vitx_torch.ViTConfig(**kw)


def numpy_params(cfg, seed=0):
    """The parameter tree of ``cfg`` (the port's init, the same tree as
    vitx's) with every leaf nudged by N(0, 0.02) noise, as numpy, so that
    biases and LayerNorm parameters take part."""
    rng = np.random.default_rng(seed)
    params = vitx_torch.init_params(seed, cfg, device="cpu")
    return jax.tree.map(lambda t: t.numpy() + 0.02 * rng.standard_normal(
        t.shape).astype(np.float32), params)


def images(cfg, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    return normal(rng, (batch, cfg.image_size, cfg.image_size, 3))


# --- the schedule -------------------------------------------------------------

@pytest.mark.parametrize("arg", ["13", " 35, 34 ", "23,23,22", "to128", 7])
def test_parse_tome_r_matches_vitx(arg):
    assert vitx_torch.parse_tome_r(arg) == jtome.parse_tome_r(arg)


@pytest.mark.parametrize("preset,target", [
    ("base16", 128), ("base16", 100), ("base16", 197), ("base16", 1),
    ("large16_384", 128), ("large16_384", 300), ("tiny", 33), ("tiny", 9)])
def test_aligned_schedule_matches_vitx(preset, target):
    """Equal schedules, or a ValueError from both (nothing to merge, the
    protected tokens, a cap that cannot be met)."""
    try:
        ref = jtome.aligned_schedule(vitx.get_config(preset), target)
    except ValueError:
        with pytest.raises(ValueError):
            vitx_torch.aligned_schedule(vitx_torch.get_config(preset),
                                        target)
        return
    assert vitx_torch.aligned_schedule(vitx_torch.get_config(preset),
                                       target) == ref


# --- merge_tokens -------------------------------------------------------------

def merge_inputs(kind, n_reg, seed=0):
    """(x, sizes, metric, sources) for 1 prefix + 20 patches + n_reg
    registers. "ties" makes every metric row a basis vector times a power
    of two, so each score is exactly 0 or 1 in any summation order: scores
    tie exactly, between A tokens and between the B tokens one A token may
    join, and only the tie order decides the selection."""
    B, T, E, D = 2, 21 + n_reg, 8, 4
    rng = np.random.default_rng(seed)
    x = normal(rng, (B, T, E))
    sizes = 1.0 + rng.integers(0, 4, (B, T)).astype(np.float32)
    metric = normal(rng, (B, T, D))
    if kind == "ties":
        metric = (np.eye(D, dtype=np.float32)[rng.integers(0, D, (B, T))]
                  * 2.0 ** rng.integers(-3, 4, (B, T, 1))).astype(np.float32)
    sources = (rng.random((B, T, 30)) < 0.2).astype(np.float32)
    return x, sizes, metric, sources


@pytest.mark.parametrize("with_sources", [False, True])
@pytest.mark.parametrize("n_reg", [0, 2])
@pytest.mark.parametrize("kind", ["random", "ties", "bfloat16"])
def test_merge_tokens_matches_vitx(kind, n_reg, with_sources):
    x, sizes, metric, sources = merge_inputs(kind, n_reg)
    dt = "bfloat16" if kind == "bfloat16" else "float32"
    src = (sources,) if with_sources else ()
    ref = jtome.merge_tokens(jnp.asarray(x, dt), jnp.asarray(sizes),
                             jnp.asarray(metric, dt), 4, 1, n_reg,
                             *map(jnp.asarray, src))
    out = vitx_torch.merge_tokens(
        torch.from_numpy(x).to(getattr(torch, dt)), torch.from_numpy(sizes),
        torch.from_numpy(metric).to(getattr(torch, dt)), 4, 1, n_reg,
        *map(torch.from_numpy, src))
    assert len(out) == len(ref) == 2 + with_sources
    assert out[0].shape == (2, x.shape[1] - 4, 8)
    assert out[0].dtype == getattr(torch, dt)
    err = float(np.max(np.abs(f32(out[0]) - f32(ref[0]))))
    assert err <= (1e-6 if dt == "float32" else 0.0)
    for o, r in zip(out[1:], ref[1:]):     # the selection itself
        np.testing.assert_array_equal(f32(o), f32(r))


def test_merge_tokens_constant_metric():
    """Every score ties (a constant image's tokens): the first r A tokens
    merge, each into the first B token, as ``jax.lax.top_k`` orders."""
    x, sizes, _, sources = merge_inputs("random", 0)
    metric = np.ones((2, 21, 4), np.float32)
    ref = jtome.merge_tokens(*map(jnp.asarray, (x, sizes, metric)), 5, 1, 0,
                             sources=jnp.asarray(sources))
    out = vitx_torch.merge_tokens(*map(torch.from_numpy, (x, sizes, metric)),
                                  5, 1, 0, sources=torch.from_numpy(sources))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(f32(o), f32(r), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="r=11"):
        vitx_torch.merge_tokens(*map(torch.from_numpy, (x, sizes, metric)),
                                11, 1, 0)


# --- B8: the kernel's plain version and the composed path ---------------------

def tome_inputs(B, T, E, H, seed=0):
    rng = np.random.default_rng(seed)
    D = E // H
    return [normal(rng, (B, T, E)), normal(rng, (E, 3, H, D), 0.1),
            normal(rng, (3, H, D), 0.1), normal(rng, (E, E), 0.1),
            normal(rng, (E,), 0.1), normal(rng, (E,), 0.1, 1.0),
            normal(rng, (E,), 0.1),
            np.log(1.0 + 5.0 * rng.random((B, T))).astype(np.float32)]


def as_lib(arrs, dtype, lib):
    """x, wqkv and wo in ``dtype``, the rest float32."""
    out = []
    for i, a in enumerate(arrs):
        dt = dtype if i in (0, 1, 3) else "float32"
        out.append(jnp.asarray(a, dt) if lib == "jax" else
                   torch.from_numpy(a).to(getattr(torch, dt)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 13, 32, 2), (1, 65, 64, 4)],
                         ids=["T13", "T65"])
def test_tome_plain_matches_pallas(dims, dtype):
    """``mha_block_tome_plain`` vs ``_tome_fwd`` (``_kernel_tome``,
    interpret mode): out and k_mean, with a random QKV bias and log_size."""
    arrs = tome_inputs(*dims)
    ref = jmha._tome_fwd(*as_lib(arrs, dtype, "jax"), eps=1e-5)
    out = mha_block_tome_plain(*as_lib(arrs, dtype, "torch"), eps=1e-5)
    for o, r in zip(out, ref):
        assert o.dtype == getattr(torch, dtype) and o.shape == r.shape
        assert rel_err(f32(o), f32(r)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hc", [1, 2])
def test_tome_plain_matches_chunked(monkeypatch, hc, dtype):
    """B9's function: ``mha_block_tome_plain`` vs ``_chunked_tome_fwd``
    (``_kernel_hchunk_tome``) with hc heads per chunk."""
    monkeypatch.setattr(jmha, "_chunk_plan", lambda *a, **k: (hc, 0))
    monkeypatch.setattr(jmha, "_use_interpret", lambda: True)
    arrs = tome_inputs(2, 16, 64, 4, seed=1)
    ref = jmha._chunked_tome_fwd(*as_lib(arrs, dtype, "jax"), eps=1e-5)
    out = mha_block_tome_plain(*as_lib(arrs, dtype, "torch"), eps=1e-5)
    for o, r in zip(out, ref):
        assert rel_err(f32(o), f32(r)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_composed_tome_matches_vitx(dtype):
    arrs = tome_inputs(2, 13, 32, 2, seed=2)
    ref = jmha._composed_tome(*as_lib(arrs, dtype, "jax"), eps=1e-5)
    out = composed_tome(*as_lib(arrs, dtype, "torch"), eps=1e-5)
    for o, r in zip(out, ref):
        assert o.dtype == getattr(torch, dtype)
        assert rel_err(f32(o), f32(r)) <= TOL[dtype]


def test_tome_wrapper_on_cpu():
    """CPU tensors take the plain version and count no launch; the inputs
    are checked."""
    args = as_lib(tome_inputs(2, 13, 32, 2), "bfloat16", "torch")
    n = fused_mha_block_tome.launches
    for a, b in zip(fused_mha_block_tome(*args), mha_block_tome_plain(*args)):
        assert torch.equal(a, b)
    assert fused_mha_block_tome.launches == n
    with pytest.raises(ValueError, match="bqkv"):
        fused_mha_block_tome(*args[:2], args[2][:, :1], *args[3:])
    with pytest.raises(ValueError, match="log_size"):
        fused_mha_block_tome(*args[:7], args[7].double())


def test_tome_grads_match_jax():
    """autograd through ``fused_mha_block_tome`` (the composed backward)
    vs jax.grad through vitx's custom VJP, all eight inputs, fp32."""
    arrs = tome_inputs(2, 13, 32, 2, seed=3)
    rng = np.random.default_rng(4)
    w_out, w_km = normal(rng, (2, 13, 32)), normal(rng, (2, 13, 16))

    def jloss(*a):
        o, km = jmha.fused_mha_block_tome(*a, eps=1e-5)
        return jnp.sum(o * w_out) + jnp.sum(km * w_km)

    ref = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    o, km = fused_mha_block_tome(*ts, eps=1e-5)
    loss = (o * torch.from_numpy(w_out)).sum() + (
        km * torch.from_numpy(w_km)).sum()
    for g, r in zip(torch.autograd.grad(loss, ts), ref):
        assert rel_err(f32(g), f32(r)) <= TOL["float32"]


# --- the ToMe forward -----------------------------------------------------------

FORWARD_CASES = {
    "r8": dict(tome_r=8),
    "schedule": dict(tome_r=(16, 8)),
    "to40": dict(tome_r="to40"),
    "r8_fused": dict(tome_r=8, fuse_mha="on", fuse_mlp="on"),
    "r8_bias": dict(tome_r=8, qkv_bias=True),
    "r8_bias_fused": dict(tome_r=8, qkv_bias=True, fuse_mha="on"),
    "r8_bf16": dict(tome_r=8, compute_dtype="bfloat16"),
    "large16_384_d2": dict(preset="large16_384", depth=2, tome_r=(65, 64)),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_tome_matches_vitx(case):
    """``forward(..., device="cpu")`` with tome_r vs ``vitx.forward``:
    fuse_mha "auto" is the composed path on both sides, "on" the plain
    version against Pallas interpret; a ``toN`` resolves to vitx's
    schedule. fp32 cases also compare ``encode_tome``'s sources and
    ``tome_patch_assignment`` exactly."""
    over = dict(FORWARD_CASES[case])
    preset = over.pop("preset", None)
    if preset:
        jcfg = vitx.get_config(preset, compute_dtype="float32", **over)
        tcfg = vitx_torch.get_config(preset, compute_dtype="float32", **over)
        batch = 1
    else:
        if isinstance(over["tome_r"], str):
            base = vitx.ViTConfig(**TINY)
            over["tome_r"] = jtome.aligned_schedule(base,
                                                    int(over["tome_r"][2:]))
            assert over["tome_r"] == vitx_torch.aligned_schedule(
                vitx_torch.ViTConfig(**TINY), 40)
        jcfg, tcfg = configs(**over)
        batch = 2
    pn = numpy_params(tcfg)
    x = images(jcfg, batch)
    jp = jax.tree.map(jnp.asarray, pn)
    ref = np.asarray(VITX_FORWARD(jp, jnp.asarray(x), jcfg))
    tp = vitx_torch.params_from_jax(pn, tcfg, "cpu")
    out = vitx_torch.forward(tp, x, tcfg, device="cpu")
    assert out.shape == (batch, tcfg.num_classes)
    assert rel_err(out.numpy(), ref) < (1e-4 if jcfg.compute_dtype ==
                                        "float32" else 0.05)
    if jcfg.compute_dtype != "float32" or case == "r8_fused":
        return
    _, jsrc = VITX_ENCODE_TOME(jp, jnp.asarray(x), jcfg, True)
    with torch.inference_mode():
        toks, src = vitx_torch.encode_tome(tp, torch.from_numpy(x), tcfg,
                                           return_sources=True)
    T0 = tcfg.seq_len
    assert toks.shape[1] == T0 - sum(tcfg.tome_schedule)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(
        vitx_torch.tome_patch_assignment(src, tcfg).numpy(),
        np.asarray(jtome.tome_patch_assignment(jsrc, jcfg)))


@pytest.mark.parametrize("fuse", ["auto", "on"])
def test_tome_is_lossless_on_identical_tokens(fuse):
    """``tests/test_tome.py:36-50`` on the port: a constant image and zero
    positional embeddings make every patch token identical, so merging
    loses nothing and proportional attention weighs each merged token by
    its size: the ToMe logits equal the full-token logits."""
    cfg = vitx_torch.ViTConfig(**dict(TINY, tome_r=8, fuse_mha=fuse,
                                      fuse_mlp=fuse))
    params = vitx_torch.init_params(0, cfg, device="cpu")
    params["pos_embed"] = torch.zeros_like(params["pos_embed"])
    x = np.full((2, 32, 32, 3), 0.3, np.float32)
    full = vitx_torch.forward(params, x, cfg.replace(tome_r=0), device="cpu")
    merged = vitx_torch.forward(params, x, cfg, device="cpu")
    assert rel_err(merged.numpy(), full.numpy()) <= 1e-4
    with torch.inference_mode():
        toks = vitx_torch.encode_tome(params, torch.from_numpy(x), cfg)
    assert toks.shape[1] == cfg.seq_len - 8 * cfg.depth


def test_params_from_jax_carries_qkv_bias():
    """A qkv_bias tree crosses with ``bqkv`` (L, 3, H, D) intact; B8 is the
    first kernel that reads it."""
    jcfg, tcfg = configs(qkv_bias=True, tome_r=4)
    pn = numpy_params(tcfg, seed=6)
    tp = vitx_torch.params_from_jax(pn, tcfg, "cpu")
    assert tp["blocks"]["bqkv"].shape == (3, 3, 2, 16)
    np.testing.assert_array_equal(tp["blocks"]["bqkv"].numpy(),
                                  pn["blocks"]["bqkv"])
    with pytest.raises(KeyError, match="bqkv"):
        vitx_torch.params_from_jax({k: v for k, v in pn.items()} | {
            "blocks": {k: v for k, v in pn["blocks"].items()
                       if k != "bqkv"}}, tcfg, "cpu")


def test_server_predicts_from_the_merged_encoder():
    """``InferenceServer.predict`` with tome_r answers from the ToMe
    forward at the server's batch shape, which differs from the full-token
    forward; ``--tome-r to128`` parses into vitx's schedule."""
    from vitx.train.checkpoint import resolve_artifact_config
    from vitx_torch.serve import InferenceServer
    from vitx_torch.train.checkpoint import \
        resolve_artifact_config as resolve_serve_config

    cfg = vitx_torch.ViTConfig(**dict(TINY, tome_r=8))
    params = vitx_torch.init_params(0, cfg, device="cpu")
    imgs = images(cfg, 4, seed=7)
    with InferenceServer(params, cfg, batch_size=4, top_k=4,
                         max_delay_ms=200.0, device="cpu") as srv:
        results = [srv.predict(im) for im in imgs[:1]]
    pad = np.concatenate([imgs[:1], np.zeros_like(imgs[:3])])
    tome = torch.softmax(vitx_torch.forward(params, pad, cfg, device="cpu"),
                         -1)[0]
    full = torch.softmax(vitx_torch.forward(params, pad, cfg.replace(
        tome_r=0), device="cpu"), -1)[0]
    probs, classes = torch.topk(tome, 4)
    assert results[0]["classes"] == classes.tolist()
    np.testing.assert_allclose(results[0]["probs"], probs.numpy(),
                               rtol=1e-6, atol=1e-9)
    assert float((tome - full).abs().max()) > 1e-6
    got = resolve_serve_config(None, None, "base16",
                               vitx_torch.parse_tome_r("to128"))
    ref = resolve_artifact_config(None, preset="base16", tome_r="to128")
    assert got.tome_r == ref.tome_r and got.tome_r[:2] == (35, 34)
