"""vitx's other model families in the port, on the CPU, against vitx.

The families: the conv stem, register tokens, the MAP head, the sincos2d
and RoPE positions, Soft-MoE blocks, and one model with registers, the MAP
head and sincos2d together. For each, at image 32, patch 8, E 64, 4
heads, depth 2: the forward in fp32 (1e-4) and bf16 (0.05,
``tests/test_parity_torch.py:58``, ``:80``) against ``vitx.forward`` on
the same numpy-seeded weights (vitx's init nudged by N(0, 0.02) noise,
carried across with ``params_from_jax``); the explain paths; ToMe over
registers; a ``.ckpt`` vitx writes, read by the port and written back bit
for bit with its AdamW moments; the ``.quant.npz`` members bit-equal to
vitx's; the train and eval CLIs' flags; ``resize_patch_embed``; the
weight-decay, freeze and LLRD rules on the new trees; the reference
layouts' refusals. A depth-2 train step's loss and gradients against
vitx's ``value_and_grad``: here for QK-Norm, SwiGLU, LayerScale, ``gap``
and the combined model; ``tests/test_torch_model.py::
test_unported_features_raise`` holds the other families.

XLA's CPU backend runs no bf16 x bf16 -> f32 product (``DotThunk``), which
vitx's bf16 Soft-MoE einsums ask for; ``fp32_dots`` feeds them fp32
operands instead, the same products (bf16 operands are exact in fp32) that
a TPU accumulates in fp32.
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vitx
import vitx_torch
from vitx.quant import save_quantized as jsave_quantized
from vitx.train import checkpoint as jckpt
from vitx.train import step as jstep
from vitx_torch.core.config import ViTConfig
from vitx_torch.nn.vit import param_spec
from vitx_torch.quant import save_quantized
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

BASE = dict(image_size=32, patch_size=8, embed_dim=64, num_heads=4, depth=2,
            num_classes=5)
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
# the families whose train step this file holds (test_torch_model.py
# holds the rest)
STEP_FAMILIES = {
    "qk_norm": {"qk_norm": True},
    "swiglu": {"mlp_act": "swiglu"},
    "layerscale": {"layerscale_init": 0.1},
    "gap": {"global_pool": "gap", "head_type": "standard"},
    "registers_map_sincos2d": FAMILIES["registers_map_sincos2d"],
}
BAR = {"float32": 1e-4, "bfloat16": 0.05}


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def configs(over, dtype="float32", **more):
    kw = dict(BASE, compute_dtype=dtype, **over, **more)
    return vitx.get_config("tiny", **kw), vitx_torch.get_config("tiny", **kw)


def vitx_params(cfg, seed=0):
    """A tree of vitx's layout (``param_spec``'s, which
    ``test_param_tree_is_vitx_tree`` holds to vitx's init) drawn with
    numpy: each leaf its init value (0.02 N(0, 1) for the trunc-normal
    ones) plus N(0, 0.02) noise."""
    rng = np.random.default_rng(seed)
    spec = param_spec(ViTConfig.from_json(cfg.to_json()))

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        shape, init = node
        base = (0.02 * rng.standard_normal(shape) if init == "normal"
                else np.full(shape, init))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    return draw(spec)


def images(cfg, batch=2, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def port(params, cfg):
    return vitx_torch.params_from_jax(params, cfg, device="cpu")


def flat(tree, prefix=""):
    """{"a/b": float32 array} of a nested dict of arrays or tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(
                v.detach().float() if torch.is_tensor(v) else v, np.float32)
    return out


@contextlib.contextmanager
def fp32_dots():
    """vitx's einsums with bf16 operands and fp32 accumulation, fed fp32
    operands (see the module docstring)."""
    orig = jnp.einsum

    def einsum(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o
                   for o in ops]
        return orig(eq, *ops, preferred_element_type=preferred_element_type,
                    **kw)
    jnp.einsum = einsum
    try:
        yield
    finally:
        jnp.einsum = orig


def vitx_call(fn, *args):
    """``fn(*args)`` jitted afresh (a new function each call: no trace from
    outside ``fp32_dots`` is reused), under ``fp32_dots``."""
    with fp32_dots():
        return jax.jit(lambda *a: fn(*a))(*args)


def grads_match(over, batch=2):
    """A depth-2 fp32 step: the loss and every gradient of the port's
    ``loss_fn`` against vitx's ``value_and_grad`` of its ``loss_fn`` on the
    same params and batch (1e-4 of each leaf's largest), then the port's
    ``train_step`` on them reports that loss."""
    jcfg, tcfg = configs(over)
    params = vitx_params(jcfg)
    x = images(jcfg, batch)
    b = {"image": x, "label": np.arange(batch, dtype=np.int32) % 5}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        functools.partial(jstep.loss_fn, cfg=jcfg, rng=None),
        has_aux=True))(params, b)
    p = port(params, tcfg)
    req = tstep.tree_map(lambda t: t.requires_grad_(), p)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tloss, _ = tstep.loss_fn(req, tb, tcfg)
    tgrads = torch.autograd.grad(tloss, tstep.leaves(req))
    assert abs(float(tloss.detach()) - float(loss)) <= 1e-4 * abs(float(loss))
    ref = flat(grads)
    names = ["/".join(q) for q in tstep.leaf_paths(req)]
    assert sorted(names) == sorted(ref)
    for name, g in zip(names, tgrads):
        assert rel_err(g.numpy(), ref[name]) <= 1e-4, name
    opt = tstep.make_optimizer(lr=1e-3)
    p = port(params, tcfg)
    state, m = tstep.train_step(tstep.TrainState(0, p, opt.init(p)), b,
                                cfg=tcfg, optimizer=opt, device="cpu")
    assert abs(float(m["loss"]) - float(loss)) <= 1e-4 * abs(float(loss))
    return tcfg


# --- the forward ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_forward_matches_vitx(family, dtype):
    jcfg, tcfg = configs(FAMILIES[family], dtype)
    params = vitx_params(jcfg)
    x = images(jcfg)
    want = vitx_call(functools.partial(vitx.forward, cfg=jcfg), params, x)
    got = vitx_torch.forward(port(params, tcfg), x, tcfg, device="cpu")
    assert got.shape == (2, 5) and got.dtype == torch.float32
    assert rel_err(got, want) <= BAR[dtype], rel_err(got, want)


def test_param_tree_is_vitx_tree():
    """Every family's tree: vitx's leaves and shapes, conv kernels in HWIO,
    no pos_embed for sincos2d and RoPE."""
    for over in FAMILIES.values():
        jcfg, tcfg = configs(over)
        want = {jax.tree_util.keystr(k): v.shape for k, v in
                jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                    functools.partial(vitx.init_params, cfg=jcfg),
                    jax.random.PRNGKey(0)))}
        got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_leaves_with_path(
                   vitx_torch.init_params(0, tcfg, device="cpu"))}
        assert got == want, over
    _, tcfg = configs(FAMILIES["conv_stem"])
    pe = param_spec(tcfg)["patch_embed"]
    assert [pe[f"conv{i}"]["kernel"][0] for i in range(3)] == [
        (3, 3, 3, 16), (3, 3, 16, 32), (3, 3, 32, 64)]
    assert pe["proj"]["kernel"][0] == (1, 1, 64, 64)


def test_positions_and_padding_match_vitx():
    """The sincos2d table and the RoPE tables (with a prefix and
    registers), and the stem's "SAME" padding at stride 2 on even and odd
    sizes against ``jax.lax.conv_general_dilated``."""
    from vitx.nn import vit as jvit
    from vitx_torch.nn import vit as tvit

    jcfg, tcfg = configs({"num_registers": 3, "distill_token": True})
    assert rel_err(tvit.sincos_pos_embed(tcfg),
                   jvit.sincos_pos_embed(jcfg)) <= 1e-6
    for a, b in zip(tvit.rope_tables(tcfg), jvit.rope_tables(jcfg)):
        assert a.shape == (tcfg.seq_len, tcfg.head_dim)
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-6
    rng = np.random.default_rng(0)
    for size in (8, 7):
        x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
        w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
        want = jax.lax.conv_general_dilated(
            x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        got = tvit._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(w), 2).permute(0, 2, 3, 1)
        assert rel_err(got, want) <= 1e-6


# --- the train step -----------------------------------------------------------

@pytest.mark.parametrize("family", list(STEP_FAMILIES))
def test_family_train_step_matches_vitx(family):
    grads_match(STEP_FAMILIES[family])


# --- explain paths and ToMe ----------------------------------------------------

@pytest.mark.parametrize("family", ["soft_moe", "registers"])
def test_explain_paths_match_vitx(family):
    """``forward_with_rollout``, ``forward_with_attn`` (head mean) with
    ``attention_rollout`` over the registers, and ``grad_cam`` over a MoE
    stack, fp32, against vitx's."""
    from vitx.nn.rollout import attention_rollout as jrollout
    from vitx.nn.saliency import grad_cam as jgrad_cam

    jcfg, tcfg = configs(FAMILIES[family])
    params = vitx_params(jcfg)
    x = images(jcfg)
    tp = port(params, tcfg)
    jl, jw = vitx_call(functools.partial(vitx.forward_with_rollout,
                                         cfg=jcfg), params, x)
    tl, tw = vitx_torch.forward_with_rollout(tp, x, tcfg, device="cpu")
    assert rel_err(tl, jl) <= 1e-4 and rel_err(tw, jw) <= 1e-4
    _, probs = vitx_torch.forward_with_attn(tp, x, tcfg, probs_mode="mean",
                                            device="cpu")
    assert probs.shape == (2, 2, tcfg.seq_len, tcfg.seq_len)
    w = vitx_torch.attention_rollout(probs,
                                     num_registers=tcfg.num_registers)
    assert rel_err(w, jw) <= 1e-4
    assert rel_err(w, jrollout(jnp.asarray(probs.numpy()),
                               num_registers=jcfg.num_registers)) <= 1e-6
    jcam, _ = vitx_call(functools.partial(jgrad_cam, cfg=jcfg, class_idx=1),
                        params, x)
    tcam, _ = vitx_torch.grad_cam(tp, x, tcfg, class_idx=1, device="cpu")
    assert rel_err(tcam, jcam) <= 1e-4


def test_tome_over_registers_matches_vitx():
    """The ToMe encoder on a registers model (the registers never merge):
    the tokens and the merges' sources against vitx's ``encode_tome``."""
    from vitx.nn.tome import encode_tome as jencode_tome

    jcfg, tcfg = configs({"num_registers": 2, "tome_r": 3})
    params = vitx_params(jcfg)
    x = images(jcfg)
    jx, jsrc = vitx_call(lambda p, im: jencode_tome(p, im, jcfg, True),
                         params, x)
    tx, src = vitx_torch.encode_tome(port(params, tcfg), torch.from_numpy(x),
                                     tcfg, return_sources=True)
    assert tx.shape == (2, tcfg.seq_len - 2 * 3, 64)
    assert rel_err(tx, jx) <= 1e-4
    assert np.array_equal(src.numpy(), np.asarray(jsrc))


# --- artifacts ------------------------------------------------------------------

def _members(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_members(a, b):
    ma, mb = _members(a), _members(b)
    assert list(ma) == list(mb)
    for k in ma:
        if k == "__meta__":
            assert json.loads(bytes(ma[k]).decode()) == \
                json.loads(bytes(mb[k]).decode())
        else:
            assert ma[k].dtype == mb[k].dtype and \
                ma[k].tobytes() == mb[k].tobytes(), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ckpt_and_quant_both_ways(tmp_path, family):
    """A ``.ckpt`` of vitx's writer (params after one AdamW update with
    its moments, the config in the meta as the Trainer stores it): the
    port restores it and writes it back member for member, bit for bit.
    The ``.quant.npz`` of the tree: every member bit-equal to vitx's."""
    jcfg, tcfg = configs(FAMILIES[family])
    params = vitx_params(jcfg)
    rng = np.random.default_rng(3)

    def moments(tree):       # what an update leaves: nonzero fp32 trees
        return jax.tree.map(lambda p: np.abs(rng.standard_normal(
            p.shape)).astype(np.float32), tree)
    def fill(node):          # the Adam node inside optax's chain
        if isinstance(node, optax.ScaleByAdamState):
            return node._replace(count=np.asarray(1, np.int32),
                                 mu=moments(params), nu=moments(params))
        if type(node) is tuple:
            return tuple(fill(n) for n in node)
        return node
    state = jstep.TrainState(np.asarray(1, np.int32), params, fill(
        jstep.make_optimizer(lr=1e-3).init(params)))
    meta = {"config": json.loads(jcfg.to_json())}
    jckpt.save_checkpoint(tmp_path / "j", jax.device_get(state), 1,
                          meta=meta)
    topt = tstep.make_optimizer(lr=1e-3)
    template = tstep.create_train_state(0, tcfg, topt, device="cpu")
    got, gmeta = tckpt.restore_checkpoint(tmp_path / "j" / "1.ckpt",
                                          template, False)
    assert gmeta["config"] == meta["config"] and got.opt_state.count == 1
    tckpt.save_checkpoint(tmp_path / "t", tckpt.snapshot(got, False), 1,
                          meta=meta)
    _same_members(tmp_path / "j" / "1.ckpt", tmp_path / "t" / "1.ckpt")
    eval_params, _ = tckpt.restore_eval_params(tmp_path / "t", tcfg,
                                               device="cpu")
    want = flat(jax.device_get(state.params))
    for k, v in flat(eval_params).items():
        assert np.array_equal(v, want[k]), k

    qmeta = {"config": meta["config"], "epoch": 1}
    jsave_quantized(tmp_path / "j.quant.npz", jax.device_get(state.params),
                    meta=qmeta)
    save_quantized(tmp_path / "t.quant.npz", eval_params, meta=qmeta)
    _same_members(tmp_path / "j.quant.npz", tmp_path / "t.quant.npz")


@pytest.mark.parametrize("family", ["soft_moe", "registers_map_sincos2d"])
def test_export_and_server_on_family_ckpt(tmp_path, family):
    """A port ``.ckpt`` of the family through ``load_server`` (top-1 equal
    to the direct forward) and through ``export_forward``'s program
    (logits within 1e-4 of the eager forward)."""
    from vitx_torch.export import export_forward
    from vitx_torch.serve import load_server

    jcfg, tcfg = configs(FAMILIES[family])
    opt = tstep.make_optimizer(lr=1e-3)
    p = port(vitx_params(jcfg), tcfg)
    state = tstep.TrainState(0, p, opt.init(p))
    tckpt.save_checkpoint(tmp_path, tckpt.snapshot(state, False), 2,
                          meta={"config": json.loads(tcfg.to_json())})
    x = images(tcfg, 3, seed=5)
    want = vitx_torch.forward(state.params, x, tcfg, device="cpu")
    with load_server(str(tmp_path), tcfg, batch_size=2,
                     device="cpu") as srv:
        for i in range(3):
            assert srv.predict(x[i])["classes"][0] == int(want[i].argmax())
    program = export_forward(state.params, tcfg)
    got = program.module()(torch.from_numpy(x))
    assert rel_err(got, want) <= 1e-4


def test_reference_layouts_refuse_the_families():
    """The reference ``.pt`` layout and the C oracle's ``model.bin`` have
    no slot for these params: ValueError, worded as vitx's."""
    from vitx_torch.interop.cbin import write_model_bin
    from vitx_torch.interop.torch_ref import export_reference_state_dict

    for over, match in (({"stem": "conv"}, "stem='patch'"),
                        ({"num_registers": 2}, "num_registers=0"),
                        ({"moe_experts": 2}, "Soft-MoE")):
        _, tcfg = configs(over, head_type="reference", proj_bias=True)
        p = vitx_torch.init_params(0, tcfg, device="cpu")
        with pytest.raises(ValueError, match=match):
            export_reference_state_dict(p, tcfg)
        with pytest.raises(ValueError, match="vitc has no"):
            write_model_bin("unused.bin", p, tcfg)


# --- the optimizer's rules --------------------------------------------------------

def test_optimizer_masks_match_vitx():
    """On a MoE tree with a MAP head, a conv stem and registers: the
    weight-decay mask and the "head" freeze mask are vitx's, leaf for
    leaf; LLRD of a Soft-MoE model raises, where vitx's fails on its
    stacked dense blocks."""
    over = {"moe_experts": 2, "moe_blocks": 1, "head_type": "map",
            "stem": "conv", "num_registers": 2}
    jcfg, tcfg = configs(over)
    jp = jax.eval_shape(functools.partial(vitx.init_params, cfg=jcfg),
                        jax.random.PRNGKey(0))
    tp = vitx_torch.init_params(0, tcfg, device="cpu")
    names = ["/".join(q) for q in tstep.leaf_paths(tp)]
    want = flat(jstep.weight_decay_mask(jp))
    assert tstep.weight_decay_mask(tp) == [bool(want[n]) for n in names]
    frozen = flat(jstep.make_trainable_mask("head")(jp))
    assert tstep.trainable_flags(tp, "head") == [bool(frozen[n])
                                                 for n in names]
    opt = tstep.make_optimizer(lr=1e-3, llrd=0.65, llrd_depth=tcfg.depth)
    with pytest.raises(ValueError, match="Soft-MoE"):
        opt.init(tp)


# --- FlexiViT ----------------------------------------------------------------------

@pytest.mark.parametrize("new_p,image_size", [(4, None), (16, None),
                                              (4, 64)])
def test_resize_patch_embed_matches_vitx(new_p, image_size):
    """The PI-resized kernel, the resized positional grid and the config
    against vitx's ``resize_patch_embed``, and the forward at the new patch
    size (fp32, 1e-4)."""
    from vitx.nn.flexivit import resize_patch_embed as jresize
    from vitx_torch.nn.flexivit import resize_patch_embed

    jcfg, tcfg = configs({}, image_size=64)
    params = vitx_params(jcfg)
    jp, jcfg2 = jresize(params, jcfg, patch_size=new_p,
                        image_size=image_size)
    tp, tcfg2 = resize_patch_embed(port(params, tcfg), tcfg,
                                   patch_size=new_p, image_size=image_size)
    assert json.loads(tcfg2.to_json()) == json.loads(jcfg2.to_json())
    want = flat(jax.device_get(jp))
    for k, v in flat(tp).items():
        assert v.shape == want[k].shape and rel_err(v, want[k]) <= 1e-5, k
    x = images(jcfg2)
    got = vitx_torch.forward(tp, x, tcfg2, device="cpu")
    assert rel_err(got, vitx_call(functools.partial(
        vitx.forward, cfg=jcfg2), jp, x)) <= 1e-4
    with pytest.raises(ValueError, match="stem='patch'"):
        resize_patch_embed(tp, tcfg.replace(stem="conv"), patch_size=4)


# --- the CLIs --------------------------------------------------------------------------

def test_train_cli_geometry_flags():
    """vitx's flags reach the config; a "toN" ToMe schedule resolves
    after the registers (vitx's ``aligned_schedule`` of the final
    config)."""
    from vitx.nn.tome import aligned_schedule as jaligned
    from vitx_torch.cli import train as ttrain

    p = ttrain.build_argparser()
    base = ["--device", "cpu", "--data", "synthetic", "--epochs", "1"]
    flags = ["--layerscale", "0.1", "--mlp-act", "gelu_tanh",
             "--pos-embed", "sincos2d", "--qk-norm", "--head-type", "map",
             "--global-pool", "gap", "--num-registers", "4"]
    tr, _, _ = ttrain.build_trainer(p.parse_args(base + flags), p)
    c = tr.cfg
    assert (c.layerscale_init, c.mlp_act, c.pos_embed, c.qk_norm,
            c.head_type, c.global_pool, c.num_registers) == (
        0.1, "gelu_tanh", "sincos2d", True, "map", "gap", 4)
    tr, _, _ = ttrain.build_trainer(p.parse_args(
        base + ["--moe-experts", "2", "--moe-blocks", "1",
                "--moe-slots", "3"]), p)
    assert (tr.cfg.moe_experts, tr.cfg.moe_block_count,
            tr.cfg.moe_slot_count) == (2, 1, 3)
    assert "moe_blocks" in tr.state.params
    tr, _, _ = ttrain.build_trainer(p.parse_args(
        base + ["--num-registers", "4", "--tome-r", "to40",
                "--tome-train"]), p)
    jcfg = vitx.get_config("tiny", num_registers=4)
    jcfg = jcfg.replace(tome_r=jaligned(jcfg, 40), tome_train=True)
    assert tr.cfg.tome_schedule == jcfg.tome_schedule == (15, 14, 0, 0)
    assert tr.cfg.seq_len == 69


def test_cli_train_eval_patch_size(tmp_path, capsys, monkeypatch):
    """The train CLI on a registers + MAP + sincos2d model and on a
    Soft-MoE one, one epoch each on procedural data at 32²: the eval CLI
    on the ``.ckpt`` reports the trainer's val accuracy; ``--patch-size 4``
    on the patch-8 ``.ckpt`` equals direct calls on
    ``resize_patch_embed``'s params over the val split at the scaled
    size, 16²."""
    from vitx_torch.cli import eval as teval
    from vitx_torch.cli import train as ttrain
    from vitx_torch.data import BatchLoader, make_preprocess
    from vitx_torch.nn.flexivit import resize_patch_embed

    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    data = ["--device", "cpu", "--data", "procedural:32,16",
            "--batch-size", "16"]
    for name, flags in (("regmap", ["--num-registers", "2", "--head-type",
                                    "map", "--pos-embed", "sincos2d"]),
                        ("moe", ["--moe-experts", "2", "--moe-blocks",
                                 "2"])):
        ck = tmp_path / name
        assert ttrain.main(data + flags + [
            "--preset", "tiny", "--image-size", "32", "--compute-dtype",
            "float32", "--epochs", "1", "--checkpoint-dir", str(ck)]) == 0
        logged = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert teval.main(data + ["--checkpoint", str(ck)]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["accuracy"] == logged["val_accuracy"], name
    ck = tmp_path / "regmap"
    assert teval.main(data + ["--checkpoint", str(ck),
                              "--patch-size", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = tckpt.resolve_artifact_config(str(ck), None, "tiny")
    params, _ = tckpt.restore_eval_params(ck, cfg, device="cpu")
    params, cfg = resize_patch_embed(params, cfg, patch_size=4)
    assert (cfg.patch_size, cfg.image_size, cfg.grid_size) == (4, 16, 4)
    pre = make_preprocess(out_size=cfg.image_size, mean=(0.5,) * 3,
                          std=(0.5,) * 3, random_flip=False)
    hits = n = 0
    for b in BatchLoader(ttrain.make_datasets(data[3], cfg, 0)[1], 16):
        x = pre(torch.from_numpy(b["image"]), None, train=False)
        logits = vitx_torch.forward(params, x, cfg, device="cpu")
        keep = b["mask"].astype(bool)
        hits += int((logits.argmax(-1).numpy() == b["label"])[keep].sum())
        n += int(keep.sum())
    assert n == 16 and out["num_examples"] == 16
    assert out["accuracy"] == pytest.approx(hits / n, abs=1e-12)
