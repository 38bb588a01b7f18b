"""``.pt2`` deployment programs (vitx_torch.export) on the CPU against
vitx's forward and its ``.stablehlo`` artifacts (vitx/export.py), at tiny
size, depth 2, fp32: a symbolic-batch program saved and loaded gives
vitx's logits within 1e-4 at batches 1, 2 and 3 and holds ``depth``
nodes each of ``vitx_torch::mha_block`` and ``::mlp_block`` (the card's
routes, traced wherever the export runs; the ops' CPU implementations are
the plain versions); a ToMe program pins its batch and holds B8's op, a
QKV-bias program B5's; a symbolic batch with ToMe raises; the sidecar is
vitx's; and ``.pt2`` serving end to end with ``/explain`` refused,
mirroring ``tests/test_export.py:85-139``."""

import json

import jax
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.export import save_exported as jsave_exported
from vitx_torch.export import (export_forward, load_exported, peek_meta,
                               save_exported)

torch.set_num_threads(1)

JCFG = vitx.get_config("tiny", compute_dtype="float32", depth=2)
TCFG = vitx_torch.get_config("tiny", compute_dtype="float32", depth=2)
TOL = 1e-4


def _ops(program) -> dict:
    """Count of each vitx_torch op among the program's graph nodes."""
    names = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    return {n.split(".")[1]: names.count(n) for n in set(names)
            if n.startswith("vitx_torch.")}


def _images(b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return vitx.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return vitx_torch.params_from_jax(jax.device_get(jparams), TCFG,
                                      device="cpu")


@pytest.fixture(scope="module")
def program(tmp_path_factory, tparams):
    path = tmp_path_factory.mktemp("pt2") / "m.pt2"
    save_exported(path, tparams, TCFG)
    return path, load_exported(path)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_program_matches_vitx_forward(program, jparams, batch):
    _, ep = program
    x = _images(batch, batch)
    got = ep.module()(torch.from_numpy(x)).numpy()
    want = np.asarray(vitx.forward(jparams, x, JCFG))
    assert got.shape == (batch, TCFG.num_classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_graph_holds_the_kernel_ops(program):
    """The loaded program's graph: K1's and K2's ops in every block, no
    other vitx_torch op, and no autograd Function."""
    _, ep = program
    assert _ops(ep) == {"mha_block": TCFG.depth, "mlp_block": TCFG.depth}
    assert not any("autograd" in str(n.target) for n in ep.graph.nodes)


def test_tome_program_pins_the_batch(tmp_path, tparams):
    """ToMe r=4: the batch pinned at 3, B8's op in every block, logits
    within 1e-4 of the port's merged forward (held to vitx's in
    ``tests/test_torch_tome.py``); another batch is refused."""
    tcfg = TCFG.replace(tome_r=4)
    with pytest.raises(ValueError, match="pinned batch_size"):
        export_forward(tparams, tcfg)
    path = tmp_path / "t.pt2"
    save_exported(path, tparams, tcfg, batch_size=3)
    ep = load_exported(path)
    assert _ops(ep) == {"mha_block_tome": tcfg.depth,
                        "mlp_block": tcfg.depth}
    x = _images(3, 7)
    want = vitx_torch.forward(tparams, x, tcfg, device="cpu").numpy()
    np.testing.assert_allclose(ep.module()(torch.from_numpy(x)).numpy(),
                               want, rtol=0, atol=TOL)
    with pytest.raises(Exception):
        ep.module()(torch.from_numpy(_images(2)))


def test_qkv_bias_program_holds_attention_fwd(tparams):
    """A QKV-bias model runs the composed path: B5's op in every block
    (attn_impl="flash": the auto rule takes B5 only from T 128)."""
    tcfg = TCFG.replace(qkv_bias=True, attn_impl="flash")
    jcfg = JCFG.replace(qkv_bias=True, attn_impl="flash")
    rng = np.random.default_rng(3)
    bqkv = rng.standard_normal(
        (tcfg.depth, 3, tcfg.num_heads, tcfg.head_dim)).astype(np.float32)
    bqkv *= 0.1
    jp = vitx.init_params(jax.random.PRNGKey(0), jcfg)
    jp = {**jp, "blocks": {**jp["blocks"], "bqkv": bqkv}}
    tp = vitx_torch.params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    ep = export_forward(tp, tcfg)
    assert _ops(ep) == {"attention_fwd": tcfg.depth,
                        "mlp_block": tcfg.depth}
    x = _images(2, 9)
    np.testing.assert_allclose(ep.module()(torch.from_numpy(x)).numpy(),
                               np.asarray(vitx.forward(jp, x, jcfg)),
                               rtol=0, atol=TOL)


def test_sidecar_equals_vitx(tmp_path, program, jparams):
    """The same config, exported by each package: equal sidecars."""
    path, _ = program
    jpath = tmp_path / "m.stablehlo"
    jsave_exported(jpath, jparams, JCFG)
    assert peek_meta(path) == json.loads(
        (tmp_path / "m.stablehlo.json").read_text())
    assert peek_meta(tmp_path / "none.pt2") is None


def test_pt2_serving_e2e(program, tparams):
    """export -> the sidecar's config -> ``load_server`` serves the
    program: top-1 and probability equal the live forward's; ``/explain``
    is refused (the program bakes only the logits)."""
    from vitx_torch.serve import load_server
    from vitx_torch.train.checkpoint import resolve_artifact_config

    path, _ = program
    cfg = resolve_artifact_config(str(path), None, "base16")
    assert cfg == TCFG
    img = _images(1, 11)[0]
    want = vitx_torch.forward(tparams, img[None], TCFG, device="cpu")[0]
    p = torch.softmax(want, -1)
    with load_server(str(path), cfg, batch_size=4, top_k=3,
                     device="cpu") as srv:
        out = srv.predict(img)
        assert out["classes"][0] == int(want.argmax())
        np.testing.assert_allclose(out["probs"][0], float(p.max()),
                                   rtol=1e-4, atol=1e-5)
        with pytest.raises(RuntimeError, match="exported program"):
            srv.explain(img)


def test_pt2_serving_guards(tmp_path, tparams):
    """A program that returns probabilities is refused; a pinned batch
    must be the server's, and serves at it."""
    from vitx_torch.serve import load_server

    soft = tmp_path / "soft.pt2"
    save_exported(soft, tparams, TCFG, with_softmax=True, batch_size=4)
    with pytest.raises(ValueError, match="with_softmax"):
        load_server(str(soft), TCFG, batch_size=4, device="cpu")
    pinned = tmp_path / "p.pt2"
    save_exported(pinned, tparams, TCFG, batch_size=8)
    with pytest.raises(ValueError, match="batch_size=8"):
        load_server(str(pinned), TCFG, batch_size=4, device="cpu")
    img = _images(1, 12)[0]
    want = vitx_torch.forward(tparams, img[None], TCFG, device="cpu")[0]
    with load_server(str(pinned), TCFG, batch_size=8, top_k=1,
                     device="cpu") as srv:
        assert srv.predict(img)["classes"][0] == int(want.argmax())


def test_eval_cli_export_pt2(tmp_path, capsys, tparams):
    """eval --export-pt2 writes a program and its sidecar (the batch
    pinned under --tome-r); --export-stablehlo names --export-pt2."""
    from vitx_torch.cli.eval import main as eval_main

    src = tmp_path / "p.npz"
    flat = {}
    for k, v in tparams.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": vv.numpy() for kk, vv in v.items()})
        else:
            flat[k] = v.numpy()
    np.savez(src, **flat)
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(TCFG.to_json())
    out = tmp_path / "m.pt2"
    assert eval_main(["--data", "synthetic", "--batch-size", "16",
                      "--device", "cpu", "--config-json", str(cfg_json),
                      "--checkpoint", str(src), "--tome-r", "4",
                      "--export-pt2", str(out)]) == 0
    capsys.readouterr()
    meta = peek_meta(out)
    assert meta["batch_size"] == 16 and meta["config"]["tome_r"] == 4
    assert _ops(load_exported(out))["mha_block_tome"] == TCFG.depth
    with pytest.raises(SystemExit, match="--export-pt2"):
        eval_main(["--checkpoint", str(src), "--device", "cpu",
                   "--export-stablehlo", "m.stablehlo"])
