"""int8 ``.quant.npz`` artifacts in the port (vitx_torch.quant) against
vitx's (vitx/quant.py), on the CPU at tiny size, depth 2, fp32: files
written by either package load in the other with every ``q::``, ``s::``
and ``f::`` member bit-equal and an equal parsed ``__meta__`` (bfloat16
members too), the same ``quantization_error``, the port's forward on the
dequantized params within 1e-4 of vitx's forward on its own, and the
artifact through ``load_server`` and the eval CLI, mirroring
``tests/test_quant.py``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.quant import load_quantized as jload
from vitx.quant import quantization_error as jerror
from vitx.quant import save_quantized as jsave
from vitx_torch.nn.vit import param_spec
from vitx_torch.quant import (load_quantized, peek_meta, quantization_error,
                              quantize_leaf, save_quantized)

torch.set_num_threads(1)

JCFG = vitx.get_config("tiny", compute_dtype="float32", depth=2)
TCFG = vitx_torch.get_config("tiny", compute_dtype="float32", depth=2)
META = {"config": json.loads(TCFG.to_json()), "epoch": 3}


def _members(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_files(a, b):
    ma, mb = _members(a), _members(b)
    assert sorted(ma) == sorted(mb)
    for k in ma:
        if k == "__meta__":
            assert (json.loads(bytes(ma[k]).decode())
                    == json.loads(bytes(mb[k]).decode()))
            continue
        assert ma[k].dtype == mb[k].dtype and ma[k].shape == mb[k].shape, k
        assert ma[k].tobytes() == mb[k].tobytes(), k


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.fixture(scope="module")
def jparams():
    return vitx.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return vitx_torch.params_from_jax(jax.device_get(jparams), TCFG,
                                      device="cpu")


def test_vitx_file_loads_in_port(tmp_path, jparams, tparams):
    """vitx writes, the port reads: the dequantized leaves equal vitx's own
    load bit for bit, the user meta survives, and the port's file of the
    same params is vitx's, member for member."""
    path = jsave(tmp_path / "j.quant.npz", jparams, meta=META)
    got, user = load_quantized(path, param_spec(TCFG), device="cpu")
    want, juser = jload(path, vitx.init_params(jax.random.PRNGKey(1), JCFG))
    assert user == juser == META and peek_meta(path) == META
    got, want = dict(_flat(got)), dict(_flat(jax.device_get(want)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert got[k].numpy().tobytes() == np.asarray(v).tobytes(), k
    mine = save_quantized(tmp_path / "t.quant.npz", tparams, meta=META)
    _assert_same_files(path, mine)


def test_port_file_loads_in_vitx(tmp_path):
    """The port writes its own init (not vitx's), vitx reads it: every leaf
    equals the port's own load bit for bit."""
    params = vitx_torch.init_params(5, TCFG, device="cpu")
    path = save_quantized(tmp_path / "t.quant.npz", params, meta=META)
    jgot, juser = jload(path, vitx.init_params(jax.random.PRNGKey(0), JCFG))
    got, user = load_quantized(path, params, device="cpu")
    assert juser == user == META
    jgot = dict(_flat(jax.device_get(jgot)))
    for k, v in _flat(got):
        assert np.asarray(jgot[k]).tobytes() == v.numpy().tobytes(), k
    # the float leaves pass through untouched
    for k in ("pos_embed", "cls_token", "blocks/ln1_scale", "blocks/b1"):
        node_t, node_p = got, params
        for part in k.split("/"):
            node_t, node_p = node_t[part], node_p[part]
        assert torch.equal(node_t, node_p), k


def test_bfloat16_members_both_ways(tmp_path, jparams, tparams):
    """bfloat16 leaves: no numpy float, so vitx stores even the weights
    unquantized; numpy reads either package's member as 2-byte void, the
    port reinterprets its bits, and its own file is vitx's."""
    jb = jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16), jparams)
    tb = jax.tree.map(lambda t: t.to(torch.bfloat16), tparams)
    path = jsave(tmp_path / "j.quant.npz", jb)
    assert _members(path)["f::pos_embed"].dtype == np.dtype("V2")
    got, _ = load_quantized(path, param_spec(TCFG), device="cpu")
    want = dict(_flat(jax.device_get(jb)))
    for k, v in _flat(got):
        assert v.dtype == torch.bfloat16, k
        assert (v.view(torch.int16).numpy().tobytes()
                == np.asarray(want[k]).tobytes()), k
    mine = save_quantized(tmp_path / "t.quant.npz", tb)
    _assert_same_files(path, mine)


def test_quantization_error_matches_vitx(jparams, tparams):
    errs = quantization_error(tparams)
    assert errs == jerror(jparams)
    assert errs and all(e <= 1.0 / 254 + 1e-6 for e in errs.values())
    w = np.random.default_rng(0).standard_normal((2, 16, 3, 2, 8))
    q, s = quantize_leaf(torch.from_numpy(w), "blocks/wqkv")
    assert q.dtype == np.int8 and s.shape == (2, 1, 3, 2, 8)
    assert np.all(np.abs(w - q * s) <= s / 2 + 1e-7)


def test_forward_on_dequantized_matches_vitx(tmp_path, jparams):
    """Each package's forward on its own load of one vitx artifact: within
    1e-4."""
    path = jsave(tmp_path / "j.quant.npz", jparams)
    tp, _ = load_quantized(path, param_spec(TCFG), device="cpu")
    jp, _ = jload(path, jparams)
    x = np.random.default_rng(1).standard_normal(
        (3, 64, 64, 3)).astype(np.float32)
    got = vitx_torch.forward(tp, x, TCFG, device="cpu").numpy()
    want = np.asarray(vitx.forward(jp, x, JCFG))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_load_server_on_quantized_artifact(tmp_path, tparams):
    """A ``.quant.npz`` serves dequantized: top-1 equals the direct forward
    on the dequantized params; its config comes from the artifact."""
    from vitx_torch.serve import load_server
    from vitx_torch.train.checkpoint import resolve_artifact_config

    path = save_quantized(tmp_path / "m.quant.npz", tparams, meta=META)
    cfg = resolve_artifact_config(str(path), None, "base16")
    assert cfg == TCFG
    deq, _ = load_quantized(path, param_spec(cfg), device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (64, 64, 3)).astype(np.float32)
    with load_server(str(path), cfg, batch_size=4, device="cpu") as srv:
        out = srv.predict(x)
    want = vitx_torch.forward(deq, x[None], cfg, device="cpu")[0]
    assert len(out["probs"]) == srv.top_k
    assert out["classes"][0] == int(want.argmax())


def test_cli_eval_export_quantized(tmp_path, capsys, tparams):
    """eval --export-quantized on a bare params .npz writes an artifact
    about 1/4 of the fp32 size that evaluates to the same accuracy within
    0.02 and that vitx reads."""
    from vitx_torch.cli.eval import main as eval_main

    src = tmp_path / "p.npz"
    np.savez(src, **{k: v.numpy() for k, v in _flat(tparams)})
    art = tmp_path / "m.quant.npz"
    argv = ["--data", "synthetic", "--batch-size", "32", "--device", "cpu",
            "--config-json"]
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(TCFG.to_json())
    assert eval_main(argv + [str(cfg_json), "--checkpoint", str(src),
                             "--export-quantized", str(art)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    fp32 = sum(v.numel() * 4 for _, v in _flat(tparams))
    assert os.path.getsize(art) < 0.45 * fp32
    assert peek_meta(art)["config"] == json.loads(TCFG.to_json())
    assert eval_main(["--data", "synthetic", "--batch-size", "32",
                      "--device", "cpu", "--checkpoint", str(art)]) == 0
    qout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(qout["accuracy"] - out["accuracy"]) <= 0.02
    jload(art, vitx.init_params(jax.random.PRNGKey(0), JCFG))
