"""Transfer fine-tuning and the reference ``.pt`` format in the port, on
the CPU, against vitx.

``transfer_params`` from the same ``.ckpt`` (with an EMA), bare ``.npz``
and reference ``.pt`` into twice the image size and a new class count, in
both packages: the same fresh-leaf list, grafted leaves bit-equal,
``pos_embed`` within 1e-6; the cross-parity, patch-size (PI-resize within
1e-5) and config-less cases. ``torch_ref``'s import and export equal
vitx's in fp32 under both parities, the AdamW export of a carried-over
vitx state within 1e-6, ``.pt`` files read bit for bit across the
packages, and the port's ``.pt`` in ``tests/torch_reference.py``'s oracle
within 1e-4 of the port's forward under ``bug_exact``. The eval CLI and a
server on a ``.pt`` equal direct calls; the train CLI's ``--init-from``
takes every kind; ``.stablehlo`` raises, naming the port's ``.pt2``.
The counterparts of ``tests/test_checkpoint.py:158-470``.
"""

import ast
import json
import pickle
import re
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from tests.torch_reference import TorchBuggyViT
from vitx.interop import torch_ref as jref
from vitx.train import checkpoint as jckpt
from vitx.train import step as jstep
from vitx_torch.cli import eval as teval
from vitx_torch.cli import train as ttrain
from vitx_torch.interop import adamw_state_from_jax, params_from_jax
from vitx_torch.interop import torch_ref as tref
from vitx_torch.serve import load_server
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train.step import AdamWState, TrainState, leaves, tree_map

torch.set_num_threads(1)

GEOM = dict(image_size=16, patch_size=4, num_classes=4, embed_dim=32,
            depth=2, num_heads=2, compute_dtype="float32")
JCFG = vitx.ViTConfig(**GEOM)
TCFG = vitx_torch.ViTConfig(**GEOM)
# the fine-tune: twice the image size, three more classes
JTGT = JCFG.replace(image_size=32, num_classes=7)
TTGT = TCFG.replace(image_size=32, num_classes=7)


def flat(tree, prefix=""):
    """{"a/b": numpy leaf} of a vitx or port tree, in sorted-key order."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        else:
            v = tree[k]
            out[prefix + k] = (v.detach().cpu().numpy() if torch.is_tensor(v)
                               else np.asarray(v))
    return out


def vitx_params(cfg, seed=0):
    return jax.device_get(vitx.init_params(jax.random.PRNGKey(seed), cfg))


def fresh_list(caught) -> list:
    """The leaves one warning names as kept fresh, [] when none does."""
    for w in caught:
        m = re.search(r"fresh init kept for (\[.*?\])", str(w.message))
        if m:
            return ast.literal_eval(m.group(1))
    return []


def run(fn, *a, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*a, **kw)
    return out, caught


def write_ckpt(path, cfg, params, seed=1):
    """A port TrainState (an EMA apart from the params) saved as vitx's
    ``.ckpt`` with the config in its meta; returns the EMA tree."""
    p = params_from_jax(params, vitx_torch.ViTConfig.from_json(cfg.to_json()),
                        device="cpu")
    g = torch.Generator().manual_seed(seed)
    ema = tree_map(lambda v: v + 0.01 * torch.randn(v.shape, generator=g), p)
    zeros = tree_map(torch.zeros_like, p)
    state = TrainState(3, p, AdamWState(3, zeros, zeros, ema))
    tckpt.save_checkpoint(path, tckpt.snapshot(state, schedule=False), 0,
                          meta={"config": json.loads(cfg.to_json()),
                                "ema_decay": 0.9})
    return ema


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The same seed-0 source in each artifact kind."""
    root = tmp_path_factory.mktemp("transfer")
    params = vitx_params(JCFG)
    write_ckpt(root / "ck", JCFG, params)
    # the same checkpoint under an .npz name: __meta__ makes it no bare npz
    shutil.copy(root / "ck" / "0.ckpt", root / "ckpt.npz")
    np.savez(root / "src.npz", **flat(params))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # corrected-parity import
        jckpt.save_reference_pt(root / "src.pt", params, JCFG, epoch=4,
                                batch_size=3)
    return root


@pytest.mark.parametrize("kind", ["ck", "ck/0.ckpt", "src.npz", "src.pt"])
def test_transfer_params_matches_vitx(sources, kind):
    """Into 2x the image size and 7 classes: vitx's fresh-leaf list, the
    grafted leaves bit-equal (the EMA from a .ckpt), pos_embed resized
    within 1e-6 of vitx's."""
    src = sources / kind
    want, jw = run(jckpt.transfer_params, src, JTGT, jax.random.PRNGKey(2))
    got, tw = run(tckpt.transfer_params, src, TTGT, 2, device="cpu")
    want, got = flat(jax.device_get(want)), flat(got)
    fresh = fresh_list(jw)
    assert sorted(fresh_list(tw)) == sorted(fresh)
    assert set(fresh) == {"head/b2", "head/w2"}
    assert list(got) == list(want)
    for key, leaf in got.items():
        assert leaf.shape == want[key].shape, key
        if key == "pos_embed":
            np.testing.assert_allclose(leaf, want[key], rtol=0, atol=1e-6)
        elif key not in fresh:
            np.testing.assert_array_equal(leaf, want[key], err_msg=key)
    assert any("pos_embed resized from 17 to 65" in str(w.message)
               for w in tw)
    if kind.startswith("ck"):
        # a .ckpt grafts the eval params: the EMA, not the live ones
        live = flat(vitx_params(JCFG))
        assert not np.array_equal(got["blocks/wqkv"], live["blocks/wqkv"])


@pytest.mark.parametrize("case", ["cross_parity", "patch_size"])
def test_transfer_params_special_cases(tmp_path, case):
    """A bug_exact source into a corrected target keeps pos_embed fresh
    (its rows are in another order) and grafts the encoder; a patch-4
    source into patch 8 PI-resizes the patchify kernel within 1e-5 of
    vitx's and resizes the grid."""
    if case == "cross_parity":
        src_j = JCFG.replace(parity="bug_exact")
        tgt_j, tgt_t = JCFG, TCFG
    else:
        src_j = JCFG
        tgt_j, tgt_t = (c.replace(patch_size=8, image_size=32)
                        for c in (JCFG, TCFG))
    write_ckpt(tmp_path / "ck", src_j, vitx_params(src_j))
    want, jw = run(jckpt.transfer_params, tmp_path / "ck", tgt_j,
                   jax.random.PRNGKey(2))
    got, tw = run(tckpt.transfer_params, tmp_path / "ck", tgt_t, 2,
                  device="cpu")
    want, got = flat(jax.device_get(want)), flat(got)
    assert fresh_list(tw) == fresh_list(jw)
    if case == "cross_parity":
        assert fresh_list(tw) == ["pos_embed"]
        np.testing.assert_array_equal(got["blocks/wqkv"],
                                      want["blocks/wqkv"])
    else:
        assert fresh_list(tw) == []
        assert any("PI-resized from patch 4 to 8" in str(w.message)
                   for w in tw)
        np.testing.assert_allclose(got["patch_embed/kernel"],
                                   want["patch_embed/kernel"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["pos_embed"], want["pos_embed"],
                                   rtol=0, atol=1e-6)


def test_transfer_params_refuses_configless_and_unported(tmp_path):
    """A source whose meta holds no config raises ValueError in both
    packages; a missing one FileNotFoundError, a missing ``.quant.npz``
    too; vitx's ``.stablehlo`` raises naming the port's ``.pt2`` in every
    artifact entry that loads parameters, while its config resolves
    from the preset (no sidecar)."""
    tckpt.save_checkpoint(tmp_path / "mae", [np.zeros(2, np.float32)], 0,
                          meta={"kind": "mae"})
    with pytest.raises(ValueError, match="no model config"):
        jckpt.transfer_params(tmp_path / "mae", JCFG, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="no model config"):
        tckpt.transfer_params(tmp_path / "mae", TCFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.transfer_params(tmp_path / "nowhere", TCFG, device="cpu")
    for name, exc, match in (
            ("m.quant.npz", FileNotFoundError, "m.quant.npz"),
            (str(tmp_path / "m.stablehlo"), NotImplementedError, r"\.pt2")):
        for call in (lambda: tckpt.transfer_params(name, TCFG, device="cpu"),
                     lambda: tckpt.load_artifact_params(name, TCFG, "cpu"),
                     lambda: ttrain.main(["--init-from", name, "--device",
                                          "cpu", "--epochs", "1"])):
            with pytest.raises(exc, match=match):
                call()
    with pytest.raises(FileNotFoundError):
        tckpt.resolve_artifact_config("m.quant.npz")
    assert tckpt.resolve_artifact_config(str(tmp_path / "m.stablehlo")) \
        == tckpt.resolve_artifact_config(None)


# ------------------------------------------------------------- torch_ref


def reference_state_dict(batch_size=3, seed=0):
    torch.manual_seed(seed)
    model = TorchBuggyViT(image_size=16, patch_size=4, num_channels=3,
                          num_classes=4, embed_dim=32, depth=2, num_heads=2,
                          batch_size=batch_size)
    return model, model.state_dict()


@pytest.mark.parametrize("parity", ["corrected", "bug_exact"])
def test_reference_state_dict_both_ways_matches_vitx(parity):
    """Import equals vitx's leaf for leaf (the per-slot CLS kept under
    bug_exact, slot 0 under corrected, which warns in both); export
    equals vitx's and, under bug_exact, the state dict itself."""
    _, sd = reference_state_dict()
    jc, tc = JCFG.replace(parity=parity), TCFG.replace(parity=parity)
    want, jw = run(jref.import_reference_state_dict, sd, jc)
    got, tw = run(tref.import_reference_state_dict, sd, tc)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert bool(tw) == (parity == "corrected")
    fw, fg = flat(want), flat(got)
    assert list(fg) == list(fw)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    back_j = jref.export_reference_state_dict(want, jc, batch_size=3)
    back_t = tref.export_reference_state_dict(got, tc, batch_size=3)
    assert list(back_t) == list(back_j)
    for k, v in back_t.items():
        assert v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), back_j[k], err_msg=k)
        if parity == "bug_exact":
            assert torch.equal(v, sd[k]), k
    assert tref.reference_parameter_order(tc) == \
        jref.reference_parameter_order(jc)


def vitx_opt_state(params):
    """vitx's AdamW state for ``params`` with seeded moments and count 3,
    as after a few steps."""
    opt = jstep.make_optimizer(lr=1e-3, weight_decay=1e-4)
    rng = np.random.default_rng(5)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.float32:
            return np.abs(rng.standard_normal(x.shape)).astype(np.float32)
        return np.full(x.shape, 3, x.dtype)
    return jax.tree_util.tree_map(fill, opt.init(params))


def test_optimizer_export_and_pt_files_cross(tmp_path):
    """The AdamW export of vitx's state carried into the port
    (``adamw_state_from_jax``) within 1e-6 of vitx's export; a ``.pt``
    written by either package, with moments or without, reads in both bit
    for bit, and the two files hold the same dicts."""
    params = vitx_params(JCFG)
    jopt = jax.device_get(vitx_opt_state(params))
    topt = adamw_state_from_jax(jopt, TCFG, device="cpu")
    want = jref.export_reference_optimizer_state(jopt, JCFG, batch_size=2)
    got = tref.export_reference_optimizer_state(topt, TCFG, batch_size=2)
    assert got["param_groups"] == want["param_groups"]
    assert list(got["state"]) == list(want["state"])
    for i, st in want["state"].items():
        assert float(got["state"][i]["step"]) == float(st["step"]) == 3.0
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got["state"][i][k].numpy(),
                                       st[k].numpy(), rtol=0, atol=1e-6)

    tparams = params_from_jax(params, TCFG, device="cpu")
    kw = dict(epoch=7, loss=0.25, step=30, batch_size=2, lr=1e-4,
              weight_decay=1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # corrected-parity imports
        for opt in (True, False):
            jp, tp = tmp_path / f"j{opt}.pt", tmp_path / f"t{opt}.pt"
            jckpt.save_reference_pt(jp, params, JCFG,
                                    opt_state=jopt if opt else None, **kw)
            tckpt.save_reference_pt(tp, tparams, TCFG,
                                    opt_state=topt if opt else None, **kw)
            jf, tf = (torch.load(p, weights_only=False) for p in (jp, tp))
            assert jf.keys() == tf.keys()
            assert jf["optimizer_state_dict"]["param_groups"] == \
                tf["optimizer_state_dict"]["param_groups"]
            assert len(tf["optimizer_state_dict"]["state"]) == (
                len(jref.reference_parameter_order(JCFG)) if opt else 0)
            for k, v in jf["model_state_dict"].items():
                assert torch.equal(tf["model_state_dict"][k], v), k
            for path in (jp, tp):
                a, ma = jckpt.load_reference_pt(path, JCFG)
                b, mb = tckpt.load_reference_pt(path, TCFG, device="cpu")
                assert ma == mb == {"epoch": 7, "loss": 0.25, "step": 30}
                fa, fb = flat(a), flat(b)
                for k in fa:
                    np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
                for k, v in flat(tparams).items():
                    np.testing.assert_array_equal(fb[k], v, err_msg=k)


def test_port_pt_in_reference_oracle(tmp_path):
    """A bug_exact model imported into the port and saved by the port loads
    into the reference-shaped oracle (strict), whose logits are the
    port's forward within 1e-4."""
    model, sd = reference_state_dict(batch_size=4, seed=3)
    cfg = TCFG.replace(parity="bug_exact", mlp_act="relu", num_classes=4)
    params = tref.import_reference_state_dict(sd, cfg)
    tckpt.save_reference_pt(tmp_path / "1.pt", params, cfg, epoch=1,
                            batch_size=4)
    oracle = TorchBuggyViT(image_size=16, patch_size=4, num_channels=3,
                           num_classes=4, embed_dim=32, depth=2, num_heads=2,
                           batch_size=4).eval()
    oracle.load_state_dict(torch.load(tmp_path / "1.pt")["model_state_dict"],
                           strict=True)
    x = torch.randn(4, 3, 16, 16, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        ref = oracle(x)
    got = vitx_torch.forward(params, x.permute(0, 2, 3, 1).contiguous(), cfg,
                             device="cpu")
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < 1e-4, err


# ------------------------------------------------------ the entry points


def test_eval_cli_and_server_on_pt(tmp_path, capsys):
    """``cli.eval --checkpoint m.pt`` (the config from --config-json) gives
    the accuracy of direct forwards on the same images; a server on the
    file answers with the direct top-1."""
    from vitx_torch.data import make_preprocess

    params = vitx_torch.init_params(4, TCFG, device="cpu")
    tckpt.save_reference_pt(tmp_path / "m.pt", params, TCFG, epoch=2)
    (tmp_path / "cfg.json").write_text(TCFG.to_json())
    with pytest.warns(UserWarning, match="corrected semantics"):
        assert teval.main(["--config-json", str(tmp_path / "cfg.json"),
                           "--checkpoint", str(tmp_path / "m.pt"),
                           "--data", "synthetic", "--batch-size", "128",
                           "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _, val = ttrain.make_datasets("synthetic", TCFG, 0)
    u8 = np.stack([val.get_example(i)[0] for i in range(len(val))])
    labels = np.array([val.get_example(i)[1] for i in range(len(val))])
    pre = make_preprocess(out_size=16, mean=(0.5,) * 3, std=(0.5,) * 3,
                          random_flip=False)
    x = pre(torch.from_numpy(u8), None, train=False)
    pred = vitx_torch.forward(params, x, TCFG, device="cpu").argmax(-1)
    assert rep["epoch"] == 2 and rep["num_examples"] == len(val)
    assert rep["accuracy"] == pytest.approx(
        float((pred.numpy() == labels).mean()), abs=1e-12)
    with pytest.warns(UserWarning, match="corrected semantics"):
        srv = load_server(str(tmp_path / "m.pt"), TCFG, batch_size=4,
                          top_k=1, device="cpu")
    try:
        for i in range(3):
            assert srv.predict(x[i].numpy())["classes"][0] == int(pred[i])
    finally:
        srv.close()


@pytest.mark.parametrize("kind", ["ck", "ck/0.ckpt", "src.npz", "src.pt",
                                  "ckpt.npz"])
def test_train_cli_init_from_every_kind(sources, tmp_path, kind):
    """``--init-from`` takes a checkpoint directory, an {epoch}.ckpt, a bare
    .npz and a reference .pt: on CIFAR-10 batches (32², 10 classes) the
    trainer starts from what ``transfer_params`` gives for the CLI's config
    and seed (final_norm for the bare .npz only), then trains an epoch. A
    checkpoint saved under an .npz name is no bare .npz: it keeps the
    user's config and grafts what the .ckpt itself grafts."""
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    rng = np.random.default_rng(0)
    for name, n in [(f"data_batch_{i}", 4) for i in range(1, 6)] + [
            ("test_batch", 6)]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f,
                        protocol=2)
    (tmp_path / "cfg.json").write_text(TCFG.to_json())
    argv = ["--config-json", str(tmp_path / "cfg.json"), "--image-size",
            "32", "--data", f"cifar10:{cifar}", "--epochs", "1",
            "--batch-size", "8", "--seed", "3", "--device", "cpu",
            "--init-from", str(sources / kind)]
    parser = ttrain.build_argparser()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer, train_loader, eval_loader = ttrain.build_trainer(
            parser.parse_args(argv), parser)
        cfg = TCFG.replace(image_size=32, num_classes=10,
                           final_norm=kind == "src.npz")
        assert trainer.cfg == cfg
        want = tckpt.transfer_params(sources / kind, cfg, 3, device="cpu")
        if kind == "ckpt.npz":
            same = tckpt.transfer_params(sources / "ck" / "0.ckpt", cfg, 3,
                                         device="cpu")
            for a, b in zip(leaves(want), leaves(same)):
                assert torch.equal(a, b)
    got = trainer.state.params
    assert [k for k, _ in tckpt._sorted_leaves(got)] == \
        [k for k, _ in tckpt._sorted_leaves(want)]
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    hist = trainer.fit(train_loader, eval_loader)
    assert np.isfinite(hist[-1]["loss"])
