"""Representation probing in the port (``forward_features``,
vitx_torch.cli.probe) on the CPU against vitx's (vitx/nn/vit.py:859-882,
vitx/cli/probe.py), at tiny size, depth 2, fp32: the features for both
pools (and ``bug_exact``'s patch-first layout) within 1e-4, the ridge
probe and the k-NN giving vitx's predictions on the same features, and
the probe CLI end to end on a ``.quant.npz`` beside vitx's on the same
file, with ``.pt2`` refused and ``--dp 2`` (two gloo ranks) giving one
process's features."""

import json

import jax
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.cli import probe as jprobe
from vitx_torch.cli import probe as tprobe

torch.set_num_threads(1)

JCFG = vitx.get_config("tiny", compute_dtype="float32", depth=2)
TCFG = vitx_torch.get_config("tiny", compute_dtype="float32", depth=2)
TOL = 1e-4


@pytest.mark.parametrize("pool,parity", [("cls", "corrected"),
                                         ("gap", "corrected"),
                                         ("gap", "bug_exact")])
def test_forward_features_matches_vitx(pool, parity):
    jcfg, tcfg = JCFG.replace(parity=parity), TCFG.replace(parity=parity)
    jp = vitx.init_params(jax.random.PRNGKey(0), jcfg)
    tp = vitx_torch.params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (3, 64, 64, 3)).astype(np.float32)
    got = vitx_torch.forward_features(tp, x, tcfg, pool=pool,
                                      device="cpu").numpy()
    want = np.asarray(vitx.forward_features(jp, x, jcfg, pool=pool))
    assert got.shape == (3, tcfg.embed_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="unknown pool"):
        vitx_torch.forward_features(tp, x, tcfg, pool="max", device="cpu")


def test_ridge_and_knn_match_vitx():
    """The same features through both packages' probes: equal
    predictions (the port copies vitx's numpy, float64 solve included)."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((4, 16))
    ytr = rng.integers(0, 4, 120)
    yte = rng.integers(0, 4, 40)
    xtr = (centers[ytr] + 0.8 * rng.standard_normal((120, 16))).astype(
        np.float32)
    xte = (centers[yte] + 0.8 * rng.standard_normal((40, 16))).astype(
        np.float32)
    for x in (xtr, xte):
        np.testing.assert_array_equal(
            tprobe.fit_linear_probe(xtr, ytr, 4)(x),
            jprobe.fit_linear_probe(xtr, ytr, 4)(x))
    for k in (1, 5, 500):
        np.testing.assert_array_equal(
            tprobe.knn_predict(xtr, ytr, xte, 4, k=k, chunk=16),
            jprobe.knn_predict(xtr, ytr, xte, 4, k=k, chunk=16))


def test_probe_cli_on_quantized_artifact(tmp_path, capsys, monkeypatch):
    """Both probe CLIs on one vitx ``.quant.npz`` over a small procedural
    split (10 classes): the same report up to the accuracies (within one
    example), the exported features within 1e-4; a ``.pt2`` is refused;
    ``--dp 2`` extracts the same features over two data ranks (1e-4)."""
    from vitx.quant import save_quantized

    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    jcfg = JCFG.replace(num_classes=10)
    jp = vitx.init_params(jax.random.PRNGKey(0), jcfg)
    art = tmp_path / "m.quant.npz"
    save_quantized(art, jp, meta={"config": json.loads(jcfg.to_json())})
    argv = ["--checkpoint", str(art), "--data", "procedural:64,32",
            "--batch-size", "32", "--knn", "5", "--pool", "gap"]
    assert tprobe.main(argv + ["--device", "cpu", "--features",
                               str(tmp_path / "t.npz")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jprobe.main(argv + ["--features", str(tmp_path / "j.npz")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    for k in ("pool", "dim", "num_train", "num_val", "knn_k"):
        assert got[k] == want[k], k
    for k in ("linear_probe_train_acc", "linear_probe_val_acc",
              "knn_val_acc"):
        assert abs(got[k] - want[k]) <= 1.0 / got["num_val"] + 1e-9, k
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        for k in ("train_features", "val_features"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=TOL)
        for k in ("train_labels", "val_labels"):
            np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(ValueError, match="no parameters"):
        tprobe.main(["--checkpoint", str(tmp_path / "m.pt2"),
                     "--device", "cpu"])
    assert tprobe.main(argv + ["--device", "cpu", "--dp", "2", "--features",
                               str(tmp_path / "d.npz")]) == 0
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "d.npz") as d:
        for k in ("train_features", "val_features"):
            np.testing.assert_allclose(d[k], t[k], rtol=0, atol=TOL)
        for k in ("train_labels", "val_labels"):
            np.testing.assert_array_equal(d[k], t[k])
