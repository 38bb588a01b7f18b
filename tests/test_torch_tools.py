"""The port's tune and bench CLIs and its parameter inspection
(vitx_torch.cli.tune, vitx_torch.cli.bench, vitx_torch.utils.debug) on
the CPU against vitx's: tune at tiny with ``--device cpu`` (batches 2 and
4, one iteration) printing vitx's keys and ``{"best": ...}`` line, a bad
candidate or an unported config as a row, an error while timing
propagated, ``--remat`` sweeping the policies and ``--unroll`` refused;
``BENCHES``' numbers and ``config`` strings equal vitx's, bench 10
(Soft-MoE) and bench 1 (with its dispatch rows) run on the CPU at reduced
sizes; ``param_summary`` and ``dump_params`` giving vitx's text."""

import io
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx.utils import debug as jdebug
from vitx_torch.cli import bench as tbench
from vitx_torch.cli import tune as ttune
from vitx_torch.train.step import leaves
from vitx_torch.utils import debug as tdebug

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ROW_KEYS = {"batch", "remat", "scan_unroll", "step_ms", "images_per_sec"}


def _lines(capsys) -> list:
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def test_tune_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "tune.json"
    rc = ttune.main(["--preset", "tiny", "--mode", "infer", "--batches",
                     "2,4", "--iters", "1", "--reps", "1", "--device", "cpu",
                     "--out", str(out)])
    rows = _lines(capsys)
    assert rc == 0 and len(rows) == 3
    cfg = vitx_torch.get_config("tiny")
    for row, b in zip(rows, (2, 4)):
        assert set(row) == ROW_KEYS and row["batch"] == b
        assert (row["remat"], row["scan_unroll"]) == (cfg.remat,
                                                      cfg.scan_unroll)
        assert row["images_per_sec"] == pytest.approx(
            b / row["step_ms"] * 1e3)
    best = rows[-1]
    assert best["best"] in rows[:2] and best["mode"] == "infer"
    assert (best["device"], best["candidates"], best["failed"]) == ("cpu",
                                                                    2, 0)
    assert json.loads(out.read_text())["results"] == rows[:2]


def test_tune_bad_candidate_is_a_row(capsys):
    """A refused candidate becomes a row with an "error" field; a train
    sweep's good one still times."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32")
    rows = ttune.run_sweep(cfg, "train", [0, 2], 1, 1, device="cpu")
    assert "error" in rows[0] and rows[0]["error"].startswith("ValueError")
    assert set(rows[1]) == ROW_KEYS
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] \
        == rows


def test_tune_unported_config_is_a_row(capsys):
    """A config the port still refuses (an expert-parallel Soft-MoE model,
    whose mesh waits for ROADMAP A13) is a row for each batch."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32",
                                moe_experts=2, ep=True)
    rows = ttune.run_sweep(cfg, "infer", [2, 4], 1, 1, device="cpu")
    assert [r["error"].split(":")[0] for r in rows] \
        == ["NotImplementedError"] * 2
    assert "A13" in rows[0]["error"]


def test_tune_timing_error_propagates(monkeypatch):
    """An error raised while a candidate times, a wrapper's ValueError
    among them, is not turned into a row."""
    def fail(*args, **kwargs):
        raise ValueError("fused_mha_block runs on cuda or cpu, not meta")

    monkeypatch.setattr(ttune, "forward_timing", fail)
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ttune.run_sweep(cfg, "infer", [2], 1, 1, device="cpu")


@pytest.mark.parametrize("flag", ["--remat", "--unroll"])
def test_tune_refuses_remat_and_unroll(flag, capsys):
    """``--unroll`` exits: the port has no scan to unroll. ``--remat``,
    refused until the policies were ported, sweeps them: a row per
    (batch, policy) with vitx's keys, the unknown policy an error row."""
    argv = ["--preset", "tiny", "--device", "cpu", "--mode", "train",
            "--batches", "2", "--iters", "1", "--reps", "1"]
    if flag == "--unroll":
        with pytest.raises(SystemExit, match="no scan to unroll"):
            ttune.main(argv + [flag, "1"])
        return
    assert ttune.main(argv + [flag, "none,block,save_stash,bogus"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rows, best = lines[:-1], lines[-1]
    assert [r["remat"] for r in rows] == ["none", "block", "save_stash",
                                          "bogus"]
    assert all(set(r) == {"batch", "remat", "scan_unroll", "step_ms",
                          "images_per_sec"} for r in rows[:3])
    assert "unknown remat" in rows[3]["error"]
    assert best["candidates"] == 4 and best["failed"] == 1


def _configs(src: str) -> dict:
    """bench number -> its config string in a bench CLI's source (vitx's
    dp{n} strings at one device)."""
    found = re.findall(r'"config": f?"(\d+):([^"]*)"', src)
    return {int(n): f"{n}:{s}".replace("{n}", "1") for n, s in found}


def test_benches_are_vitx_benches(monkeypatch):
    from vitx.cli import bench as jbench_src  # noqa: F401  importable

    want = _configs((ROOT / "vitx/cli/bench.py").read_text())
    got = _configs((ROOT / "vitx_torch/cli/bench.py").read_text())
    assert sorted(tbench.BENCHES) == sorted(jbench_src.BENCHES)
    assert got == want
    # bench 10 (Soft-MoE) at a reduced size on the CPU, as bench 1 runs:
    # vitx's keys, each with its median
    cfg = vitx_torch.get_config("tiny", depth=2, image_size=32,
                                moe_experts=2, moe_blocks=1,
                                compute_dtype="float32")
    monkeypatch.setattr(vitx_torch.core.config, "get_config",
                        lambda *a, **k: cfg)
    out = tbench.bench_10(device="cpu", iters=1, reps=2)
    assert out["config"] == "10:vit-b16-softmoe-e8x6"
    assert out["device"] == "cpu"
    assert out["params_millions"] == pytest.approx(sum(
        t.numel() for t in leaves(vitx_torch.init_params(
            0, cfg, device="cpu"))) / 1e6)
    for k in ("infer_step_ms", "train_step_ms"):
        assert 0 < out[k] <= out[f"{k}_median"]
    assert out["train_images_per_sec"] == pytest.approx(
        128 / out["train_step_ms"] * 1e3)


def test_bench_1_on_cpu():
    """bench 1 at one iteration (one dispatch) a timing: vitx's keys, its
    dispatch rows k 1, 4 and 16 included, each with its median, on the
    named device."""
    out = tbench.bench_1(device="cpu", iters=1, reps=2)
    assert out["config"] == "1:vit-tiny-64" and out["device"] == "cpu"
    for k in ("forward_ms", "train_step_ms", "train_step_ms_k1",
              "train_step_ms_k4", "train_step_ms_k16"):
        assert 0 < out[k] <= out[f"{k}_median"]
    assert out["train_images_per_sec"] == pytest.approx(
        8 / out["train_step_ms"] * 1e3)
    for k in (1, 4, 16):
        assert out[f"train_images_per_sec_k{k}"] == pytest.approx(
            8 / out[f"train_step_ms_k{k}"] * 1e3)


def test_timed_counts_calls():
    calls = []
    runs = tbench.timed(lambda: calls.append(1), 3, 2, torch.device("cpu"),
                        warmup=1)
    assert len(runs) == 2 and len(calls) == 1 + 3 * 2


def test_param_summary_is_vitx_text():
    jcfg = vitx.get_config("tiny", depth=2)
    tcfg = vitx_torch.get_config("tiny", depth=2)
    jp = vitx.init_params(jax.random.PRNGKey(0), jcfg)
    tp = vitx_torch.params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    assert tdebug.param_summary(tp) == jdebug.param_summary(jp)
    assert "float32" in tdebug.param_summary(tp)
    small = {"a": tp["head"]["b2"], "b": {"c": tp["cls_token"][0, 0, :4]}}
    jsmall = jax.tree.map(lambda t: np.asarray(t), small)
    tbuf, jbuf = io.StringIO(), io.StringIO()
    tdebug.dump_params(small, max_full=8, file=tbuf)
    jdebug.dump_params(jsmall, max_full=8, file=jbuf)
    assert tbuf.getvalue() == jbuf.getvalue()
