"""Serving, probing and bench 4 over a data mesh of rank processes, and
the train CLI's pipeline, on the CPU (gloo).

``InferenceServer(mesh=...)``: rank 0 keeps the batcher, each data rank
runs its rows and the logits are gathered (``serve.mesh_logits``, held to
the one-process forward at 1e-5); the answers equal the one-process
server's; ``cli.serve --dp 2`` answers HTTP requests with the
one-process server's top-k and stops its ranks on SIGINT; bench 4's dp
row runs two ranks (``cli.probe --dp 2`` is held to one process in
``tests/test_torch_probe.py``); ``cli.train --pp 2`` trains, writes a
``.ckpt`` and resumes under 1F1B (``tests/test_torch_pipeline.py`` holds
the steps to vitx's). The references are the port's own one-process
paths, which ``tests/test_torch_serve.py`` holds to vitx.
"""

import io
import json
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import vitx_torch
from vitx_torch.nn.vit import init_params, model_logits, param_spec
from vitx_torch.parallel import spawn
from vitx_torch.serve import InferenceServer

from tests import torch_pipeline_helpers as H
from tests.torch_pretrain_helpers import draw

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _images(n, size, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _close(got, want):
    assert got["classes"] == want["classes"]
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                               atol=TOL)


def test_mesh_server_matches_one_process(tmp_path):
    """Two ranks: the split forward's logits within 1e-5 of one process's
    and the server's answers its (top-k classes equal, probabilities
    within 1e-5); rank 1 ran every batch and stopped with the server."""
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32",
                                image_size=32)
    params = draw(param_spec(cfg), 4)
    pl = {"cfg": cfg.to_json(), "params": params, "batch_size": 4,
          "images": _images(4, 32)}
    got, ran = spawn(H.run_mesh_server, 2, (pl,), device="cpu",
                     init_method=f"file://{tmp_path / 'rdv'}")
    tparams = H.to_torch(params)
    with torch.inference_mode():
        want = model_logits(tparams, torch.from_numpy(pl["images"]), cfg)
    np.testing.assert_allclose(got["logits"], want.numpy(), rtol=0,
                               atol=TOL)
    with InferenceServer(tparams, cfg, batch_size=4, device="cpu") as srv:
        for im, answer in zip(pl["images"], got["answers"]):
            _close(answer, srv.predict(im))
    assert ran >= 1


def test_serve_cli_dp2_answers_and_stops():
    """``cli.serve --dp 2``: the front end on rank 0 answers /predict with
    the one-process server's top-k; SIGINT stops it and its rank."""
    cfg = vitx_torch.get_config("tiny")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vitx_torch.cli.serve", "--preset", "tiny",
         "--device", "cpu", "--dp", "2", "--port", "0", "--batch-size",
         "4"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("serving"):
                port = int(line.split(":")[2].split()[0])
                assert "dp 2" in line
                break
        assert port is not None, proc.stderr.read()
        answers = []
        for im in _images(3, cfg.image_size):
            buf = io.BytesIO()
            np.save(buf, im)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.loads(r.read()))
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    with InferenceServer(init_params(0, cfg, device="cpu"), cfg,
                         batch_size=4, device="cpu") as srv:
        for im, answer in zip(_images(3, cfg.image_size), answers):
            _close(answer, srv.predict(im))


def test_bench_4_dp2_row():
    """Bench 4 at two data ranks (gloo on the CPU, cut to tiny): vitx's
    config name with ``dp2``, the global batch's rate."""
    from vitx_torch.cli import bench

    cfg = vitx_torch.get_config("tiny", compute_dtype="float32")
    row = bench.bench_4(device="cpu", iters=1, reps=1, devices=2,
                        per_device_batch=2, cfg=cfg)
    assert row["config"] == "4:vit-b16-train-dp2"
    assert (row["devices"], row["per_device_batch"]) == (2, 2)
    assert row["step_ms"] > 0
    assert row["images_per_sec"] == pytest.approx(4 / row["step_ms"] * 1e3)


def test_train_cli_pp_end_to_end_and_resume(tmp_path, capfd, monkeypatch):
    """``cli.train --pp 2`` (GPipe, 2 stage ranks) trains an epoch and
    writes a ``.ckpt``; ``--pp 2 --pp-schedule 1f1b --epochs 2`` resumes
    from it and writes the next, which ``cli.eval`` reads in one process."""
    from vitx_torch.cli import eval as teval
    from vitx_torch.cli import train as ttrain
    from vitx_torch.train.checkpoint import peek_meta

    monkeypatch.setenv("VITX_PROC_CACHE", str(tmp_path / "proc"))
    ck = str(tmp_path / "ck")
    argv = ["--preset", "tiny", "--image-size", "32", "--data",
            "procedural:32,16", "--batch-size", "8", "--device", "cpu",
            "--checkpoint-dir", ck, "--pp", "2", "--pp-microbatches", "2"]
    assert ttrain.main(argv + ["--epochs", "1"]) == 0
    assert peek_meta(ck)["epoch"] == 0
    capfd.readouterr()
    assert ttrain.main(argv + ["--epochs", "2", "--pp-schedule",
                               "1f1b"]) == 0
    out = capfd.readouterr().out
    assert "resumed from epoch 0" in out and "epoch 1:" in out
    assert peek_meta(ck)["epoch"] == 1
    assert teval.main(["--checkpoint", ck, "--data", "procedural:32,16",
                       "--device", "cpu"]) == 0
