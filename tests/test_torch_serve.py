"""The port's serving layer (vitx_torch.serve, vitx_torch.cli.serve) on the
CPU: dynamic batching, top-k against a direct forward, stats, the queue
bound, the HTTP front end with ``/explain`` (its rollout heatmap held to
vitx's ``forward_with_rollout`` on the same params) and artifact
loading."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from vitx_torch.cli.serve import serve_in_thread
from vitx_torch.serve import InferenceServer, ServerOverloaded, load_server

torch.set_num_threads(1)

CFG = vitx_torch.get_config("tiny", compute_dtype="float32")
JCFG = vitx.get_config("tiny", compute_dtype="float32")


def _img(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (CFG.image_size, CFG.image_size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return vitx_torch.init_params(0, CFG, device="cpu")


def _direct_topk(params, imgs, k):
    logits = vitx_torch.forward(params, np.stack(imgs), CFG, device="cpu")
    probs, classes = torch.topk(torch.softmax(logits, -1), k)
    return probs.numpy(), classes.numpy()


def test_concurrent_predict_matches_direct_forward(params):
    """8 concurrent clients get the top-k of a direct forward; the
    collector batches them and the stats count every request."""
    imgs = [_img(i) for i in range(8)]
    results = [None] * 8
    with InferenceServer(params, CFG, batch_size=8, top_k=3,
                         max_delay_ms=50.0, device="cpu") as srv:
        def call(i):
            results[i] = srv.predict(imgs[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        s = srv.stats.summary()
    probs, classes = _direct_topk(params, imgs, 3)
    for i in range(8):
        assert results[i]["classes"][0] == int(classes[i, 0])
        np.testing.assert_allclose(results[i]["probs"][0], probs[i, 0],
                                   rtol=1e-5)
        assert results[i]["probs"] == sorted(results[i]["probs"],
                                             reverse=True)
    assert s["requests"] == 8
    assert s["batches"] < 8
    assert 0 < s["batch_occupancy"] <= 1
    assert s["p50_ms"] <= s["p90_ms"] <= s["p99_ms"]


def test_queue_bound_raises_overloaded(params):
    srv = InferenceServer(params, CFG, batch_size=2, max_queue=1,
                          device="cpu")
    srv.close()               # no collector: the queue can only fill
    srv._queue.put_nowait(object())
    with pytest.raises(ServerOverloaded):
        srv.predict(_img(0))
    assert srv.stats.summary()["rejected"] == 1


def test_explain_bound_raises_overloaded(params):
    """Beyond 4 explains in flight, explain raises ServerOverloaded and
    counts a rejection; a freed slot serves again."""
    with InferenceServer(params, CFG, batch_size=2, device="cpu") as srv:
        for _ in range(4):
            assert srv._explain_slots.acquire(blocking=False)
        with pytest.raises(ServerOverloaded):
            srv.explain(_img(0))
        assert srv.stats.summary()["rejected"] == 1
        srv._explain_slots.release()
        out = srv.explain(_img(0), method="gradcam")
        assert out["method"] == "gradcam"
        assert srv.stats.summary()["explains"] == 1


def test_shape_validation(params):
    with InferenceServer(params, CFG, batch_size=2, device="cpu") as srv:
        with pytest.raises(ValueError):
            srv.predict(np.zeros((8, 8, 3), np.float32))


def test_http_front_end():
    """/healthz, /predict (npy and raw bodies), /stats, /metrics and
    /explain, on weights made by vitx and carried across with
    ``params_from_jax``."""
    rng = np.random.default_rng(11)
    pn = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.02 *
                      rng.standard_normal(a.shape).astype(np.float32),
                      vitx.init_params(jax.random.PRNGKey(0), JCFG))
    params = vitx_torch.params_from_jax(pn, CFG, "cpu")
    with InferenceServer(params, CFG, batch_size=2, top_k=2,
                         device="cpu") as srv:
        httpd, _ = serve_in_thread(srv)
        base = f"http://127.0.0.1:{httpd.server_port}"
        try:
            ok = json.loads(urllib.request.urlopen(base + "/healthz").read())
            assert ok["status"] == "ok"
            img = _img(9)
            buf = io.BytesIO()
            np.save(buf, img)
            req = urllib.request.Request(base + "/predict",
                                         data=buf.getvalue(), method="POST")
            out = json.loads(urllib.request.urlopen(req).read())
            assert out["classes"][0] == int(_direct_topk(params, [img],
                                                         2)[1][0, 0])
            req = urllib.request.Request(base + "/predict",
                                         data=img.tobytes(), method="POST")
            assert json.loads(urllib.request.urlopen(req).read())[
                "classes"] == out["classes"]
            stats = json.loads(urllib.request.urlopen(base + "/stats").read())
            assert stats["requests"] == 2
            metrics = urllib.request.urlopen(base + "/metrics").read()
            assert b"vitx_requests_total 2" in metrics
            explains = {}
            for query in ("", "?method=gradcam", "?method=gradcam&class=3"):
                req = urllib.request.Request(base + "/explain" + query,
                                             data=buf.getvalue(),
                                             method="POST")
                explains[query] = json.loads(urllib.request.urlopen(req)
                                             .read())
            for query, out in explains.items():
                assert sorted(out) == ["classes", "grid", "heatmap",
                                       "method", "probs"]
                assert out["grid"] == CFG.grid_size
                assert len(out["heatmap"]) == CFG.grid_size ** 2
                assert out["classes"] == explains[""]["classes"]
                assert out["method"] == ("gradcam" if "gradcam" in query
                                         else "rollout")
            cam, _ = vitx_torch.grad_cam(params, img[None], CFG, class_idx=3,
                                         device="cpu")
            np.testing.assert_allclose(
                explains["?method=gradcam&class=3"]["heatmap"], cam[0],
                rtol=1e-6, atol=1e-9)
            # the rollout heatmap against vitx on the same params
            _, ref = vitx.forward_with_rollout(
                jax.tree.map(jnp.asarray, pn), jnp.asarray(img[None]), JCFG)
            np.testing.assert_allclose(explains[""]["heatmap"],
                                       np.asarray(ref)[0], rtol=1e-4,
                                       atol=1e-6)
            for query in ("?method=bad", "?method=rollout&class=1",
                          "?method=gradcam&class=4", "?method=gradcam&class=x"):
                req = urllib.request.Request(base + "/explain" + query,
                                             data=buf.getvalue(),
                                             method="POST")
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(req)
                assert e.value.code == 400, query
            metrics = urllib.request.urlopen(base + "/metrics").read()
            assert b"vitx_explains_total 3" in metrics
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_load_server_from_export_npz(tmp_path, params):
    path = tmp_path / "vit.npz"

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), v.numpy()

    np.savez(path, **dict(flat(params)))
    srv = load_server(str(path), CFG, batch_size=2, top_k=1, device="cpu")
    try:
        img = _img(7)
        out = srv.predict(img)
        assert out["classes"][0] == int(_direct_topk(params, [img], 1)[1][0, 0])
    finally:
        srv.close()


@pytest.mark.parametrize("name,exc,item", [
    ("m.quant.npz", FileNotFoundError, "m.quant.npz"),
    ("m.stablehlo", NotImplementedError, r"\.pt2"),
    ("3.orbax", NotImplementedError, "JAX stack")])
def test_load_server_unported_artifacts(name, exc, item):
    """vitx's .stablehlo programs and orbax directories need JAX; a
    .quant.npz is read now, so a missing one is refused by its path."""
    with pytest.raises(exc, match=item):
        load_server(name, CFG, device="cpu")
