"""Serving CLI: ``python -m vitx_torch.cli.serve --preset base16``

A stdlib HTTP front end over ``vitx_torch.serve.InferenceServer``, the
counterpart of ``vitx/cli/serve.py``. Endpoints:

- ``POST /predict``: the body is a float32 (H, W, C) image (``.npy`` bytes
  or raw little-endian floats); the answer is JSON ``{"probs": [...],
  "classes": [...]}`` for the top-k classes.
- ``POST /explain[?method=rollout|gradcam&class=K]``: the same body; the
  answer adds ``heatmap`` (patch-grid weights, row-major), ``grid`` and
  ``method``. ``rollout`` is class-agnostic attention rollout, ``gradcam``
  class-specific Grad-CAM (``class`` defaults to the prediction). 400 on
  a bad method, class or image, 503 when 4 explains are in flight.
- ``GET /stats``: JSON throughput / latency / occupancy counters.
- ``GET /metrics``: the same counters in Prometheus text format.
- ``GET /healthz``: 200 once the model is warmed up and serving.

``--checkpoint`` takes any artifact the eval CLI reads (an int8
``.quant.npz`` serves dequantized) or a ``.pt2`` program from ``eval
--export-pt2`` (served through the program; ``/explain`` then answers
400, and a ToMe program's pinned batch must be ``--batch-size``).
``--device`` selects the device (default ``cuda``; the server refuses to
start without one unless ``--device cpu`` is given). ``--dp N`` serves
over a data mesh of N ranks (``InferenceServer(mesh=...)``): this process
is rank 0 and keeps the front end, N - 1 rank processes beside it run
their rows of every batch, and they stop when the server does (SIGINT or
SIGTERM here). ``--tome-r`` serves
``/predict`` from the ToMe encoder: ``13`` merges 13 token pairs in every
block, ``35,34`` follows a per-block schedule, ``to128`` resolves to
vitx's schedule reaching 128 tokens (``aligned_schedule``); ``/explain``
runs every token.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from vitx_torch.core.config import PRESETS
from vitx_torch.nn.tome import parse_tome_r
from vitx_torch.serve import ServerOverloaded, load_server
from vitx_torch.train.checkpoint import resolve_artifact_config


def make_handler(server):
    cfg = server.cfg

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):            # quiet access log
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code, payload: dict):
            self._send(code, json.dumps(payload).encode(),
                       "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                self._reply(200, server.stats.summary())
            elif self.path == "/metrics":
                s = server.stats.summary()
                lines = []
                for name, key in (("requests_total", "requests"),
                                  ("batches_total", "batches"),
                                  ("rejected_total", "rejected"),
                                  ("explains_total", "explains")):
                    lines.append(f"# TYPE vitx_{name} counter")
                    lines.append(f"vitx_{name} {s[key]}")
                lines.append("# TYPE vitx_batch_occupancy gauge")
                lines.append(f"vitx_batch_occupancy {s['batch_occupancy']}")
                lines.append("# TYPE vitx_latency_ms summary")
                for q, key in (("0.5", "p50_ms"), ("0.9", "p90_ms"),
                               ("0.99", "p99_ms")):
                    lines.append(
                        f'vitx_latency_ms{{quantile="{q}"}} {s[key]}')
                self._send(200, ("\n".join(lines) + "\n").encode(),
                           "text/plain; version=0.0.4")
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/predict", "/explain"):
                self._reply(404, {"error": "unknown path"})
                return
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            try:
                if raw[:6] == b"\x93NUMPY":
                    img = np.load(io.BytesIO(raw))
                else:
                    img = np.frombuffer(raw, np.float32).reshape(
                        cfg.image_size, cfg.image_size, cfg.num_channels)
                img = np.asarray(img, np.float32)
                if url.path == "/predict":
                    out = server.predict(img)
                else:
                    q = parse_qs(url.query)
                    cls = q.get("class", [None])[0]
                    out = server.explain(
                        img, method=q.get("method", ["rollout"])[0],
                        class_idx=None if cls is None else int(cls))
                self._reply(200, out)
            except ServerOverloaded as e:
                self._reply(503, {"error": f"{type(e).__name__}: {e}"})
            except (ValueError, RuntimeError, TimeoutError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(prog="vitx_torch.serve")
    p.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    p.add_argument("--config-json", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="vitx checkpoint directory or {epoch}.ckpt (the "
                        "EMA shadow where the run kept one; the config "
                        "from its meta), an int8 .quant.npz, a .pt2 "
                        "program (eval --export-pt2), a bare params .npz "
                        "(vitx.cli.pretrain --export-vit) or a reference "
                        ".pt (at --preset's or --config-json's geometry); "
                        "omit for fresh params")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8808)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--dp", type=int, default=None,
                   help="serve over a data-parallel mesh of this many "
                        "ranks (batch-size must divide)")
    p.add_argument("--temperature", type=float, default=None,
                   help="temperature-scale the served probabilities")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: cuda)")
    p.add_argument("--tome-r", type=parse_tome_r, default=0,
                   help="ToMe token merging for /predict: pairs merged per "
                        "block, a comma-separated per-block schedule, or "
                        "'toN' (e.g. to128)")
    args = p.parse_args(argv)
    if args.dp is not None:
        from vitx_torch.parallel import lead

        return lead(serve_rank, args.dp, (args,), device=args.device)[0]
    return serve(args)


def serve_rank(ctx, args) -> int:
    """One rank of ``--dp``: rank 0 serves (``serve``), the others run
    ``serve_worker`` until it stops; they leave SIGINT to rank 0."""
    import signal

    from vitx_torch.parallel import make_mesh
    from vitx_torch.serve import load_params, serve_worker

    mesh = make_mesh(args.dp, device=ctx.device)
    if ctx.rank == 0:
        return serve(args, mesh)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    cfg = resolve_artifact_config(args.checkpoint, args.config_json,
                                  args.preset, args.tome_r)
    params, cfg = load_params(args.checkpoint, cfg, mesh.device)
    serve_worker(params, cfg, mesh, args.batch_size)
    return 0


def serve(args, mesh=None) -> int:
    """Load the server (rank 0 of ``mesh``) and answer HTTP until SIGINT
    or SIGTERM."""
    import signal

    cfg = resolve_artifact_config(args.checkpoint, args.config_json,
                                  args.preset, args.tome_r)
    server = load_server(args.checkpoint, cfg, batch_size=args.batch_size,
                         top_k=args.top_k, max_delay_ms=args.max_delay_ms,
                         temperature=args.temperature, device=args.device,
                         mesh=mesh)
    if mesh is not None:
        # SIGTERM stops the server as SIGINT does, and the ranks with it
        signal.signal(signal.SIGTERM, signal.default_int_handler)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    dp = f", dp {mesh.dp}" if mesh is not None else ""
    print(f"serving {args.preset} on http://{args.host}:{httpd.server_port} "
          f"(batch {args.batch_size}, top-{server.top_k}, "
          f"tome_r={cfg.tome_r}, {server.device}{dp})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()
    return 0


def serve_in_thread(server, host="127.0.0.1", port=0):
    """Start the HTTP front end on a background thread (tests, embedding).
    Returns (httpd, thread); ``httpd.server_port`` has the bound port."""
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


if __name__ == "__main__":
    sys.exit(main())
