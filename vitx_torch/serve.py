"""Batched inference serving for the PyTorch port.

The counterpart of ``vitx/serve.py``: requests queue on the host, a
collector thread drains up to ``batch_size`` of them (waiting at most
``max_delay_ms`` after the first), pads them to ONE fixed batch shape, runs
one forward on the device (through the ToMe encoder when ``cfg.tome_r`` is
set) and fans the top-k results back out. Softmax and
top-k run on the device in fp32, so only k values per image return to the
host. The server warms up at start (which also builds the CUDA kernels),
tracks p50/p90/p99 latency with drift against a recent window, and bounds
its queue (``max_queue``) so overload raises ``ServerOverloaded`` instead of
growing the latency tail. ``explain`` answers one image with a heatmap
(attention rollout or Grad-CAM) outside the batcher. ``logits_fn`` serves
a program with the parameters baked in (a ``.pt2`` from
``vitx_torch.export``) in place of the forward; an int8 ``.quant.npz``
serves dequantized to float, as vitx's does.

``mesh`` (``vitx_torch.parallel.make_mesh``, vitx's mesh serving,
``vitx/serve.py:116-191``): the server runs on rank 0 of a data mesh,
which keeps the queue, the batcher and the front end; each batch goes to
every data rank (a broadcast of the padded batch), each runs the forward
on its rows and the logits are gathered back, and rank 0 takes the top-k.
The other ranks run ``serve_worker`` until rank 0's ``close`` tells them
to stop.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.nn.saliency import grad_cam
from vitx_torch.nn.vit import forward_with_rollout, init_params, \
    model_logits, params_to
from vitx_torch.parallel.mesh import DATA_AXIS

# the header rank 0 broadcasts to its data ranks before each batch
_STOP, _BATCH = 0, 1


class ServerOverloaded(RuntimeError):
    """Raised by ``predict`` when the request queue is at ``max_queue``."""


@dataclass
class ServerStats:
    """Counters and a bounded latency window; mutated under ``lock`` by the
    collector and the predict threads."""
    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    rejected: int = 0
    explains: int = 0
    window: int = 10_000
    recent_window: int = 1_000
    latencies_ms: deque = field(default=None)
    recent_ms: deque = field(default=None)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def __post_init__(self):
        if self.latencies_ms is None:
            self.latencies_ms = deque(maxlen=self.window)
        if self.recent_ms is None:
            self.recent_ms = deque(maxlen=self.recent_window)

    @staticmethod
    def _pct(lat, p):
        return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

    def summary(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies_ms)
            recent = sorted(self.recent_ms)
            requests, batches = self.requests, self.batches
            rejected, padded = self.rejected, self.padded_slots
            explains = self.explains
        occupancy = 0.0
        if requests + padded:
            occupancy = requests / (requests + padded)
        p50, p99 = self._pct(lat, 0.50), self._pct(lat, 0.99)
        p50_r, p99_r = self._pct(recent, 0.50), self._pct(recent, 0.99)
        return {"requests": requests, "batches": batches,
                "rejected": rejected, "explains": explains,
                "batch_occupancy": round(occupancy, 3),
                "p50_ms": round(p50, 2),
                "p90_ms": round(self._pct(lat, 0.90), 2),
                "p99_ms": round(p99, 2),
                # drift: the last-1k percentiles against the 10k window;
                # positive means the server is getting slower
                "p50_recent_ms": round(p50_r, 2),
                "p99_recent_ms": round(p99_r, 2),
                "p50_drift_ms": round(p50_r - p50, 2),
                "p99_drift_ms": round(p99_r - p99, 2)}


class _Pending:
    __slots__ = ("image", "event", "result", "error", "t0")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t0 = time.perf_counter()


class InferenceServer:
    """Dynamic-batching inference over one fixed-shape forward.

    ``predict(image)`` is thread-safe and blocking: it enqueues the (H, W, C)
    image, the collector folds it into the next device batch, and the call
    returns ``{"probs": [k], "classes": [k]}`` for the top-``k`` classes.
    """

    def __init__(self, params, cfg: ViTConfig, *, batch_size: int = 32,
                 top_k: int = 5, max_delay_ms: float = 5.0,
                 max_queue: int | None = None,
                 temperature: float | None = None, device="cuda",
                 logits_fn=None, mesh=None):
        """``max_queue``: beyond this many queued requests ``predict``
        raises ``ServerOverloaded`` (the HTTP front end answers 503).
        Default: 8 device batches. ``temperature`` scales the logits before
        the softmax (calibrated confidences; the top-k order is unchanged).
        ``device``: a CUDA device by default; raises when there is none.
        ``logits_fn``: images -> fp32 logits with the parameters baked in
        (an exported program's ``module()``), run in place of the forward;
        ``params`` is then ignored and ``explain`` refused. ``mesh``: this
        process is rank 0 of a data mesh (the module's doc), on the
        mesh's device; ``batch_size`` must divide over its data axis.
        """
        if mesh is not None:
            if logits_fn is not None:
                raise ValueError("logits_fn (.pt2 program) serving is "
                                 "single-device — re-export from the "
                                 "checkpoint for mesh serving")
            if batch_size % mesh.dp:
                raise ValueError(f"batch_size {batch_size} not divisible by "
                                 f"the mesh's data axis ({mesh.dp})")
            device = mesh.device
        self.mesh = mesh
        self._mesh_lock = threading.Lock()
        self._closed = False
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.top_k = min(top_k, cfg.num_classes)
        self.max_delay_s = max_delay_ms / 1000.0
        self.max_queue = (max_queue if max_queue is not None
                          else 8 * batch_size)
        self.temperature = temperature
        self.stats = ServerStats()
        self._queue: queue.Queue[_Pending] = queue.Queue(
            maxsize=self.max_queue)
        self._stop = threading.Event()
        self._logits_fn = logits_fn
        self._params = ({} if logits_fn is not None
                        else params_to(params, self.device))
        self._inv_t = 1.0 / temperature if temperature else 1.0
        # warm-up at the serving shape: the first request must not pay for
        # building the kernels or for allocator growth
        shape = (batch_size, cfg.image_size, cfg.image_size,
                 cfg.num_channels)
        self._run(torch.zeros(shape, dtype=cfg.cdtype(), device=self.device))
        # explain() bypasses the batcher: one at a time, and beyond 4 in
        # flight it raises ServerOverloaded instead of stacking threads
        self._explain_lock = threading.Lock()
        self._explain_slots = threading.Semaphore(4)
        self._thread = threading.Thread(target=self._collector, daemon=True)
        self._thread.start()

    def _run(self, images):
        """images on the device -> (values (B, k), indices (B, k)) on the
        host: the forward (ToMe-merged when ``cfg.tome_r`` is set, as
        vitx's server runs ``vitx.nn.vit.forward``), fp32 softmax and top-k
        on the device."""
        with torch.inference_mode():
            if self._logits_fn is not None:
                return self._topk(self._logits_fn(images))
            if self.mesh is not None:
                with self._mesh_lock:
                    _broadcast_header(self.mesh, _BATCH)
                    return self._topk(mesh_logits(self._params, images,
                                                  self.cfg, self.mesh))
            return self._topk(model_logits(self._params, images, self.cfg))

    def _topk(self, logits):
        probs = torch.softmax(logits.float() * self._inv_t, dim=-1)
        values, indices = torch.topk(probs, self.top_k, dim=-1)
        return values.cpu().numpy(), indices.cpu().numpy()

    def explain(self, image: np.ndarray, *, method: str = "rollout",
                class_idx: int | None = None) -> dict:
        """One image's top-k classes and a patch-grid heatmap
        (``vitx/serve.py:212-305``).

        ``method="rollout"``: class-agnostic attention rollout
        (``forward_with_rollout``, where CLS looked). ``method="gradcam"``:
        class-specific Grad-CAM (``grad_cam``) for ``class_idx``, by
        default the predicted class. Runs at batch 1 outside the batcher,
        one call at a time; beyond 4 in flight it raises
        ``ServerOverloaded``. Returns predict's fields plus ``heatmap``
        ((grid*grid,) patch-raster weights), ``method`` and ``grid``; the
        HTTP front end serves it as ``POST /explain``.
        """
        if self._logits_fn is not None:
            raise RuntimeError(
                "explain() needs the model's forward; an exported program "
                "bakes only the logits -- serve the checkpoint itself to use "
                "/explain")
        if method not in ("rollout", "gradcam"):
            raise ValueError(f"unknown explain method {method!r} "
                             "(rollout or gradcam)")
        if class_idx is not None:
            if method != "gradcam":
                raise ValueError("class selection needs method='gradcam' "
                                 "(rollout is class-agnostic)")
            if not 0 <= int(class_idx) < self.cfg.num_classes:
                raise ValueError(f"class_idx {class_idx} out of range "
                                 f"[0, {self.cfg.num_classes})")
        expect = (self.cfg.image_size, self.cfg.image_size,
                  self.cfg.num_channels)
        if tuple(image.shape) != expect:
            raise ValueError(f"expected image shape {expect}, "
                             f"got {tuple(image.shape)}")
        if not self._explain_slots.acquire(blocking=False):
            with self.stats.lock:
                self.stats.rejected += 1
            raise ServerOverloaded("too many in-flight explain requests")
        try:
            x = torch.from_numpy(np.array(image, np.float32)[None]).to(
                self.device).to(self.cfg.cdtype())
            with self._explain_lock:
                if method == "rollout":
                    logits, heat = forward_with_rollout(
                        self._params, x, self.cfg, device=self.device)
                else:
                    heat, logits = grad_cam(
                        self._params, x, self.cfg, device=self.device,
                        class_idx=(None if class_idx is None
                                   else int(class_idx)))
                values, indices = self._topk(logits)
                heat = heat.float().cpu().numpy()
        finally:
            self._explain_slots.release()
        with self.stats.lock:
            self.stats.explains += 1
        return {"probs": values[0].tolist(), "classes": indices[0].tolist(),
                "heatmap": heat[0].tolist(), "method": method,
                "grid": self.cfg.grid_size}

    def predict(self, image: np.ndarray, timeout: float = 30.0) -> dict:
        """image: (H, W, C) float array in model input scale."""
        expect = (self.cfg.image_size, self.cfg.image_size,
                  self.cfg.num_channels)
        if tuple(image.shape) != expect:
            raise ValueError(f"expected image shape {expect}, "
                             f"got {tuple(image.shape)}")
        item = _Pending(np.asarray(image, np.float32))
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            with self.stats.lock:
                self.stats.rejected += 1
            raise ServerOverloaded(
                f"queue full ({self.max_queue} pending)") from None
        if not item.event.wait(timeout):
            raise TimeoutError("inference request timed out")
        if item.error is not None:
            raise RuntimeError(f"inference failed: {item.error}")
        return item.result

    def close(self):
        """Stop the collector; on a mesh, then tell the data ranks to stop
        (once, after any batch in flight)."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self.mesh is not None:
            with self._mesh_lock:
                if not self._closed:
                    _broadcast_header(self.mesh, _STOP)
                    self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _collector(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_delay_s
            while len(batch) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_batch(batch)
            except Exception as e:   # noqa: BLE001 -- hand to the waiters
                for item in batch:
                    item.error = e
                    item.event.set()

    def _run_batch(self, batch):
        n = len(batch)
        pad = self.batch_size - n
        images = np.stack([b.image for b in batch])
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], np.float32)])
        values, indices = self._run(
            torch.from_numpy(images).to(self.device).to(self.cfg.cdtype()))
        now = time.perf_counter()
        with self.stats.lock:
            for item in batch:
                ms = (now - item.t0) * 1000.0
                self.stats.latencies_ms.append(ms)
                self.stats.recent_ms.append(ms)
            self.stats.requests += n
            self.stats.batches += 1
            self.stats.padded_slots += pad
        for i, item in enumerate(batch):
            item.result = {"probs": values[i].tolist(),
                           "classes": indices[i].tolist()}
            item.event.set()


def _broadcast_header(mesh, cmd: int = _STOP) -> int:
    """Rank 0's next command (``_BATCH`` or ``_STOP``) to every data rank
    -> the command (on the other ranks, ``cmd`` is overwritten)."""
    head = torch.tensor([cmd], dtype=torch.int64, device=mesh.device)
    group = mesh.group(DATA_AXIS)
    if group is not None:
        torch.distributed.broadcast(head, src=0, group=group)
    return int(head.item())


def mesh_logits(params, images, cfg: ViTConfig, mesh):
    """One batch on every data rank: rank 0's images broadcast, each rank's
    rows (a contiguous block) through the forward, the logits gathered
    in row order (the same on every rank)."""
    from vitx_torch.parallel import comm

    group = mesh.group(DATA_AXIS)
    if group is not None:
        torch.distributed.broadcast(images, src=0, group=group)
    rows = comm.chunk_of(images, mesh, DATA_AXIS, 0)
    logits = model_logits(params, rows, cfg).float()
    return comm.all_gather_cat(logits, mesh, DATA_AXIS, 0)


def serve_worker(params, cfg: ViTConfig, mesh, batch_size: int) -> int:
    """A data rank other than 0 of a mesh server: runs its rows of each
    batch rank 0 sends until rank 0 closes -> the batches it ran."""
    params = params_to(params, mesh.device)
    images = torch.empty((batch_size, cfg.image_size, cfg.image_size,
                          cfg.num_channels), dtype=cfg.cdtype(),
                         device=mesh.device)
    n = 0
    with torch.inference_mode():
        while _broadcast_header(mesh) == _BATCH:
            mesh_logits(params, images, cfg, mesh)
            n += 1
    return n


def load_params(checkpoint, cfg: ViTConfig, device) -> tuple:
    """(params, cfg) a server serves from ``checkpoint`` (not a ``.pt2``):
    ``load_server``'s rule."""
    from vitx_torch.train.checkpoint import load_artifact_params

    if checkpoint is None:
        return init_params(0, cfg, device=device), cfg
    from vitx_torch.nn.lora import merge_lora_params

    params, _ = load_artifact_params(checkpoint, cfg, device=device)
    # a LoRA run's adapters fold in once, not in every forward
    return merge_lora_params(params, cfg)


def load_server(checkpoint, cfg: ViTConfig, *, device="cuda", mesh=None,
                **kw) -> InferenceServer:
    """A server from ``None`` (fresh parameters, seed 0), a vitx checkpoint
    directory or ``{epoch}.ckpt`` (the EMA shadow where the run kept one),
    an int8 ``.quant.npz`` (dequantized), a bare params ``.npz``
    (``vitx.cli.pretrain --export-vit``) or a reference ``.pt``, by the
    eval CLI's loading rule (``train.checkpoint.load_artifact_params``;
    a LoRA run's adapters folded into its weights),
    or a ``.pt2`` program (``vitx_torch.export``, served through its
    module with vitx's guards, ``vitx/serve.py:403-419``: a program that
    returns probabilities is refused, a pinned batch must be the
    server's). vitx's ``.stablehlo`` programs and orbax directories need
    JAX. ``mesh``: rank 0 of a data mesh (``InferenceServer``), which
    refuses a ``.pt2`` program."""
    dev = resolve_device(device if mesh is None else mesh.device)
    if checkpoint is not None and str(checkpoint).endswith(".pt2"):
        if mesh is not None:
            raise ValueError("logits_fn (.pt2 program) serving is "
                             "single-device — re-export from the "
                             "checkpoint for mesh serving")
        from vitx_torch.export import load_exported
        from vitx_torch.export import peek_meta as peek_export_meta

        meta = peek_export_meta(checkpoint) or {}
        if meta.get("with_softmax"):
            raise ValueError(
                "this program was exported with_softmax=True (it returns "
                "probabilities); export logits for serving -- the server "
                "applies softmax and temperature itself")
        pinned = meta.get("batch_size")
        if pinned is not None and pinned != kw.get("batch_size", 32):
            raise ValueError(
                f"program pins batch_size={pinned} (ToMe export); pass "
                f"batch_size={pinned} to serve it")
        program = load_exported(checkpoint).module()
        return InferenceServer({}, cfg, device=dev, logits_fn=program, **kw)
    params, cfg = load_params(checkpoint, cfg, dev)
    return InferenceServer(params, cfg, device=dev, mesh=mesh, **kw)
