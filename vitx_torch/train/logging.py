"""Scalar logging: TensorBoard event files, or a JSONL fallback.

The counterpart of ``vitx/train/logging.py::ScalarWriter``, with the same
tags (``Loss/train_batch`` per step, ``val?acc`` per epoch, ``LR``,
``Throughput/images_per_sec``). It writes TensorBoard event files through
the ``tensorboard`` package where that imports, and otherwise appends
``{"tag", "value", "step", "ts"}`` lines to ``scalars.jsonl`` in the log
directory.
"""

from __future__ import annotations

import json
import pathlib
import time


class ScalarWriter:
    """TensorBoard-compatible scalar writer with flush_secs semantics
    (reference uses SummaryWriter(log_dir, flush_secs=10), train.py:83)."""

    def __init__(self, log_dir, flush_secs: float = 10.0):
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._last_flush = time.time()
        self._flush_secs = flush_secs
        self._tb = None
        self._jsonl = None
        try:
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import (
                EventFileWriter,
            )

            self._Summary = Summary
            self._tb = EventFileWriter(str(self.log_dir))
        except ImportError:
            self._jsonl = open(self.log_dir / "scalars.jsonl", "a")

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        if self._tb is not None:
            from tensorboard.compat.proto.event_pb2 import Event

            summ = self._Summary(
                value=[self._Summary.Value(tag=tag, simple_value=value)])
            event = Event(summary=summ, step=int(step),
                          wall_time=time.time())
            self._tb.add_event(event)
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": value, "step": int(step),
                 "ts": time.time()}) + "\n")
        now = time.time()
        if now - self._last_flush > self._flush_secs:
            self.flush()

    def flush(self):
        self._last_flush = time.time()
        if self._tb is not None:
            self._tb.flush()
        else:
            self._jsonl.flush()

    def close(self):
        self.flush()
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
