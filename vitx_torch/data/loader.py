"""Host-side batch loader with threaded decode and static batch shapes.

The port's copy of ``vitx/data/loader.py::BatchLoader`` (numpy only):
examples are read on a thread pool, batches assembled by a producer thread
and handed over through a bounded queue. Every batch has the same shape:
a ragged final batch is zero-padded and carries a ``mask`` (1 for real
rows, 0 for padding), so eval stays exact. The order is a function of
``(seed, epoch)`` alone (``np.random.default_rng((seed, epoch))``), the
same as vitx's, so both packages see the same batches.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading

import numpy as np


class BatchLoader:
    """Iterable over {"image": (B,H,W,C) u8, "label": (B,), "mask": (B,)}."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_threads: int = 8, prefetch: int = 2,
                 cache_decoded: bool = False, rows: tuple | None = None):
        """``cache_decoded``: keep every decoded (image, label) example in
        RAM after its first read, so epoch >= 1 serves from memory with no
        disk IO or decode at all — the standard small/medium-dataset trick
        when host RAM exceeds the decoded dataset (e.g. 5k images at
        224x224x3 = 0.75 GB). Decode rates being the few-core host's
        bottleneck (docs/data.md), this removes them entirely for datasets
        that fit; leave it off for datasets larger than RAM.

        ``rows = (index, count)``: a rank of a data-parallel run loads
        only its block of each global batch of ``batch_size`` rows, block
        ``index`` of ``count`` (the order and the batches stay the
        global ones, so the ranks' blocks put together are the batch one
        process would load; a ragged last batch pads each block, masked)."""
        if rows is not None and batch_size % rows[1]:
            raise ValueError(f"batch size {batch_size} does not split into "
                             f"{rows[1]} ranks' rows")
        self.rows = rows
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self._epoch = 0
        self._seed = seed
        self._cache = {} if cache_decoded else None

    def _get_example(self, i: int):
        if self._cache is None:
            return self.dataset.get_example(i)
        ex = self._cache.get(i)
        if ex is None:
            # dict writes are atomic under the GIL; worst case two pool
            # threads decode the same index once each
            ex = self._cache[i] = self.dataset.get_example(i)
        return ex

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Reshuffle per epoch (deterministic in (seed, epoch))."""
        self._epoch = epoch

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self._seed, self._epoch)).shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield order[start:start + self.batch_size]

    def _assemble(self, pool, idx):
        size = self.batch_size
        if self.rows is not None:
            size //= self.rows[1]
            idx = idx[self.rows[0] * size:(self.rows[0] + 1) * size]
            if len(idx) == 0:         # a block of padding only
                ex = self._get_example(0)
                lab = np.zeros_like(np.array(ex[1], np.int32))
                return {"image": np.zeros((size,) + np.shape(ex[0]),
                                          np.asarray(ex[0]).dtype),
                        "label": np.zeros((size,) + lab.shape, np.int32),
                        "mask": np.zeros(size, np.int32)}
        examples = list(pool.map(self._get_example, idx))
        images = np.stack([e[0] for e in examples])
        # labels: (B,) ints for single-label, (B, C) multi-hot for
        # multi-label datasets — padding rows are zeros either way
        labels = np.array([e[1] for e in examples], np.int32)
        pad = size - len(idx)
        mask = np.ones(size, np.int32)
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            labels = np.concatenate(
                [labels, np.zeros((pad,) + labels.shape[1:], np.int32)])
            mask[len(idx):] = 0
        return {"image": images, "label": labels, "mask": mask}

    def __iter__(self):
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def producer():
            # bounded put that aborts if the consumer walked away (e.g.
            # Trainer breaking out on preemption) — otherwise this thread
            # would block on the full queue forever. The sentinel goes
            # through the same guard: an unguarded final put can deadlock
            # t.join() when the consumer stops with the queue full.
            def put(item) -> bool:
                while not stop.is_set():
                    try:
                        out.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                with cf.ThreadPoolExecutor(self.num_threads) as pool:
                    for idx in self._index_batches():
                        if not put(self._assemble(pool, idx)):
                            return
            except BaseException as e:  # surface decode errors to the consumer
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
