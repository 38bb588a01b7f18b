"""The port's ``device_prefetch`` against vitx's, and the Trainer's loops
through it, on the CPU.

``vitx_torch.data.pipeline.device_prefetch`` yields what vitx's
(``vitx/data/pipeline.py:132-158``, on JAX's CPU) yields -- the same keys,
values and order, bit for bit -- at sizes 1-3 over 0-5 batches, a ragged
masked last batch among them; it reads exactly ``min(size, n)`` batches
before its first yield, passes tensors already on the target through with
their storage, and closes its source when the consumer stops; an error
of the source reaches the consumer. A tiny Trainer epoch
(``steps_per_dispatch`` 1 and 2) and its evaluations equal, bit for bit, a
synchronous route driven here: each batch uploaded as it comes,
``Trainer._step`` and the eval step called directly. The CUDA route
(pinned copies on a copy stream) is held on the card in
``tests/test_torch_cuda.py``.
"""

import threading

import numpy as np
import pytest
import torch
from vitx.data.pipeline import device_prefetch as jprefetch

import vitx_torch
from vitx_torch.data import (BatchLoader, SyntheticDataset,
                             SyntheticMultiLabelDataset, make_preprocess)
from vitx_torch.data.pipeline import device_prefetch
from vitx_torch.train import loop as tloop
from vitx_torch.train import step as tstep

torch.set_num_threads(1)

CPU = torch.device("cpu")


def host_batches(n: int, seed: int = 0, batch: int = 4) -> list:
    """``n`` BatchLoader-style batches drawn from a seed; the last one
    ragged (half its rows padding, masked) when n > 1."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        image = rng.integers(0, 256, (batch, 8, 8, 3), dtype=np.uint8)
        label = rng.integers(0, 10, batch).astype(np.int32)
        mask = np.ones(batch, np.int32)
        if n > 1 and i == n - 1:
            image[batch // 2:] = 0
            label[batch // 2:] = 0
            mask[batch // 2:] = 0
        out.append({"image": image, "label": label, "mask": mask})
    return out


class Counting:
    """An iterator over ``batches`` that counts the batches drawn and
    records whether it was closed."""

    def __init__(self, batches):
        self.batches, self.drawn, self.closed = batches, 0, False

    def __iter__(self):
        return self

    def __next__(self):
        if self.drawn == len(self.batches):
            raise StopIteration
        self.drawn += 1
        return self.batches[self.drawn - 1]

    def close(self):
        self.closed = True


@pytest.mark.parametrize("n", [0, 1, 2, 5])
@pytest.mark.parametrize("size", [1, 2, 3])
def test_matches_vitx(size, n):
    batches = host_batches(n, seed=size * 10 + n)
    want = list(jprefetch(iter(batches), size=size))
    got = list(device_prefetch(iter(batches), size=size, device="cpu"))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            a, b = g[key].numpy(), np.asarray(w[key])
            assert g[key].device == CPU and a.dtype == b.dtype
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("size", [1, 2, 3])
def test_reads_size_ahead(size, n):
    src = Counting(host_batches(n))
    out = device_prefetch(src, size=size, device="cpu")
    next(out)
    assert src.drawn == min(size, n)
    assert len(list(out)) == n - 1 and src.drawn == n


def test_device_tensors_pass_through():
    batch = {"image": torch.arange(24, dtype=torch.uint8).reshape(2, 4, 3),
             "label": torch.tensor([3, 1], dtype=torch.int32),
             "mask": np.ones(2, np.int32)}
    (got,) = device_prefetch(iter([batch]), device="cpu")
    for key in ("image", "label"):
        assert got[key] is batch[key]
        assert (got[key].untyped_storage().data_ptr()
                == batch[key].untyped_storage().data_ptr())
    assert np.shares_memory(got["mask"].numpy(), batch["mask"])


def test_source_errors_reach_the_consumer():
    def broken():
        yield host_batches(1)[0]
        raise OSError("unreadable shard")

    out = device_prefetch(broken(), size=1, device="cpu")
    next(out)
    with pytest.raises(OSError, match="unreadable shard"):
        next(out)


def test_refuses_size_0():
    with pytest.raises(ValueError, match="size >= 1"):
        device_prefetch(iter([]), size=0, device="cpu")


def test_stopping_closes_the_loader():
    """Leaving the loop after one batch closes the source, and a
    BatchLoader's producer thread with it."""
    src = Counting(host_batches(5))
    for _ in device_prefetch(src, device="cpu"):
        break
    assert src.closed and src.drawn == 2
    before = threading.active_count()
    loader = BatchLoader(SyntheticDataset(num_examples=64, image_size=8),
                         4, num_threads=2)
    for _ in device_prefetch(iter(loader), device="cpu"):
        break
    assert threading.active_count() == before


# --- the Trainer -------------------------------------------------------------

CFG = vitx_torch.get_config("tiny", compute_dtype="float32", image_size=32,
                            depth=2, num_classes=4)


def trainer(k=1, **tkw):
    pre = make_preprocess(out_size=32, mean=(0.5,) * 3, std=(0.5,) * 3,
                          random_flip=True, random_crop=True)
    return tloop.Trainer(CFG, tloop.TrainerConfig(
        epochs=1, steps_per_dispatch=k, log_every=2, lr=1e-3, **tkw),
        preprocess=pre, device="cpu")


def on_cpu(batch) -> dict:
    """The synchronous route's upload: each array as it comes."""
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("k", [1, 2])
def test_trainer_epoch_matches_synchronous_route(k):
    """26 images in batches of 4 (6 full, a ragged masked seventh; at k 2
    three dispatches and a single step): the flushed losses, the image
    count and every param equal the synchronous route's bit for bit."""
    ds = SyntheticDataset(num_examples=26, image_size=32, num_classes=4)
    tr = trainer(k)
    flushed = []
    flush = tr._flush

    def keep(pending, writer):
        flushed.extend(float(m["loss"]) for _, m in pending)
        return flush(pending, writer)
    tr._flush = keep
    stats = tr.fit(BatchLoader(ds, 4, shuffle=True))[-1]

    ref = trainer(k)
    loader = BatchLoader(ds, 4, shuffle=True)
    loader.set_epoch(0)
    losses = [float(ref._step(on_cpu(b), 0, i)["loss"])
              for i, b in enumerate(loader)]
    assert flushed == losses and len(losses) == 7
    assert stats["epoch_loss_sum"] == float(sum(losses))
    assert stats["images_per_sec"] * stats["epoch_secs"] == \
        pytest.approx(26)
    assert int(tr.state.step) == int(ref.state.step) == 7
    for a, b in zip(tstep.leaves(tr.state.params),
                    tstep.leaves(ref.state.params)):
        assert torch.equal(a, b)


def test_evaluate_matches_synchronous_route():
    """``evaluate`` over 10 images in batches of 4 (the last ragged): the
    confusion matrix and the valid-row-weighted loss of the eval step
    called batch by batch."""
    val = SyntheticDataset(num_examples=10, image_size=32, num_classes=4,
                           seed=1)
    tr = trainer()
    got = tr.evaluate(BatchLoader(val, 4))
    cm, loss_sum = 0, 0.0
    for b in BatchLoader(val, 4):
        prepped = tr._prep(on_cpu(b), None, train=False)
        cm_b, loss = tr.eval_step(tr.eval_params(), prepped)
        cm = cm + cm_b
        loss_sum = loss_sum + loss * cm_b.sum()
    assert np.array_equal(got["confusion_matrix"], cm.numpy())
    assert got["loss"] == float(loss_sum) / float(cm.sum())


def test_evaluate_multilabel_matches_synchronous_route():
    val = SyntheticMultiLabelDataset(num_examples=10, image_size=32,
                                     num_classes=4, seed=1)
    tr = trainer(loss="bce")
    got = tr.evaluate(BatchLoader(val, 4))
    batches = []
    for b in BatchLoader(val, 4):
        prepped = tr._prep(on_cpu(b), None, train=False)
        batches.append((prepped["image"], prepped["label"], prepped["mask"]))
    want = tloop.multilabel_eval(tr.eval_params(), CFG, batches)
    assert got.keys() == want.keys() and "mAP" in got
    for key, v in want.items():
        assert np.array_equal(got[key], v), key
