"""Device-side preprocessing: a uint8 batch -> normalised, augmented floats.

The counterpart of ``vitx/data/pipeline.py``: the host hands over uint8
NHWC images and everything else runs on their device, in vitx's order
(``preprocess``): scale to [0, 1], resize (eval) or random-resized crop
(train), color jitter, RandAugment, normalise, horizontal flip, random
erasing. The random draws come from one explicit ``torch.Generator``,
consumed in that order; each augmentation also has a function of its
draws (``crop_resize``, ``jitter``, ``randaugment.augment_layer``,
``flip``, ``randaugment.erase_rect``) so that a test can give it vitx's.
``device_prefetch`` moves the host's batches to the device ahead of the
step that reads them.
"""

from __future__ import annotations

import collections
import math
from functools import partial

import numpy as np
import torch

from vitx_torch.core.device import resolve_device
from vitx_torch.data import randaugment
from vitx_torch.interop.pretrained import resize_bilinear

# ImageNet statistics, the conventional default (vitx's train CLI passes
# 0.5 / 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _scale_translate_weights(n_in: int, n_out: int, scale, translation):
    """(B, n_in, n_out) weights of ``jax.image.scale_and_translate``'s
    linear method with antialiasing along one axis: the triangle kernel,
    widened by 1 / scale when shrinking, normalised per output sample,
    zero where the sample falls outside the input."""
    dev = scale.device
    inv = 1.0 / scale[:, None, None]
    kscale = torch.clamp_min(inv, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
              [None, None, :] * inv - translation[:, None, None] * inv - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=dev)[None, :, None]
    w = torch.clamp_min(1.0 - torch.abs(sample - src) / kscale, 0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def crop_resize(x, out_size: int, y0, x0, ch, cw):
    """Crop boxes (B,) -> (B, out_size, out_size, C): each image's box of
    ch x cw at (y0, x0) resized by ``scale_and_translate`` (vitx's
    ``_random_resized_crop``, ``vitx/data/pipeline.py:25-55``), rows then
    columns."""
    _, H, W, _ = x.shape
    sy, sx = out_size / ch, out_size / cw
    wy = _scale_translate_weights(H, out_size, sy, -y0 * sy)
    wx = _scale_translate_weights(W, out_size, sx, -x0 * sx)
    x = torch.einsum("bhwc,bho->bowc", x, wy)
    return torch.einsum("bowc,bwp->bopc", x, wx)


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def random_resized_crop(x, gen, out_size: int, scale_range, ratio_range):
    """Per-image crop box (area in ``scale_range``, aspect in
    ``ratio_range``) drawn from ``gen``, then ``crop_resize``."""
    B, H, W, _ = x.shape
    area = _uniform(gen, B, scale_range[0], scale_range[1])
    ratio = torch.exp(_uniform(gen, B, math.log(ratio_range[0]),
                               math.log(ratio_range[1])))
    ch = torch.clamp(torch.sqrt(area / ratio) * H, 1.0, float(H))
    cw = torch.clamp(torch.sqrt(area * ratio) * W, 1.0, float(W))
    y0 = _uniform(gen, B, 0.0, 1.0) * (H - ch)
    x0 = _uniform(gen, B, 0.0, 1.0) * (W - cw)
    return crop_resize(x, out_size, y0, x0, ch, cw)


def jitter(x, fb, fc, fs):
    """Brightness, contrast, saturation by factors (B, 1, 1, 1)
    (``vitx/data/pipeline.py:58-69``)."""
    x = x * fb
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * fc + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * fs + gray
    return x.clamp(0.0, 1.0)


def flip(x, mask):
    """Images where ``mask`` (B,) is true mirrored left to right."""
    return torch.where(mask[:, None, None, None], x.flip(2), x)


def preprocess(images_u8, gen, *, out_size: int | None, mean, std,
               random_flip: bool, train: bool, random_crop: bool = False,
               crop_scale=(0.6, 1.0), crop_ratio=(3 / 4, 4 / 3),
               color_jitter: float | None = None, randaug_layers: int = 0,
               randaug_magnitude: float = 9.0,
               random_erase: float | None = None):
    """(B, H, W, C) uint8 -> (B, S, S, C) float32 on the images' device
    (``vitx/data/pipeline.py:72-105``). ``gen`` (a ``torch.Generator`` on
    that device) is needed when ``train`` and an augmentation is on."""
    x = images_u8.float() / 255.0
    B, H, _, _ = x.shape
    size = out_size if out_size is not None else H
    if train and random_crop:
        x = random_resized_crop(x, gen, size, crop_scale, crop_ratio)
    elif out_size is not None and H != out_size:
        x = resize_bilinear(x, (out_size, out_size))
    if train and color_jitter:
        lo, hi = 1.0 - color_jitter, 1.0 + color_jitter
        fb, fc, fs = (_uniform(gen, (B, 1, 1, 1), lo, hi) for _ in range(3))
        x = jitter(x, fb, fc, fs)
    if train and randaug_layers:
        x = randaugment.rand_augment(x, gen, num_layers=randaug_layers,
                                     magnitude=randaug_magnitude)
    if mean is not None:
        x = ((x - torch.tensor(mean, dtype=torch.float32, device=x.device))
             / torch.tensor(std, dtype=torch.float32, device=x.device))
    if train and random_flip:
        x = flip(x, torch.rand(B, generator=gen, device=gen.device) < 0.5)
    if train and random_erase:
        x = randaugment.random_erasing(x, gen, prob=random_erase)
    return x


def make_preprocess(*, out_size: int | None = None, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD, random_flip: bool = True,
                    random_crop: bool = False, crop_scale=(0.6, 1.0),
                    color_jitter: float | None = None,
                    randaug_layers: int = 0, randaug_magnitude: float = 9.0,
                    random_erase: float | None = None):
    """``(images_u8, gen, train=...) -> float images`` with vitx's
    options (``vitx/data/pipeline.py:108-130``): ``mean=None`` turns
    normalisation off; the augmentations run only with ``train=True``."""
    return partial(preprocess, out_size=out_size, mean=mean,
                   std=None if mean is None else std,
                   random_flip=random_flip, random_crop=random_crop,
                   crop_scale=tuple(crop_scale), color_jitter=color_jitter,
                   randaug_layers=randaug_layers,
                   randaug_magnitude=randaug_magnitude,
                   random_erase=random_erase)


def device_prefetch(iterator, *, size: int = 2, device=None):
    """Double-buffered host-to-device transfer (vitx's ``device_prefetch``,
    ``vitx/data/pipeline.py:132-158``): the batches of ``iterator`` (flat
    dicts of numpy arrays or tensors), in order, with every value on
    ``device`` (a CUDA device by default), ``size`` batches read and placed
    ahead of the consumer as vitx's deque reads them, the rest drained at
    the end. Values already on ``device`` pass through as they are,
    without a copy (a device cache's gathers). vitx's ``sharding=`` has no
    counterpart: a rank of a data-parallel run loads only its own rows
    (``BatchLoader(rows=...)``), so the target is the rank's own device.

    On the CPU the values are placed on the CPU (no copy of a numpy
    array's memory). On CUDA each batch's host arrays are copied into
    pinned memory and their copies enqueued on a copy stream of the
    generator's own: a copy never waits for the step's stream, as one
    from pageable memory does, and runs beside the step's kernels wherever
    the host is ahead of the card; before a batch is yielded the
    consumer's current stream waits for its copies, and each copied tensor
    is marked as used by that stream (``record_stream``), so that the
    caching allocator gives its memory to no later copy while a step may
    still read it. The reading, pinning and copies run in the consumer's
    thread: a thread of their own waits for the interpreter lock while the
    step loop launches kernels (``PERF.md``, §6). Closing the generator
    (or leaving a loop over it) closes ``iterator``."""
    if size < 1:
        raise ValueError(f"device_prefetch needs size >= 1, got {size}")
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cpu":
        return _read_ahead(iterator, size, partial(_place, dev=dev),
                           lambda batch: batch)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(dev)

    def place(batch: dict) -> tuple:
        """Enqueue the batch's copies on ``stream`` -> (the batch on the
        device, the keys copied, the copies' event or None)."""
        out, copied = {}, []
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                t = _as_tensor(v)
                if t.device != dev:
                    if t.device.type == "cpu":
                        t = _pinned(t)
                    t = t.to(dev, non_blocking=True)
                    copied.append(k)
                out[k] = t
            done = stream.record_event() if copied else None
        return out, copied, done

    def ready(staged: tuple) -> dict:
        """The consumer's stream waits for the batch's copies, and owns
        its tensors from then on."""
        out, copied, done = staged
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for k in copied:
                out[k].record_stream(consumer)
        return out

    return _read_ahead(iterator, size, place, ready)


def _as_tensor(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))


def _place(batch: dict, dev: torch.device) -> dict:
    return {k: _as_tensor(v).to(dev) for k, v in batch.items()}


def _read_ahead(iterator, size: int, place, ready):
    """vitx's deque: ``place`` each batch as it is read, and yield the
    oldest, through ``ready``, once ``size`` are placed."""
    src = iter(iterator)
    try:
        buf = collections.deque()
        for batch in src:
            buf.append(place(batch))
            if len(buf) >= size:
                yield ready(buf.popleft())
        while buf:
            yield ready(buf.popleft())
    finally:
        close = getattr(src, "close", None)
        if close is not None:
            close()


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (on the CPU) in pinned memory: a block of the caching host
    allocator, which a non-blocking copy from it keeps until the copy has
    run. numpy copies it in one thread: torch's copy spreads over the
    intra-op threads, and on a host whose cores the loader's threads hold
    it stalls for tens of ms (``PERF.md``, §6)."""
    if t.is_pinned():
        return t
    out = torch.empty_like(t, pin_memory=True)
    np.copyto(out.numpy(), t.numpy())
    return out

