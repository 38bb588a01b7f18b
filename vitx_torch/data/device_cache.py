"""Device-resident dataset: the whole split lives in device memory, batches
are gathers on the device.

The counterpart of ``vitx/data/device_cache.py::DeviceBatchLoader``: the
uint8 images and int32 labels are uploaded once (in 64 MB slices, so the
host holds no second copy of a multi-GB split), and every batch is an
``index_select`` on the device. Steady-state training moves no image bytes
from the host: each epoch uploads its order (one int64 per example) and
each batch is a slice of it. The order is ``BatchLoader``'s
(``default_rng((seed, epoch)).shuffle``), and a ragged final batch is
padded with index 0 and its padded rows zeroed, as ``BatchLoader`` pads
with zeros, so a device-cached run sees the batches of a host-loaded one.
"""

from __future__ import annotations

import numpy as np
import torch

from vitx_torch.core.device import resolve_device


def _chunked_upload(arr: np.ndarray, dev: torch.device,
                    chunk_bytes: int = 64 << 20) -> torch.Tensor:
    out = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                      device=dev)
    rows = max(1, int(chunk_bytes // max(arr[:1].nbytes, 1)))
    for i in range(0, len(arr), rows):
        out[i:i + rows].copy_(torch.from_numpy(arr[i:i + rows]))
    return out


class DeviceBatchLoader:
    """BatchLoader-compatible iterable whose batches are gathers from a split
    resident on ``device`` (a CUDA device by default).

    ``dataset``: anything with ``materialize() -> (images u8, labels)``
    (``ProceduralShapes``) or ``get_example``/``__len__``
    (``SyntheticDataset``), whose examples are stacked on the host once.
    Yields ``{"image": (B, H, W, C) uint8, "label": (B,) int32 -- (B, C)
    multi-hot for a multi-label dataset --, "mask": (B,) int32}``, all on
    the device.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if hasattr(dataset, "materialize"):
            images, labels = dataset.materialize()
        else:
            ex = [dataset.get_example(i) for i in range(len(dataset))]
            images = np.stack([e[0] for e in ex])
            labels = np.array([e[1] for e in ex], np.int32)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._epoch = 0
        self._n = len(labels)
        self._images = _chunked_upload(np.ascontiguousarray(images),
                                       self.device)
        self._labels = torch.from_numpy(
            np.asarray(labels, np.int32)).to(self.device)
        self._ones = torch.ones(batch_size, dtype=torch.int32,
                                device=self.device)

    @property
    def nbytes(self) -> int:
        return (self._images.numel() * self._images.element_size()
                + self._labels.numel() * self._labels.element_size())

    def __len__(self):
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Reshuffle per epoch -- BatchLoader's (seed, epoch) rule."""
        self._epoch = epoch

    def __iter__(self):
        order = np.arange(self._n)
        if self.shuffle:
            np.random.default_rng((self._seed, self._epoch)).shuffle(order)
        B = self.batch_size
        stop = (self._n // B) * B if self.drop_last else self._n
        pad = (-stop) % B
        # one upload of the epoch's order, padded to whole batches
        order = torch.from_numpy(np.concatenate(
            [order[:stop], np.zeros(pad, order.dtype)])).to(self.device)
        for start in range(0, stop, B):
            idx = order[start:start + B]
            mask = self._ones
            if start + B > stop:
                mask = (torch.arange(B, device=self.device)
                        < stop - start).to(torch.int32)
            yield gather(self._images, self._labels, idx, mask)


def gather(images, labels, idx, mask) -> dict:
    """``{"image", "label", "mask"}`` of rows ``idx``, the rows where
    ``mask`` is 0 zeroed (``vitx/data/device_cache.py:51-59``)."""
    img = images.index_select(0, idx)
    img = img * mask.to(img.dtype)[:, None, None, None]
    lab = labels.index_select(0, idx)
    lab = lab * mask.to(lab.dtype).reshape((-1,) + (1,) * (lab.dim() - 1))
    return {"image": img, "label": lab, "mask": mask}
