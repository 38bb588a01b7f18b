"""CIFAR-10 from a local copy of the standard python-pickle batches.

The port's copy of ``vitx/data/cifar.py``: it reads an already-present
``cifar-10-batches-py/`` directory (or the directory that holds it) and
never touches the network. The batch files are pickles; they are read
with an unpickler that builds only the containers and numpy arrays the
format holds, so a foreign file cannot run code.
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np

CLASSES = ["airplane", "automobile", "bird", "cat", "deer",
           "dog", "frog", "horse", "ship", "truck"]

# what a CIFAR batch pickle may reference: numpy's array reconstruction
# (protocols 2-4, and 5's out-of-band form) and, where Python 3 wrote bytes
# at protocol 2, their encoding
_ALLOWED = {("numpy.core.multiarray", "_reconstruct"),
            ("numpy._core.multiarray", "_reconstruct"),
            ("numpy.core.numeric", "_frombuffer"),
            ("numpy._core.numeric", "_frombuffer"),
            ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode")}


class _BatchUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"a CIFAR batch does not reference {module}.{name}")
        return super().find_class(module, name)


class CIFAR10:
    """The five training batches (``train=True``) or the test batch, as
    uint8 NHWC images and int32 labels."""

    def __init__(self, data_dir, *, train: bool = True):
        root = pathlib.Path(data_dir)
        if (root / "cifar-10-batches-py").is_dir():
            root = root / "cifar-10-batches-py"
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        images, labels = [], []
        for name in files:
            path = root / name
            if not path.exists():
                raise FileNotFoundError(
                    f"{path} not found: CIFAR-10 must already be on disk "
                    "(nothing is downloaded)")
            with open(path, "rb") as f:
                batch = _BatchUnpickler(f, encoding="bytes").load()
            images.append(np.asarray(batch[b"data"], np.uint8))
            labels.extend(batch[b"labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.images = np.ascontiguousarray(data.transpose(0, 2, 3, 1))
        self.labels = np.array(labels, np.int32)
        self.classes = list(CLASSES)
        self.class_encoding = dict(enumerate(self.classes))

    def __len__(self):
        return len(self.labels)

    def get_example(self, i: int):
        return self.images[i], int(self.labels[i])
