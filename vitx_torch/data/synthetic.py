"""Deterministic synthetic classification dataset.

The port's copy of ``vitx/data/synthetic.py::SyntheticDataset``: each class
is an oriented sinusoidal grating with a class-dependent frequency plus
seeded noise. numpy only, from ``default_rng(seed)`` for the labels and
``default_rng((seed, i))`` for example i, so for a seed it gives the same
uint8 images and labels as vitx's and both packages train on the same
batches, with vitx's class names (``class_0``, ...). (vitx's ``cache``
option has no caller in the port yet.)
"""

from __future__ import annotations

import numpy as np


class SyntheticDataset:
    def __init__(self, *, num_examples: int = 512, image_size: int = 64,
                 num_classes: int = 4, num_channels: int = 3, seed: int = 0,
                 noise: float = 0.3):
        self.image_size = image_size
        self.num_classes = num_classes
        self.num_channels = num_channels
        self.noise = noise
        self._seed = seed
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, num_classes,
                                   size=num_examples).astype(np.int32)
        self.classes = [f"class_{i}" for i in range(num_classes)]
        self.class_encoding = dict(enumerate(self.classes))

    def __len__(self):
        return len(self.labels)

    def get_example(self, i: int):
        """-> ((S, S, C) uint8 image, int label)."""
        return self._generate(i)

    def _wave(self, label: int):
        S = self.image_size
        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
        angle = np.pi * label / self.num_classes
        freq = 3.0 + 2.0 * label
        return np.sin(2 * np.pi * freq *
                      (np.cos(angle) * xx + np.sin(angle) * yy))

    def _generate(self, i: int):
        label = int(self.labels[i])
        rng = np.random.default_rng((self._seed, i))
        S = self.image_size
        wave = self._wave(label)
        img = 0.5 + 0.35 * wave[..., None] + \
            self.noise * rng.standard_normal((S, S, self.num_channels))
        img = np.clip(img, 0.0, 1.0)
        return (img * 255).astype(np.uint8), label
