"""Folder-structured image dataset: one subfolder per class.

The port's copy of ``vitx/data/folder.py`` (numpy only): the class list is
the sorted subfolder names, and the train/test selection is made once at
construction by the reference's stratified split (``test_size=0.2``,
``random_state=42``), or not at all for datasets that ship predefined
split directories (``test_size=None``). ``get_example`` decodes with PIL,
imported where it decodes, and returns uint8 HWC RGB for the device-side
preprocessing.

``split_indices`` is a numpy copy of the draws ``sklearn.model_selection.
train_test_split(..., stratify=labels, random_state=...)`` makes, so the
port needs no scikit-learn and selects the same images as vitx.
"""

from __future__ import annotations

import math
import os
import pathlib

import numpy as np

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".gif",
             ".webp"}


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """How many of ``n_draws`` fall to each class: the floor of the class's
    share, then one more to the largest remainders, ties broken by
    ``rng.choice`` (scikit-learn's ``extmath._approximate_mode``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def split_indices(labels, *, train: bool, test_size: float | None,
                  random_state: int) -> np.ndarray:
    """The sorted indices of one side of the reference's stratified split
    (``vitx/data/folder.py:25-41``), or every index when ``test_size`` is
    None.

    The draws of ``train_test_split(arange(n), test_size=test_size,
    stratify=labels, random_state=random_state)``: ``n_test =
    ceil(test_size * n)``; one ``RandomState(random_state)`` serves the
    two ``_approximate_mode`` calls (train slots, then test slots from
    what is left), then one ``permutation`` per class in class order; a
    class's first slots go to train, the next to test. It raises
    ``ValueError`` where scikit-learn does: ``test_size`` outside (0, 1),
    an empty train side, a class with fewer than 2 members, or fewer
    train or test slots than classes."""
    labels = np.asarray(labels)
    n = len(labels)
    idx_all = np.arange(n)
    if test_size is None:
        return idx_all
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the "
                         f"(0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size}, "
                         f"the train set would be empty")
    classes, y_indices, class_counts = np.unique(
        labels, return_inverse=True, return_counts=True)
    n_classes = len(classes)
    if class_counts.min() < 2:
        raise ValueError(
            f"The least populated classes have only 1 member, which is too "
            f"few for a stratified split: "
            f"{classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    picked = []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]))
        picked.append(perm[:n_i[i]] if train
                      else perm[n_i[i]:n_i[i] + t_i[i]])
    return np.sort(np.concatenate(picked))


def decode_rgb(src, image_size: int | None) -> np.ndarray:
    """A file path or file object -> uint8 HWC RGB through PIL, converted
    to RGB where the mode differs (grayscale, RGBA, palette) and resized
    bilinearly to ``image_size`` squared when one is given."""
    from PIL import Image

    img = Image.open(src)
    if img.mode != "RGB":
        img = img.convert("RGB")
    if image_size is not None:
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


class FolderDataset:
    """``data_dir/<class_name>/*.<image>``; train or test selected at
    construction (``split_indices``). ``test_size=None`` keeps every image,
    for the predefined split directories ``make_datasets`` detects."""

    def __init__(self, data_dir, *, train: bool = True,
                 test_size: float | None = 0.2,
                 random_state: int = 42, image_size: int | None = None):
        self.data_dir = pathlib.Path(data_dir)
        self.image_size = image_size
        self.classes = sorted(
            d for d in os.listdir(self.data_dir)
            if (self.data_dir / d).is_dir())
        if not self.classes:
            raise ValueError(f"no class subfolders under {data_dir}")
        self.class_encoding = dict(enumerate(self.classes))

        paths, labels = [], []
        for idx, name in enumerate(self.classes):
            for p in sorted((self.data_dir / name).iterdir()):
                if p.suffix.lower() in _IMG_EXTS:
                    paths.append(p)
                    labels.append(idx)
        if not paths:
            raise ValueError(f"no images under {data_dir}")
        labels = np.array(labels, np.int32)
        sel = split_indices(labels, train=train, test_size=test_size,
                            random_state=random_state)
        self.paths = [paths[i] for i in sel]
        self.labels = labels[sel]

    def __len__(self):
        return len(self.paths)

    def get_example(self, i: int):
        """-> (uint8 HWC RGB image, int label)."""
        return decode_rgb(self.paths[i], self.image_size), int(self.labels[i])
