"""Tar-shard image dataset: production-scale image IO.

The port's copy of ``vitx/data/shards.py``. ``write_shards`` packs any
dataset (``__len__``, ``get_example``, ``classes``) into
``shard-%05d.tar`` files with the WebDataset member convention --
``<key>.<ext>`` for the image, ``<key>.cls`` for its integer class -- and
a ``classes.json`` sidecar; for the same dataset and format it writes the
same bytes as vitx (``TarInfo``'s defaults make the headers
deterministic). ``ShardDataset`` scans every tar once to build a
byte-range index, then serves ``get_example(i)`` by one seek and read on a
per-thread file handle, so ``BatchLoader``'s decode threads never share a
file position. Raw ``.npy`` members (``image_format="raw"``) load without
PIL; PNG and JPEG members, and a raw member of another size than
``image_size``, decode or resize through PIL. The split is
``FolderDataset``'s: the reference's stratified split, or
``test_size=None`` for predefined train/val shard directories.
"""

from __future__ import annotations

import io
import json
import pathlib
import tarfile
import threading

import numpy as np

from vitx_torch.data.folder import decode_rgb, split_indices

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp",
             ".npy"}   # .npy: pre-decoded uint8 (image_format="raw")


def _encode(img, image_format: str) -> tuple[str, bytes]:
    buf = io.BytesIO()
    if image_format == "raw":
        np.save(buf, np.ascontiguousarray(img, np.uint8))
        return "npy", buf.getvalue()
    from PIL import Image

    Image.fromarray(np.asarray(img, np.uint8)).save(buf, format=image_format)
    return image_format, buf.getvalue()


def write_shards(dataset, out_dir, *, shard_size: int = 1000,
                 image_format: str = "png") -> list[pathlib.Path]:
    """Pack ``dataset`` into tar shards of ``shard_size`` images under
    ``out_dir`` -> the shard paths. ``image_format``: "png" (lossless),
    "jpeg" or "raw" (the decoded uint8 array as an ``.npy`` member: one
    seek, read and ``np.load`` to serve, no decode; pack at the training
    resolution so nothing is resampled). A directory that already holds
    ``.tar`` files is refused: a smaller pack over an old one would leave
    stale shards that ``ShardDataset`` indexes."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stale = sorted(out_dir.glob("*.tar"))
    if stale:
        raise ValueError(
            f"{out_dir} already holds {len(stale)} .tar shard(s) "
            f"(e.g. {stale[0].name}); write into a fresh directory or "
            f"remove them first")
    classes = list(getattr(dataset, "classes",
                           [str(i) for i in range(
                               getattr(dataset, "num_classes", 0))]))
    (out_dir / "classes.json").write_text(json.dumps(classes))

    paths, tf = [], None
    try:
        for i in range(len(dataset)):
            if i % shard_size == 0:
                if tf is not None:
                    tf.close()
                paths.append(out_dir / f"shard-{len(paths):05d}.tar")
                tf = tarfile.open(paths[-1], "w")
            img, label = dataset.get_example(i)
            ext, payload = _encode(img, image_format)
            key = f"{i:08d}"
            for name, data in ((f"{key}.{ext}", payload),
                               (f"{key}.cls", str(int(label)).encode())):
                ti = tarfile.TarInfo(name)
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))
    finally:
        if tf is not None:
            tf.close()
    return paths


class ShardDataset:
    """Random-access image dataset over a directory of ``*.tar`` shards
    (and an optional ``classes.json``). Construction reads the tar headers
    once and records (shard, data offset, size, raw) per image; reads then
    bypass ``tarfile``."""

    def __init__(self, shard_dir, *, train: bool = True,
                 test_size: float | None = 0.2, random_state: int = 42,
                 image_size: int | None = None):
        self.shard_dir = pathlib.Path(shard_dir)
        self.image_size = image_size
        self.shards = sorted(self.shard_dir.glob("*.tar"))
        if not self.shards:
            raise ValueError(f"no .tar shards under {shard_dir}")

        entries, labels = [], []
        for si, shard in enumerate(self.shards):
            images, cls = {}, {}
            with tarfile.open(shard) as tf:
                for m in tf:
                    if not m.isfile():
                        continue
                    stem, dot, rest = m.name.partition(".")
                    ext = "." + rest.lower() if dot else ""
                    if ext in _IMG_EXTS:
                        images[stem] = (si, m.offset_data, m.size,
                                        ext == ".npy")
                    elif ext == ".cls":
                        cls[stem] = int(tf.extractfile(m).read().decode()
                                        .strip())
            missing = sorted(set(images) ^ set(cls))
            if missing:
                raise ValueError(
                    f"{shard}: unpaired members (image without .cls or "
                    f"vice versa): {missing[:5]}")
            for stem in sorted(images):
                entries.append(images[stem])
                labels.append(cls[stem])
        labels = np.asarray(labels, np.int32)

        cj = self.shard_dir / "classes.json"
        if cj.is_file():
            self.classes = list(json.loads(cj.read_text()))
        else:
            self.classes = [str(c) for c in range(int(labels.max()) + 1)]
        self.class_encoding = dict(enumerate(self.classes))

        sel = split_indices(labels, train=train, test_size=test_size,
                            random_state=random_state)
        self._entries = [entries[i] for i in sel]
        self.labels = labels[sel]
        self._local = threading.local()

    def __len__(self):
        return len(self._entries)

    def _handle(self, si: int):
        """This thread's open handle on shard ``si``: each reader thread
        seeks its own file position."""
        handles = getattr(self._local, "handles", None)
        if handles is None:
            handles = self._local.handles = {}
        h = handles.get(si)
        if h is None:
            h = handles[si] = open(self.shards[si], "rb")
        return h

    def get_example(self, i: int):
        """-> (uint8 HWC RGB image, int label) by one seek and read."""
        si, offset, size, is_raw = self._entries[i]
        h = self._handle(si)
        h.seek(offset)
        data = h.read(size)
        label = int(self.labels[i])
        if not is_raw:
            return decode_rgb(io.BytesIO(data), self.image_size), label
        arr = np.load(io.BytesIO(data))
        size = self.image_size
        if size is not None and arr.shape[:2] != (size, size):
            from PIL import Image

            arr = np.asarray(Image.fromarray(arr).resize(
                (size, size), Image.BILINEAR), np.uint8)
        return arr, label
