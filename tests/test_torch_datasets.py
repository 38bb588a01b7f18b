"""The port's on-disk data sources against vitx's, on the CPU.

The same files, written here from a numpy seed, go through vitx and the
port: the stratified split (``split_indices``, scikit-learn's draws in
vitx, a numpy copy in the port) index for index, including its errors;
``FolderDataset`` over RGB, grayscale, RGBA and palette PNG and JPEG
images; ``CIFAR10`` over locally written python batches; tar shards byte
for byte in both directions, read by each package, under ``BatchLoader``'s
threads; the pack CLI; ``make_datasets`` for every spec and split layout;
and one train-CLI epoch on each source, scored alike by the eval CLI.
"""

import io
import json
import pickle
import sys
import tarfile

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import vitx
import vitx_torch
from vitx.cli import pack as jpack
from vitx.cli import train as jtrain
from vitx.data import cifar as jcifar
from vitx.data import folder as jfolder
from vitx.data import shards as jshards
from vitx.data.synthetic import SyntheticDataset as JSynthetic
from vitx_torch.cli import eval as teval
from vitx_torch.cli import pack as tpack
from vitx_torch.cli import train as ttrain
from vitx_torch.data import BatchLoader
from vitx_torch.data import cifar as tcifar
from vitx_torch.data import folder as tfolder
from vitx_torch.data import shards as tshards

torch.set_num_threads(1)

SIZE = 24                     # the config's image size in the CLI cases
CFG_J = vitx.get_config("tiny", image_size=SIZE, patch_size=8)
CFG_T = vitx_torch.get_config("tiny", image_size=SIZE, patch_size=8)


def write_folder(root, counts, seed=0, shape=(20, 18)):
    """``root/<class>/<i>.<ext>`` images in every mode a folder holds: RGB
    and grayscale PNG and JPEG, RGBA and palette PNG."""
    rng = np.random.default_rng(seed)
    kinds = (("RGB", "png"), ("L", "png"), ("RGB", "jpg"), ("RGBA", "png"),
             ("L", "jpeg"), ("P", "png"))
    for cls, n in counts.items():
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n):
            mode, ext = kinds[i % len(kinds)]
            arr = rng.integers(0, 256, (*shape, 4), dtype=np.uint8)
            img = (Image.fromarray(arr, "RGBA") if mode == "RGBA" else
                   Image.fromarray(arr[..., :3], "RGB").convert(mode))
            img.save(d / f"{i:03d}.{ext}")
    (root / next(iter(counts)) / "notes.txt").write_text("not an image")


def write_cifar(root, n_train=6, n_test=8, seed=0):
    """The torchvision layout: ``data_batch_1..5`` and ``test_batch``, each
    a protocol-2 pickle of {b"data": (n, 3072) uint8, b"labels": [...]}."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for name, n in [(f"data_batch_{i}", n_train) for i in range(1, 6)] + [
            ("test_batch", n_test)]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": [int(v) for v in rng.integers(0, 10, n)],
                 b"batch_label": name.encode()}
        with open(root / name, "wb") as f:
            pickle.dump(batch, f, protocol=2)


def tree_bytes(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def same_examples(a, b, idx=None):
    assert len(a) == len(b)
    assert list(a.classes) == list(b.classes)
    np.testing.assert_array_equal(a.labels, b.labels)
    for i in (range(len(a)) if idx is None else idx):
        (xa, la), (xb, lb) = a.get_example(i), b.get_example(i)
        assert la == lb
        np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))


# ------------------------------------------------------------- the split


@settings(max_examples=80, deadline=None)
@given(n_classes=st.integers(2, 12), n=st.integers(4, 400),
       test_size=st.sampled_from([0.1, 0.2, 0.25]),
       random_state=st.sampled_from([0, 7, 42]), seed=st.integers(0, 2**16))
def test_split_indices_matches_sklearn(n_classes, n, test_size,
                                       random_state, seed):
    """Index for index as scikit-learn's ``train_test_split`` draws them
    in vitx, and the same exception type where it refuses (a class of
    one, fewer slots than classes)."""
    labels = np.random.default_rng(seed).integers(0, n_classes, n)
    for train in (True, False):
        kw = dict(train=train, test_size=test_size,
                  random_state=random_state)
        try:
            want = jfolder.split_indices(labels, **kw)
        except ValueError:
            with pytest.raises(ValueError):
                tfolder.split_indices(labels, **kw)
            continue
        got = tfolder.split_indices(labels, **kw)
        assert got.dtype.kind == "i"
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- folder


@pytest.fixture(scope="module")
def folder_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("brain")
    write_folder(root, {"glioma": 9, "meningioma": 6, "none": 11,
                        "pituitary": 5})
    return root


@pytest.mark.parametrize("train,test_size,image_size", [
    (True, 0.2, None), (False, 0.2, 16), (True, None, 16)],
    ids=["train", "test_resized", "whole_resized"])
def test_folder_dataset_matches_vitx(folder_root, train, test_size,
                                     image_size):
    """Classes, class_encoding, paths, labels and every decoded image (RGB
    converted from L, RGBA, P; bilinear resize) equal vitx's."""
    kw = dict(train=train, test_size=test_size, image_size=image_size)
    a = tfolder.FolderDataset(folder_root, **kw)
    b = jfolder.FolderDataset(folder_root, **kw)
    assert a.class_encoding == b.class_encoding
    assert a.paths == b.paths
    same_examples(a, b)
    x, _ = a.get_example(0)
    assert x.dtype == np.uint8 and x.shape[-1] == 3


# ----------------------------------------------------------------- CIFAR


@pytest.mark.parametrize("parent", [True, False], ids=["parent", "bare"])
def test_cifar10_matches_vitx(tmp_path, parent):
    """Both splits equal vitx's arrays and labels, read from the batch
    directory or the directory holding ``cifar-10-batches-py``."""
    write_cifar(tmp_path / "cifar-10-batches-py")
    root = tmp_path if parent else tmp_path / "cifar-10-batches-py"
    for train in (True, False):
        a = tcifar.CIFAR10(root, train=train)
        b = jcifar.CIFAR10(root, train=train)
        assert a.images.dtype == np.uint8 and a.images.shape[1:] == (32, 32,
                                                                     3)
        np.testing.assert_array_equal(a.images, b.images)
        assert a.class_encoding == b.class_encoding
        same_examples(a, b, idx=[0, len(a) - 1])


def test_cifar10_missing_and_foreign_files(tmp_path):
    """A missing batch raises FileNotFoundError naming it in both packages;
    a pickle that references anything but numpy arrays is refused."""
    write_cifar(tmp_path)
    (tmp_path / "data_batch_3").unlink()
    for mod in (tcifar, jcifar):
        with pytest.raises(FileNotFoundError, match="data_batch_3"):
            mod.CIFAR10(tmp_path, train=True)
    with open(tmp_path / "test_batch", "wb") as f:
        pickle.dump({b"data": np.zeros((1, 3072), np.uint8),
                     b"labels": [0], b"hook": io.BytesIO()}, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match="BytesIO"):
        tcifar.CIFAR10(tmp_path, train=False)


# ---------------------------------------------------------------- shards


def jsource(n=23, size=12, classes=3, seed=0):
    return JSynthetic(num_examples=n, image_size=size, num_classes=classes,
                      seed=seed)


@pytest.mark.parametrize("fmt", ["raw", "png"])
def test_shards_bytes_and_cross_reads(tmp_path, fmt):
    """The port writes vitx's bytes (every shard and classes.json); each
    package reads the other's shards to the same labels and pixels, whole
    and through the stratified split."""
    src = jsource()
    tshards.write_shards(src, tmp_path / "t", shard_size=7, image_format=fmt)
    jshards.write_shards(src, tmp_path / "j", shard_size=7, image_format=fmt)
    got, want = tree_bytes(tmp_path / "t"), tree_bytes(tmp_path / "j")
    assert list(got) == list(want) == ["classes.json"] + [
        f"shard-{i:05d}.tar" for i in range(4)]
    assert got == want
    for reader, writer in ((tshards, "j"), (jshards, "t")):
        for kw in ({"test_size": None}, {"train": True}, {"train": False}):
            same_examples(reader.ShardDataset(tmp_path / writer, **kw),
                          jshards.ShardDataset(tmp_path / "j", **kw))
    whole = tshards.ShardDataset(tmp_path / "t", test_size=None)
    for i in (0, 22):
        np.testing.assert_array_equal(whole.get_example(i)[0],
                                      src.get_example(i)[0])


def test_shards_refuse_stale_and_unpaired(tmp_path):
    tshards.write_shards(jsource(n=6), tmp_path / "a", shard_size=4)
    with pytest.raises(ValueError, match="already holds"):
        tshards.write_shards(jsource(n=3), tmp_path / "a", shard_size=4)
    d = tmp_path / "b"
    d.mkdir()
    with tarfile.open(d / "shard-00000.tar", "w") as tf:
        payload = b"not really a png"
        ti = tarfile.TarInfo("0001.png")
        ti.size = len(payload)
        tf.addfile(ti, io.BytesIO(payload))
    with pytest.raises(ValueError, match="unpaired"):
        tshards.ShardDataset(d, test_size=None)


def test_shards_threaded_reads_through_batch_loader(tmp_path):
    """``BatchLoader``'s 8 decode threads over 4 shards, switching every
    microsecond: every batch equals the examples read one by one (a shared
    file position would hand one thread another's bytes)."""
    tshards.write_shards(jsource(n=40, classes=4), tmp_path, shard_size=10,
                         image_format="raw")
    ds = tshards.ShardDataset(tmp_path, test_size=None)
    ref = [ds.get_example(i) for i in range(len(ds))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epoch in range(3):
            loader = BatchLoader(ds, 8, shuffle=True, seed=epoch,
                                 num_threads=8)
            order = list(loader._index_batches())
            batches = list(loader)
            assert len(batches) == len(order) == 5
            for idx, b in zip(order, batches):
                np.testing.assert_array_equal(
                    b["image"], np.stack([ref[i][0] for i in idx]))
                np.testing.assert_array_equal(b["label"],
                                              [ref[i][1] for i in idx])
    finally:
        sys.setswitchinterval(old)


# ---------------------------------------------------------- make_datasets


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One directory of each on-disk kind, and each split layout."""
    root = tmp_path_factory.mktemp("sources")
    write_cifar(root / "cifar" / "cifar-10-batches-py")
    write_folder(root / "folder", {"a": 7, "b": 6, "c": 8}, seed=1)
    for tr, te in (("Training", "Testing"), ("train", "val"),
                   ("train", "test")):
        base = root / f"folder_{tr}_{te}"
        write_folder(base / tr, {"x": 5, "y": 4}, seed=2)
        write_folder(base / te, {"x": 2, "y": 3}, seed=3)
    for split, n, seed in (("train", 18, 4), ("val", 9, 5)):
        tshards.write_shards(jsource(n=n, classes=3, seed=seed),
                             root / "shards" / split, shard_size=8,
                             image_format="raw")
    tshards.write_shards(jsource(n=20, classes=2, seed=6),
                         root / "shards_one", shard_size=8,
                         image_format="png")
    return root


SPECS = ["cifar10:cifar", "cifar10:cifar/cifar-10-batches-py",
         "folder:folder", "folder:folder_Training_Testing",
         "folder:folder_train_val", "folder:folder_train_test",
         "shards:shards", "shards:shards_one"]


@pytest.mark.parametrize("spec", SPECS)
def test_make_datasets_matches_vitx(sources, spec):
    kind, _, rel = spec.partition(":")
    full = f"{kind}:{sources / rel}"
    got = ttrain.make_datasets(full, CFG_T, 0)
    want = jtrain.make_datasets(full, CFG_J, 0)
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__
        same_examples(a, b, idx=[0, len(a) - 1])


def test_make_datasets_class_mismatch(tmp_path):
    """Predefined split directories that name other classes are an error in
    both packages, for folders and for shards."""
    write_folder(tmp_path / "f" / "train", {"x": 3, "y": 3})
    write_folder(tmp_path / "f" / "val", {"x": 2, "z": 2})
    tshards.write_shards(jsource(n=4, classes=2), tmp_path / "s" / "train")
    tshards.write_shards(jsource(n=4, classes=3), tmp_path / "s" / "test")
    for spec in (f"folder:{tmp_path / 'f'}", f"shards:{tmp_path / 's'}"):
        for make, cfg in ((ttrain.make_datasets, CFG_T),
                          (jtrain.make_datasets, CFG_J)):
            with pytest.raises(ValueError, match="disagree on"):
                make(spec, cfg, 0)


# ------------------------------------------------------------- pack, CLIs


@pytest.mark.parametrize("spec,fmt", [("folder:folder", "png"),
                                      ("cifar10:cifar", "raw")])
def test_pack_cli_matches_vitx(sources, tmp_path, capsys, spec, fmt):
    """``vitx_torch.cli.pack`` writes vitx's shard bytes and the same JSON
    lines (but the seconds) for both splits."""
    kind, _, rel = spec.partition(":")
    argv = ["--data", f"{kind}:{sources / rel}", "--format", fmt,
            "--image-size", "16", "--shard-size", "8"]
    lines = {}
    for name, mod in (("t", tpack), ("j", jpack)):
        assert mod.main(argv + ["--out", str(tmp_path / name)]) == 0
        lines[name] = [{k: v for k, v in json.loads(ln).items()
                        if k != "pack_secs"}
                       for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("{")]
    assert lines["t"] == lines["j"] and len(lines["t"]) == 2
    assert tree_bytes(tmp_path / "t") == tree_bytes(tmp_path / "j")


@pytest.mark.parametrize("spec", ["cifar10:cifar", "folder:folder",
                                  "shards:shards"])
def test_train_cli_epoch_then_eval(sources, tmp_path, capsys, spec):
    """One train-CLI epoch of tiny (fp32, 24², patch 8) on each on-disk
    source, then ``vitx_torch.cli.eval`` on its checkpoint reports the
    accuracy the trainer logged, over the whole val split."""
    kind, _, rel = spec.partition(":")
    data = ["--data", f"{kind}:{sources / rel}"]
    common = ["--preset", "tiny", "--batch-size", "8", "--device", "cpu"]
    ck = str(tmp_path / "ck")
    assert ttrain.main(common + data + [
        "--image-size", str(SIZE), "--compute-dtype", "float32",
        "--epochs", "1", "--lr", "1e-3", "--checkpoint-dir", ck]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epoch"] == 0 and np.isfinite(out["loss"])
    _, val = ttrain.make_datasets(f"{kind}:{sources / rel}", CFG_T, 0)
    assert teval.main(common + data + ["--checkpoint", ck]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["accuracy"] == out["val_accuracy"]
    assert rep["num_examples"] == len(val)
    assert list(rep["per_class_f1"]) == list(val.classes)
