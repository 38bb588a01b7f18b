"""The port's data path (vitx_torch.data) against vitx's, on the CPU.

``ProceduralShapes`` and both loaders must give vitx's bytes and batches
exactly. The augmentations run in fp32 on both sides and are held within
1e-5 absolute: each RandAugment op at fixed ``(op, mag_signed)``, random
erasing, the crop and the jitter with vitx's own draws injected (torch
cannot draw threefry's streams), and the eval path. The torch draws are
held to their distributions within 5 sigma.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitx.data import pipeline as jpipe
from vitx.data import randaugment as jra
from vitx.data.device_cache import DeviceBatchLoader as JDeviceBatchLoader
from vitx.data.loader import BatchLoader as JBatchLoader
from vitx.data.procedural import ProceduralShapes as JProcedural
from vitx.data.synthetic import SyntheticDataset as JSynthetic
from vitx_torch.data import (BatchLoader, DeviceBatchLoader,
                             ProceduralShapes, SyntheticDataset)
from vitx_torch.data import pipeline as tpipe
from vitx_torch.data import randaugment as tra

torch.set_num_threads(1)

AUG_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


@jax.jit
def vitx_layer(x, ops, mags):
    """vitx's RandAugment layer at given draws, compiled once."""
    mats = jax.vmap(lambda o, m: jra._affine_params(o, m, x.shape[1],
                                                    x.shape[2]))(ops, mags)
    return jra._color_ops(jra._warp_mxu(x, mats), ops, mags)


def images(shape=(4, 32, 32, 3), seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("size,seed", [(48, 0), (64, 3)])
def test_procedural_bit_equal(size, seed):
    a = ProceduralShapes(num_examples=6, image_size=size, seed=seed)
    b = JProcedural(num_examples=6, image_size=size, seed=seed)
    assert np.array_equal(a.labels, b.labels)
    assert a.classes == b.classes and a.num_classes == b.num_classes
    for i in range(len(a)):
        (ia, la), (ib, lb) = a.get_example(i), b.get_example(i)
        assert la == lb and ia.dtype == np.uint8 and np.array_equal(ia, ib)


@pytest.mark.parametrize("writer", ["port", "vitx"])
def test_procedural_cache_file_read_across(tmp_path, writer):
    kw = dict(num_examples=5, image_size=48, seed=2, cache_dir=str(tmp_path))
    first, second = ((ProceduralShapes, JProcedural) if writer == "port"
                     else (JProcedural, ProceduralShapes))
    imgs, labels = first(**kw).materialize()
    files = list(tmp_path.glob("procshapes_n5_s48_seed2.npz"))
    assert len(files) == 1
    reader = second(**kw)
    # the reader takes the file: poison generation to prove it
    reader._generate = None
    got, got_labels = reader.materialize()
    assert np.array_equal(got, imgs) and np.array_equal(got_labels, labels)


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_batch_loader_matches_vitx(shuffle, drop_last):
    kw = dict(num_examples=21, image_size=16, num_classes=3, seed=4)
    ours = BatchLoader(SyntheticDataset(**kw), 8, shuffle=shuffle, seed=7,
                       drop_last=drop_last, num_threads=2)
    ref = JBatchLoader(JSynthetic(**kw), 8, shuffle=shuffle, seed=7,
                       drop_last=drop_last, num_threads=2)
    assert len(ours) == len(ref)
    for epoch in (0, 1):
        got, want = _batches(ours, epoch), _batches(ref, epoch)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k],
                                                                  w[k]), k
    if not drop_last:
        assert got[-1]["mask"].tolist() == [1] * 5 + [0] * 3


@pytest.mark.parametrize("drop_last", [False, True])
def test_device_loader_matches_vitx(drop_last):
    kw = dict(num_examples=6, image_size=32, seed=1)
    ours = DeviceBatchLoader(ProceduralShapes(**kw), 4, shuffle=True,
                             seed=3, drop_last=drop_last, device="cpu")
    ref = JDeviceBatchLoader(JProcedural(**kw), 4, shuffle=True, seed=3,
                             drop_last=drop_last)
    assert len(ours) == len(ref)
    assert ours.nbytes == ref.nbytes
    for epoch in (0, 1):
        got, want = _batches(ours, epoch), _batches(ref, epoch)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in ("image", "label", "mask"):
                assert np.array_equal(g[k], w[k]), k
            assert g["image"].dtype == np.uint8 and g["label"].dtype == \
                np.int32


def test_batch_loader_stops_its_producer_and_caches():
    ds = SyntheticDataset(num_examples=40, image_size=8, seed=0)
    calls = []
    get = ds.get_example
    ds.get_example = lambda i: (calls.append(i), get(i))[1]
    loader = BatchLoader(ds, 4, num_threads=2, prefetch=1,
                         cache_decoded=True)
    before = threading.active_count()
    for _ in loader:
        break                  # the consumer walks away with a full queue
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    first = list(loader)
    n = len(calls)
    again = list(loader)       # every example now comes from the cache
    assert len(calls) == n and set(calls) == set(range(40))
    for a, b in zip(first, again):
        assert np.array_equal(a["image"], b["image"])


@pytest.mark.parametrize("op", range(14), ids=list(tra.OPS))
def test_augment_op_matches_vitx(op):
    x = images()
    worst = 0.0
    for mag in (-0.83, 0.37, 1.0):
        ops = np.full(4, op, np.int32)
        mags = np.full(4, mag, np.float32)
        ref = vitx_layer(jnp.asarray(x), jnp.asarray(ops), jnp.asarray(mags))
        got = tra.augment_layer(t(x), t(ops).long(), t(mags))
        worst = max(worst, float(np.abs(got.numpy() - np.asarray(ref)).max()))
    assert worst <= AUG_TOL, worst


def vitx_layer_draws(rng, batch, magnitude, num_layers, mag_std=0.5):
    """The (op, mag_signed) of each layer of vitx's ``rand_augment``."""
    out = []
    for _ in range(num_layers):
        rng, k_op, k_mag, k_sign = jax.random.split(rng, 4)
        op = jax.random.randint(k_op, (batch,), 0, jra._N_OPS)
        mag = jnp.clip(magnitude + mag_std * jax.random.normal(
            k_mag, (batch,)), 0.0, 10.0) / 10.0
        sign = jnp.where(jax.random.bernoulli(k_sign, 0.5, (batch,)),
                         1.0, -1.0)
        out.append((t(op).long(), t(mag * sign)))
    return out


def vitx_erase_draws(rng, shape, prob=0.25, scale=(0.02, 0.33),
                     ratio=(0.3, 3.3)):
    """(on, y0, x0, eh, ew, noise) as vitx's ``random_erasing`` draws them."""
    B, H, W, _ = shape
    k_on, k_area, k_ratio, k_y, k_x, k_noise = jax.random.split(rng, 6)
    on = jax.random.bernoulli(k_on, prob, (B,))
    area = jax.random.uniform(k_area, (B,), minval=scale[0],
                              maxval=scale[1]) * (H * W)
    aspect = jnp.exp(jax.random.uniform(k_ratio, (B,),
                                        minval=jnp.log(ratio[0]),
                                        maxval=jnp.log(ratio[1])))
    eh = jnp.clip(jnp.sqrt(area * aspect), 1.0, float(H))
    ew = jnp.clip(jnp.sqrt(area / aspect), 1.0, float(W))
    y0 = jax.random.uniform(k_y, (B,)) * (H - eh)
    x0 = jax.random.uniform(k_x, (B,)) * (W - ew)
    noise = jax.random.normal(k_noise, shape)
    return tuple(t(a) for a in (on, y0, x0, eh, ew, noise))


def test_random_erasing_matches_vitx_with_its_draws():
    x = images((8, 24, 32, 3))
    rng = jax.random.PRNGKey(5)
    ref = jax.jit(jra.random_erasing, static_argnames="prob")(
        jnp.asarray(x), rng, prob=0.6)
    on, *rect = vitx_erase_draws(rng, x.shape, prob=0.6)
    assert 0 < int(on.sum()) < 8
    got = tra.erase_rect(t(x), on, *rect)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= AUG_TOL


def test_rand_augment_matches_vitx_with_its_draws():
    x = images((8, 32, 32, 3), seed=2)
    rng = jax.random.PRNGKey(11)
    ref = jax.jit(jra.rand_augment, static_argnames=(
        "num_layers", "magnitude"))(jnp.asarray(x), rng, num_layers=2,
                                    magnitude=5.0)
    got = t(x)
    for op, mag in vitx_layer_draws(rng, 8, 5.0, 2):
        got = tra.augment_layer(got, op, mag)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= AUG_TOL


def test_recipe_preprocess_matches_vitx_with_its_draws():
    """The train path of the recipe (RandAugment m5 n2, normalise 0.5,
    flip, erase), vitx's key splits mirrored."""
    u8 = (images((6, 32, 32, 3), seed=3) * 255).astype(np.uint8)
    rng = jax.random.PRNGKey(2)
    kw = dict(out_size=32, mean=(0.5,) * 3, std=(0.5,) * 3,
              randaug_layers=2, randaug_magnitude=5.0, random_erase=0.5)
    ref = jpipe.make_preprocess(**kw)(jnp.asarray(u8), rng, train=True)
    r, k_ra = jax.random.split(rng)
    r, k_flip = jax.random.split(r)
    r, k_erase = jax.random.split(r)
    x = t(u8).float() / 255.0
    for op, mag in vitx_layer_draws(k_ra, 6, 5.0, 2):
        x = tra.augment_layer(x, op, mag)
    x = (x - 0.5) / 0.5
    x = tpipe.flip(x, t(jax.random.bernoulli(k_flip, 0.5, (6, 1, 1, 1)))
                   .reshape(6))
    x = tra.erase_rect(x, *vitx_erase_draws(k_erase, x.shape, prob=0.5))
    assert np.abs(x.numpy() - np.asarray(ref)).max() <= AUG_TOL


@pytest.mark.parametrize("size,norm", [(32, True), (20, True), (48, False)])
def test_eval_preprocess_matches_vitx(size, norm):
    u8 = (images((3, 32, 32, 3), seed=4) * 255).astype(np.uint8)
    kw = dict(out_size=size, mean=(0.5,) * 3 if norm else None,
              std=(0.5,) * 3 if norm else None, random_flip=True)
    ref = jpipe.make_preprocess(**kw)(jnp.asarray(u8), None, train=False)
    got = tpipe.make_preprocess(**kw)(t(u8), None, train=False)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= AUG_TOL


def test_crop_and_jitter_match_vitx_with_their_draws():
    x = images((4, 32, 32, 3), seed=5)
    rng = jax.random.PRNGKey(3)
    ref = jpipe._random_resized_crop(jnp.asarray(x), rng, 24, (0.3, 1.0),
                                     (3 / 4, 4 / 3))
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    area = jax.random.uniform(k1, (4,), minval=0.3, maxval=1.0)
    ratio = jnp.exp(jax.random.uniform(k2, (4,), minval=jnp.log(3 / 4),
                                       maxval=jnp.log(4 / 3)))
    ch = jnp.clip(jnp.sqrt(area / ratio) * 32, 1.0, 32.0)
    cw = jnp.clip(jnp.sqrt(area * ratio) * 32, 1.0, 32.0)
    y0 = jax.random.uniform(k3, (4,)) * (32 - ch)
    x0 = jax.random.uniform(k4, (4,)) * (32 - cw)
    got = tpipe.crop_resize(t(x), 24, t(y0), t(x0), t(ch), t(cw))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= AUG_TOL

    ref = jpipe._color_jitter(jnp.asarray(x), rng, 0.4)
    keys = jax.random.split(rng, 3)
    f = [t(jax.random.uniform(k, (4, 1, 1, 1), minval=0.6, maxval=1.4))
         for k in keys]
    got = tpipe.jitter(t(x), *f)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= AUG_TOL


def _within(count, n, p):
    return abs(count - n * p) <= 5 * np.sqrt(n * p * (1 - p))


def test_torch_draws_follow_their_distributions():
    n, m = 28000, 5.0
    gen = torch.Generator().manual_seed(0)
    op, mag = tra.draw_layer(n, gen, m)
    counts = np.bincount(op.numpy(), minlength=14)
    assert len(counts) == 14
    assert all(_within(c, n, 1 / 14) for c in counts), counts
    assert _within(int((mag > 0).sum()), n, 0.5)
    a = mag.abs().numpy()
    # |mag| * 10 ~ N(5, 0.5) clipped to [0, 10]: mean 5, std 0.5
    assert abs(a.mean() * 10 - m) <= 5 * 0.5 / np.sqrt(n)
    assert abs(a.std() * 10 - 0.5) <= 5 * 0.5 / np.sqrt(2 * n)
    u8 = torch.zeros((n, 1, 2, 3), dtype=torch.uint8)
    u8[:, :, 0] = 255
    x = tpipe.preprocess(u8, gen, out_size=None, mean=None, std=None,
                         random_flip=True, train=True)
    assert _within(int((x[:, 0, 0, 0] == 0).sum()), n, 0.5)
    on = tra.random_erasing(torch.zeros((n, 1, 1, 1)) + 7.0, gen, prob=0.25)
    assert _within(int((on != 7.0).sum()), n, 0.25)
