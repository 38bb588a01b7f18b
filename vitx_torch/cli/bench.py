"""Benchmark CLI: ``python -m vitx_torch.cli.bench [--config N|all]``.

The counterpart of ``vitx/cli/bench.py``: vitx's benchmark configurations
(``BENCHES``), each printing one JSON line with vitx's ``config`` string
and keys, on one card (4 and 9: data parallel over every card, one rank
process each):

  1 ViT-Tiny 64x64 4-class, batch 8 (forward + train step)
  2 ViT-Small/16 @224 with the augmentation pipeline, batch 32 (train)
  3 ViT-Base/16 @224 batched inference, batch 256
  4 ViT-Base/16 @224 train step, batch 128 a card (dp over every card)
  5 ViT-Large/16 @384 inference with attention rollout, batch 8
  6 ViT-Base/16 @224 batch-256 inference with ToMe (r=13, (35, 34))
  7 ViT-Base/16 @224 serving latency at batch 1/4/8
  8 ViT-Large/16 @384 batch-32 inference with ToMe (r=23, to 128)
  9 ViT-Base/16 @224 batch-128-a-card train with patch dropout (dp)
 10 Soft-MoE ViT-B (8 experts over the last 6 blocks): inference batch
    256, train step batch 128
 11 the end-to-end input pipeline from disk
 12 ViT-Base/16 @224 batch-128 train with ToMe-train (r=13, (35, 34))
 13 ViT-Huge/14: inference batch 32, train batch 8 (head width 128)
 14 the base16 train step's remainder, itemised

Timing (``timed``): CUDA events around ``iters`` back-to-back calls after
a warm-up call, per call; each key holds the minimum over the reps and
``<key>_median`` the median. vitx's device loops and its anti-hoist
scaling have no counterpart: PyTorch runs each call eagerly. Every line
names its device; ``--device cpu`` runs the plain versions and gives CPU
times, never the card's. Rooflines use the H100 SXM's data-sheet rates:
989 TFLOP/s bf16, 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vitx_torch.core.device import resolve_device

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
HBM_BYTES_S = 3.35e12         # H100 SXM HBM3
BENCH_DATA = Path(__file__).resolve().parents[2] / ".bench_data"


def timed(fn, iters: int, reps: int, dev, warmup: int = 1) -> list:
    """ms a call of ``fn`` in each of ``reps`` runs of ``iters`` calls
    back to back, after ``warmup`` calls: CUDA events on the card, the host
    clock after a final synchronisation elsewhere."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / iters)
    return runs


def _put(out: dict, key: str, runs: list) -> float:
    """out[key] = the min of ``runs``, out[key_median] their median;
    returns the min."""
    out[key] = min(runs)
    out[f"{key}_median"] = statistics.median(runs)
    return out[key]


def _rate(out: dict, key: str, batch: int, ms: float) -> None:
    out[key] = batch / (ms / 1e3)


def device_name(dev) -> str:
    """What a line's "device" names: the card, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _images(b: int, s: int, dev, seed: int, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((b, s, s, 3), generator=g, device=dev).to(dtype)


def _n(iters, default: int) -> int:
    return default if iters is None else iters


def train_timing(cfg, batch_size, iters, reps, dev, stochastic=False,
                  seed=0, image_seed=1):
    """ms a train step (plain AdamW, lr 1e-4, as vitx's benches build it)
    at ``batch_size``, the batch on the card; ``stochastic`` feeds the
    step a generator (patch dropout, dropout)."""
    from vitx_torch.train.step import (create_train_state, make_optimizer,
                                       make_train_step)

    opt = make_optimizer(lr=1e-4)
    state = create_train_state(seed, cfg, opt, device=dev)
    step = make_train_step(cfg, opt, device=dev)
    batch = {"image": _images(batch_size, cfg.image_size, dev, image_seed,
                              cfg.cdtype()),
             "label": torch.zeros((batch_size,), dtype=torch.int32,
                                  device=dev)}
    gen = torch.Generator(device=dev).manual_seed(7) if stochastic else None
    # the step updates the state's tensors in place
    return timed(lambda: step(state, batch, gen), iters, reps, dev)


def dp_train_timing(cfg, per_device: int, iters, reps, device, devices: int,
                    stochastic=False) -> list:
    """``train_timing`` of a data-parallel step over ``devices`` rank
    processes (``vitx_torch.parallel.spawn``: nccl with a card each, gloo
    ranks on the CPU), ``per_device`` rows each -> rank 0's runs."""
    from vitx_torch.parallel import spawn

    return spawn(_dp_train_rank, devices, (cfg.to_json(), per_device,
                                           iters, reps, stochastic),
                 device=str(device))[0]


def _dp_train_rank(ctx, cfg_json: str, per_device: int, iters, reps,
                   stochastic) -> list:
    from vitx_torch.core.config import ViTConfig
    from vitx_torch.parallel import make_mesh, sharded
    from vitx_torch.train.step import create_train_state, make_optimizer

    cfg = ViTConfig.from_json(cfg_json)
    mesh = make_mesh(ctx.world, device=ctx.device)
    dev = mesh.device
    opt = make_optimizer(lr=1e-4)
    whole = create_train_state(0, cfg, opt, device=dev)
    specs = sharded.state_sharding(whole, cfg, mesh)
    state = sharded.place_state(whole, cfg, mesh, specs=specs)
    del whole
    step = sharded.make_parallel_train_step(cfg, opt, mesh,
                                            state_shardings=specs)
    batch = {"image": _images(per_device, cfg.image_size, dev, 1 + ctx.rank,
                              cfg.cdtype()),
             "label": torch.zeros((per_device,), dtype=torch.int32,
                                  device=dev)}
    gen = torch.Generator(device=dev).manual_seed(7) if stochastic else None
    # the step updates the rank's state in place
    return timed(lambda: step(state, batch, gen), iters, reps, dev)


def _dp_devices(dev, devices) -> int:
    """The data ranks of benches 4 and 9: every card (one on the CPU)."""
    if devices is not None:
        return devices
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def forward_timing(cfg, batch_size, iters, reps, dev, seed=1):
    """ms a forward (``vitx_torch.forward``) at ``batch_size``, fresh
    params (seed 0) and the images on the card."""
    from vitx_torch.nn.vit import forward, init_params

    params = init_params(0, cfg, device=dev)
    x = _images(batch_size, cfg.image_size, dev, seed, cfg.cdtype())
    return timed(lambda: forward(params, x, cfg, device=dev), iters, reps,
                 dev)


def bench_1(device="cuda", iters=None, reps=3):
    """ViT-Tiny b8: the forward and the train step, then vitx's dispatch
    rows (``vitx/cli/bench.py:114-135``): for k in 1, 4, 16 the Trainer's
    ``steps_per_dispatch`` path (``Trainer.dispatch_steps``: k batches
    stacked and placed once, k steps issued back to back) over max(64 //
    k, 4) dispatches, per step; their k copies of the batch are on the
    card, as vitx's are."""
    from vitx_torch.core.config import get_config
    from vitx_torch.train.loop import Trainer, TrainerConfig

    dev = resolve_device(device)
    cfg = get_config("tiny")
    out = {"config": "1:vit-tiny-64", "device": device_name(dev)}
    _put(out, "forward_ms", forward_timing(cfg, 8, _n(iters, 200), reps,
                                            dev))
    dt = _put(out, "train_step_ms", train_timing(cfg, 8, _n(iters, 100),
                                                  reps, dev))
    _rate(out, "train_images_per_sec", 8, dt)
    batch = {"image": _images(8, cfg.image_size, dev, 1, cfg.cdtype()),
             "label": torch.zeros((8,), dtype=torch.int32, device=dev)}
    for k in (1, 4, 16):
        tr = Trainer(cfg, TrainerConfig(lr=1e-4, steps_per_dispatch=k),
                     device=dev)
        n_disp = max(64 // k, 4) if iters is None else iters
        runs = timed(lambda: tr.dispatch_steps([batch] * k, 0, 0), n_disp,
                     reps, dev)
        dt = _put(out, f"train_step_ms_k{k}", [r / k for r in runs])
        _rate(out, f"train_images_per_sec_k{k}", 8, dt)
    return out


def bench_2(device="cuda", iters=None, reps=3):
    """ViT-S/16 b32 train with the augmentation pipeline in every step:
    uint8 256² images on the card, random-resized to 224² and flipped
    (``make_preprocess``), then the step."""
    from vitx_torch.core.config import get_config
    from vitx_torch.data import make_preprocess
    from vitx_torch.train.step import (create_train_state, make_optimizer,
                                       make_train_step)

    dev = resolve_device(device)
    cfg = get_config("small16")
    opt = make_optimizer(lr=1e-4)
    state = create_train_state(0, cfg, opt, device=dev)
    step = make_train_step(cfg, opt, device=dev)
    pre = make_preprocess(out_size=cfg.image_size, random_flip=True)
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (32, 256, 256, 3), dtype=np.uint8)).to(dev)
    labels = torch.zeros((32,), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def one():
        imgs = pre(u8, gen, train=True).to(cfg.cdtype())
        step(state, {"image": imgs, "label": labels}, gen)

    out = {"config": "2:vit-s16-augment-train", "device": device_name(dev)}
    dt = _put(out, "step_ms", timed(one, _n(iters, 50), reps, dev))
    _rate(out, "images_per_sec", 32, dt)
    return out


def bench_3(device="cuda", iters=None, reps=3):
    """ViT-B/16 b256 inference (K1 and K2 in every block)."""
    from vitx_torch.core.config import get_config

    dev = resolve_device(device)
    out = {"config": "3:vit-b16-infer-256", "device": device_name(dev)}
    dt = _put(out, "step_ms", forward_timing(get_config("base16"), 256,
                                              _n(iters, 20), reps, dev))
    _rate(out, "images_per_sec", 256, dt)
    return out


def bench_4(device="cuda", iters=None, reps=3, devices=None,
            per_device_batch=128, cfg=None):
    """ViT-B/16 train step at 128 a device, data parallel over every card
    (``vitx/cli/bench.py:195-224``): B = 128 n, config ``...-dp{n}``; one
    process at n = 1, n rank processes past it (``devices`` and
    ``per_device_batch``, and ``cfg`` in base16's place, cut the run to a
    test's size)."""
    from vitx_torch.core.config import get_config

    dev = resolve_device(device)
    n = _dp_devices(dev, devices)
    cfg = cfg or get_config("base16")
    B = per_device_batch * n
    out = {"config": f"4:vit-b16-train-dp{n}", "device": device_name(dev)}
    runs = (train_timing(cfg, B, _n(iters, 10), reps, dev) if n == 1 else
            dp_train_timing(cfg, per_device_batch, _n(iters, 10), reps, dev,
                            n))
    dt = _put(out, "step_ms", runs)
    _rate(out, "images_per_sec", B, dt)
    out.update(devices=n, per_device_batch=per_device_batch)
    return out


def bench_5(device="cuda", iters=None, reps=3):
    """ViT-L/16 @384 b8 inference with attention rollout
    (``forward_with_rollout``: B7 and K2 in every block, the fp32 chain)."""
    from vitx_torch.core.config import get_config
    from vitx_torch.nn.vit import forward_with_rollout, init_params

    dev = resolve_device(device)
    cfg = get_config("large16_384")
    params = init_params(0, cfg, device=dev)
    x = _images(8, cfg.image_size, dev, 1, cfg.cdtype())
    out = {"config": "5:vit-l16-384-rollout", "device": device_name(dev)}
    dt = _put(out, "step_ms", timed(
        lambda: forward_with_rollout(params, x, cfg, device=dev),
        _n(iters, 20), reps, dev))
    _rate(out, "images_per_sec", 8, dt)
    return out


def bench_6(device="cuda", iters=None, reps=3):
    """ViT-B/16 b256 inference with ToMe at r=13 and the (35, 34)
    schedule (B8 and K2 in every block)."""
    from vitx_torch.core.config import get_config

    dev = resolve_device(device)
    out = {"config": "6:vit-b16-infer-256-tome", "device": device_name(dev)}
    for tag, r in (("r13", 13), ("sched_35_34", (35, 34))):
        dt = _put(out, f"{tag}_step_ms", forward_timing(
            get_config("base16", tome_r=r), 256, _n(iters, 20), reps, dev))
        _rate(out, f"{tag}_images_per_sec", 256, dt)
    return out


def bench_7(device="cuda", iters=None, reps=3):
    """Serving latency: ViT-B/16 at request-sized batches 1, 4, 8 through
    the predict program (forward, fp32 softmax, top-5), the device's time
    alone (the batcher and HTTP add host time)."""
    from vitx_torch.core.config import get_config
    from vitx_torch.nn.vit import forward, init_params

    dev = resolve_device(device)
    cfg = get_config("base16")
    params = init_params(0, cfg, device=dev)
    out = {"config": "7:vit-b16-serving-latency",
           "device": device_name(dev)}
    for b in (1, 4, 8):
        x = _images(b, cfg.image_size, dev, b, cfg.cdtype())

        def predict(x=x):
            probs = torch.softmax(forward(params, x, cfg, device=dev).float(),
                                  dim=-1)
            return torch.topk(probs, min(5, cfg.num_classes), dim=-1)

        _put(out, f"float_b{b}_ms", timed(predict, _n(iters, 50), reps, dev))
    return out


def bench_8(device="cuda", iters=None, reps=3):
    """ViT-L/16 @384 b32 inference with ToMe at r=23 and the schedule to
    128 tokens by block 7."""
    from vitx_torch.core.config import get_config

    dev = resolve_device(device)
    out = {"config": "8:vit-l16-384-infer-32-tome",
           "device": device_name(dev)}
    for tag, r in (("r23", 23),
                   ("sched_to128", (65, 64, 64, 64, 64, 64, 64))):
        dt = _put(out, f"{tag}_step_ms", forward_timing(
            get_config("large16_384", tome_r=r), 32, _n(iters, 10), reps,
            dev))
        _rate(out, f"{tag}_images_per_sec", 32, dt)
    return out


def bench_9(device="cuda", iters=None, reps=3, devices=None,
            per_device_batch=128, cfg=None):
    """ViT-B/16 train at 128 a device with patch dropout at p=0.25 and 0.5
    (T 148 and 99), a fresh subset every step, data parallel over every
    card as bench 4 (``vitx/cli/bench.py:338-368``)."""
    from vitx_torch.core.config import get_config

    dev = resolve_device(device)
    n = _dp_devices(dev, devices)
    base = cfg or get_config("base16")
    B = per_device_batch * n
    out = {"config": f"9:vit-b16-train-128-patchdrop-dp{n}",
           "device": device_name(dev)}
    for tag, pdrop in (("p25", 0.25), ("p50", 0.5)):
        c = base.replace(patch_drop=pdrop)
        runs = (train_timing(c, B, _n(iters, 10), reps, dev,
                             stochastic=True) if n == 1 else
                dp_train_timing(c, per_device_batch, _n(iters, 10), reps,
                                dev, n, stochastic=True))
        dt = _put(out, f"{tag}_step_ms", runs)
        _rate(out, f"{tag}_images_per_sec", B, dt)
    return out


def bench_10(device="cuda", iters=None, reps=3):
    """Soft-MoE ViT-B/16 (``base16`` with 8 experts over the last 6
    blocks, 24 slots an expert; ~285 M parameters, ~3.3x dense): the
    forward at batch 256 as bench 3 times it and the train step at 128 as
    bench 4 does. The MoE blocks run K1 for their attention and
    ``soft_moe_mlp``'s batched products for their MLP; the dense ones K1
    and K2."""
    from vitx_torch.core.config import get_config
    from vitx_torch.nn.vit import forward, init_params
    from vitx_torch.train.step import leaves

    dev = resolve_device(device)
    cfg = get_config("base16", moe_experts=8, moe_blocks=6)
    params = init_params(0, cfg, device=dev)
    out = {"config": "10:vit-b16-softmoe-e8x6", "device": device_name(dev),
           "params_millions": sum(t.numel() for t in leaves(params)) / 1e6}
    x = _images(256, cfg.image_size, dev, 1, cfg.cdtype())
    dt = _put(out, "infer_step_ms", timed(
        lambda: forward(params, x, cfg, device=dev), _n(iters, 20), reps,
        dev))
    _rate(out, "infer_images_per_sec", 256, dt)
    del params, x
    dt = _put(out, "train_step_ms", train_timing(
        cfg, 128, _n(iters, 10), reps, dev))
    _rate(out, "train_images_per_sec", 128, dt)
    return out


def _e2e_dataset_dirs(n_images=5120, classes=4, src_size=256, out_size=224):
    """Build once, under ``<repo>/.bench_data`` (git-ignored), the two disk
    forms the end-to-end bench reads: ``jpeg/``, class folders of 256²
    quality-87 JPEGs, and ``raw224/``, the same images as raw uint8 tar
    shards at 224² (``cli.pack --format raw``)."""
    import shutil

    from PIL import Image

    from vitx_torch.data import FolderDataset, SyntheticDataset, write_shards

    root = BENCH_DATA / f"e2e_{n_images}_{src_size}_{out_size}"
    jpeg, raw = root / "jpeg", root / "raw224"
    done = root / ".done"
    if not done.exists():
        # a build cut short leaves partial trees that write_shards refuses
        if root.exists():
            shutil.rmtree(root)
        src = SyntheticDataset(num_examples=n_images, image_size=src_size,
                               num_classes=classes, seed=0, noise=0.06)
        for i in range(n_images):
            img, label = src.get_example(i)
            d = jpeg / f"class_{label}"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(d / f"{i:06d}.jpg", quality=87)
        write_shards(FolderDataset(jpeg, test_size=None, image_size=out_size),
                     raw, shard_size=1024, image_format="raw")
        done.touch()
    return jpeg, raw


def bench_11(device="cuda", iters=None, reps=3, n_images=5120):
    """The end-to-end input pipeline at ViT-B/16 shapes: host-to-device
    bandwidth of a b128 uint8 batch; the loader alone (``BatchLoader``, 8
    threads) from JPEG folders and raw shards; the ``Trainer``'s epoch
    (b128, flips on the card; its first epoch warms, the second is
    measured) and a b256 inference pass from each through
    ``device_prefetch``."""
    import os

    from vitx_torch.core.config import get_config
    from vitx_torch.data import (BatchLoader, FolderDataset, ShardDataset,
                                 make_preprocess)
    from vitx_torch.data.pipeline import device_prefetch
    from vitx_torch.nn.vit import forward, init_params
    from vitx_torch.train.loop import Trainer, TrainerConfig

    dev = resolve_device(device)
    jpeg_dir, raw_dir = _e2e_dataset_dirs(n_images=n_images)
    out = {"config": "11:e2e-input-pipeline", "device": device_name(dev),
           "host_cpus": os.cpu_count()}

    arrs = [np.random.default_rng(i).integers(0, 255, (128, 224, 224, 3))
            .astype(np.uint8) for i in range(3)]
    torch.from_numpy(arrs[0]).to(dev).float().sum().item()       # warm
    best = float("inf")
    for a in arrs:
        t0 = time.perf_counter()
        torch.from_numpy(a).to(dev).float().sum().item()
        best = min(best, time.perf_counter() - t0)
    out["h2d_mb_s"] = arrs[0].nbytes / best / 1e6
    out["h2d_img_s_cap_b128_224"] = 128 / best

    ds_jpeg = FolderDataset(jpeg_dir, test_size=None, image_size=224)
    ds_raw = ShardDataset(raw_dir, test_size=None)
    for tag, ds in (("jpeg", ds_jpeg), ("raw", ds_raw)):
        loader = BatchLoader(ds, 128, shuffle=True, drop_last=True,
                             num_threads=8)
        for _ in loader:          # the first pass warms the page cache
            pass
        t0 = time.perf_counter()
        cnt = sum(b["image"].shape[0] for b in loader)
        out[f"loader_{tag}_img_s"] = cnt / (time.perf_counter() - t0)

    cfg = get_config("base16", num_classes=4)
    pre = make_preprocess(out_size=None, random_flip=True)
    for tag, ds in (("raw", ds_raw), ("jpeg", ds_jpeg)):
        loader = BatchLoader(ds, 128, shuffle=True, drop_last=True,
                             num_threads=8)
        tr = Trainer(cfg, TrainerConfig(epochs=2, log_every=10**9),
                     preprocess=pre, device=dev)
        tr._train_epoch(loader, 0, None)
        stats = tr._train_epoch(loader, 1, None)
        out[f"train_e2e_{tag}_img_s"] = stats["images_per_sec"]
        del tr

    params = init_params(0, cfg, device=dev)

    def run_infer(ds):
        loader = BatchLoader(ds, 256, drop_last=True, num_threads=8)
        cnt, logits = 0, None
        t0 = time.perf_counter()
        for b in device_prefetch(iter(loader), size=2, device=dev):
            x = pre(b["image"], None, train=False).to(cfg.cdtype())
            logits = forward(params, x, cfg, device=dev)
            cnt += x.shape[0]
        logits.sum().item()
        return cnt / (time.perf_counter() - t0)

    for tag, ds in (("raw", ds_raw), ("jpeg", ds_jpeg)):
        run_infer(ds)                        # warm
        out[f"infer_e2e_{tag}_img_s"] = run_infer(ds)
    out["n_images"] = len(ds_jpeg)
    return out


def bench_12(device="cuda", iters=None, reps=3):
    """ViT-B/16 b128 train with training-time ToMe (``tome_train``) at
    r=13 and the (35, 34) schedule: B8 forward, its composed backward."""
    from vitx_torch.core.config import get_config

    dev = resolve_device(device)
    out = {"config": "12:vit-b16-train-128-tome-train",
           "device": device_name(dev)}
    for tag, r in (("r13", 13), ("sched_35_34", (35, 34))):
        dt = _put(out, f"{tag}_step_ms", train_timing(
            get_config("base16", tome_r=r, tome_train=True), 128,
            _n(iters, 10), reps, dev, stochastic=True))
        _rate(out, f"{tag}_images_per_sec", 128, dt)
    return out


def bench_13(device="cuda", iters=None, reps=3):
    """ViT-Huge/14 (``huge14``: E 1280, depth 32, 10 heads of D 128,
    M 5120): inference b32 and a train step b8 on one card. The blocks'
    attention runs the sm90 body at D 128, their products the sm90 GEMM;
    the step's attention backward B2's sm90 kernel."""
    from vitx_torch.core.config import get_config
    from vitx_torch.nn.vit import forward, init_params
    from vitx_torch.train.step import leaves

    dev = resolve_device(device)
    cfg = get_config("huge14")
    params = init_params(0, cfg, device=dev)
    out = {"config": "13:vit-h14", "device": device_name(dev),
           "params_millions": sum(t.numel() for t in leaves(params)) / 1e6}
    x = _images(32, cfg.image_size, dev, 1, cfg.cdtype())
    dt = _put(out, "infer_b32_ms", timed(
        lambda: forward(params, x, cfg, device=dev), _n(iters, 10), reps,
        dev))
    _rate(out, "infer_images_per_sec", 32, dt)
    del params, x
    dt = _put(out, "train_b8_step_ms", train_timing(
        cfg, 8, _n(iters, 5), reps, dev, seed=2, image_seed=3))
    _rate(out, "train_images_per_sec", 8, dt)
    return out


def _grads_sum(grads) -> torch.Tensor:
    return sum(g.float().sum() for g in grads if g is not None)


def bench_14(device="cuda", iters=None, reps=3):
    """Itemise the base16 b128 train step: each row an isolated forward +
    backward beside its own bound, and the components measured in this
    run (vitx carried its from a table).

    - LN seam: one ``add_layer_norm`` forward + backward at the step's
      (B, T, E) bf16 -- bytes-bound: the forward reads x and the residual
      and writes the sum and the normed (4 passes), the backward ~5.
    - patchify / embed: ``embed_tokens``'s product + CLS / positions,
      forward + backward; its bound 3x the forward's product at 989
      TFLOP/s.
    - head + loss: the reference head and the softmax cross-entropy.
    - components: one block's attention half (K1 with its stash, its
      backward B2 and B3) and MLP half (K2, B3) forward + backward, times
      the depth, plus the optimizer's update: ``ln_seams_in_step_ms`` is
      the step less these, the patchify and the head -- the residual adds
      and casts between them.
    """
    from vitx_torch.core.config import get_config
    from vitx_torch.kernels import fused_mha_block, fused_mlp_block
    from vitx_torch.nn.layers import add_layer_norm
    from vitx_torch.nn.vit import classify, embed_tokens, init_params, unstack
    from vitx_torch.train.step import (cross_entropy_loss, leaves,
                                       make_optimizer)

    dev = resolve_device(device)
    n = _n(iters, 50)
    cfg = get_config("base16")
    B, T, E, M = 128, cfg.seq_len, cfg.embed_dim, cfg.mlp_dim
    eps = cfg.layer_norm_eps
    bf = torch.bfloat16
    out = {"config": "14:train-step-remainder-itemization",
           "device": device_name(dev)}

    x = torch.randn((B, T, E), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).to(bf).requires_grad_()
    pend = torch.randn((B, T, E), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(bf).requires_grad_()
    g = torch.ones(E, device=dev, requires_grad=True)
    bb = torch.zeros(E, device=dev, requires_grad=True)

    def ln_body():
        s, y = add_layer_norm(x, pend, g, bb, eps=eps)
        v = y.float().sum() + s.float().sum()
        return _grads_sum(torch.autograd.grad(v, (x, pend, g, bb)))

    dt_ln = _put(out, "ln_seam_fwdbwd_ms", timed(ln_body, n, reps, dev))
    bytes_ln = (B * T * E * 2) * (4 + 5)
    out["ln_seam_roofline_ms"] = bytes_ln / HBM_BYTES_S * 1e3
    out["ln_seam_per_step_ms"] = dt_ln * 2 * cfg.depth
    del x, pend

    params = init_params(2, cfg, device=dev)
    imgs = _images(B, cfg.image_size, dev, 3, cfg.cdtype())
    req = {k: v.detach().requires_grad_() for k, v in params.items()
           if not isinstance(v, dict)}
    req["patch_embed"] = {k: v.detach().requires_grad_()
                          for k, v in params["patch_embed"].items()}

    def emb_body():
        t = embed_tokens(req, imgs, cfg)
        return _grads_sum(torch.autograd.grad(t.float().sum(),
                                              leaves(req)))

    _put(out, "patchify_fwdbwd_ms", timed(emb_body, n, reps, dev))
    fl_emb = 3 * 2 * B * cfg.num_patches * E * (cfg.patch_size ** 2 * 3)
    out["patchify_roofline_ms"] = fl_emb / PEAK_BF16_FLOPS * 1e3

    toks = torch.randn((B, T, E), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev).to(bf)
    labels = torch.zeros((B,), dtype=torch.int32, device=dev)
    head = {"head": {k: v.detach().requires_grad_()
                     for k, v in params["head"].items()}}

    def head_body():
        loss = cross_entropy_loss(classify(head, toks, cfg), labels)
        return _grads_sum(torch.autograd.grad(loss, leaves(head)))

    _put(out, "head_loss_fwdbwd_ms", timed(head_body, n, reps, dev))

    bp = {k: v.detach().requires_grad_()
          for k, v in unstack(params["blocks"])[0].items()}
    xb = toks.detach().requires_grad_()
    dy = torch.randn((B, T, E), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev).to(bf) * 0.1

    def mha_body():
        o = fused_mha_block(xb, bp["wqkv"].to(bf), bp["wo"].to(bf),
                            torch.zeros(E, device=dev), bp["ln1_scale"],
                            bp["ln1_bias"], eps=eps)
        return _grads_sum(torch.autograd.grad(
            o, (xb, bp["wqkv"], bp["wo"], bp["ln1_scale"], bp["ln1_bias"]),
            dy))

    def mlp_body():
        o = fused_mlp_block(xb, bp["w1"].to(bf), bp["b1"], bp["w2"].to(bf),
                            bp["b2"], bp["ln2_scale"], bp["ln2_bias"],
                            act=cfg.mlp_act, eps=eps)
        return _grads_sum(torch.autograd.grad(
            o, (xb, bp["w1"], bp["b1"], bp["w2"], bp["b2"],
                bp["ln2_scale"], bp["ln2_bias"]), dy))

    mha_ms = _put(out, "block_attention_fwdbwd_ms",
                  timed(mha_body, _n(iters, 10), reps, dev))
    mlp_ms = _put(out, "block_mlp_fwdbwd_ms",
                  timed(mlp_body, _n(iters, 10), reps, dev))
    opt = make_optimizer(lr=1e-4)
    ps = [t.detach() for t in leaves(params)]
    ost = opt.init(params)
    grads = [torch.zeros_like(t) for t in ps]
    upd = _put(out, "optimizer_update_ms", timed(
        lambda: opt.update(grads, ost, params), _n(iters, 10), reps, dev))
    del xb, bp, toks, head, req, grads, ost, ps
    dt_step = _put(out, "full_step_ms", train_timing(
        cfg, B, _n(iters, 10), reps, dev, seed=5, image_seed=3))
    comp = cfg.depth * (mha_ms + mlp_ms) + upd
    seam = dt_step - comp - out["patchify_fwdbwd_ms"] \
        - out["head_loss_fwdbwd_ms"]
    out["component_table_ms"] = comp
    out["ln_seams_in_step_ms"] = seam
    out["ln_seams_in_step_per_pair_ms"] = seam / (2 * cfg.depth)
    out["ln_seams_roofline_ratio"] = (seam / (2 * cfg.depth)
                                      / out["ln_seam_roofline_ms"])
    return out


BENCHES = {1: bench_1, 2: bench_2, 3: bench_3, 4: bench_4, 5: bench_5,
           6: bench_6, 7: bench_7, 8: bench_8, 9: bench_9, 10: bench_10,
           11: bench_11, 12: bench_12, 13: bench_13, 14: bench_14}


def main(argv=None):
    p = argparse.ArgumentParser(prog="vitx_torch.bench")
    p.add_argument("--config", default="all",
                   help="benchmark number 1-14 or 'all'")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="also write a torch.profiler trace of each bench "
                        "(DIR/bench_N.json, chrome trace format)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    which = (sorted(BENCHES) if args.config == "all"
             else [int(args.config)])
    for i in which:
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            Path(args.profile).mkdir(parents=True, exist_ok=True)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                res = BENCHES[i](device=dev)
            trace = f"{args.profile}/bench_{i}.json"
            prof.export_chrome_trace(trace)
            res["trace"] = trace
        else:
            res = BENCHES[i](device=dev)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
