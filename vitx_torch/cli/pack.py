"""Pack a dataset into tar shards: ``python -m vitx_torch.cli.pack``.

The counterpart of ``vitx/cli/pack.py``, with its flags: any ``--data``
spec the train CLI takes (``make_datasets``: ``synthetic``,
``procedural[:<ntrain>,<nval>]``, ``cifar10:DIR``, ``folder:DIR``,
``shards:DIR``) becomes WebDataset-convention tar shards
(``vitx_torch.data.shards``) under ``--out/train`` and ``--out/val``,
ready for ``train --data shards:OUT``, with one JSON line per split.

``--format raw`` stores pre-decoded uint8 ``.npy`` members at
``--image-size``: serving one is a seek, a read and ``np.load``, where a
PNG or JPEG member is decoded (and resized) on the host each time; raw
members are larger on disk. It needs no PIL; ``png`` and ``jpeg`` do.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="vitx_torch.pack",
                                description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True,
                   help="source dataset: any spec the train CLI takes")
    p.add_argument("--out", required=True,
                   help="output directory (train/ + val/ created inside)")
    p.add_argument("--format", default="raw",
                   choices=("raw", "png", "jpeg"),
                   help="member encoding: raw = pre-decoded uint8 .npy "
                        "(fastest to load), png lossless, jpeg small")
    p.add_argument("--image-size", type=int, default=224,
                   help="resolution packed members are resized to (raw "
                        "members especially should match the train size)")
    p.add_argument("--shard-size", type=int, default=1000,
                   help="images per .tar shard")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from vitx_torch.cli.train import make_datasets
    from vitx_torch.core.config import get_config
    from vitx_torch.data.shards import write_shards

    # no model is built: the config only carries the image size and class
    # count into make_datasets, and patch 1 divides every size
    cfg = get_config("tiny").replace(image_size=args.image_size,
                                     patch_size=1)
    train_ds, eval_ds = make_datasets(args.data, cfg, args.seed)
    out = pathlib.Path(args.out)
    for split, ds in (("train", train_ds), ("val", eval_ds)):
        t0 = time.perf_counter()
        paths = write_shards(ds, out / split, shard_size=args.shard_size,
                             image_format=args.format)
        dt = time.perf_counter() - t0
        total = sum(q.stat().st_size for q in paths)
        print(json.dumps({
            "split": split, "images": len(ds), "shards": len(paths),
            "bytes": total, "format": args.format,
            "bytes_per_image": round(total / max(len(ds), 1)),
            "pack_secs": round(dt, 1),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
