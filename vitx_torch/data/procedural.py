"""Procedural shape-counting classification data, generated from a seed.

The port's copy of ``vitx/data/procedural.py::ProceduralShapes`` (numpy
only): each image shows 1-5 filled circles and possibly one filled square
on a cluttered background (gradient, low-frequency waves, noise and 4-7
distractor triangles), labelled ``(n_circles - 1) * 2 + has_square`` (10
classes). Pixel statistics carry no class signal, so a linear probe sits
near chance while a ViT learns the task over tens of epochs
(``CONVERGENCE.md``). Everything is deterministic in ``(seed, index)``:
for a seed both packages give the same uint8 images and labels, bit for
bit, and ``materialize()``'s cache file
(``procshapes_n{N}_s{S}_seed{seed}.npz``) is read by either.
"""

from __future__ import annotations

import os

import numpy as np

NUM_CLASSES = 10
_GRID = 4                 # 4x4 placement cells for target shapes
_MARGIN = 0.125           # safe-region margin (fraction of image size)


def _hsv_to_rgb(h, s, v):
    """Vectorized HSV -> RGB for saturated target colors."""
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = int(i) % 6
    return [(v, t, p), (q, v, p), (p, v, t),
            (p, q, v), (t, p, v), (v, p, q)][i]


class ProceduralShapes:
    """Shape-counting dataset (see module docstring). BatchLoader-compatible
    (``get_example``/``__len__``/``classes``) like SyntheticDataset."""

    def __init__(self, *, num_examples: int = 12800, image_size: int = 224,
                 seed: int = 0, cache_dir: str | None = None):
        self.image_size = image_size
        self.num_classes = NUM_CLASSES
        self.num_channels = 3
        self._seed = seed
        self._cache_dir = cache_dir
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, NUM_CLASSES,
                                   size=num_examples).astype(np.int32)
        self.classes = [f"c{k // 2 + 1}_{'sq' if k % 2 else 'nosq'}"
                        for k in range(NUM_CLASSES)]
        self.class_encoding = dict(enumerate(self.classes))
        self._images = None          # set by materialize()
        S = image_size
        self._yy, self._xx = np.mgrid[0:S, 0:S].astype(np.float32)

    def __len__(self):
        return len(self.labels)

    # ---------------------------------------------------------- rendering

    def _paste(self, img, m, color, y0, x0):
        """Alpha-composite a soft mask ``m`` (h, w) at offset (y0, x0)."""
        h, w = m.shape
        sub = img[y0:y0 + h, x0:x0 + w]
        mm = m[..., None]
        img[y0:y0 + h, x0:x0 + w] = sub * (1.0 - mm) + \
            np.asarray(color, np.float32) * mm

    def _bbox_grid(self, cy, cx, r):
        """Local coordinate grids for a (2r)^2 bounding box around (cy,cx),
        clipped to the image; returns (yy, xx, y0, x0)."""
        S = self.image_size
        y0, y1 = max(int(cy - r) - 1, 0), min(int(cy + r) + 2, S)
        x0, x1 = max(int(cx - r) - 1, 0), min(int(cx + r) + 2, S)
        return (self._yy[y0:y1, x0:x1], self._xx[y0:y1, x0:x1], y0, x0)

    def _draw_circle(self, img, cy, cx, r, color):
        yy, xx, y0, x0 = self._bbox_grid(cy, cx, r)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        self._paste(img, np.clip(r + 0.5 - d, 0.0, 1.0), color, y0, x0)

    def _draw_square(self, img, cy, cx, h, color):
        yy, xx, y0, x0 = self._bbox_grid(cy, cx, h)
        d = np.maximum(np.abs(yy - cy), np.abs(xx - cx))
        self._paste(img, np.clip(h + 0.5 - d, 0.0, 1.0), color, y0, x0)

    def _draw_triangle(self, img, pts, color):
        """Soft-edged filled triangle from 3 (y, x) vertices."""
        # CCW orientation so all inner edge distances are positive
        a, b, c = pts
        if (b[0] - a[0]) * (c[1] - a[1]) \
                - (b[1] - a[1]) * (c[0] - a[0]) < 0:
            b, c = c, b
        r = max(np.abs(pts - pts.mean(0)).max(), 2.0)
        cy, cx = pts.mean(0)
        yy, xx, y0, x0 = self._bbox_grid(cy, cx, r + 2)
        m = None
        for p, q in ((a, b), (b, c), (c, a)):
            e = q - p
            # inner signed distance of each pixel to edge p->q
            d = ((xx - p[1]) * e[0] - (yy - p[0]) * e[1]) \
                / max(np.hypot(e[0], e[1]), 1e-6)
            m = d if m is None else np.minimum(m, d)
        self._paste(img, np.clip(m + 0.5, 0.0, 1.0), color, y0, x0)

    def _generate(self, i: int):
        label = int(self.labels[i])
        n_circles, has_square = label // 2 + 1, label % 2
        rng = np.random.default_rng((self._seed, i))
        S = self.image_size
        yy, xx = self._yy, self._xx

        # --- background: muted 2-color gradient + low-freq waves + noise
        c0, c1 = rng.uniform(0.25, 0.75, (2, 3)).astype(np.float32)
        th = rng.uniform(0.0, 2 * np.pi)
        p = np.cos(th) * xx + np.sin(th) * yy
        t = (p - p.min()) / max(np.ptp(p), 1e-6)
        img = c0 + t[..., None] * (c1 - c0)
        for _ in range(2):
            f, al, ph = rng.uniform(1.5, 4.0), rng.uniform(0, np.pi), \
                rng.uniform(0, 2 * np.pi)
            wave = np.sin(2 * np.pi * f
                          * (np.cos(al) * xx + np.sin(al) * yy) / S + ph)
            img += 0.06 * wave[..., None] \
                * rng.uniform(0.5, 1.0, 3).astype(np.float32)
        img += 0.03 * rng.standard_normal((S, S, 1)).astype(np.float32)

        # --- distractor triangles (drawn FIRST: never occlude targets)
        for _ in range(int(rng.integers(4, 8))):
            cy, cx = rng.uniform(0.08 * S, 0.92 * S, 2)
            ang = rng.uniform(0, 2 * np.pi, 3) + [0, 2.1, 4.2]
            rad = rng.uniform(0.04 * S, 0.11 * S, 3)
            pts = np.stack([cy + rad * np.sin(ang),
                            cx + rad * np.cos(ang)], 1).astype(np.float32)
            self._draw_triangle(img, pts, rng.uniform(0.15, 0.95, 3))

        # --- target shapes on a jittered grid (non-overlapping cells in
        # the central safe region)
        cell = S * (1.0 - 2 * _MARGIN) / _GRID
        cells = rng.choice(_GRID * _GRID, n_circles + has_square,
                           replace=False)
        for j, ci in enumerate(cells):
            gy, gx = divmod(int(ci), _GRID)
            cy = S * _MARGIN + (gy + 0.5) * cell
            cx = S * _MARGIN + (gx + 0.5) * cell
            color = _hsv_to_rgb(rng.uniform(), rng.uniform(0.75, 1.0),
                                rng.uniform(0.75, 1.0))
            if j < n_circles:                      # circle
                r = rng.uniform(0.24 * cell, 0.42 * cell)
                jit = max(cell / 2 - r - 1.0, 0.0)
                self._draw_circle(img, cy + rng.uniform(-jit, jit),
                                  cx + rng.uniform(-jit, jit), r, color)
            else:                                  # the one square
                h = rng.uniform(0.22 * cell, 0.38 * cell)
                jit = max(cell / 2 - h - 1.0, 0.0)
                self._draw_square(img, cy + rng.uniform(-jit, jit),
                                  cx + rng.uniform(-jit, jit), h, color)

        img = np.clip(img, 0.0, 1.0)
        return (img * 255).astype(np.uint8), label

    # --------------------------------------------------------------- API

    def get_example(self, i: int):
        if self._images is not None:
            return self._images[i], int(self.labels[i])
        return self._generate(i)

    def materialize(self):
        """(images u8 (N, S, S, 3), labels i32) — the whole split as arrays,
        disk-cached when ``cache_dir`` was given (keyed by n/size/seed, so
        repeat runs — e.g. the 3-variant convergence comparison — skip the
        few-minute regeneration)."""
        if self._images is not None:
            return self._images, self.labels
        path = None
        if self._cache_dir is not None:
            os.makedirs(self._cache_dir, exist_ok=True)
            path = os.path.join(
                self._cache_dir,
                f"procshapes_n{len(self)}_s{self.image_size}"
                f"_seed{self._seed}.npz")
            if os.path.exists(path):
                z = np.load(path)
                if np.array_equal(z["labels"], self.labels):
                    self._images = z["images"]
                    return self._images, self.labels
        imgs = np.empty((len(self), self.image_size, self.image_size, 3),
                        np.uint8)
        for i in range(len(self)):
            imgs[i] = self._generate(i)[0]
        self._images = imgs
        if path is not None:
            tmp = path + ".tmp.npz"
            np.savez(tmp, images=imgs, labels=self.labels)
            os.replace(tmp, path)
        return self._images, self.labels
