"""Deterministic synthetic image data: the port's copy of
exemplar_vae_tpu/data/synthetic.py::synthetic_images (same algorithm, same
output for the same arguments). Class-structured mixtures of Gaussian blobs;
the hermetic bank and test data of chip_smoke.py. Unlike the JAX copy it
keeps no on-disk cache."""

from __future__ import annotations

import numpy as np


def synthetic_images(n: int, h: int, w: int, c: int, *, n_classes: int = 10,
                     seed: int = 0, blobs_per_class: int = 3):
    """Returns (images float32 (n,h,w,c) in [0,1], labels int32 (n,))."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)

    # fixed per-class blob layout (shared across samples of the class)
    class_rng = np.random.default_rng(12345)
    centers = class_rng.uniform(0.15, 0.85, (n_classes, blobs_per_class, 2))
    sigmas = class_rng.uniform(0.06, 0.14, (n_classes, blobs_per_class))
    amps = class_rng.uniform(0.6, 1.0, (n_classes, blobs_per_class))

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy /= max(h - 1, 1)
    xx /= max(w - 1, 1)

    # per-sample jitter of the class layout, float32 and chunked
    jitter = rng.normal(0.0, 0.04, (n, blobs_per_class, 2)).astype(np.float32)
    cy = (centers[labels, :, 0] + jitter[:, :, 0]).astype(np.float32)
    cx = (centers[labels, :, 1] + jitter[:, :, 1]).astype(np.float32)
    sg = sigmas[labels].astype(np.float32)
    am = (amps[labels] * rng.uniform(0.8, 1.2, (n, blobs_per_class))
          ).astype(np.float32)
    out = np.empty((n, h, w, c), np.float32)
    phase = (0.6 + 0.4 * np.cos(np.arange(c, dtype=np.float32)[None, :]
                                + labels[:, None].astype(np.float32) * 0.7)
             ).astype(np.float32)                      # (n, c)
    chunk = 16384
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        imgs = np.zeros((e - s, h, w), np.float32)
        for b in range(blobs_per_class):
            d2 = (yy[None] - cy[s:e, b, None, None]) ** 2 + \
                 (xx[None] - cx[s:e, b, None, None]) ** 2
            inv = (-0.5 / sg[s:e, b, None, None] ** 2).astype(np.float32)
            imgs += am[s:e, b, None, None] * np.exp(d2 * inv)
        np.clip(imgs, 0.0, 1.0, out=imgs)
        if c == 1:
            out[s:e, ..., 0] = imgs
        else:
            for k in range(c):
                np.clip(imgs * phase[s:e, k, None, None], 0, 1,
                        out=out[s:e, ..., k])
    return out, labels
