"""Seeded images made on the device: a torch copy of the blob generator of
exemplar_vae_tpu_torch/data/synthetic.py (class-structured mixtures of
Gaussian blobs; a fixed per-class layout, per-image jitter and amplitude).
Every seed makes the same number and sizes of images; only their values
differ. The real MNIST and CelebA files are not used."""

from __future__ import annotations

import torch

from portbench.common import sub_seed

CHUNK = 16384
CLASS_LAYOUT_SEED = 12345


def blob_images(n: int, h: int, w: int, c: int, *, seed: int, tag: str,
                device, out_dtype=torch.float32, n_classes: int = 10,
                blobs_per_class: int = 3):
    """(n, h, w, c) images in [0, 1] (float32), or as uint8 ``x * 255``
    rounded down (the loaders' continuous convention). Made in chunks of
    CHUNK images from a generator on ``device`` seeded by (seed, tag)."""
    lay = torch.Generator(device=device).manual_seed(CLASS_LAYOUT_SEED)
    shape = (n_classes, blobs_per_class)
    centers = 0.15 + 0.7 * torch.rand(shape + (2,), generator=lay,
                                      device=device)
    sigmas = 0.06 + 0.08 * torch.rand(shape, generator=lay, device=device)
    amps = 0.6 + 0.4 * torch.rand(shape, generator=lay, device=device)

    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "data", tag))
    labels = torch.randint(0, n_classes, (n,), generator=g, device=device)
    jitter = 0.04 * torch.randn((n, blobs_per_class, 2), generator=g,
                                device=device)
    gain = 0.8 + 0.4 * torch.rand((n, blobs_per_class), generator=g,
                                  device=device)
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None].expand(h, w)
    xx = torch.linspace(0.0, 1.0, w, device=device)[None, :].expand(h, w)
    phase = 0.6 + 0.4 * torch.cos(
        torch.arange(c, device=device, dtype=torch.float32)[None, :]
        + labels[:, None].float() * 0.7)                        # (n, c)
    out = torch.empty((n, h, w, c), dtype=out_dtype, device=device)
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        lab = labels[s:e]
        cy = centers[lab, :, 0] + jitter[s:e, :, 0]             # (m, blobs)
        cx = centers[lab, :, 1] + jitter[s:e, :, 1]
        inv = -0.5 / sigmas[lab] ** 2
        am = amps[lab] * gain[s:e]
        imgs = torch.zeros((e - s, h, w), device=device)
        for b in range(blobs_per_class):
            d2 = ((yy[None] - cy[:, b, None, None]) ** 2
                  + (xx[None] - cx[:, b, None, None]) ** 2)
            imgs += am[:, b, None, None] * torch.exp(d2 * inv[:, b, None, None])
        imgs.clamp_(0.0, 1.0)
        x = (imgs[..., None] * phase[s:e, None, None, :]).clamp_(0.0, 1.0)
        if out_dtype == torch.uint8:
            x = (x * 255.0).floor_()
        out[s:e] = x.to(out_dtype)
    return out


def binarize(x, *, seed: int, tag: str):
    """A one-time Bernoulli sample of gray levels (the eval splits of a
    dynamically binarized data set), from a generator on x's device."""
    g = torch.Generator(device=x.device).manual_seed(
        sub_seed(seed, "binarize", tag))
    return (torch.rand(x.shape, generator=g, device=x.device) < x).float()

