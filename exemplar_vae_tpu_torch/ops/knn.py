"""Pairwise distances and the bank encode (counterpart of part of
exemplar_vae_tpu/ops/knn.py). ``knn_indices`` waits for the approximate-prior
slice."""

from __future__ import annotations

import torch


def pairwise_sq_dist(q, bank):
    """(B, N) squared Euclidean distances via one matmul."""
    q = q.to(torch.float32)
    bank = bank.to(torch.float32)
    q_sq = torch.sum(torch.square(q), dim=-1, keepdim=True)
    b_sq = torch.sum(torch.square(bank), dim=-1)[None, :]
    return torch.clamp_min(q_sq + b_sq - 2.0 * (q @ bank.T), 0.0)


@torch.no_grad()
def encode_bank(model, bank_images, *, chunk: int = 8192, pre_fn=None):
    """Encode the whole exemplar bank -> (N, Dz) latent means, ``chunk``
    rows at a time (``chunk <= 0``: one encode). ``pre_fn(xc) -> xc``
    preprocesses each chunk right before it is encoded, so a raw uint8 bank
    stays raw on the device. No gradient: this is the eval-time encode."""
    n = bank_images.shape[0]
    if chunk is None or chunk <= 0 or chunk >= n:
        chunk = max(n, 1)
    outs = []
    for start in range(0, n, chunk):
        xc = bank_images[start:start + chunk]
        if pre_fn is not None:
            xc = pre_fn(xc)
        outs.append(model.encode_top_mean(xc))
    return torch.cat(outs, dim=0)
