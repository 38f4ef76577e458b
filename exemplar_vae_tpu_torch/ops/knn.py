"""Pairwise distances and the bank encode (counterpart of part of
exemplar_vae_tpu/ops/knn.py). ``knn_indices`` waits for the approximate-prior
slice."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def pairwise_sq_dist(q, bank):
    """(B, N) squared Euclidean distances via one matmul."""
    q = q.to(torch.float32)
    bank = bank.to(torch.float32)
    q_sq = torch.sum(torch.square(q), dim=-1, keepdim=True)
    b_sq = torch.sum(torch.square(bank), dim=-1)[None, :]
    return torch.clamp_min(q_sq + b_sq - 2.0 * (q @ bank.T), 0.0)


def encode_bank_with_grad(model, bank_images, *, chunk: int = 8192,
                          remat: bool = True, pre_fn=None):
    """Encode the whole exemplar bank -> (N, Dz) latent means, with
    gradients to the encoder: the exact prior's per-step re-encode.

    ``chunk <= 0`` (or >= N) is one encode; otherwise ``chunk`` rows at a
    time, the last chunk ragged. ``remat`` recomputes each chunk's
    activations in the backward (torch.utils.checkpoint) instead of keeping
    them, so memory stays O(chunk). ``pre_fn(xc) -> xc`` preprocesses each
    chunk right before it is encoded, inside the recomputed region, so a
    raw uint8 bank stays raw on the device."""

    def enc(xc):
        if pre_fn is not None:
            xc = pre_fn(xc)
        return model.encode_top_mean(xc)

    def run(xc):
        if remat:
            return checkpoint(enc, xc, use_reentrant=False)
        return enc(xc)

    n = bank_images.shape[0]
    if chunk is None or chunk <= 0 or chunk >= n:
        return run(bank_images)
    return torch.cat([run(bank_images[s:s + chunk])
                      for s in range(0, n, chunk)], dim=0)


@torch.no_grad()
def encode_bank(model, bank_images, *, chunk: int = 8192, pre_fn=None):
    """The eval-time encode: as encode_bank_with_grad, without gradients
    (so without remat)."""
    return encode_bank_with_grad(model, bank_images, chunk=chunk, remat=False,
                                 pre_fn=pre_fn)
