"""kNN selection over the cached exemplar means (counterpart of
exemplar_vae_tpu/ops/knn.py).

The approximate prior's cache holds exemplar latent means encoded by a
snapshot of the encoder (refreshed once per epoch, no gradient); per batch
point the K nearest cache rows by Euclidean distance are selected here, and
the caller re-encodes them through the current encoder with gradients
(train/bank.py encodes the bank)."""

from __future__ import annotations

import torch


def pairwise_sq_dist(q, bank):
    """(B, N) squared Euclidean distances via one matmul."""
    q = q.to(torch.float32)
    bank = bank.to(torch.float32)
    q_sq = torch.sum(torch.square(q), dim=-1, keepdim=True)
    b_sq = torch.sum(torch.square(bank), dim=-1)[None, :]
    return torch.clamp_min(q_sq + b_sq - 2.0 * (q @ bank.T), 0.0)


def smallest_k(d, k: int):
    """(values, columns) of the min(k, N) smallest entries of each row of
    the (B, N) fp32 distances ``d`` (>= 0 or +inf), smallest first.

    Ties break to the lowest column, as ``lax.top_k`` does: the top-k runs
    over one int64 key per entry, the distance's fp32 bits (monotone for
    distances >= 0, +inf included) above the column index, so every key is
    distinct and the order is exact on the CPU and on the card alike."""
    n = d.shape[1]
    # clamp_min(0) maps -0.0 (bits 0x80000000) to +0.0
    bits = d.view(torch.int32).clamp_min(0).to(torch.int64)
    keys = (bits << 32) | torch.arange(n, device=d.device)
    nearest = torch.topk(keys, min(k, n), dim=1, largest=False).values
    return (nearest >> 32).to(torch.int32).view(torch.float32), \
        nearest & 0xFFFFFFFF


def knn_indices(q_means, cache_means, k: int, *, valid=None):
    """(B, min(k, N)) int64 indices of the nearest cache rows per query,
    nearest first, ties to the lowest index (smallest_k). ``valid`` (N,)
    bool: False rows (padding) get distance +inf and are never picked while
    k valid rows remain."""
    d = pairwise_sq_dist(q_means.detach(), cache_means.detach())
    if valid is not None:
        d = torch.where(valid[None, :], d, torch.inf)
    return smallest_k(d, k)[1]


def dedup_valid_mask(flat_idx):
    """True where an entry of the flat index vector is the first occurrence
    of its value: the batch-union support keeps all B*K selected indices at
    a static shape and masks the repeats, so a logsumexp over it equals one
    over the unique union."""
    order = torch.argsort(flat_idx, stable=True)
    sorted_ = flat_idx[order]
    dup_sorted = torch.cat([torch.zeros(1, dtype=torch.bool,
                                        device=flat_idx.device),
                            sorted_[1:] == sorted_[:-1]])
    dup = torch.empty_like(dup_sorted)
    dup[order] = dup_sorted
    return ~dup

