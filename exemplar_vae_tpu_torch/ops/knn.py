"""kNN selection over the cached exemplar means, and the bank encode
(counterpart of exemplar_vae_tpu/ops/knn.py).

The approximate prior's cache holds exemplar latent means encoded by a
snapshot of the encoder (refreshed once per epoch, no gradient); per batch
point the K nearest cache rows by Euclidean distance are selected here, and
the caller re-encodes them through the current encoder with gradients."""

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


def encode_bank_with_grad(model, bank_images, *, chunk: int = 8192,
                          remat: bool = True, pre_fn=None, draw_fn=None):
    """Encode the whole exemplar bank -> (N, Dz) latent means, with
    gradients to the encoder: the exact prior's per-step re-encode.

    ``chunk <= 0`` (or >= N) is one encode; otherwise ``chunk`` rows at a
    time, the last chunk ragged. ``remat`` recomputes each chunk's
    activations in the backward (torch.utils.checkpoint) instead of keeping
    them, so memory stays O(chunk). ``pre_fn(xc, u) -> xc`` preprocesses
    each chunk right before it is encoded, inside the recomputed region, so
    a raw uint8 bank stays raw on the device. Its noise ``u`` comes from
    ``draw_fn(xc)``, called outside the recomputed region, so that the
    recompute sees the same draw (it is kept for the backward: 4 bytes per
    input element); without ``draw_fn``, u is None."""

    def enc(xc, u):
        if pre_fn is not None:
            xc = pre_fn(xc, u)
        return model.encode_top_mean(xc)

    def run(xc):
        u = draw_fn(xc) if draw_fn is not None else None
        if remat:
            return checkpoint(enc, xc, u, use_reentrant=False)
        return enc(xc, u)

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
