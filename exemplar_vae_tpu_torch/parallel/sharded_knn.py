"""The approximate-kNN exemplar prior on the data mesh (counterpart of
exemplar_vae_tpu/parallel/sharded_knn.py).

The bank images and the cache of their latent means are split by rows over
the ranks, and so is the batch: each rank holds its own rows' query means.
Four pieces:

1. the cache refresh: each rank encodes its own shard, no collective
   (train/steps.py::make_cache_refresh);
2. the kNN select: the detached query means are gathered into the whole
   batch's (B, Dz) on every rank; each rank takes the k nearest rows of its
   cache shard (padding at +inf, padded to k candidates with +inf when the
   shard holds fewer), as global rows; the W*k candidates per query are
   gathered to every rank and reduced to the global top-k, ties to the
   lowest position in the rank-major candidate list, as lax.top_k does
   there, which is the lowest global row. Every rank then holds the (B, K)
   selection;
3. the row gather: each rank takes the selected rows it holds, zeros
   elsewhere, and an all_reduce SUM assembles them (each row lives on one
   rank, so the sum is the gather). uint8 images and int32 indices travel
   in their own types, exact at any bank size. The gathers and the
   candidate merge are ``evae.mesh.gather`` ranges under a profiler, inside
   the prior's ``evae.prior.knn`` and ``evae.prior.reencode``;
4. the re-encode with gradients. Per-row support: each rank keeps its own
   rows' B_r * K neighbours, re-encodes only those and scores its own rows;
   a row's mixture uses only its own K neighbours, so no differentiable
   collective is needed. Batch-union support: each rank re-encodes the
   whole union of B * K rows, as the JAX package keeps it replicated, and
   scores its own rows against it; the step's gradient average (the union's
   encoder gradient summed over the ranks' rows, then / W) stays the
   one-process gradient.
"""

from __future__ import annotations

import functools

import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.ops.knn import pairwise_sq_dist, smallest_k
from exemplar_vae_tpu_torch.parallel.mesh import Mesh
from exemplar_vae_tpu_torch.train.loss import approx_log_p_top
from exemplar_vae_tpu_torch.train.profiling import span


def sharded_knn_select(q_means, cache_shard, valid_shard, k: int,
                       mesh: Mesh):
    """(B, k) int64 global bank rows of the k nearest cached means of each
    query, over every rank's shard; every rank passes the same (B, Dz)
    queries, the whole batch's. ``valid_shard`` is the shard's valid mask:
    padding rows get +inf and are never picked while k valid rows remain."""
    n_loc = cache_shard.shape[0]
    d = pairwise_sq_dist(q_means.detach(), cache_shard.detach())
    d = torch.where(valid_shard[None, :], d, torch.inf)
    dist, idx = smallest_k(d, k)                          # (B, min(k, n_loc))
    rows = idx + mesh.rank * n_loc
    b, kk = rows.shape
    if kk < k:                  # every rank gives k candidates
        dist = torch.cat([dist, dist.new_full((b, k - kk), torch.inf)], 1)
        rows = torch.cat([rows, rows.new_zeros((b, k - kk))], 1)
    with span("evae.mesh.gather"):
        dist_all = mesh.all_gather_rows(dist[None])       # (W, B, k)
        rows_all = mesh.all_gather_rows(rows[None])
        dist_all = dist_all.permute(1, 0, 2).reshape(b, -1)   # rank-major
        rows_all = rows_all.permute(1, 0, 2).reshape(b, -1)
        _, pos = smallest_k(dist_all.contiguous(), k)
        return torch.gather(rows_all, 1, pos)


def sharded_row_gather(arr_shard, rows, mesh: Mesh):
    """Rows ``rows`` (global, any shape) of the row-sharded array whose
    shard this rank holds, in the shard's dtype: a masked local gather,
    then all_reduce SUM."""
    n_loc = arr_shard.shape[0]
    with span("evae.mesh.gather"):
        local = rows.reshape(-1) - mesh.rank * n_loc
        mine = (local >= 0) & (local < n_loc)
        flat = arr_shard.reshape(n_loc, -1).index_select(
            0, local.clamp(0, n_loc - 1))
        flat = torch.where(mine[:, None], flat, torch.zeros_like(flat))
        mesh.all_reduce(flat)
    return flat.reshape(tuple(rows.shape) + tuple(arr_shard.shape[1:]))


def make_sharded_approx_prior(cfg: Config, mesh: Mesh):
    """``prior_fn(model, out, cfg, bank, loo_idx, log_denom, generator=None,
    *, bank_u=None, batch_size)``, the train loss's ``sharded_approx_fn``:
    the approximate prior (per-row or batch-union support) of this rank's
    rows of a batch of ``batch_size`` (``out``, ``loo_idx``), with the kNN
    select and the row gather over the mesh; ``bank`` holds this rank's
    shard of the images, indices, valid mask and cache."""
    gather = functools.partial(sharded_row_gather, mesh=mesh)

    def prior_fn(model, out, cfg, bank, loo_idx, log_denom, generator=None,
                 *, bank_u=None, batch_size):
        def select(q_means, cache_shard, valid_shard, k):
            q_all = mesh.all_gather_rows(q_means.detach(), batch_size)
            return sharded_knn_select(q_all, cache_shard, valid_shard, k,
                                      mesh)

        return approx_log_p_top(model, out, cfg, bank, loo_idx, log_denom,
                                generator, bank_u=bank_u, select=select,
                                gather=gather,
                                batch_rows=mesh.batch_rows(batch_size))

    return prior_fn
