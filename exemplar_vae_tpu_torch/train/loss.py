"""ELBO term assembly (counterpart of exemplar_vae_tpu/train/loss.py).

    loss = -RE + beta * KL,   KL = E_q[log q(z|x) - log p(z|X)]

Exemplar-prior support, by mode:
  train + exact   - re-encode the whole exemplar bank through the current
                    encoder with gradients, LOO mask, denominator N-1
  train + approx  - kNN over the stale cache means, then a gather and a
                    fresh re-encode of each point's K neighbours with
                    gradients (per-row support, or the batch union)
  eval            - precomputed full-bank means, no LOO, denominator N

How the bank is stored, preprocessed and encoded: train/bank.py.

Noise: the reparameterization draw is injected (``eps``) or drawn from
``generator``; nothing here reads a global random state.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models.base import reconstruction_log_lik
from exemplar_vae_tpu_torch.ops.distributions import log_normal_diag
from exemplar_vae_tpu_torch.ops.knn import dedup_valid_mask, knn_indices
from exemplar_vae_tpu_torch.train.bank import (Bank, bank_log_denom,
                                               encode_bank_with_grad,
                                               rows_input)
from exemplar_vae_tpu_torch.train.profiling import profiler_active, span


def prior_impl(cfg: Config) -> str:
    """The exemplar prior's LSE route: the pairwise-LSE kernel when
    cfg.use_pallas_prior, else the blockwise scan."""
    return "pallas" if cfg.use_pallas_prior else "scan"


def _local_select(q_means, cache_means, valid, k):
    return knn_indices(q_means, cache_means, k, valid=valid)


def _local_gather(arr, rows):
    """Rows ``rows`` (any shape) of ``arr``, from its flat 2-D view."""
    flat = arr.reshape(arr.shape[0], -1).index_select(0, rows.reshape(-1))
    return flat.reshape(tuple(rows.shape) + tuple(arr.shape[1:]))


def approx_log_p_top(model, out, cfg: Config, bank: Bank, loo_idx, log_denom,
                     generator=None, *, bank_u=None, select=_local_select,
                     gather=_local_gather, batch_rows=None):
    """kNN over the stale cache, then a fresh re-encode of each point's K
    neighbours with gradients; per-row or batch-union support.
    ``select(q_means, cache, valid, k) -> (B, K)`` bank rows and
    ``gather(arr, rows)`` default to the bank on one device; the sharded
    prior passes their collective forms (parallel/sharded_knn.py), with
    ``out`` and ``loo_idx`` holding the rows ``batch_rows`` = (lo, hi) of
    the selection's B: per-row support then re-encodes only those rows'
    neighbours, the batch union every selected row. ``bank_u``: the
    re-encoded rows' uniforms (train/bank.py::rows_input).

    ``approx_log_p_top.rows`` counts the bank rows re-encoded with
    gradients (B*K a call, a rank's rows of it on the mesh's per-row
    support). While a profiler runs, ``approx_log_p_top.kept`` also keeps
    each call's count before it and its selection of those rows (a
    reference, no copy), so that a reader can take the count's change over
    the profiled stretch and the distinct rows of each selection."""
    with span("evae.prior.knn"):
        idx = select(out.q_mean, bank.cache_means, bank.valid,
                     cfg.approximate_k)                         # (B, K)
    lo, hi = batch_rows or (0, idx.shape[0])
    union = cfg.approximate_support == "batch_union"
    with span("evae.prior.reencode"):
        flat_idx = idx.reshape(-1)
        flat = gather(bank.images, flat_idx)                    # (B*K, ...)
        ex_idx = gather(bank.data_idx, idx)                     # (B, K)
        chosen = idx
        if not union:
            k = idx.shape[1]
            flat, ex_idx = flat[lo * k:hi * k], ex_idx[lo:hi]
            chosen = idx[lo:hi]
        flat = rows_input(flat, cfg, generator, bank_u)
        if cfg.approx_remat:
            means = checkpoint(model.encode_top_mean, flat,
                               use_reentrant=False)
        else:
            means = model.encode_top_mean(flat)
    if profiler_active():
        approx_log_p_top.kept.append((approx_log_p_top.rows, chosen))
    approx_log_p_top.rows += flat.shape[0]
    with span("evae.prior.lse"):
        if union:
            # every point's mixture runs over all B*K selected exemplars,
            # repeats masked so that each unique exemplar counts once. The
            # scan, not the kernel: the support is only B*K columns, as in
            # the JAX package
            return model.log_p_z_top(
                out.z_top, bank_means=means, data_idx=loo_idx,
                exemplar_idx=ex_idx.reshape(-1),
                valid=dedup_valid_mask(flat_idx), log_denom=log_denom,
                impl="scan", block_n=cfg.prior_block_n)
        return model.log_p_z_top(
            out.z_top,
            bank_means=means.reshape(ex_idx.shape + (means.shape[-1],)),
            data_idx=loo_idx, exemplar_idx=ex_idx, log_denom=log_denom)


approx_log_p_top.rows = 0
# (rows before the call, its selection) of the latest calls made under a
# profiler, newest last
approx_log_p_top.kept = collections.deque(maxlen=256)


def exemplar_prior_log_prob(model, out, cfg: Config, bank: Bank, data_idx,
                            train: bool, *, generator=None, bank_u=None,
                            sharded_exact_fn=None, sharded_approx_fn=None):
    """log p(z_top | exemplar bank) for the three support modes; on the
    data mesh the training modes go to ``sharded_exact_fn`` /
    ``sharded_approx_fn`` (parallel/), which see this rank's bank shard and
    its rows of the batch (``out``, ``data_idx``). ``bank_u``: the
    approximate prior's raw-bank uniforms (approx_log_p_top)."""
    if not train:
        return eval_log_p_top(model, out.z_top, cfg, bank)
    log_denom = bank_log_denom(cfg, bank, True)
    loo_idx = data_idx if cfg.loo_mask_enabled else None
    if cfg.approximate_prior:
        fn = sharded_approx_fn or approx_log_p_top
        return fn(model, out, cfg, bank, loo_idx, log_denom, generator,
                  bank_u=bank_u)
    if sharded_exact_fn is not None:
        return sharded_exact_fn(model, out.z_top, loo_idx, bank, log_denom,
                                generator)
    with span("evae.prior.reencode"):
        means = encode_bank_with_grad(model, bank.images, cfg, generator)
    with span("evae.prior.lse"):
        return model.log_p_z_top(
            out.z_top, bank_means=means, data_idx=loo_idx,
            exemplar_idx=bank.data_idx, valid=bank.valid,
            log_denom=log_denom, impl=prior_impl(cfg),
            block_n=cfg.prior_block_n)


def eval_log_p_top(model, z, cfg: Config, bank: Optional[Bank]):
    """log p(z_top) at eval: full precomputed bank, no LOO, denominator N,
    by prior_impl's route."""
    if cfg.prior != "exemplar_prior":
        return model.log_p_z_top(z)
    with span("evae.prior.lse"):
        return model.log_p_z_top(
            z, bank_means=bank.cache_means, data_idx=None,
            exemplar_idx=bank.data_idx, valid=bank.valid,
            log_denom=bank_log_denom(cfg, bank, False), impl=prior_impl(cfg),
            block_n=cfg.prior_block_n)


def elbo_terms(model, x, cfg: Config, *, data_idx=None,
               bank: Optional[Bank] = None, train: bool = True, eps=None,
               bank_u=None, generator=None, sharded_exact_fn=None,
               sharded_approx_fn=None):
    """One forward pass -> per-example (RE, KL, ForwardOut). ``eps``
    (B, Dz) injects the reparameterization noise and ``bank_u`` the
    approximate prior's raw-bank uniforms, else they are drawn from
    ``generator`` (which also feeds the exact prior's stochastic raw-bank
    preprocessing)."""
    out = model(x, eps=eps, generator=generator)
    re = reconstruction_log_lik(x, out.x_mean, out.x_logvar, cfg.input_type)
    log_q = log_normal_diag(out.z_top, out.q_mean, out.q_logvar)
    if cfg.prior == "exemplar_prior":
        log_p = exemplar_prior_log_prob(
            model, out, cfg, bank, data_idx, train, generator=generator,
            bank_u=bank_u, sharded_exact_fn=sharded_exact_fn,
            sharded_approx_fn=sharded_approx_fn)
    else:
        log_p = model.log_p_z_top(out.z_top)
    kl = log_q - log_p + out.extra_kl
    return re, kl, out


def batch_loss(model, x, beta, cfg: Config, *, batch_size=None, **kw):
    """Scalar loss and the mean terms (0-d tensors on the device); ``kw``
    as elbo_terms. With ``batch_size``, ``x`` holds one rank's rows of a
    batch of that many: the loss and the terms are the rank's shares of the
    batch means, its sums / batch_size, which add up over the ranks to the
    means (parallel/mesh.py::Mesh.average_grads has the gradient's
    accounting)."""
    re, kl, _ = elbo_terms(model, x, cfg, **kw)
    if batch_size is None:
        loss = torch.mean(-re + beta * kl)
        return loss, {"re": torch.mean(-re), "kl": torch.mean(kl),
                      "loss": loss}
    loss = torch.sum(-re + beta * kl) / batch_size
    return loss, {"re": torch.sum(-re) / batch_size,
                  "kl": torch.sum(kl) / batch_size, "loss": loss}
