"""ELBO term assembly (counterpart of exemplar_vae_tpu/train/loss.py).

    loss = -RE + beta * KL,   KL = E_q[log q(z|x) - log p(z|X)]

Exemplar-prior support, by mode:
  train + exact   - re-encode the whole exemplar bank through the current
                    encoder with gradients (chunked, optionally recomputed
                    in the backward), LOO mask, denominator N-1
  train + approx  - kNN over a stale cache: the approximate-prior slice
                    (ROADMAP.md, Queue 1, item 8)
  eval            - precomputed full-bank means, no LOO, denominator N

Noise: the reparameterization draw is injected (``eps``) or drawn from
``generator``; nothing here reads a global random state.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models.base import reconstruction_log_lik
from exemplar_vae_tpu_torch.ops.distributions import log_normal_diag
from exemplar_vae_tpu_torch.ops.knn import encode_bank_with_grad
from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch

_SHARDED = ("the sharded exemplar prior comes with bank sharding over "
            "torch.distributed (ROADMAP.md, Queue 1, item 11)")


class Bank(NamedTuple):
    """Exemplar-bank inputs.

    images: preprocessed exemplar inputs (N, H, W, C) - None once encoded.
    data_idx: (N,) int32 global dataset indices (LOO addressing).
    valid: (N,) bool - False rows are padding.
    cache_means: (N, Dz) precomputed exact means (eval).
    n_effective: int - true exemplar count N (mixture denominator).
    """
    images: Any
    data_idx: Any
    valid: Any
    cache_means: Any
    n_effective: int


def bank_pre_fn(cfg: Config, generator=None):
    """Per-chunk preprocessing of a raw (uint8) bank; float banks are
    preprocessed once per epoch instead. Stochastic only under
    ``cfg.bank_stochastic_preprocess``: by default the bank is preprocessed
    deterministically everywhere, and only the training batch gets fresh
    draws."""

    def pre(xc):
        return preprocess_batch(xc, input_type=cfg.input_type,
                                dynamic_binarization=cfg.dynamic_binarization,
                                train=cfg.bank_stochastic_preprocess,
                                generator=generator)

    return pre


def bank_log_denom(cfg: Config, bank: Bank, train: bool) -> float:
    """log(N) at eval; log(N-1) when the LOO mask removes one component."""
    n = float(bank.n_effective)
    if train and cfg.loo_mask_enabled:
        return math.log(n - 1.0)
    return math.log(n)


def exemplar_prior_log_prob(model, out, cfg: Config, bank: Bank, data_idx,
                            train: bool, *, generator=None,
                            sharded_exact_fn=None, sharded_approx_fn=None):
    """log p(z_top | exemplar bank) for the exact-train and eval modes."""
    if sharded_exact_fn is not None or sharded_approx_fn is not None:
        raise NotImplementedError(_SHARDED)
    if not train:
        return eval_log_p_top(model, out.z_top, cfg, bank)
    if cfg.approximate_prior:
        raise NotImplementedError(
            "the approximate (kNN) exemplar prior comes with the "
            "approximate-prior slice (ROADMAP.md, Queue 1, item 8)")
    pre = None
    if bank.images.dtype == torch.uint8:
        if cfg.bank_stochastic_preprocess and cfg.exact_remat:
            # the recompute would draw the chunk's noise again
            raise NotImplementedError(
                "stochastic preprocessing of a raw uint8 bank under "
                "exact_remat comes with the ConvHVAE slice (ROADMAP.md, "
                "Queue 1, item 9)")
        pre = bank_pre_fn(cfg, generator=generator)
    means = encode_bank_with_grad(model, bank.images,
                                  chunk=cfg.exact_reencode_chunk,
                                  remat=cfg.exact_remat, pre_fn=pre)
    return model.log_p_z_top(
        out.z_top, bank_means=means,
        data_idx=data_idx if cfg.loo_mask_enabled else None,
        exemplar_idx=bank.data_idx, valid=bank.valid,
        log_denom=bank_log_denom(cfg, bank, True),
        impl="pallas" if cfg.use_pallas_prior else "scan",
        block_n=cfg.prior_block_n)


def eval_log_p_top(model, z, cfg: Config, bank: Optional[Bank]):
    """log p(z_top) at eval: full precomputed bank, no LOO, denominator N.
    The exemplar prior runs the pairwise-LSE kernel when
    cfg.use_pallas_prior, else the blockwise scan."""
    if cfg.prior != "exemplar_prior":
        return model.log_p_z_top(z)
    impl = "pallas" if cfg.use_pallas_prior else "scan"
    return model.log_p_z_top(
        z, bank_means=bank.cache_means, data_idx=None,
        exemplar_idx=bank.data_idx, valid=bank.valid,
        log_denom=bank_log_denom(cfg, bank, False), impl=impl,
        block_n=cfg.prior_block_n)


def elbo_terms(model, x, cfg: Config, *, data_idx=None,
               bank: Optional[Bank] = None, train: bool = True, eps=None,
               generator=None, sharded_exact_fn=None, sharded_approx_fn=None):
    """One forward pass -> per-example (RE, KL, ForwardOut). ``eps``
    (B, Dz) injects the reparameterization noise, else it is drawn from
    ``generator`` (which also feeds a stochastic raw-bank preprocessing)."""
    out = model(x, eps=eps, generator=generator)
    re = reconstruction_log_lik(x, out.x_mean, out.x_logvar, cfg.input_type)
    log_q = log_normal_diag(out.z_top, out.q_mean, out.q_logvar)
    if cfg.prior == "exemplar_prior":
        log_p = exemplar_prior_log_prob(
            model, out, cfg, bank, data_idx, train, generator=generator,
            sharded_exact_fn=sharded_exact_fn,
            sharded_approx_fn=sharded_approx_fn)
    else:
        log_p = model.log_p_z_top(out.z_top)
    kl = log_q - log_p + out.extra_kl
    return re, kl, out


def batch_loss(model, x, beta, cfg: Config, **kw):
    """Scalar loss and the mean terms (0-d tensors on the device); ``kw``
    as elbo_terms."""
    re, kl, _ = elbo_terms(model, x, cfg, **kw)
    loss = torch.mean(-re + beta * kl)
    return loss, {"re": torch.mean(-re), "kl": torch.mean(kl), "loss": loss}
