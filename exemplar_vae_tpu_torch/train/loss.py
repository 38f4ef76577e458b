"""Eval-time prior terms (counterpart of the eval part of
exemplar_vae_tpu/train/loss.py). The train branches (exact re-encode,
approximate kNN) wait for the training slice."""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

from exemplar_vae_tpu_torch.config import Config


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


def bank_log_denom(cfg: Config, bank: Bank, train: bool) -> float:
    """log(N) at eval; log(N-1) when the LOO mask removes one component."""
    n = float(bank.n_effective)
    if train and cfg.loo_mask_enabled:
        return math.log(n - 1.0)
    return math.log(n)


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
