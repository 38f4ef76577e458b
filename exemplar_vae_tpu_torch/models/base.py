"""Shared VAE machinery: prior dispatch and likelihood heads (counterpart of
exemplar_vae_tpu/models/base.py).

Every model exposes the same method surface:
  forward(x, eps=..., generator=...) -> ForwardOut (eps: (B, Dz), or the
                                pair (eps2, eps1) for the two-level models)
  encode_top(x)              -> (mean, logvar) of the prior-level latent
  encode_top_mean(x)         -> mean only (exemplar-bank caching)
  generate_from_top(z, eps=..., generator=...) -> decoder means (eps: the
                                two-level models' z1 noise); the PixelHVAE
                                returns samples, its eps the pair (z1
                                noise, per-pixel uniforms)
  log_p_z_top(z, ...)        -> prior log-density {standard, vampprior,
                                exemplar_prior}
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from exemplar_vae_tpu_torch.models.layers import hardtanh
from exemplar_vae_tpu_torch.ops.distributions import (
    log_bernoulli,
    log_logistic_256,
    log_normal_diag,
    log_normal_standard,
)
from exemplar_vae_tpu_torch.ops.exemplar_prior import NEG_INF, exemplar_log_prob


class ForwardOut(NamedTuple):
    """Everything one forward pass produces (per example)."""
    z_top: torch.Tensor       # (B, Dz) sampled prior-level latent
    q_mean: torch.Tensor      # (B, Dz)
    q_logvar: torch.Tensor    # (B, Dz)
    x_mean: torch.Tensor      # (B, H, W, C) decoder mean / Bernoulli probs
    x_logvar: torch.Tensor    # (B, H, W, C) decoder log-var (zeros for binary)
    extra_kl: torch.Tensor    # (B,) lower-level sampled KL; zeros for VAE


def reparameterize(mean, logvar, *, eps=None, generator=None):
    """z = mean + sigma * eps, with eps injected (a tensor or an array) or
    drawn from ``generator``."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                          dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * torch.as_tensor(
        eps, dtype=mean.dtype, device=mean.device)


def reconstruction_log_lik(x, x_mean, x_logvar, input_type: str):
    """log p(x | z) summed over pixels."""
    b = x.shape[0]
    xf = x.reshape(b, -1)
    mf = x_mean.reshape(b, -1)
    if input_type == "binary":
        return log_bernoulli(xf, mf)
    return log_logistic_256(xf, mf, x_logvar.reshape(b, -1))


def likelihood_params(x_mean, logvar_fn, input_type: str):
    """Decoder likelihood-head clamps: binary -> (sigmoid'd mean, zero
    log-var placeholder); gray/continuous -> mean clipped to
    [1/512, 1-1/512] plus the clamped log-var head."""
    if input_type == "binary":
        return x_mean, torch.zeros_like(x_mean)
    return (torch.clamp(x_mean, 1.0 / 512.0, 1.0 - 1.0 / 512.0),
            logvar_fn().to(torch.float32))


def prior_log_var_floor(cfg) -> float:
    """Lower clamp of the learned prior log-variance: -8, or
    log(cfg.prior_var_min) when that opt-in floor is set."""
    if cfg is not None and getattr(cfg, "prior_var_min", 0.0) > 0.0:
        return max(-8.0, math.log(cfg.prior_var_min))
    return -8.0


def clamped_prior_log_var(model, cfg=None):
    """The model's prior log-variance, hardtanh-clamped to
    [prior_log_var_floor(cfg), 8] (the JAX version reads it from a params
    dict; here the model holds it)."""
    return hardtanh(model.prior_log_var, prior_log_var_floor(cfg), 8.0)


def rows_exemplar_log_prob(z, means_bk, log_var, *, log_denom, data_idx=None,
                           exemplar_idx_bk=None):
    """Exemplar prior over a per-row support set (approximate-kNN mode):
    each batch point b has its own K re-encoded neighbours. LSE over K with
    the full-set denominator ``log_denom``, so the objective stays a lower
    bound on the exact mixture; a neighbour that is the point itself (LOO)
    is masked to NEG_INF.

    z (B, D); means_bk (B, K, D); exemplar_idx_bk (B, K) global indices.
    """
    d = z.shape[-1]
    sq = torch.sum(torch.square(z[:, None, :] - means_bk), dim=-1)   # (B, K)
    lp = -0.5 * (d * log_var + sq * torch.exp(-log_var))
    if data_idx is not None and exemplar_idx_bk is not None:
        lp = torch.where(exemplar_idx_bk == data_idx[:, None], NEG_INF, lp)
    m = torch.amax(lp, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(lp - m[:, None]), dim=-1))
    return lse - float(log_denom)


class PriorMixin:
    """Prior parameters + log p(z_top) dispatch, shared by all models:
      standard        -> N(0, I)
      vampprior       -> mixture over learned pseudo-inputs re-encoded by
                         the current encoder
      exemplar_prior  -> isotropic mixture over exemplar latent means with a
                         learned shared scalar sigma^2
    """

    def _setup_prior(self, generator=None):
        cfg = self.cfg
        if cfg.prior == "exemplar_prior":
            self.prior_log_var = nn.Parameter(torch.tensor(
                math.log(cfg.prior_variance_init), dtype=torch.float32))
        elif cfg.prior == "vampprior":
            c_in, h, w = cfg.input_size
            self.pseudo_inputs = nn.Parameter(0.01 * torch.randn(
                (cfg.number_components, h, w, c_in), generator=generator))

    def get_prior_log_var(self):
        """Learned shared log sigma^2, clamped (see clamped_prior_log_var)."""
        return clamped_prior_log_var(self, self.cfg)

    def get_pseudo_inputs(self):
        """Pseudo-inputs clamped to the valid pixel range [0, 1]."""
        return hardtanh(self.pseudo_inputs, 0.0, 1.0)

    def log_p_z_top(self, z, *, bank_means=None, data_idx=None,
                    exemplar_idx=None, valid=None, log_denom=None,
                    impl="scan", block_n=2048):
        cfg = self.cfg
        if cfg.prior == "standard":
            return log_normal_standard(z)
        if cfg.prior == "vampprior":
            m, lv = self.encode_top(self.get_pseudo_inputs())   # (C, Dz) each
            lp = log_normal_diag(z[:, None, :], m[None], lv[None],
                                 reduce_dim=-1)                 # (B, C)
            return (torch.logsumexp(lp, dim=-1)
                    - math.log(cfg.number_components))
        if bank_means is None:
            raise ValueError("exemplar prior requires bank_means")
        if bank_means.dim() == 3:                   # approx: per-row K
            return rows_exemplar_log_prob(
                z, bank_means, self.get_prior_log_var(), log_denom=log_denom,
                data_idx=data_idx, exemplar_idx_bk=exemplar_idx)
        return exemplar_log_prob(
            z, bank_means, self.get_prior_log_var(), log_denom=log_denom,
            data_idx=data_idx, exemplar_idx=exemplar_idx, valid=valid,
            impl=impl, block_n=block_n)
