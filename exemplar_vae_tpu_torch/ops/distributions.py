"""Log-density primitives (counterpart of exemplar_vae_tpu/ops/distributions.py).

Same numerics contract: Gaussian log-densities omit the -D/2 log(2 pi)
constant unless ``include_const``; Bernoulli probabilities are clamped to
[MIN_EPSILON, 1 - MIN_EPSILON]; the discretized logistic snaps x to its
1/256 bin's left edge and floors the bin mass at LOGISTIC_EPS.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
MIN_EPSILON = 1e-5
LOGISTIC_EPS = 1e-7


def _maybe_reduce(x, reduce_dim):
    if reduce_dim is None:
        return x
    return torch.sum(x, dim=reduce_dim)


def log_normal_diag(x, mean, log_var, *, reduce_dim=-1, include_const=False):
    """Diagonal-Gaussian log density, element-wise then summed over reduce_dim."""
    lp = -0.5 * (log_var + torch.square(x - mean) * torch.exp(-log_var))
    if include_const:
        lp = lp - 0.5 * LOG_2PI
    return _maybe_reduce(lp, reduce_dim)


def log_normal_standard(x, *, reduce_dim=-1, include_const=False):
    """N(0, I) log density (same constant convention as log_normal_diag)."""
    lp = -0.5 * torch.square(x)
    if include_const:
        lp = lp - 0.5 * LOG_2PI
    return _maybe_reduce(lp, reduce_dim)


def log_bernoulli(x, p, *, reduce_dim=-1):
    """Bernoulli log likelihood with clamped probabilities."""
    pc = torch.clamp(p, MIN_EPSILON, 1.0 - MIN_EPSILON)
    lp = x * torch.log(pc) + (1.0 - x) * torch.log(1.0 - pc)
    return _maybe_reduce(lp, reduce_dim)


def log_logistic_256(x, mean, log_var, *, reduce_dim=-1):
    """Discretized logistic likelihood over 256 gray levels; x in [0, 1)."""
    bin_size = 1.0 / 256.0
    scale = torch.exp(log_var)
    xs = (torch.floor(x / bin_size) * bin_size - mean) / scale
    cdf_plus = torch.sigmoid(xs + bin_size / scale)
    cdf_minus = torch.sigmoid(xs)
    lp = torch.log(cdf_plus - cdf_minus + LOGISTIC_EPS)
    return _maybe_reduce(lp, reduce_dim)
