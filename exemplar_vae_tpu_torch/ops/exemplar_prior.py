"""Exemplar prior: log p(z | X) = logsumexp_n log N(z; mu_n, sigma^2 I) - log(den).

Counterpart of exemplar_vae_tpu/ops/exemplar_prior.py. Three
implementations share one API:

* ``impl='naive'``  - the full (B, N) matrix (oracle; small N);
* ``impl='scan'``   - blockwise over exemplar tiles with an online
                      (running-max, running-sumexp) accumulator;
* ``impl='pallas'`` / ``'pallas_bf16'`` - ops/pairwise_lse.py: the CUDA
                      kernel on the card (fp32 or bf16 inputs, fp32
                      accumulation), its plain version on the CPU.

All of them run inside ONE ``torch.autograd.Function`` (the counterpart of
the JAX package's ``custom_vjp``): the forward keeps no (B, N) graph, and
the backward recomputes the softmax weights from the saved row-LSE, in one
wide shot (three large GEMMs) while the (B, N) weights fit
WIDE_BWD_MAX_BYTES, else blockwise over exemplar tiles. The kernel itself is
forward-only; its gradient is this torch backward on every impl.
"""

from __future__ import annotations

from typing import Optional

import torch

from exemplar_vae_tpu_torch.ops.pairwise_lse import pairwise_lse

NEG_INF = -1e30  # finite sentinel: keeps running-max arithmetic NaN-free

# The backward takes the wide schedule while 4*B*N bytes (one fp32 (B, N)
# weight matrix; 20 MB at B = 100, N = 50 000) fit this budget, else the
# blockwise one. The same number and test as the JAX package, which
# dispatches on it; tests force each schedule by monkeypatching it. The
# wide schedule holds two to three (B, N) buffers at once, so 4*B*N
# undercounts its peak (ROADMAP.md).
WIDE_BWD_MAX_BYTES = 256 * 1024 * 1024


def _logits_tile(z, mu_tile, log_var, d):
    """(B, TN) pairwise log-density tile in fp32."""
    z_sq = torch.sum(torch.square(z), dim=-1, keepdim=True)
    m_sq = torch.sum(torch.square(mu_tile), dim=-1)[None, :]
    sq = torch.clamp_min(z_sq + m_sq - 2.0 * (z @ mu_tile.T), 0.0)
    return -0.5 * (d * log_var + sq * torch.exp(-log_var))


def _mask_tile(logits, data_idx, ex_idx_tile, valid_tile):
    """Apply the LOO and padding masks to a logits tile."""
    masked = ~valid_tile[None, :]
    if data_idx is not None:
        masked = masked | (data_idx[:, None] == ex_idx_tile[None, :])
    return torch.where(masked, torch.full_like(logits, NEG_INF), logits)


def _lse_naive(z, means, log_var, data_idx, ex_idx, valid):
    logits = _mask_tile(_logits_tile(z, means, log_var, z.shape[-1]),
                        data_idx, ex_idx, valid)
    m = torch.amax(logits, dim=-1)
    return m + torch.log(torch.sum(torch.exp(logits - m[:, None]), dim=-1))


def _lse_scan(z, means, log_var, data_idx, ex_idx, valid, block_n):
    b, d = z.shape
    m = torch.full((b,), NEG_INF, dtype=torch.float32, device=z.device)
    s = torch.zeros((b,), dtype=torch.float32, device=z.device)
    for start in range(0, means.shape[0], block_n):
        sl = slice(start, start + block_n)
        logits = _mask_tile(_logits_tile(z, means[sl], log_var, d),
                            data_idx, ex_idx[sl], valid[sl])
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        s = s * torch.exp(m - m_new) + torch.sum(
            torch.exp(logits - m_new[:, None]), dim=-1)
        m = m_new
    return m + torch.log(s)


def pairwise_lse_fwd(z, means, log_var, data_idx, ex_idx, valid, impl,
                     block_n):
    """(B,) LSE without the denominator, dispatched on ``impl`` as
    ``_pairwise_lse_fwd_impl`` is in the JAX package."""
    z = z.to(torch.float32)
    means = means.to(torch.float32)
    log_var = log_var.to(torch.float32)
    if impl in ("pallas", "pallas_bf16"):
        in_dt = torch.bfloat16 if impl == "pallas_bf16" else torch.float32
        return pairwise_lse(z, means, log_var, data_idx, ex_idx, valid,
                            in_dtype=in_dt, block_n=block_n)
    if impl == "scan":
        return _lse_scan(z, means, log_var, data_idx, ex_idx, valid, block_n)
    if impl == "naive":
        return _lse_naive(z, means, log_var, data_idx, ex_idx, valid)
    raise ValueError(f"unknown impl {impl!r}; want naive | scan | pallas | "
                     f"pallas_bf16")


class _PairwiseLSE(torch.autograd.Function):
    """(B,) row-LSE with the softmax-weight recompute backward.

    Per-pair weight w[b,n] = exp(logits[b,n] - lse[b]); then
      dz[b]     = sum_n g[b] w[b,n] (mu[n] - z[b]) / sigma^2
      dmu[n]    = sum_b g[b] w[b,n] (z[b] - mu[n]) / sigma^2
      dlogvar  += sum_{b,n} g[b] w[b,n] (-D/2 + ||z-mu||^2 / (2 sigma^2))
    Masked entries have w = 0 and contribute nothing."""

    @staticmethod
    def forward(ctx, z, means, log_var, data_idx, ex_idx, valid, impl,
                block_n):
        lse = pairwise_lse_fwd(z, means, log_var, data_idx, ex_idx, valid,
                               impl, block_n)
        ctx.block_n = block_n
        ctx.save_for_backward(z, means, log_var, data_idx, ex_idx, valid, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        z, means, log_var, data_idx, ex_idx, valid, lse = ctx.saved_tensors
        # a fully-masked row has lse ~ NEG_INF (or -inf); clamp so that
        # exp(logits - lse) stays 0 there, not 1 or inf
        lse = torch.clamp_min(lse, 0.5 * NEG_INF)
        b, n = z.shape[0], means.shape[0]
        if 4 * b * n <= WIDE_BWD_MAX_BYTES or not ctx.block_n > 0:
            tile = max(n, 1)        # wide: one tile, three large GEMMs
        else:
            tile = ctx.block_n      # blockwise: one (B, block_n) tile live
        dz, dmu, dlv = _bwd_tiles(z, means, log_var, data_idx, ex_idx, valid,
                                  lse, g, tile)
        return dz, dmu, dlv.reshape(log_var.shape), None, None, None, None, None


def _dlv_terms(logits, gw, log_var, d):
    """sum gw * (-D/2 + sq/(2 sigma^2)), sq recovered from the logits;
    masked entries contribute 0."""
    sq_half_inv = torch.where(logits <= NEG_INF * 0.5,
                              torch.zeros_like(logits),
                              -(logits + 0.5 * d * log_var))
    return torch.sum(gw * (-0.5 * d + sq_half_inv))


def _bwd_tiles(z, means, log_var, data_idx, ex_idx, valid, lse, g, tile):
    """The gradient sums over exemplar tiles of width ``tile``: per tile the
    logits in one (B,D)x(D,TN) GEMM, then two (B,TN)-operand GEMMs.
    O(B*D + N*D) memory beside one (B, tile) tile."""
    d = z.shape[1]
    inv_var = torch.exp(-log_var)
    dz, dlv, dmu = 0.0, 0.0, []
    for start in range(0, means.shape[0], tile):
        sl = slice(start, start + tile)
        mu = means[sl]
        logits = _mask_tile(_logits_tile(z, mu, log_var, d), data_idx,
                            ex_idx[sl], valid[sl])
        gw = g[:, None] * torch.exp(logits - lse[:, None])        # (B, TN)
        dz = dz + inv_var * (gw @ mu - torch.sum(gw, dim=-1, keepdim=True) * z)
        dmu.append(inv_var * (gw.T @ z - torch.sum(gw, dim=0)[:, None] * mu))
        dlv = dlv + _dlv_terms(logits, gw, log_var, d)
    return dz, dmu[0] if len(dmu) == 1 else torch.cat(dmu, dim=0), dlv


def exemplar_log_prob(
    z: torch.Tensor,
    means: torch.Tensor,
    log_var,
    *,
    log_denom,
    data_idx: Optional[torch.Tensor] = None,
    exemplar_idx: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    impl: str = "scan",
    block_n: int = 2048,
) -> torch.Tensor:
    """log p(z | exemplar set) for a batch of latents.

    z (B, D); means (N, D); log_var the scalar log sigma^2; log_denom the
    scalar log of the mixture denominator (log N at eval, log(N-1) under
    the LOO mask); data_idx (B,) int32 enables LOO; exemplar_idx (N,) int32
    global indices of the exemplars; valid (N,) bool, False rows are
    padding. Returns (B,) fp32, differentiable in z, means and log_var.
    """
    n = means.shape[0]
    if exemplar_idx is None:
        if data_idx is not None:
            raise ValueError("data_idx given without exemplar_idx")
        exemplar_idx = torch.arange(n, dtype=torch.int32, device=means.device)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=means.device)
    log_var = torch.as_tensor(log_var, dtype=torch.float32, device=z.device)
    lse = _PairwiseLSE.apply(z.to(torch.float32), means.to(torch.float32),
                             log_var, data_idx, exemplar_idx, valid, impl,
                             int(block_n))
    # a Python scalar: subtracted in fp32 on the device, with no host copy
    # (a tensor made from it on the card would synchronize the host)
    return lse - float(log_denom)


def lse_combine(m1, s1, m2, s2):
    """Combine two online-LSE partial states (running max m, scaled sum s)."""
    m = torch.maximum(m1, m2)
    s = s1 * torch.exp(m1 - m) + s2 * torch.exp(m2 - m)
    return m, s
