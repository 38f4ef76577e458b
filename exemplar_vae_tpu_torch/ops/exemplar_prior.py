"""Exemplar prior: log p(z | X) = logsumexp_n log N(z; mu_n, sigma^2 I) - log(den).

Counterpart of exemplar_vae_tpu/ops/exemplar_prior.py (forward). Three
implementations share one API:

* ``impl='naive'``  - the full (B, N) matrix (oracle; small N);
* ``impl='scan'``   - blockwise over exemplar tiles with an online
                      (running-max, running-sumexp) accumulator;
* ``impl='pallas'`` / ``'pallas_bf16'`` - ops/pairwise_lse.py: the CUDA
                      kernel on the card (fp32 or bf16 inputs, fp32
                      accumulation), its plain version on the CPU.

'naive' and 'scan' are differentiable through autograd. The kernel is
forward-only in this slice; the custom backward (``_bwd_wide`` and the
blockwise schedule of the JAX package) comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from exemplar_vae_tpu_torch.ops.pairwise_lse import pairwise_lse

NEG_INF = -1e30  # finite sentinel: keeps running-max arithmetic NaN-free


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
    padding. Returns (B,) fp32.
    """
    n = means.shape[0]
    if exemplar_idx is None:
        if data_idx is not None:
            raise ValueError("data_idx given without exemplar_idx")
        exemplar_idx = torch.arange(n, dtype=torch.int32, device=means.device)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=means.device)
    log_var = torch.as_tensor(log_var, dtype=torch.float32, device=z.device)
    lse = pairwise_lse_fwd(z, means, log_var, data_idx, exemplar_idx, valid,
                           impl, int(block_n))
    return lse - torch.as_tensor(log_denom, dtype=torch.float32,
                                 device=z.device)


def lse_combine(m1, s1, m2, s2):
    """Combine two online-LSE partial states (running max m, scaled sum s)."""
    m = torch.maximum(m1, m2)
    s = s1 * torch.exp(m1 - m) + s2 * torch.exp(m2 - m)
    return m, s
