"""Importance-weighted test NLL and the eval bank (counterpart of
exemplar_vae_tpu/train/evaluation.py: make_eval_bank_fn, make_iwae_fn).

Protocol: test NLL = -[logsumexp_s (log p(x|z_s) + log p(z_s) - log q(z_s|x))
- log S]; at eval the exemplar prior uses the full bank with no LOO mask,
encoded once. Chunks are (t test points) x (r samples) per round with an
online-LSE carry over rounds, as in the JAX package. The generic path
(force_generic, the 2-level models) waits for the HVAE slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models.base import (reconstruction_log_lik,
                                                reparameterize)
from exemplar_vae_tpu_torch.ops.distributions import log_normal_diag
from exemplar_vae_tpu_torch.ops.knn import encode_bank
from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch
from exemplar_vae_tpu_torch.train.loss import Bank, eval_log_p_top


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def as_tensor(x, device, dtype=None):
    """numpy array or tensor -> tensor on ``device`` (no copy if already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def make_eval_bank_fn(model, cfg: Config):
    """Encode the full exemplar bank once for evaluation (no gradient)."""

    def pre(xc):
        return preprocess_batch(xc, input_type=cfg.input_type,
                                dynamic_binarization=cfg.dynamic_binarization,
                                train=False)

    @torch.no_grad()
    def build_bank(bank: Bank) -> Bank:
        if cfg.prior != "exemplar_prior":
            return bank
        dev = model_device(model)
        imgs = as_tensor(bank.images, dev)
        if imgs.dtype == torch.uint8:
            # raw banks stay raw on the device; each chunk is preprocessed
            means = encode_bank(model, imgs, chunk=cfg.exact_reencode_chunk,
                                pre_fn=pre)
        else:
            means = encode_bank(model, pre(imgs),
                                chunk=cfg.exact_reencode_chunk)
        return Bank(images=None, data_idx=as_tensor(bank.data_idx, dev,
                                                    torch.int32),
                    valid=as_tensor(bank.valid, dev, torch.bool),
                    cache_means=means, n_effective=bank.n_effective)

    return build_bank


def make_iwae_fn(model, cfg: Config):
    """Importance-weighted NLL, S samples per point, for the single-level
    VAE with the encode-once fast path: q(z|x) runs once per chunk and its
    stats are repeated to the t*r rows of each round."""
    if cfg.model_name.lower() != "vae":
        raise NotImplementedError(
            f"IWAE for model_name={cfg.model_name!r} (the generic path) comes "
            f"with the HVAE slice (ROADMAP.md, Queue 1)")

    @torch.no_grad()
    def chunk_nll(x_chunk_raw, bank, rounds: int, r: int, *, generator=None,
                  eps=None):
        """(t,) NLL of one chunk. ``eps`` injects the per-round noise,
        (rounds, t*r, Dz); else it is drawn from ``generator``."""
        dev = model_device(model)
        x = preprocess_batch(as_tensor(x_chunk_raw, dev),
                             input_type=cfg.input_type,
                             dynamic_binarization=cfg.dynamic_binarization,
                             train=False)
        t = x.shape[0]
        x_rep = torch.repeat_interleave(x, r, dim=0)
        q_mean, q_logvar = model.encode_top(x)
        mu_rep = torch.repeat_interleave(q_mean, r, dim=0)
        lv_rep = torch.repeat_interleave(q_logvar, r, dim=0)
        if eps is not None and tuple(eps.shape) != (rounds,) + mu_rep.shape:
            raise ValueError(f"eps must be {(rounds,) + tuple(mu_rep.shape)}, "
                             f"got {tuple(eps.shape)}")
        m = torch.full((t,), -1e30, dtype=torch.float32, device=dev)
        s = torch.zeros((t,), dtype=torch.float32, device=dev)
        for i in range(rounds):
            z = reparameterize(mu_rep, lv_rep,
                               eps=None if eps is None else eps[i],
                               generator=generator)
            x_mean, x_logvar = model.decode(z)
            re = reconstruction_log_lik(x_rep, x_mean, x_logvar,
                                        cfg.input_type)
            log_q = log_normal_diag(z, mu_rep, lv_rep)
            log_p = eval_log_p_top(model, z, cfg, bank)
            a = (re - (log_q - log_p)).reshape(t, r)
            m_new = torch.maximum(m, torch.amax(a, dim=1))
            s = s * torch.exp(m - m_new) + torch.sum(
                torch.exp(a - m_new[:, None]), dim=1)
            m = m_new
        return -(m + torch.log(s) - math.log(rounds * r))

    def calculate_likelihood(test_images_raw, bank, s_total: Optional[int] = None,
                             chunk: Optional[int] = None,
                             r: Optional[int] = None, *, generator=None,
                             eps=None):
        """Mean test NLL in nats/image and the per-point NLLs (numpy).
        s_total ~ cfg.S, r ~ cfg.MB; rounds are ceil(S / r). ``eps``: one
        noise tensor per chunk, as chunk_nll takes it.

        chunk autotune: each round holds chunk*r input rows, so the chunk
        is capped to keep that working set near a fixed ~256 MB budget."""
        s_total = s_total or cfg.S
        r = min(r or cfg.MB, s_total)
        rounds = max(-(-s_total // r), 1)
        if chunk is None:
            d_in = int(np.prod(test_images_raw.shape[1:]))
            rows_budget = max(4096, 268_435_456 // (d_in * 4))
            chunk = max(1, min(cfg.test_batch_size, rows_budget // r))
        n = test_images_raw.shape[0]
        nlls = []
        for i, start in enumerate(range(0, n, chunk)):
            xc = test_images_raw[start:start + chunk]
            out = chunk_nll(xc, bank, rounds, r, generator=generator,
                            eps=None if eps is None else eps[i])
            nlls.append(out.cpu().numpy())
        per = np.concatenate(nlls)
        return float(np.mean(per)), per

    calculate_likelihood.chunk_nll = chunk_nll
    return calculate_likelihood
