"""Validation ELBO, importance-weighted test NLL and the eval bank
(counterpart of exemplar_vae_tpu/train/evaluation.py).

Protocol: test NLL = -[logsumexp_s (log p(x|z_s) + log p(z_s) - log q(z_s|x))
- log S]; at eval the exemplar prior uses the full bank with no LOO mask,
encoded once. Chunks are (t test points) x (r samples) per round with an
online-LSE carry over rounds, as in the JAX package. The encode-once fast
path runs what depends on x alone (q(z|x); for the two-level models q(z2|x)
and the x-side features of q(z1|x,z2)) once per chunk, and gives the
PixelHVAE's teacher-forced decoder the repeated x; the generic path
(``force_generic``) runs the whole forward per round, on the same noise.
Under a profiler a chunk is an ``evae.iwae.chunk`` range over
``evae.iwae.encode`` and one ``evae.iwae.round`` a round, which holds
``evae.iwae.decode`` and the prior's ``evae.prior.lse``; the eval bank is
``evae.eval_bank`` (train/profiling.py's ``span``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.device import as_tensor
from exemplar_vae_tpu_torch.models.base import (reconstruction_log_lik,
                                                reparameterize)
from exemplar_vae_tpu_torch.models.hvae import TwoLevelMLPCore
from exemplar_vae_tpu_torch.ops.distributions import log_normal_diag
from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch
from exemplar_vae_tpu_torch.train.bank import Bank, encode_eval_bank
from exemplar_vae_tpu_torch.train.loss import elbo_terms, eval_log_p_top
from exemplar_vae_tpu_torch.train.profiling import span


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_eval_bank_fn(model, cfg: Config, mesh=None):
    """Encode the full exemplar bank once for evaluation (no gradient;
    train/bank.py::encode_eval_bank). On a ``mesh`` (parallel/mesh.py)
    ``bank`` is this rank's shard: each rank encodes its rows, then the
    means, indices and valid mask are gathered to every rank, so validation
    and the IWAE run replicated over the whole padded bank (padding masked
    by ``valid``, the denominator n_effective), as XLA runs them over the
    JAX package's sharded arrays."""

    @torch.no_grad()
    def build_bank(bank: Bank) -> Bank:
        if cfg.prior != "exemplar_prior":
            return bank
        with span("evae.eval_bank"):
            return _build(bank)

    def _build(bank: Bank) -> Bank:
        dev = model_device(model)
        means = encode_eval_bank(model, as_tensor(bank.images, dev), cfg)
        data_idx = as_tensor(bank.data_idx, dev, torch.int32)
        valid = as_tensor(bank.valid, dev, torch.bool)
        if mesh is not None:
            means, data_idx, valid = (mesh.all_gather_rows(t) for t in
                                      (means, data_idx, valid))
        return Bank(images=None, data_idx=data_idx, valid=valid,
                    cache_means=means, n_effective=bank.n_effective)

    return build_bank


def make_elbo_eval_fn(model, cfg: Config):
    """Mean validation loss, RE and KL: the full batches, then the tail
    batch, each with its own reparameterization draw. The batch means stay
    on the device until one host read at the end; the weighting by batch
    size is done in float64 on the host, as in the JAX package."""

    @torch.no_grad()
    def _terms(x_raw, bank, eps, generator):
        x = preprocess_batch(x_raw, input_type=cfg.input_type,
                             dynamic_binarization=cfg.dynamic_binarization,
                             train=False)
        re, kl, _ = elbo_terms(model, x, cfg, bank=bank, train=False,
                               eps=eps, generator=generator)
        return torch.stack([torch.mean(-re + kl), torch.mean(-re),
                            torch.mean(kl)])

    def evaluate(images_raw, bank, *, generator=None, eps=None):
        """(loss, RE, KL) over ``images_raw`` in batches of
        cfg.test_batch_size. ``eps``: one noise tensor per batch (the full
        batches, then the tail), else drawn from ``generator``."""
        x_all = as_tensor(images_raw, model_device(model))
        n = x_all.shape[0]
        batch = min(cfg.test_batch_size, n)
        steps = n // batch
        starts = list(range(0, steps * batch, batch))
        if n > steps * batch:
            starts.append(steps * batch)
        outs = torch.stack([
            _terms(x_all[s:s + batch], bank,
                   None if eps is None else eps[i], generator)
            for i, s in enumerate(starts)]).cpu().numpy().astype(np.float64)
        tot = outs[:steps].sum(axis=0) * batch
        if n > steps * batch:
            tot = tot + outs[steps] * (n - steps * batch)
        return tuple(tot / max(n, 1))

    return evaluate


def _eps_at(eps, i):
    """Round ``i`` of injected IWAE noise: a tensor, or a two-level pair."""
    if eps is None:
        return None
    if isinstance(eps, (tuple, list)):
        return tuple(e[i] for e in eps)
    return eps[i]


def make_iwae_fn(model, cfg: Config, force_generic: bool = False):
    """Importance-weighted NLL, S samples per point. ``force_generic``
    turns the encode-once fast path off (tests pin the two against each
    other); both draw z2's noise, then z1's, per round."""
    two_level = isinstance(model, TwoLevelMLPCore)

    def round_terms(x_rep, enc, bank, e, generator):
        """(t*r,) log importance weights of one round: the decode side in
        evae.iwae.decode, the prior (eval_log_p_top) in evae.prior.lse."""
        if enc is None:                                  # generic
            with span("evae.iwae.decode"):
                re, kl, _ = elbo_terms(model, x_rep, cfg, bank=bank,
                                       train=False, eps=e,
                                       generator=generator)
            return re - kl
        if not two_level:
            mu_rep, lv_rep = enc
            with span("evae.iwae.decode"):
                z = reparameterize(mu_rep, lv_rep, eps=e, generator=generator)
                x_mean, x_logvar = model.decode(z)
                re = reconstruction_log_lik(x_rep, x_mean, x_logvar,
                                            cfg.input_type)
                log_q = log_normal_diag(z, mu_rep, lv_rep)
            return re - (log_q - eval_log_p_top(model, z, cfg, bank))
        mu_rep, lv_rep, hx_rep = enc
        e2, e1 = (None, None) if e is None else e
        with span("evae.iwae.decode"):
            z2 = reparameterize(mu_rep, lv_rep, eps=e2, generator=generator)
            q1_mean, q1_logvar = model.q_z1_from_cache(hx_rep, z2)
            z1 = reparameterize(q1_mean, q1_logvar, eps=e1,
                                generator=generator)
            p1_mean, p1_logvar = model.p_z1(z2)
            extra_kl = (log_normal_diag(z1, q1_mean, q1_logvar)
                        - log_normal_diag(z1, p1_mean, p1_logvar))
            x_mean, x_logvar = model.decode_x(x_rep, z1, z2)
            re = reconstruction_log_lik(x_rep, x_mean, x_logvar,
                                        cfg.input_type)
            log_q = log_normal_diag(z2, mu_rep, lv_rep)
        return re - (log_q - eval_log_p_top(model, z2, cfg, bank) + extra_kl)

    @torch.no_grad()
    def chunk_nll(x_chunk_raw, bank, rounds: int, r: int, *, generator=None,
                  eps=None):
        """(t,) NLL of one chunk. ``eps`` injects the per-round noise:
        (rounds, t*r, Dz), or for the two-level models the pair
        ((rounds, t*r, z2), (rounds, t*r, z1)); else it is drawn from
        ``generator``."""
        with span("evae.iwae.chunk"):
            return _chunk_nll(x_chunk_raw, bank, rounds, r, generator, eps)

    def _chunk_nll(x_chunk_raw, bank, rounds, r, generator, eps):
        dev = model_device(model)
        with span("evae.iwae.encode"):
            x = preprocess_batch(as_tensor(x_chunk_raw, dev),
                                 input_type=cfg.input_type,
                                 dynamic_binarization=cfg.dynamic_binarization,
                                 train=False)
            t = x.shape[0]
            if eps is not None:
                want = ([(rounds, t * r, cfg.z2_size),
                         (rounds, t * r, cfg.z1_size)]
                        if two_level else [(rounds, t * r, cfg.z1_size)])
                got = [tuple(e.shape) for e in (eps if two_level else [eps])]
                if got != want:
                    raise ValueError(f"eps must be {want}, got {got}")
            x_rep = torch.repeat_interleave(x, r, dim=0)
            enc = None
            if not force_generic:
                q_mean, q_logvar = model.encode_top(x)
                enc = (torch.repeat_interleave(q_mean, r, dim=0),
                       torch.repeat_interleave(q_logvar, r, dim=0))
                if two_level:
                    enc += (torch.repeat_interleave(model.q_z1_cache(x), r,
                                                    dim=0),)
            m = torch.full((t,), -1e30, dtype=torch.float32, device=dev)
            s = torch.zeros((t,), dtype=torch.float32, device=dev)
        for i in range(rounds):
            with span("evae.iwae.round"):
                a = round_terms(x_rep, enc, bank, _eps_at(eps, i),
                                generator).reshape(t, r)
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
