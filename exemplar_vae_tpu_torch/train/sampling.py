"""Generation (counterpart of exemplar_vae_tpu/train/sampling.py: generate_x,
reference_based_generation_x, reconstruct_x, latent_neighbors).

Generative process of the exemplar prior: n ~ Uniform(N);
z ~ N(mu_phi(x_n), sigma^2 I); x_hat = decode(z). Exemplar-conditioned
generation uses a chosen exemplar instead of a sampled one.

Draws come in the JAX key-split order: the exemplar (or pseudo-input) index
first, then the top latent's noise, then (two-level models) the noise of z1
~ p(z1|z2). Each can be injected (``idx``, ``eps``, ``eps1``) so that tests
replay JAX's draws; otherwise they come from ``generator``. For the
PixelHVAE ``eps1`` is the pair (z1 noise, per-pixel uniforms) and the
results are its autoregressive samples.
"""

from __future__ import annotations

import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models.base import clamped_prior_log_var
from exemplar_vae_tpu_torch.ops.knn import knn_indices
from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch
from exemplar_vae_tpu_torch.train.evaluation import as_tensor, model_device


def _prep(x, cfg: Config):
    return preprocess_batch(x, input_type=cfg.input_type,
                            dynamic_binarization=cfg.dynamic_binarization,
                            train=False)


def draw_index(idx, n, hi, generator, device):
    """``n`` indices in [0, hi): the injected ``idx`` or a draw."""
    if idx is not None:
        return as_tensor(idx, device, torch.int64)
    return torch.randint(0, hi, (n,), generator=generator, device=device)


def draw_normal(eps, shape, generator, device):
    """Standard-normal noise of ``shape``: the injected ``eps`` or a draw."""
    if eps is not None:
        eps = as_tensor(eps, device, torch.float32)
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"eps must be {tuple(shape)}, got "
                             f"{tuple(eps.shape)}")
        return eps
    return torch.randn(shape, generator=generator, device=device)


@torch.no_grad()
def generate_x(model, cfg: Config, n: int, bank_images_raw=None,
               n_valid: int = None, *, generator=None, idx=None, eps=None,
               eps1=None):
    """Unconditional samples: (n, H, W, C) decoder means. ``n_valid``
    bounds exemplar sampling to the real (non-padding) bank rows."""
    dev = model_device(model)
    if cfg.prior == "standard":
        z = draw_normal(eps, (n, model.top_dim), generator, dev)
    elif cfg.prior == "vampprior":
        u = model.get_pseudo_inputs()
        i = draw_index(idx, n, u.shape[0], generator, dev)
        m, lv = model.encode_top(u[i])
        z = m + torch.exp(0.5 * lv) * draw_normal(eps, m.shape, generator, dev)
    else:
        hi = n_valid if n_valid is not None else bank_images_raw.shape[0]
        i = draw_index(idx, n, hi, generator, dev)
        ex = _prep(as_tensor(bank_images_raw, dev)[i], cfg)
        mu = model.encode_top_mean(ex)
        log_var = clamped_prior_log_var(model, cfg)
        z = mu + torch.exp(0.5 * log_var) * draw_normal(eps, mu.shape,
                                                        generator, dev)
    return model.generate_from_top(z, eps=eps1, generator=generator)


@torch.no_grad()
def reference_based_generation_x(model, cfg: Config, x_ref_raw,
                                 n_per_ref: int = 1, *, generator=None,
                                 eps=None, eps1=None):
    """Samples conditioned on given exemplars x_ref. Returns
    (B * n_per_ref, H, W, C)."""
    dev = model_device(model)
    mu = model.encode_top_mean(_prep(as_tensor(x_ref_raw, dev), cfg))
    if n_per_ref > 1:
        mu = torch.repeat_interleave(mu, n_per_ref, dim=0)
    log_var = (clamped_prior_log_var(model, cfg)
               if cfg.prior == "exemplar_prior"
               else torch.zeros((), device=dev))
    z = mu + torch.exp(0.5 * log_var) * draw_normal(eps, mu.shape, generator,
                                                    dev)
    return model.generate_from_top(z, eps=eps1, generator=generator)


@torch.no_grad()
def reconstruct_x(model, cfg: Config, x_raw, *, generator=None, eps=None):
    """(preprocessed x, decoder means of one posterior sample of x). ``eps``
    is the forward's noise: (B, Dz), or the pair (eps2, eps1) for the
    two-level models."""
    x = _prep(as_tensor(x_raw, model_device(model)), cfg)
    return x, model(x, eps=eps, generator=generator).x_mean


@torch.no_grad()
def latent_neighbors(model, cfg: Config, x_query_raw, bank_images_raw,
                     cache_means, k: int, *, valid=None):
    """The ``k`` nearest exemplars of each query in encoder-mean space:
    (indices (B, k), their bank images (B, k, H, W, C)). ``valid`` masks
    padding rows of the cache, so they never show up as neighbours."""
    dev = model_device(model)
    q = model.encode_top_mean(_prep(as_tensor(x_query_raw, dev), cfg))
    idx = knn_indices(q, as_tensor(cache_means, dev), k,
                      valid=None if valid is None else as_tensor(valid, dev))
    return idx, as_tensor(bank_images_raw, dev)[idx]
