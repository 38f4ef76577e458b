"""The exemplar bank: its storage format, its preprocessing draws and its
encodes (the JAX package keeps them in exemplar_vae_tpu/train/loss.py and
steps.py).

Storage. A raw uint8 bank stays raw on the device: it is preprocessed per
encode chunk, inside the recomputed region of the exact re-encode, or per
gathered row of the approximate prior. A float bank is preprocessed once per
epoch (epoch_bank) and stored in bf16 when the compute is bf16, since the
encoder casts its input to bf16 anyway.

Draws. The training bank's preprocessing is deterministic unless
cfg.bank_stochastic_preprocess; only the training batch always gets fresh
draws. The eval bank is always deterministic. On the data mesh, the draws
over a rank's own shard come from the rank's generator
(Mesh.shard_generator) in three cases: the epoch preprocessing of a float
shard, the exact re-encode of a uint8 shard and the cache refresh. The
approximate prior's gathered rows take the uniforms ``u`` that every rank
draws alike for the whole selection (draw_rows_u).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.ops.preprocess import (preprocess_batch,
                                                   train_draws_uniforms)
from exemplar_vae_tpu_torch.train.profiling import span


class Bank(NamedTuple):
    """Exemplar-bank inputs.

    images: exemplar inputs (N, H, W, C), raw or as epoch_bank stores
      them - None once encoded.
    data_idx: (N,) int32 global dataset indices (LOO addressing).
    valid: (N,) bool - False rows are padding.
    cache_means: (N, Dz) - the stale cache (approximate training) or the
      precomputed exact means (eval); None in exact training.
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


def _preprocess(cfg: Config, x, stochastic: bool, generator=None, u=None):
    return preprocess_batch(x, input_type=cfg.input_type,
                            dynamic_binarization=cfg.dynamic_binarization,
                            train=stochastic, generator=generator, u=u)


def _shard_generator(cfg: Config, generator, mesh):
    if mesh is not None and cfg.bank_stochastic_preprocess:
        return mesh.shard_generator(generator)
    return generator


def epoch_bank(bank: Bank, cfg: Config, generator=None, mesh=None) -> Bank:
    """The training bank of an epoch (or of one step): a float bank
    preprocessed and cast as the module docstring says; a raw uint8 bank,
    or none, as it is."""
    if bank is None or bank.images is None or bank.images.dtype == torch.uint8:
        return bank
    imgs = _preprocess(cfg, bank.images, cfg.bank_stochastic_preprocess,
                       _shard_generator(cfg, generator, mesh))
    if cfg.compute_dtype == "bfloat16":
        imgs = imgs.to(torch.bfloat16)
    return bank._replace(images=imgs)


def _encode(model, images, cfg: Config, stochastic: bool, generator=None, *,
            grad: bool = False):
    """(N, Dz) latent means of the bank ``images``, in chunks of
    cfg.exact_reencode_chunk rows (<= 0 or >= N: one encode), the last
    chunk ragged. Without ``grad`` a float bank is preprocessed whole
    first. With ``grad``, cfg.exact_remat recomputes each chunk's
    activations in the backward (torch.utils.checkpoint), so memory stays
    O(chunk); a stochastic raw chunk's uniforms are then drawn outside the
    recomputed region, so that the recompute sees the same draw (kept for
    the backward: 4 bytes per input element)."""
    raw = images.dtype == torch.uint8
    if not grad and not raw:
        images = _preprocess(cfg, images, stochastic, generator)
    draw = grad and raw and stochastic

    def enc(xc, u):
        if raw:
            xc = _preprocess(cfg, xc, stochastic, generator, u)
        return model.encode_top_mean(xc)

    def run(xc):
        u = (torch.rand(xc.shape, generator=generator, device=xc.device)
             if draw else None)
        if grad and cfg.exact_remat:
            return checkpoint(enc, xc, u, use_reentrant=False)
        return enc(xc, u)

    n, chunk = images.shape[0], cfg.exact_reencode_chunk
    if chunk <= 0 or chunk >= n:
        return run(images)
    return torch.cat([run(images[s:s + chunk])
                      for s in range(0, n, chunk)], dim=0)


def encode_bank_with_grad(model, images, cfg: Config, generator=None,
                          mesh=None):
    """The exact prior's per-step re-encode of the epoch bank ``images``
    (epoch_bank's; on a mesh the rank's shard), with gradients to the
    encoder."""
    if images.dtype == torch.uint8:
        generator = _shard_generator(cfg, generator, mesh)
    return _encode(model, images, cfg, cfg.bank_stochastic_preprocess,
                   generator, grad=True)


@torch.no_grad()
def encode_bank(model, images, cfg: Config, generator=None, mesh=None):
    """The approximate prior's cache refresh: the raw bank ``images`` (on
    a mesh the rank's shard) encoded with no gradient, preprocessed as the
    training bank is."""
    generator = _shard_generator(cfg, generator, mesh)
    with span("evae.cache_refresh"):
        return _encode(model, images, cfg, cfg.bank_stochastic_preprocess,
                       generator)


@torch.no_grad()
def encode_eval_bank(model, images, cfg: Config):
    """The eval bank's means: the raw bank ``images`` encoded with no
    gradient, preprocessed deterministically."""
    return _encode(model, images, cfg, False)


def draw_rows_u(cfg: Config, bank: Bank, n_rows: int, generator=None):
    """The uniforms of ``n_rows`` gathered raw bank rows' stochastic
    preprocessing (rows_input), or None when it draws none."""
    if not (cfg.bank_stochastic_preprocess
            and bank.images.dtype == torch.uint8 and train_draws_uniforms(
                torch.uint8, input_type=cfg.input_type,
                dynamic_binarization=cfg.dynamic_binarization)):
        return None
    return torch.rand((n_rows,) + tuple(bank.images.shape[1:]),
                      generator=generator, device=bank.images.device)


def rows_input(rows, cfg: Config, generator=None, u=None):
    """Gathered bank rows as encoder input: raw uint8 rows preprocessed
    with the uniforms ``u`` (draw_rows_u's), else drawn from
    ``generator``; rows of a float bank as epoch_bank stored them."""
    if rows.dtype != torch.uint8:
        return rows
    return _preprocess(cfg, rows, cfg.bank_stochastic_preprocess, generator,
                       u)
