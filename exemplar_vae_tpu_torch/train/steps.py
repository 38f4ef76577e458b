"""The train step and the epoch loop (counterpart of
exemplar_vae_tpu/train/steps.py).

* Each step binarizes / dequantizes its batch on the device, computes the
  loss, runs the backward and applies the optimizer, with no host read.
* The epoch is a loop of steps over a permutation that lives on the device;
  each step gathers its B rows from the device-resident ``train_x``. The
  bank is preprocessed once per epoch. The step metrics stay on the device
  until the caller reads the epoch means (one host read per epoch).
* Noise comes from an explicit ``torch.Generator``, or is injected per step
  (the batch's uniforms ``u`` and the reparameterization ``eps``) so that
  tests can replay the JAX package's draws.

The JAX package's ``epoch_splits`` and ``gather_in_scan`` work around XLA
and TPU limits and have no counterpart here; the loop uses no CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch
from exemplar_vae_tpu_torch.train.loss import Bank, batch_loss
from exemplar_vae_tpu_torch.train.optimizer import Adam, make_optimizer


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (its moments and count)
    and the number of steps taken. Steps update it in place."""
    model: nn.Module
    opt: Adam
    step: int = 0


def init_train_state(model, cfg: Config) -> TrainState:
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def _preprocess_bank(bank: Bank, cfg: Config, generator=None) -> Bank:
    """The epoch's bank: deterministic preprocessing unless
    cfg.bank_stochastic_preprocess, stored in bf16 when the compute is bf16
    (the encoder casts its input to bf16 anyway); a raw uint8 bank stays raw
    and is preprocessed per encode chunk."""
    if bank is None or bank.images is None or bank.images.dtype == torch.uint8:
        return bank
    imgs = preprocess_batch(bank.images, input_type=cfg.input_type,
                            dynamic_binarization=cfg.dynamic_binarization,
                            train=cfg.bank_stochastic_preprocess,
                            generator=generator)
    if cfg.compute_dtype == "bfloat16":
        imgs = imgs.to(torch.bfloat16)
    return bank._replace(images=imgs)


def make_train_step(cfg: Config, *, bank_preprocessed: bool = False):
    """(state, x_raw, data_idx, bank, beta) -> (state, metrics).

    With ``bank_preprocessed`` the caller preprocessed the bank already (the
    epoch loop does it once per epoch); the batch always gets fresh draws.
    After the step each parameter's ``.grad`` holds the step's gradient."""

    def train_step(state: TrainState, x_raw, data_idx, bank, beta, *,
                   generator=None, u=None, eps=None):
        x = preprocess_batch(x_raw, input_type=cfg.input_type,
                             dynamic_binarization=cfg.dynamic_binarization,
                             train=True, generator=generator, u=u)
        if cfg.prior == "exemplar_prior" and not bank_preprocessed:
            bank = _preprocess_bank(bank, cfg, generator)
        state.opt.zero_grad(set_to_none=True)
        loss, aux = batch_loss(state.model, x, beta, cfg, data_idx=data_idx,
                               bank=bank, train=True, eps=eps,
                               generator=generator)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in aux.items()}

    return train_step


def make_epoch_fn(cfg: Config):
    """One epoch: the train step over ``perm``'s (S, B) rows.

    ``epoch_fn(state, train_x, train_idx, perm, bank, beta, generator=...,
    noise=...)``: ``perm`` (S, B) holds the epoch's permuted dataset indices
    on the device; ``noise`` is an optional sequence of per-step (u, eps),
    else the draws come from ``generator``. Returns (state, mean metrics as
    0-d device tensors)."""
    train_step = make_train_step(cfg, bank_preprocessed=True)

    def epoch_fn(state, train_x, train_idx, perm, bank, beta, *,
                 generator=None, noise=None):
        steps, batch = perm.shape
        if cfg.prior == "exemplar_prior":
            bank = _preprocess_bank(bank, cfg, generator)
        x2d = train_x.reshape(train_x.shape[0], -1)
        auxs = []
        for i in range(steps):
            rows = perm[i]
            x = x2d.index_select(0, rows).reshape((batch,) + train_x.shape[1:])
            u, eps = noise[i] if noise is not None else (None, None)
            state, aux = train_step(state, x, train_idx.index_select(0, rows),
                                    bank, beta, generator=generator, u=u,
                                    eps=eps)
            auxs.append(aux)
        return state, {k: torch.stack([a[k] for a in auxs]).mean()
                       for k in auxs[0]}

    return epoch_fn
