"""The train step and the epoch loop (counterpart of
exemplar_vae_tpu/train/steps.py).

* Each step binarizes / dequantizes its batch on the device, computes the
  loss, runs the backward and applies the optimizer, with no host read.
* The epoch is a loop of steps over a permutation that lives on the device;
  each step gathers its B rows from the device-resident ``train_x``. The
  bank is prepared once per epoch (train/bank.py). The step metrics stay on
  the device until the caller reads the epoch means (one host read per
  epoch).
* Noise comes from an explicit ``torch.Generator``, or is injected per step
  (the batch's uniforms ``u`` and the reparameterization ``eps``) so that
  tests can replay the JAX package's draws. The step draws the whole
  batch's noise up front, in one process's order (draw_step_noise), and on
  the data mesh each rank then keeps its own rows of it.
* Under a profiler each step is an ``evae.step`` range over
  ``evae.step.inputs`` (the draws, the preprocessing), ``evae.step.forward``
  (whose prior opens ``evae.prior.*``, train/loss.py), ``evae.step.backward``
  and ``evae.step.optimizer``; the epoch loop's row gather before it is an
  ``evae.step.inputs`` of its own, and the epoch's bank and the cache
  refresh are ``evae.epoch.bank`` and ``evae.cache_refresh``
  (train/profiling.py's ``span``: nothing without a profiler); on the data
  mesh the collectives are ``evae.mesh.*`` ranges (parallel/mesh.py).

The JAX package's ``epoch_splits`` and ``gather_in_scan`` work around XLA
and TPU limits and have no counterpart here; the loop uses no CUDA graph.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.ops.preprocess import (preprocess_batch,
                                                   train_draws_uniforms)
from exemplar_vae_tpu_torch.parallel.sharded_knn import \
    make_sharded_approx_prior
from exemplar_vae_tpu_torch.parallel.sharded_prior import \
    make_sharded_exact_prior
from exemplar_vae_tpu_torch.train.bank import (draw_rows_u, encode_bank,
                                               epoch_bank)
from exemplar_vae_tpu_torch.train.loss import batch_loss
from exemplar_vae_tpu_torch.train.optimizer import Adam, make_optimizer
from exemplar_vae_tpu_torch.train.profiling import span


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (its moments and count)
    and the number of steps taken. Steps update it in place."""
    model: nn.Module
    opt: Adam
    step: int = 0


def init_train_state(model, cfg: Config) -> TrainState:
    return TrainState(model, make_optimizer(cfg, model.parameters()))


class StepNoise(NamedTuple):
    """What one train step draws before its forward, for the whole batch:
    ``u`` the batch's preprocessing uniforms (the shape of x, or None when
    its preprocessing draws none); ``eps`` the reparameterization noise,
    (B, z1) for the VAE, the pair (eps2 (B, z2), eps1 (B, z1)) for the
    two-level models; ``bank_u`` the uniforms of the approximate prior's
    gathered raw bank rows (train/bank.py::draw_rows_u), (B * K, ...) in
    the selection's row-major order, or None."""
    u: Optional[torch.Tensor]
    eps: Any
    bank_u: Optional[torch.Tensor]

    def rows(self, lo: int, hi: int, k: Optional[int]) -> "StepNoise":
        """Rows [lo, hi) of the batch's noise; of ``bank_u`` those rows' k
        neighbours each, or all of it when ``k`` is None (the batch union,
        which every rank re-encodes whole)."""
        eps = (tuple(e[lo:hi] for e in self.eps)
               if isinstance(self.eps, tuple) else self.eps[lo:hi])
        bank_u = self.bank_u
        if bank_u is not None and k is not None:
            bank_u = bank_u[lo * k:hi * k]
        return StepNoise(None if self.u is None else self.u[lo:hi], eps,
                         bank_u)


def draw_step_noise(model, cfg: Config, x_raw, bank, generator=None, *,
                    u=None, eps=None, preprocess_bank: bool = False,
                    mesh=None):
    """(StepNoise, bank): the whole batch's draws of one train step from
    ``generator``, in the order one process has always drawn them (the
    batch's uniforms; the epoch bank's draws when ``preprocess_bank``,
    which returns train/bank.py::epoch_bank's bank; the reparameterization
    noise, model.draw_eps's; the approximate prior's gathered rows'
    uniforms). ``u`` and ``eps`` are kept when injected.
    One process and every rank of the data mesh call this alike, so the
    ranks' generators stay in step and each row sees one process's
    numbers."""
    b, dev = x_raw.shape[0], x_raw.device
    if u is None and train_draws_uniforms(
            x_raw.dtype, input_type=cfg.input_type,
            dynamic_binarization=cfg.dynamic_binarization):
        u = torch.rand(x_raw.shape, generator=generator, device=dev)
    exemplar = cfg.prior == "exemplar_prior"
    if exemplar and preprocess_bank:
        bank = epoch_bank(bank, cfg, generator, mesh)
    if eps is None:
        eps = model.draw_eps(b, generator, dev)
    bank_u = None
    if exemplar and cfg.approximate_prior:
        bank_u = draw_rows_u(cfg, bank, b * cfg.approximate_k, generator)
    return StepNoise(u, eps, bank_u), bank


def make_train_step(cfg: Config, *, bank_preprocessed: bool = False,
                    mesh=None):
    """(state, x_raw, data_idx, bank, beta) -> (state, metrics).

    With ``bank_preprocessed`` the caller preprocessed the bank already (the
    epoch loop does it once per epoch); the batch always gets fresh draws.

    With a ``mesh`` (parallel/mesh.py) the step is data-parallel: every rank
    is given the whole batch (x_raw, data_idx and any injected u / eps) and
    draws the whole batch's noise, then keeps its own rows
    (Mesh.batch_rows) and runs their forward and backward alone; ``bank``
    is this rank's shard and the exemplar prior runs over the mesh
    (parallel/sharded_prior.py, parallel/sharded_knn.py). The backward runs
    from W times the rank's share of the batch mean, and each parameter's
    gradient is then averaged over the ranks, which makes it the one-process
    gradient (Mesh.average_grads). After the step each parameter's
    ``.grad`` holds the step's gradient; the metrics are the batch means on
    one process and on a mesh the rank's shares of them (its rows' sums /
    B), which add up over the ranks to the means."""
    sharded = {}
    if mesh is not None and cfg.prior == "exemplar_prior":
        if cfg.approximate_prior:
            sharded["sharded_approx_fn"] = make_sharded_approx_prior(cfg, mesh)
        else:
            sharded["sharded_exact_fn"] = make_sharded_exact_prior(cfg, mesh)
    k_rows = None if cfg.approximate_support == "batch_union" \
        else cfg.approximate_k

    def train_step(state: TrainState, x_raw, data_idx, bank, beta, *,
                   generator=None, u=None, eps=None):
        with span("evae.step"):
            with span("evae.step.inputs"):
                noise, bank = draw_step_noise(
                    state.model, cfg, x_raw, bank, generator, u=u, eps=eps,
                    preprocess_bank=not bank_preprocessed, mesh=mesh)
                kw = {}
                if mesh is not None:
                    b = x_raw.shape[0]
                    lo, hi = mesh.batch_rows(b)
                    x_raw, data_idx = x_raw[lo:hi], data_idx[lo:hi]
                    noise = noise.rows(lo, hi, k_rows)
                    kw = {k: functools.partial(f, batch_size=b)
                          for k, f in sharded.items()}
                    kw["batch_size"] = b
                x = preprocess_batch(
                    x_raw, input_type=cfg.input_type,
                    dynamic_binarization=cfg.dynamic_binarization,
                    train=True, generator=generator, u=noise.u)
            state.opt.zero_grad(set_to_none=True)
            with span("evae.step.forward"):
                loss, aux = batch_loss(state.model, x, beta, cfg,
                                       data_idx=data_idx, bank=bank,
                                       train=True, eps=noise.eps,
                                       bank_u=noise.bank_u,
                                       generator=generator, **kw)
            with span("evae.step.backward"):
                if mesh is None:
                    loss.backward()
                else:
                    (loss * mesh.size).backward()
                    mesh.average_grads(state.model.parameters())
            with span("evae.step.optimizer"):
                state.opt.step()
            state.step += 1
            return state, {k: v.detach() for k, v in aux.items()}

    return train_step


def make_epoch_fn(cfg: Config, mesh=None):
    """One epoch: the train step over ``perm``'s (S, B) rows (on a
    ``mesh``, data-parallel with this rank's bank shard; see
    make_train_step).

    ``epoch_fn(state, train_x, train_idx, perm, bank, beta, generator=...,
    noise=...)``: ``perm`` (S, B) holds the epoch's permuted dataset indices
    on the device; ``noise`` is an optional sequence of per-step (u, eps)
    of the whole batch, else the draws come from ``generator``. Returns
    (state, mean metrics as 0-d device tensors). On a mesh each rank adds up
    its shares of the steps' means on the device, and one all_reduce at the
    end of the epoch (no per-step collective or host read for the metrics)
    gives the sums over the ranks, / S."""
    train_step = make_train_step(cfg, bank_preprocessed=True, mesh=mesh)

    def epoch_fn(state, train_x, train_idx, perm, bank, beta, *,
                 generator=None, noise=None):
        steps, batch = perm.shape
        if cfg.prior == "exemplar_prior":
            with span("evae.epoch.bank"):
                bank = epoch_bank(bank, cfg, generator, mesh)
        x2d = train_x.reshape(train_x.shape[0], -1)
        auxs = []
        for i in range(steps):
            with span("evae.step.inputs"):
                rows = perm[i]
                x = x2d.index_select(0, rows).reshape(
                    (batch,) + train_x.shape[1:])
                idx = train_idx.index_select(0, rows)
            u, eps = noise[i] if noise is not None else (None, None)
            state, aux = train_step(state, x, idx, bank, beta,
                                    generator=generator, u=u, eps=eps)
            auxs.append(aux)
        if mesh is None:
            return state, {k: torch.stack([a[k] for a in auxs]).mean()
                           for k in auxs[0]}
        keys = list(auxs[0])
        with span("evae.mesh.metrics"):
            sums = mesh.all_reduce(torch.stack(
                [torch.stack([a[k] for a in auxs]).sum() for k in keys]))
        return state, dict(zip(keys, (sums / steps).unbind()))

    return epoch_fn


def make_cache_refresh(model, cfg: Config, mesh=None):
    """The approximate prior's per-epoch cache refresh: ``refresh(
    bank_images_raw, generator=None) -> (N, Dz)`` encodes the whole bank
    (on a ``mesh`` the rank's shard, no collective) with the current params
    and no gradient (train/bank.py::encode_bank), so the cache lags the
    encoder by up to one epoch."""

    def refresh(bank_images_raw, generator=None):
        return encode_bank(model, bank_images_raw, cfg, generator, mesh)

    return refresh
