"""The experiment loop (counterpart of exemplar_vae_tpu/train/trainer.py, one
device, without checkpoints or visual artifacts).

Per-epoch protocol: beta = min(1, epoch / warmup); one training pass over a
fresh permutation; the validation ELBO; early stopping on the validation
loss with patience ``early_stopping_epochs`` once beta has warmed up; the
best-on-validation params kept as a CPU copy; abort on a non-finite loss;
the final IWAE NLL on the test split with the best params. Metrics go to
``<snapshot_dir>/<experiment_name>/metrics.jsonl`` beside ``config.json``
and ``results.json``.

Randomness: one ``torch.Generator`` on the device, seeded from cfg.seed,
draws each epoch's permutation and every step's noise, so a seed reproduces
a run on one device; validation and the final evaluation draw from
generators seeded afresh with fixed offsets of cfg.seed, so they are
functions of the params.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.data.loaders import load_dataset
from exemplar_vae_tpu_torch.device import resolve_device
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.train.evaluation import (make_elbo_eval_fn,
                                                     make_eval_bank_fn,
                                                     make_iwae_fn)
from exemplar_vae_tpu_torch.train.loss import Bank
from exemplar_vae_tpu_torch.train.sampling import _top_dim
from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                make_cache_refresh,
                                                make_epoch_fn)

# offsets of cfg.seed for the evaluation generators (the fold-in constants
# of the JAX trainer's evaluation keys)
VAL_SEED_OFFSET = 1_000_003
TEST_SEED_OFFSET = 999_983

_LATER = {
    "resume": "checkpoint/resume (ROADMAP.md, Queue 1, item 6)",
    "eval_only": "checkpoint/resume (ROADMAP.md, Queue 1, item 6)",
    "checkpoint_every": "checkpoint/resume (ROADMAP.md, Queue 1, item 6)",
    "debug_nans": "the profiling tools (ROADMAP.md, Queue 1, item 12)",
    "profile_epoch": "the profiling tools (ROADMAP.md, Queue 1, item 12)",
}


def beta_schedule(epoch: int, warmup: int) -> float:
    """KL warm-up: beta ramps 0->1 over ``warmup`` epochs."""
    if warmup <= 0:
        return 1.0
    return min(1.0, epoch / warmup)


class Experiment:
    """Owns the data, the model, the optimizer and the epoch loop, on
    ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, cfg: Config, device="cuda", verbose: bool = True):
        for name, slice_ in _LATER.items():
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"Config.{name}={getattr(cfg, name)!r} is not ported "
                    f"yet: it comes with {slice_}")
        if tuple(cfg.mesh_shape) != (1,):
            raise NotImplementedError(
                f"mesh_shape={cfg.mesh_shape}: the port trains on one device; "
                f"bank sharding comes with ROADMAP.md, Queue 1, item 11")
        self.device = dev = resolve_device(device)
        self.splits, self.cfg = load_dataset(cfg)
        cfg = self.cfg
        self.verbose = verbose
        self.model = create_model(cfg, device=dev)
        self.state = init_train_state(self.model, cfg)
        self.gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        # --- device-resident data ---
        self.train_x = torch.from_numpy(self.splits.train_x).to(dev)
        self.train_idx = torch.from_numpy(self.splits.train_idx).to(dev)
        self.val_x = torch.from_numpy(self.splits.val_x).to(dev)
        self.test_x = torch.from_numpy(self.splits.test_x).to(dev)
        self.n_train = int(self.splits.train_x.shape[0])
        self.steps_per_epoch = self.n_train // cfg.batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size={cfg.batch_size} exceeds the training set "
                f"({self.n_train} examples): zero steps per epoch. Lower "
                f"batch_size or raise training_set_size.")

        # --- exemplar bank: the first number_components training points,
        # a view of train_x (no second copy); the approximate prior's cache
        # starts at zero and is refreshed at the start of every epoch ---
        self.bank = None
        self.cache_refresh = None
        if cfg.prior == "exemplar_prior":
            n_ex = min(cfg.number_components, self.n_train)
            cache = None
            if cfg.approximate_prior:
                cache = torch.zeros((n_ex, _top_dim(cfg)),
                                    dtype=torch.float32, device=dev)
                self.cache_refresh = make_cache_refresh(self.model, cfg)
            self.bank = Bank(
                images=self.train_x[:n_ex],
                data_idx=torch.arange(n_ex, dtype=torch.int32, device=dev),
                valid=torch.ones(n_ex, dtype=torch.bool, device=dev),
                cache_means=cache, n_effective=n_ex)
        if cfg.prior == "vampprior" and cfg.use_training_data_init:
            # the pseudo-inputs start as the first C training points
            c = cfg.number_components
            seed_imgs = np.asarray(self.splits.train_x[:c], np.float32)
            if seed_imgs.shape[0] < c:
                reps = -(-c // seed_imgs.shape[0])
                seed_imgs = np.tile(seed_imgs, (reps, 1, 1, 1))[:c]
            if self.splits.train_x.dtype == np.uint8:
                seed_imgs = seed_imgs / 255.0
            with torch.no_grad():
                self.model.pseudo_inputs.copy_(torch.from_numpy(seed_imgs))

        self.epoch_fn = make_epoch_fn(cfg)
        self.build_eval_bank = make_eval_bank_fn(self.model, cfg)
        self.elbo_eval = make_elbo_eval_fn(self.model, cfg)
        self.iwae = make_iwae_fn(self.model, cfg)

        self.epoch = 0
        self.best_val = float("inf")
        self.best_params = self._params_on_cpu()
        self.bad_epochs = 0

        # --- experiment dir + metrics ---
        self.exp_dir = os.path.join(cfg.snapshot_dir, cfg.experiment_name())
        os.makedirs(self.exp_dir, exist_ok=True)
        with open(os.path.join(self.exp_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        self._metrics_path = os.path.join(self.exp_dir, "metrics.jsonl")

    # ------------------------------------------------------------------
    def _params_on_cpu(self) -> dict:
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.model.state_dict().items()}

    @contextlib.contextmanager
    def _loaded(self, params: dict):
        """Run the body with ``params`` in the model, then put the live
        params back (the optimizer keeps its tensors: loads copy in place)."""
        live = self._params_on_cpu()
        self.model.load_state_dict(params)
        try:
            yield
        finally:
            self.model.load_state_dict(live)

    def _log(self, record):
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.verbose:
            msg = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in record.items())
            print(msg, flush=True)

    def epoch_perm(self, steps: int, batch: int) -> torch.Tensor:
        """(steps, batch) permuted training indices, drawn on the device."""
        perm = torch.randperm(self.n_train, generator=self.gen,
                              device=self.device)
        return perm[:steps * batch].reshape(steps, batch)

    # ------------------------------------------------------------------
    def train_epoch(self) -> dict:
        self.epoch += 1
        cfg = self.cfg
        beta = beta_schedule(self.epoch, cfg.warmup)
        if self.cache_refresh is not None:
            # the epoch's kNN cache, encoded with the params it starts from
            self.bank = self.bank._replace(cache_means=self.cache_refresh(
                self.bank.images, generator=self.gen))
        perm = self.epoch_perm(self.steps_per_epoch, cfg.batch_size)
        t0 = time.perf_counter()
        self.state, metrics = self.epoch_fn(
            self.state, self.train_x, self.train_idx, perm, self.bank, beta,
            generator=self.gen)
        metrics = {k: float(v) for k, v in metrics.items()}   # one host read
        dt = time.perf_counter() - t0
        metrics.update(epoch=self.epoch, beta=beta, epoch_seconds=dt,
                       images_per_sec=self.steps_per_epoch * cfg.batch_size / dt)
        if cfg.prior == "exemplar_prior":
            # observability of the learned prior variance
            metrics["prior_log_var"] = float(self.model.prior_log_var.detach())
        return metrics

    def validate(self) -> tuple:
        """(loss, RE, KL) on the validation split: a function of the params
        (fixed eval binarization, one fixed generator seed per run)."""
        eval_bank = (self.build_eval_bank(self.bank)
                     if self.bank is not None else None)
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + VAL_SEED_OFFSET)
        return self.elbo_eval(self.val_x, eval_bank, generator=gen)

    def run(self, max_epochs: Optional[int] = None) -> dict:
        cfg = self.cfg
        max_epochs = max_epochs or cfg.epochs
        while self.epoch < max_epochs:
            m = self.train_epoch()
            val_loss, val_re, val_kl = self.validate()
            m.update(val_loss=float(val_loss), val_re=float(val_re),
                     val_kl=float(val_kl))
            if not (np.isfinite(m["loss"]) and np.isfinite(val_loss)):
                # a non-finite state never recovers; best_params still hold
                # the last finite best-on-val state for the final evaluation
                m["aborted_non_finite"] = 1
                self._log(m)
                break
            if float(val_loss) < self.best_val:
                self.best_val = float(val_loss)
                self.best_params = self._params_on_cpu()
                self.bad_epochs = 0
                m["best"] = 1
            elif self.epoch > cfg.warmup:
                # early stopping counts only once beta has warmed up
                self.bad_epochs += 1
            self._log(m)
            if self.bad_epochs >= cfg.early_stopping_epochs:
                break
        return self.final_evaluation()

    # ------------------------------------------------------------------
    def final_evaluation(self) -> dict:
        """IWAE NLL (cfg.S samples) on the test split with the best params,
        and their validation loss (equal to the tracked best_val: same
        generator seed)."""
        with self._loaded(self.best_params):
            eval_bank = (self.build_eval_bank(self.bank)
                         if self.bank is not None else None)
            gen = torch.Generator(device=self.device).manual_seed(
                self.cfg.seed + TEST_SEED_OFFSET)
            test_nll, _ = self.iwae(self.test_x, eval_bank, generator=gen)
            val_loss, _, _ = self.validate()
        results = {"test_nll": float(test_nll),
                   "best_val_loss": float(val_loss),
                   "epochs_trained": self.epoch}
        with open(os.path.join(self.exp_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        self._log({"final_test_nll": float(test_nll)})
        return results
