"""The experiment loop (counterpart of exemplar_vae_tpu/train/trainer.py).

Per-epoch protocol: beta = min(1, epoch / warmup); one training pass over a
fresh permutation; the validation ELBO; early stopping on the validation
loss with patience ``early_stopping_epochs`` once beta has warmed up; the
best-on-validation params kept as a CPU copy; abort on a non-finite loss;
the final IWAE NLL on the test split with the best params, then the
visual artifacts (image grids). Metrics go to
``<snapshot_dir>/<experiment_name>/metrics.jsonl`` beside ``config.json``
and ``results.json``; ``checkpoint_every`` saves the full state to
``ckpt_last`` (train/checkpoints.py), ``profile_epoch`` traces one epoch
into ``profile/``, ``debug_nans`` runs the training steps under autograd's
anomaly detection.

Randomness: epoch e's permutation, cache refresh and step noise come from a
``torch.Generator`` on the device seeded with fold_seed(cfg.seed, e), as
the JAX trainer folds the epoch into its key; so a seed reproduces a run
on one device, and a run resumed from a checkpoint of epoch e draws what
the uninterrupted run draws from epoch e + 1 on, with no generator state
saved. Validation, the final evaluation and the artifacts draw from
generators seeded afresh with fixed offsets of cfg.seed, so they are
functions of the params.

Data parallelism: with ``cfg.mesh_shape`` (W,) the Experiment runs as
rank r of W processes (torchrun; parallel/mesh.py). Each step's batch is
split by rows: every rank gathers the whole batch and draws the whole
batch's noise from the epoch's generator (the same on every rank), then
trains on its own rows (Mesh.batch_rows; the splits may be uneven), and
the gradients are averaged into the one-process gradient. The exemplar
bank, padded to a multiple of W (padding rows with exemplar index -2 and
valid False), and the approximate prior's cache are split by rows, rank r
holding [r * n_loc, (r + 1) * n_loc). The training data, the params and
the optimizer state are replicated, and validation, the final evaluation
and the artifacts run whole on every rank. Rank 0 alone writes
config.json, metrics.jsonl, results.json, the artifacts and the
checkpoints; every rank runs the same epochs in lockstep.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.data.loaders import load_dataset
from exemplar_vae_tpu_torch.device import resolve_device
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.parallel.mesh import create_mesh, pad_to_shards
from exemplar_vae_tpu_torch.train import checkpoints, plots, sampling
from exemplar_vae_tpu_torch.train.evaluation import (make_elbo_eval_fn,
                                                     make_eval_bank_fn,
                                                     make_iwae_fn)
from exemplar_vae_tpu_torch.train.loss import Bank
from exemplar_vae_tpu_torch.train.profiling import nan_debug, trace
from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                make_cache_refresh,
                                                make_epoch_fn)

# offsets of cfg.seed for the evaluation generators (the fold-in constants
# of the JAX trainer's evaluation keys; the artifacts' is the port's own)
VAL_SEED_OFFSET = 1_000_003
TEST_SEED_OFFSET = 999_983
ARTIFACT_SEED_OFFSET = 999_979

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, n: int) -> int:
    """A 63-bit seed derived from (seed, n) alone (a splitmix64 step over
    the pair; Python's hash() is salted per process): the port's
    counterpart of jax.random.fold_in."""
    x = (seed * 0x9E3779B97F4A7C15 + n + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def beta_schedule(epoch: int, warmup: int) -> float:
    """KL warm-up: beta ramps 0->1 over ``warmup`` epochs."""
    if warmup <= 0:
        return 1.0
    return min(1.0, epoch / warmup)


class Experiment:
    """Owns the data, the model, the optimizer and the epoch loop, on
    ``device`` ("cuda" unless the caller asks for "cpu"; on a mesh "cuda"
    is the rank's card, cuda:LOCAL_RANK). ``exp_dir`` overrides the
    experiment directory that the config derives
    (<snapshot_dir>/<experiment_name>), for a run directory that was moved
    or copied (augment.load_experiment)."""

    def __init__(self, cfg: Config, device="cuda", verbose: bool = True,
                 exp_dir: Optional[str] = None):
        if cfg.checkpoint_backend != "npz":
            raise NotImplementedError(
                f"checkpoint_backend={cfg.checkpoint_backend!r}: the port "
                f"writes npz checkpoints only; orbax is a JAX library and "
                f"the port runs without JAX (ROADMAP.md, Queue 3)")
        dev = resolve_device(device)
        self.mesh = create_mesh(cfg, dev)
        self.device = dev = self.mesh.device if self.mesh else dev
        self._is_main = self.mesh is None or self.mesh.is_main
        self.splits, self.cfg = load_dataset(cfg)
        cfg = self.cfg
        self.verbose = verbose
        self.model = create_model(cfg, device=dev)
        self.state = init_train_state(self.model, cfg)
        # the current epoch's generator (epoch 0's until training starts,
        # for callers that drive epoch_fn themselves)
        self.gen = self._generator(fold_seed(cfg.seed, 0))

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
        # a view of train_x (no second copy; on a mesh this rank's rows of
        # it, padded); the approximate prior's cache starts at zero and is
        # refreshed at the start of every epoch ---
        self.bank = None
        self.cache_refresh = None
        if cfg.prior == "exemplar_prior":
            n_ex = min(cfg.number_components, self.n_train)
            images, idxs, valid = self._bank_rows(n_ex)
            cache = None
            if cfg.approximate_prior:
                cache = torch.zeros((images.shape[0], self.model.top_dim),
                                    dtype=torch.float32, device=dev)
                self.cache_refresh = make_cache_refresh(self.model, cfg,
                                                        self.mesh)
            self.bank = Bank(images=images, data_idx=idxs, valid=valid,
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

        self.epoch_fn = make_epoch_fn(cfg, self.mesh)
        self.build_eval_bank = make_eval_bank_fn(self.model, cfg, self.mesh)
        self.elbo_eval = make_elbo_eval_fn(self.model, cfg)
        self.iwae = make_iwae_fn(self.model, cfg)

        self.epoch = 0
        self.best_val = float("inf")
        self.best_params = self._params_on_cpu()
        self.bad_epochs = 0

        # --- experiment dir + metrics ---
        self.exp_dir = exp_dir or os.path.join(cfg.snapshot_dir,
                                               cfg.experiment_name())
        if self._is_main:
            os.makedirs(self.exp_dir, exist_ok=True)
            with open(os.path.join(self.exp_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())
        self._metrics_path = os.path.join(self.exp_dir, "metrics.jsonl")

    # ------------------------------------------------------------------
    def _bank_rows(self, n_ex: int) -> tuple:
        """(images, data_idx, valid) of the bank rows this process holds:
        all n_ex on one device; on a mesh rank r's rows of the bank padded
        to a multiple of the mesh size (zero images, index -2, valid
        False). Images are views of train_x where no padding falls in."""
        idxs = np.arange(n_ex, dtype=np.int32)
        lo, hi = 0, n_ex
        if self.mesh is not None:
            idxs, _ = pad_to_shards(idxs, self.mesh.size, pad_value=-2)
            lo, hi = self.mesh.shard_range(len(idxs))
        idxs = torch.from_numpy(idxs[lo:hi]).to(self.device)
        images = self.train_x[lo:min(hi, n_ex)]
        if images.shape[0] < hi - lo:
            images = torch.cat([images, images.new_zeros(
                (hi - lo - images.shape[0],) + tuple(images.shape[1:]))])
        return images, idxs, idxs >= 0

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

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
        if not self._is_main:
            return
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
        self.gen = self._generator(fold_seed(cfg.seed, self.epoch))
        if self.cache_refresh is not None:
            # the epoch's kNN cache, encoded with the params it starts from
            self.bank = self.bank._replace(cache_means=self.cache_refresh(
                self.bank.images, generator=self.gen))
        perm = self.epoch_perm(self.steps_per_epoch, cfg.batch_size)
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if (cfg.profile_epoch and self.epoch == cfg.profile_epoch
                    and self._is_main):
                stack.enter_context(trace(os.path.join(self.exp_dir,
                                                       "profile")))
            if cfg.debug_nans:
                stack.enter_context(nan_debug(True))
            self.state, metrics = self.epoch_fn(
                self.state, self.train_x, self.train_idx, perm, self.bank,
                beta, generator=self.gen)
            metrics = {k: float(v) for k, v in metrics.items()}  # host read
        dt = time.perf_counter() - t0
        # images/s of the whole mesh: every rank's rows of every batch
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
        return self.elbo_eval(self.val_x, eval_bank, generator=self._generator(
            self.cfg.seed + VAL_SEED_OFFSET))

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
            if cfg.checkpoint_every and self.epoch % cfg.checkpoint_every == 0:
                self.save_checkpoint()
            if self.bad_epochs >= cfg.early_stopping_epochs:
                break
        return self.final_evaluation()

    # ------------------------------------------------------------------
    def final_evaluation(self) -> dict:
        """IWAE NLL (cfg.S samples) on the test split with the best params,
        their validation loss (equal to the tracked best_val: same
        generator seed), then the artifacts. A failure of the artifacts is
        recorded as ``artifact_error`` in results.json, which is written
        after them, and does not fail the finished run."""
        with self._loaded(self.best_params):
            eval_bank = (self.build_eval_bank(self.bank)
                         if self.bank is not None else None)
            gen = self._generator(self.cfg.seed + TEST_SEED_OFFSET)
            test_nll, _ = self.iwae(self.test_x, eval_bank, generator=gen)
            val_loss, _, _ = self.validate()
            results = {"test_nll": float(test_nll),
                       "best_val_loss": float(val_loss),
                       "epochs_trained": self.epoch}
            if self._is_main:
                try:
                    self.save_artifacts(eval_bank)
                except Exception as e:  # plotting must not kill a finished run
                    traceback.print_exc()
                    results["artifact_error"] = f"{type(e).__name__}: {e}"
        if self._is_main:
            with open(os.path.join(self.exp_dir, "results.json"), "w") as f:
                json.dump(results, f, indent=2)
        self._log({"final_test_nll": float(test_nll)})
        return results

    def save_artifacts(self, eval_bank):
        """Image grids of the model in place: reconstructions.png (25 test
        points) beside real.png, generations.png (25 samples) and, under
        the exemplar prior, exemplar_neighborhoods.png (5 samples around
        each of 5 training points) and latent_knn_retrieval.png (each of 5
        test points' 5 nearest exemplars in latent space)."""
        cfg, g = self.cfg, self._generator(self.cfg.seed + ARTIFACT_SEED_OFFSET)

        def save(name, images, ncol=None):
            images = images.float() / 255.0 if images.dtype == torch.uint8 \
                else images.float()
            plots.save_grid(images.cpu().numpy(),
                            os.path.join(self.exp_dir, name), ncol=ncol)

        x_test = self.test_x[:25]
        _, recon = sampling.reconstruct_x(self.model, cfg, x_test, generator=g)
        save("reconstructions.png", recon)
        save("real.png", x_test)
        # the whole bank's images: train_x is whole on every rank
        n_ex = None if self.bank is None else self.bank.n_effective
        images = None if n_ex is None else self.train_x[:n_ex]
        save("generations.png", sampling.generate_x(
            self.model, cfg, 25, images, n_valid=n_ex, generator=g))
        if cfg.prior == "exemplar_prior":
            save("exemplar_neighborhoods.png",
                 sampling.reference_based_generation_x(
                     self.model, cfg, self.train_x[:5], n_per_ref=5,
                     generator=g), ncol=5)
            _, imgs = sampling.latent_neighbors(
                self.model, cfg, self.test_x[:5], images,
                eval_bank.cache_means[:n_ex], 5, valid=eval_bank.valid[:n_ex])
            save("latent_knn_retrieval.png",
                 imgs.reshape((-1,) + tuple(imgs.shape[2:])), ncol=5)

    # ------------------------------------------------------------------
    def save_checkpoint(self, tag: str = "last"):
        checkpoints.save_checkpoint(self, tag)

    def restore_checkpoint(self, tag: str = "last") -> bool:
        """Load ckpt_<tag> into this Experiment (its tensors onto its
        device); False when there is none."""
        return checkpoints.restore_checkpoint(self, tag)
