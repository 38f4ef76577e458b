"""Exemplar-guided data augmentation (counterpart of
exemplar_vae_tpu/train/augment.py; BASELINE Config 5).

A permutation-invariant MLP classifier is trained where each minibatch
example is, with probability ``pi``, replaced by an Exemplar-VAE sample
conditioned on it (label-preserving: z ~ N(mu_phi(x), sigma^2 I), then
decode), and its test error is compared with the plain classifier's.

The augmentation (encode, sample, decode), the mask, the classifier's loss,
backward and Adam update run on the model's device with no host read; the
epoch's mean loss is read once per epoch. Every draw comes from an explicit
generator (epoch e's seeded with trainer.fold_seed(seed, e)), or is
injected per step so that tests replay the JAX package's draws.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models.base import clamped_prior_log_var
from exemplar_vae_tpu_torch.models.layers import Dense
from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch
from exemplar_vae_tpu_torch.train.evaluation import as_tensor, model_device
from exemplar_vae_tpu_torch.train.sampling import draw_normal
from exemplar_vae_tpu_torch.train.trainer import Experiment, fold_seed


class MLPClassifier(nn.Module):
    """Permutation-invariant MLP: d_in -> hidden -> hidden -> n_classes
    with ReLUs, the flax module's names (Dense_0..2), (in, out) kernels and
    init (LeCun-normal kernels, zero biases)."""

    def __init__(self, d_in: int, n_classes: int = 10, hidden: int = 512, *,
                 generator=None):
        super().__init__()
        self.Dense_0 = Dense(d_in, hidden, generator=generator)
        self.Dense_1 = Dense(hidden, hidden, generator=generator)
        self.Dense_2 = Dense(hidden, n_classes, generator=generator)

    def forward(self, x):
        h = x.reshape(x.shape[0], -1)
        h = torch.relu(self.Dense_0(h))
        h = torch.relu(self.Dense_1(h))
        return self.Dense_2(h)


class ClassifierResult(NamedTuple):
    test_error: float
    train_seconds: float
    history: list


def make_augment_fn(vae_model, cfg: Config):
    """``augment(x, *, generator=None, eps=None, eps1=None)``: an
    exemplar-conditioned sample of each preprocessed x (label-preserving),
    with the model's current weights. ``eps`` is the top latent's noise,
    ``eps1`` the two-level models' z1 noise (JAX draws them from
    ``split(key)`` in that order)."""
    with torch.no_grad():
        log_var = (clamped_prior_log_var(vae_model, cfg)
                   if cfg.prior == "exemplar_prior"
                   else torch.zeros((), device=model_device(vae_model)))
        scale = torch.exp(0.5 * log_var)

    @torch.no_grad()
    def augment(x, *, generator=None, eps=None, eps1=None):
        mu = vae_model.encode_top_mean(x)
        z = mu + scale * draw_normal(eps, mu.shape, generator, mu.device)
        return vae_model.generate_from_top(z, eps=eps1, generator=generator)

    return augment


def make_classifier_step(clf, opt, cfg: Config, augment_fn=None,
                         pi: float = 0.5):
    """``step(x_raw, y, *, generator=None, u=None, eps=None, eps1=None,
    u_mask=None) -> loss`` (a device scalar): dynamic binarization of the
    batch (uniforms ``u``), with ``augment_fn`` the replacement of each row
    by its augmented sample where ``u_mask < pi`` (JAX's ``bernoulli(k,
    pi)``), then softmax cross-entropy and one update of ``opt``."""

    def step(x_raw, y, *, generator=None, u=None, eps=None, eps1=None,
             u_mask=None):
        x = preprocess_batch(x_raw, input_type=cfg.input_type,
                             dynamic_binarization=cfg.dynamic_binarization,
                             train=True, generator=generator, u=u)
        if augment_fn is not None:
            x_gen = augment_fn(x, generator=generator, eps=eps, eps1=eps1)
            if u_mask is None:
                u_mask = torch.rand((x.shape[0],), generator=generator,
                                    device=x.device)
            mask = as_tensor(u_mask, x.device) < pi
            x = torch.where(mask[:, None, None, None], x_gen, x)
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(clf(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


@torch.no_grad()
def error_rate(clf, cfg: Config, x_raw, y) -> float:
    """Share of misclassified points (eval preprocessing: no draws)."""
    x = preprocess_batch(x_raw, input_type=cfg.input_type,
                         dynamic_binarization=cfg.dynamic_binarization,
                         train=False)
    return float((clf(x).argmax(-1) != y).float().mean())


def train_classifier(vae_model, cfg: Config, splits, *, pi: float = 0.5,
                     epochs: int = 30, lr: float = 1e-3, batch_size: int = 100,
                     seed: int = 0, augment: bool = True,
                     label_budget: int = 0):
    """Train the (optionally augmented) classifier on the device of
    ``vae_model``, whose current weights make the samples; return its test
    error, the seconds it took (training and the test error) and the
    per-epoch mean losses. Adam is ``torch.optim.Adam``, which equals
    ``optax.adam``.

    label_budget > 0 subsamples the labeled training set to that many
    examples (a fixed per-seed choice): generative augmentation matters
    when the classifier is data-limited."""
    if splits.train_labels is None:
        raise ValueError("dataset has no labels; classifier needs them")
    dev = model_device(vae_model)
    n_classes = int(np.max(splits.train_labels)) + 1
    x_np = np.asarray(splits.train_x)
    y_np = np.asarray(splits.train_labels, np.int64)
    if label_budget and label_budget < len(x_np):
        sel = torch.randperm(len(x_np), generator=torch.Generator().manual_seed(
            fold_seed(seed, 0xBEEF)))[:label_budget].numpy()
        x_np, y_np = x_np[sel], y_np[sel]
    x_all = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
    y_all = torch.from_numpy(np.ascontiguousarray(y_np)).to(dev)
    n = len(x_np)
    batch = min(batch_size, n)
    steps = n // batch
    clf = MLPClassifier(int(np.prod(x_np.shape[1:])), n_classes,
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(clf.parameters(), lr=lr)
    step = make_classifier_step(
        clf, opt, cfg, make_augment_fn(vae_model, cfg) if augment else None,
        pi)
    history = []
    t0 = time.perf_counter()
    for e in range(1, epochs + 1):
        gen = torch.Generator(device=dev).manual_seed(fold_seed(seed, e))
        perm = torch.randperm(n, generator=gen, device=dev)[:steps * batch]
        losses = [step(x_all[idx], y_all[idx], generator=gen)
                  for idx in perm.reshape(steps, batch)]
        history.append(float(torch.stack(losses).mean()))    # one host read
    err = error_rate(clf, cfg, torch.from_numpy(splits.test_x).to(dev),
                     torch.from_numpy(np.asarray(splits.test_labels,
                                                 np.int64)).to(dev))
    return ClassifierResult(err, time.perf_counter() - t0, history)


def load_experiment(exp_dir: str, device="cuda") -> Experiment:
    """Rebuild an Experiment from a run directory and restore its
    checkpoint (ckpt_final, else ckpt_last), from the directory given: the
    snapshot_dir in its config.json goes stale once the directory is moved
    or copied. Raises FileNotFoundError when no checkpoint restores, rather
    than hand back untrained weights."""
    with open(os.path.join(exp_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    exp = Experiment(cfg, device=device, verbose=False, exp_dir=exp_dir)
    for tag in ("final", "last"):
        if exp.restore_checkpoint(tag):
            return exp
    raise FileNotFoundError(
        f"no restorable checkpoint (ckpt_final or ckpt_last) under "
        f"{exp_dir!r}: the run may have crashed before its first save; "
        f"refusing to hand back untrained parameters")
