"""Eval-split binarization: the port's copy of the part of
exemplar_vae_tpu/data/loaders.py that serving needs. The dataset readers
wait for the training slice."""

from __future__ import annotations

import numpy as np

# Fixed seed of the one-time Bernoulli binarization of val/test splits of
# dynamically-binarized datasets, so evaluation targets are identical across
# epochs and runs; training data stays gray and is re-sampled per step.
EVAL_BIN_SEED = 777


def binarize_eval_split(x: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """One-time Bernoulli sample of an eval split's gray levels -> float32 0/1."""
    xf = x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else \
        np.asarray(x, np.float32)
    return (rng.random_sample(xf.shape) < xf).astype(np.float32)
