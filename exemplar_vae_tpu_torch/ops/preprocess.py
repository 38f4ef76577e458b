"""Batch preprocessing (counterpart of exemplar_vae_tpu/ops/preprocess.py).

* Binary data: a fresh Bernoulli sample of the gray levels at train time;
  at eval the splits were binarized once at load time, so they pass through.
* Continuous data stored as uint8: (x + u)/256 with u ~ U[0,1) at train
  time, (x + 0.5)/256 at eval.
* Gray data: the gray levels as they are.

Random draws come from ``generator``, or from the injected uniform noise
``u`` (the shape of x), so that tests can replay JAX's draws: JAX's
``bernoulli(key, p)`` is ``uniform(key, shape) < p``.
"""

from __future__ import annotations

import torch


def to_float(x):
    """uint8 [0,255] -> float32 [0,1] (scale 1/255, the loaders'
    convention); float input is cast to float32."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def _uniform(x, u, generator):
    if u is not None:
        return u.to(device=x.device, dtype=torch.float32)
    return torch.rand(x.shape, generator=generator, device=x.device)


def preprocess_batch(x, *, input_type: str, dynamic_binarization: bool,
                     train: bool, generator=None, u=None):
    """x: uint8 or float in [0,1], any layout. Returns float32."""
    if input_type == "binary":
        xf = to_float(x)
        if dynamic_binarization and train:
            return (_uniform(xf, u, generator) < xf).to(torch.float32)
        return xf
    if input_type == "continuous":
        if x.dtype == torch.uint8:
            xi = x.to(torch.float32)
            noise = _uniform(xi, u, generator) if train else 0.5
            return (xi + noise) / 256.0
        return to_float(x)
    return to_float(x)
