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


def train_draws_uniforms(dtype, *, input_type: str,
                         dynamic_binarization: bool) -> bool:
    """Whether preprocess_batch(train=True) of an x of ``dtype`` consumes
    uniforms, one per element of x (the ``u`` it takes)."""
    if input_type == "binary":
        return dynamic_binarization
    return input_type == "continuous" and dtype == torch.uint8


def preprocess_batch(x, *, input_type: str, dynamic_binarization: bool,
                     train: bool, generator=None, u=None):
    """x: uint8 or float in [0,1], any layout. Returns float32."""
    noise = (_uniform(x, u, generator) if train and train_draws_uniforms(
        x.dtype, input_type=input_type,
        dynamic_binarization=dynamic_binarization) else None)
    if input_type == "binary":
        xf = to_float(x)
        return xf if noise is None else (noise < xf).to(torch.float32)
    if input_type == "continuous" and x.dtype == torch.uint8:
        return (x.to(torch.float32)
                + (0.5 if noise is None else noise)) / 256.0
    return to_float(x)
