"""Seeded weights made on the device, and their layouts on both sides.

The reference family's ``param_spec`` lists every leaf in the flax layout
(``"q_layers_0/h_kernel"``: dense kernels (in, out), conv kernels HWIO) with
its initializer. ``make_weights`` draws them all in one call of
``torch.randn`` on the device and scales each leaf's slice: kernels as the
flax initializers do (He or LeCun normal, truncated at two standard
deviations, here by clamping), biases small and non-zero so that every
bias path carries a value, the prior's log-variance at log(1). The port's
parameters carry the same names with dots (``q_layers_0.h_kernel``) and
the same layouts, so ``program_state`` is a renaming and the reference
takes the flax names as they are."""

from __future__ import annotations

import math

import torch

from portbench.common import sub_seed

TRUNC_STD = 0.87962566103423978   # std of a standard normal cut to [-2, 2]
BIAS_STD = 0.01


def make_weights(spec: dict, *, seed: int, device) -> dict:
    """{flax name: fp32 tensor on ``device``} for ``spec`` ({name: (shape,
    init)}, init one of "he", "lecun", "bias", "zero")."""
    total = sum(math.prod(shape) for shape, _ in spec.values())
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, (shape, init) in spec.items():
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if init in ("he", "lecun"):
            fan_in = math.prod(shape[:-1])
            std = math.sqrt((2.0 if init == "he" else 1.0) / fan_in)
            v.clamp_(-2.0, 2.0).mul_(std / TRUNC_STD)
        elif init == "bias":
            v.mul_(BIAS_STD)
        elif init == "zero":
            v.zero_()
        else:
            raise ValueError(f"unknown initializer {init!r} of {name}")
        out[name] = v
    return out


def program_state(weights: dict) -> dict:
    """The port's state_dict names for the flax-named weights."""
    return {k.replace("/", "."): v for k, v in weights.items()}


def reference_params(weights: dict) -> dict:
    """Fresh leaves for the reference: copies that require grad."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in weights.items()}
