"""NN primitives (counterpart of exemplar_vae_tpu/models/layers.py, dense part).

Parameters keep the flax names and layouts: a dense ``kernel`` is (in, out)
and is applied as ``x @ kernel + bias``; ``GatedDense`` keeps separate
``h_*``/``g_*`` tensors (AdamNormGrad normalizes per tensor) and joins them
into one GEMM at compute time. Params are fp32; ``dtype`` (from
``compute_dtype``) casts matmul inputs explicitly, with no autocast. Init
follows flax: He-normal kernels (truncated normal), LeCun-normal for a plain
``nn.Dense``, zero biases. The conv layers wait for the ConvHVAE slice.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

# flax's truncated-normal variance scaling divides by the std of a standard
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def hardtanh(x, min_val: float = -1.0, max_val: float = 1.0):
    return torch.clamp(x, min_val, max_val)


def _variance_scaling(shape, scale, generator):
    std = math.sqrt(scale / shape[0]) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return w


def he_init(shape, generator=None):
    return _variance_scaling(shape, 2.0, generator)


def lecun_init(shape, generator=None):
    return _variance_scaling(shape, 1.0, generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ kernel + bias, kernel (in, out)."""

    def __init__(self, d_in: int, features: int, *, dtype=None, init=lecun_init,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(init((d_in, features), generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or self.kernel.dtype
        return torch.addmm(self.bias.to(dt), x.to(dt), self.kernel.to(dt))


class NonLinear(nn.Module):
    """Linear layer with an optional activation; the flax module nests its
    Dense as ``Dense_0``, and so does this one."""

    def __init__(self, d_in: int, features: int,
                 activation: Optional[Callable] = None, *, dtype=None,
                 generator=None):
        super().__init__()
        self.Dense_0 = Dense(d_in, features, dtype=dtype, init=he_init,
                             generator=generator)
        self.activation = activation

    def forward(self, x):
        h = self.Dense_0(x)
        if self.activation is not None:
            h = self.activation(h)
        return h


class GatedDense(nn.Module):
    """h = f(W1 x) * sigmoid(W2 x) with separate value and gate params."""

    def __init__(self, d_in: int, features: int,
                 activation: Optional[Callable] = None, *, dtype=None,
                 generator=None):
        super().__init__()
        self.h_kernel = nn.Parameter(he_init((d_in, features), generator))
        self.g_kernel = nn.Parameter(he_init((d_in, features), generator))
        self.h_bias = nn.Parameter(torch.zeros(features))
        self.g_bias = nn.Parameter(torch.zeros(features))
        self.activation = activation
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or self.h_kernel.dtype
        w = torch.cat([self.h_kernel.to(dt), self.g_kernel.to(dt)], dim=-1)
        b = torch.cat([self.h_bias.to(dt), self.g_bias.to(dt)])
        h, g = torch.chunk(torch.addmm(b, x.to(dt), w), 2, dim=-1)
        if self.activation is not None:
            h = self.activation(h)
        return h * torch.sigmoid(g)


def compute_dtype(cfg):
    """cfg.compute_dtype -> layer dtype (None = fp32 everywhere)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def q_logvar_activation_for(cfg):
    """Inference-net log-var clamp [cfg.q_logvar_min, 2] (default [-6, 2])."""
    lo = float(getattr(cfg, "q_logvar_min", -6.0))
    return lambda x: hardtanh(x, lo, 2.0)


def p_logvar_activation(x):
    """Clamp for continuous-decoder log-variances [-4.5, 0]."""
    return hardtanh(x, -4.5, 0.0)
