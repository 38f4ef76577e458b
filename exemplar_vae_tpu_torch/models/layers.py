"""NN primitives (counterpart of exemplar_vae_tpu/models/layers.py).

Parameters keep the flax names and layouts: a dense ``kernel`` is (in, out)
and is applied as ``x @ kernel + bias``; a conv kernel is HWIO
(kh, kw, in, out) and is permuted at compute time. ``GatedDense`` and the
gated convs keep separate ``h_*``/``g_*`` tensors (AdamNormGrad normalizes
per tensor) and join them into one GEMM or one 2F-channel conv. Params are
fp32; ``dtype`` (from ``compute_dtype``) casts matmul and conv inputs
explicitly, with no autocast. Init follows flax: He-normal kernels
(truncated normal, fan-in = every axis but the last), LeCun-normal for a
plain ``nn.Dense`` / ``nn.Conv``, zero biases.

The convs take and return NCHW tensors; the models hand them NHWC data
through ``permute(0, 3, 1, 2)``, a view in the channels-last memory format,
and flatten in flax's NHWC order through ``permute(0, 2, 3, 1)``. Padding is
flax's SAME: for a conv, ``total = max((ceil(n/s)-1)*s + k - n, 0)`` split
``total//2`` before and the rest after (asymmetric when the total is odd);
for a transposed conv, lax's fractionally-strided correlation (no kernel
flip) with ``pad_len = k+s-2``, ``pad_a = k-1 if s > k-1 else
ceil(pad_len/2)``, run as ``F.conv_transpose2d`` of the flipped kernel (no
zero-dilated input) and cropped or output-padded to the same result.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated-normal variance scaling divides by the std of a standard
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def hardtanh(x, min_val: float = -1.0, max_val: float = 1.0):
    return torch.clamp(x, min_val, max_val)


def _variance_scaling(shape, scale, generator):
    std = math.sqrt(scale / math.prod(shape[:-1])) / _TRUNC_STD
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


def _same_pads(n: int, k: int, s: int):
    """flax/XLA SAME padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x, w_hwio, b, stride):
    """flax ``nn.Conv`` with SAME padding: x NCHW, kernel HWIO."""
    kh, kw = w_hwio.shape[:2]
    (t, bo), (le, ri) = (_same_pads(x.shape[2], kh, stride[0]),
                         _same_pads(x.shape[3], kw, stride[1]))
    w = w_hwio.permute(3, 2, 0, 1)
    if t == bo and le == ri:
        return F.conv2d(x, w, b, stride=stride, padding=(t, le))
    return F.conv2d(F.pad(x, (le, ri, t, bo)), w, b, stride=stride)


def _transpose_pads(k: int, s: int):
    """lax.conv_transpose SAME padding of one dim, as (padding,
    output_padding, crop) of F.conv_transpose2d: its effective pads are
    (k-1-padding) before and (k-1-padding+output_padding) after."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    pad_b = pad_len - pad_a
    return k - 1 - pad_a, max(pad_b - pad_a, 0), max(pad_a - pad_b, 0)


def conv_transpose_same(x, w_hwio, b, stride):
    """flax ``nn.ConvTranspose`` with SAME padding (a correlation: no kernel
    flip), x NCHW, kernel HWIO: output spatial size = input * stride."""
    (ph, oph, ch), (pw, opw, cw) = (_transpose_pads(w_hwio.shape[0], stride[0]),
                                    _transpose_pads(w_hwio.shape[1], stride[1]))
    w = w_hwio.permute(2, 3, 0, 1).flip(2, 3)       # (in, out, kh, kw)
    y = F.conv_transpose2d(x, w, b, stride=stride, padding=(ph, pw),
                           output_padding=(oph, opw))
    if ch or cw:
        y = y[:, :, :y.shape[2] - ch, :y.shape[3] - cw]
    return y


class Conv(nn.Module):
    """flax ``nn.Conv`` with a 1x1 kernel (HWIO (1, 1, in, out)), LeCun
    init: the ConvHVAE's and PixelHVAE's likelihood heads."""

    def __init__(self, c_in: int, features: int, *, dtype=None,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_init((1, 1, c_in, features),
                                              generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or self.kernel.dtype
        return conv_same(x.to(dt), self.kernel.to(dt), self.bias.to(dt),
                         (1, 1))


class _GatedConvBase(nn.Module):
    """h * sigmoid(g) of one 2F-channel conv over separate value and gate
    params (HWIO kernels), no activation (the conv stacks use none)."""

    def __init__(self, c_in: int, features: int, kernel_size, strides, *,
                 dtype=None, generator=None):
        super().__init__()
        shape = tuple(kernel_size) + (c_in, features)
        self.h_kernel = nn.Parameter(he_init(shape, generator))
        self.g_kernel = nn.Parameter(he_init(shape, generator))
        self.h_bias = nn.Parameter(torch.zeros(features))
        self.g_bias = nn.Parameter(torch.zeros(features))
        self.strides = tuple(strides)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or self.h_kernel.dtype
        w = torch.cat([self.h_kernel.to(dt), self.g_kernel.to(dt)], dim=-1)
        b = torch.cat([self.h_bias.to(dt), self.g_bias.to(dt)])
        h, g = torch.chunk(self._conv(x.to(dt), w, b, self.strides), 2,
                           dim=1)
        return h * torch.sigmoid(g)


class GatedConv2d(_GatedConvBase):
    """Gated convolution, SAME padding."""
    _conv = staticmethod(conv_same)


class GatedConvTranspose2d(_GatedConvBase):
    """Gated transposed convolution, SAME padding (output = input * s)."""
    _conv = staticmethod(conv_transpose_same)


class MaskedConv2d(nn.Module):
    """PixelCNN masked convolution, stride 1, SAME padding, He init.

    The mask is spatial (all input channels of a pixel together): 'A' zeroes
    the centre tap and everything after it in raster order (the first
    layer: pixel i must not see x_i), 'B' keeps the centre tap. The HWIO
    kernel is masked in fp32, then cast to the compute dtype; the mask
    survives the permute to OIHW because neither F.conv2d nor lax.conv
    flips the kernel."""

    def __init__(self, c_in: int, features: int, kernel_size=(3, 3),
                 mask_type: str = "B", *, dtype=None, generator=None):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(he_init((kh, kw, c_in, features),
                                           generator))
        self.bias = nn.Parameter(torch.zeros(features))
        mask = torch.ones((kh, kw, 1, 1))
        mask[kh // 2, kw // 2 + (1 if mask_type == "B" else 0):] = 0.0
        mask[kh // 2 + 1:] = 0.0
        self.register_buffer("mask", mask, persistent=False)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or self.kernel.dtype
        return conv_same(x.to(dt), (self.kernel * self.mask).to(dt),
                         self.bias.to(dt), (1, 1))


def compute_dtype(cfg):
    """cfg.compute_dtype -> layer dtype (None = fp32 everywhere)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def q_logvar_activation_for(cfg):
    """Inference-net log-var clamp [cfg.q_logvar_min, 2] (default [-6, 2])."""
    lo = float(getattr(cfg, "q_logvar_min", -6.0))
    return lambda x: hardtanh(x, lo, 2.0)


def q_logvar_activation(x):
    """The fixed [-6, 2] clamp (the two-level models' p(z1|z2) log-var)."""
    return hardtanh(x, -6.0, 2.0)


def p_logvar_activation(x):
    """Clamp for continuous-decoder log-variances [-4.5, 0]."""
    return hardtanh(x, -4.5, 0.0)
