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

The convs take and return NCHW tensors in the memory format they are given;
the models hand them NHWC data in the format of cuDNN's kernels for the
compute dtype (``channels_last``, ``nchw_for``: NCHW-contiguous in fp32,
the channels-last view of ``permute(0, 3, 1, 2)`` in bf16) and flatten in
flax's NHWC order through ``permute(0, 2, 3, 1)``. Padding is
flax's SAME: for a conv, ``total = max((ceil(n/s)-1)*s + k - n, 0)`` split
``total//2`` before and the rest after (asymmetric when the total is odd);
for a transposed conv, lax's fractionally-strided correlation (no kernel
flip) with ``pad_len = k+s-2``, ``pad_a = k-1 if s > k-1 else
ceil(pad_len/2)``.

A transposed conv takes one of two routes. When a gradient flows through it
(grad mode on and the input, kernel or bias requiring grad) it runs as
``F.conv_transpose2d`` of the flipped kernel (no zero-dilated input),
cropped or output-padded to the same result: its backward is a strided conv
and a weight gradient. Otherwise (scoring, sampling, serving programs) it
runs as one stride-1 sub-pixel conv: output phase r of ``y[s*q + r]`` sums
``x[q + d] * w[t]`` over the taps with ``r + t - pad_a = s*d``, so the s*s
phases are the output channels of one ``F.conv2d`` whose kernel spans the
offsets d and holds zeros at the taps a phase does not use, followed by a
depth-to-space copy that adds the bias. That keeps cuDNN on its forward
route, which at Config 4's decoder shapes on an H100 (fp32, TF32 off) is
~1.5x as fast as the dgrad engine it runs ``conv_transpose2d`` on, despite
the zero taps (16/9 of the multiply-adds for k 3, s 2).
``conv_transpose_same.subpixel`` counts the calls that take the second route.

The gated convs on that no-gradient route, in fp32, take NCHW-contiguous
input (``nchw_for``; they refuse any other) and run without their bias:
the conv's raw sum, for a transposed conv the sub-pixel conv's phase-major
channels with no depth-to-space copy, goes to one pass of
``ops/gated_epilogue.py`` that adds the biases, moves the phases to space
and gates. ``gated_epilogue.launches`` counts those calls.
Every other call (a gradient to carry, or bf16) is ``gated_conv``: the conv
with its bias, ``chunk``, sigmoid and product; ``gated_conv.grad_nchw``
counts those that carry a gradient over an NCHW-contiguous input.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from exemplar_vae_tpu_torch.ops.gated_epilogue import gated_epilogue

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


def _lax_transpose_pads(k: int, s: int):
    """lax.conv_transpose SAME padding of one dim: the pads (before, after)
    of the zero-dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def _transpose_pads(k: int, s: int):
    """lax.conv_transpose SAME padding of one dim, as (padding,
    output_padding, crop) of F.conv_transpose2d: its effective pads are
    (k-1-padding) before and (k-1-padding+output_padding) after."""
    pad_a, pad_b = _lax_transpose_pads(k, s)
    return k - 1 - pad_a, max(pad_b - pad_a, 0), max(pad_a - pad_b, 0)


def _subpixel_taps(k: int, s: int):
    """One dim of the sub-pixel form: output phase r of ``y[s*q + r]`` sums
    ``x[q + d] * w[t]`` over the taps t with ``r + t - pad_a = s*d``. Returns
    the input's pads (before, after) of the stride-1 conv over the offsets
    d and, per phase, the tap at each offset (None: a zero tap). The
    offsets always span 0, so both pads are >= 0."""
    pad_a, _ = _lax_transpose_pads(k, s)
    hits = [(r, t, (r + t - pad_a) // s) for r in range(s) for t in range(k)
            if (r + t - pad_a) % s == 0]
    lo, hi = min(d for *_, d in hits), max(d for *_, d in hits)
    taps = [[None] * (hi - lo + 1) for _ in range(s)]
    for r, t, d in hits:
        taps[r][d - lo] = t
    return (-lo, hi), taps


def _subpixel_conv(x, w_hwio, stride):
    """The sub-pixel form's stride-1 conv, with no bias: s_h*s_w*out
    channels, phase-major (channel (a*s_w + b)*out + c holds output phase
    (a, b) of channel c), in the memory format of x. Counted in
    ``conv_transpose_same.subpixel``."""
    (sh, sw), f = stride, w_hwio.shape[3]
    (ph, taps_h), (pw, taps_w) = (_subpixel_taps(w_hwio.shape[0], sh),
                                  _subpixel_taps(w_hwio.shape[1], sw))
    kh, kw = len(taps_h[0]), len(taps_w[0])
    zero = w_hwio.new_zeros(w_hwio.shape[2:])
    w = torch.stack([zero if i is None or j is None else w_hwio[i, j]
                     for rh in range(sh) for rw in range(sw)
                     for i in taps_h[rh] for j in taps_w[rw]])
    # (sh, sw, kh, kw, in, out) -> (sh*sw*out, in, kh, kw)
    w = w.view(sh, sw, kh, kw, *w_hwio.shape[2:]).permute(0, 1, 5, 4, 2, 3)
    w = w.reshape(sh * sw * f, w_hwio.shape[2], kh, kw)
    conv_transpose_same.subpixel += 1
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w)


def _conv_transpose_subpixel(x, w_hwio, b, stride):
    """conv_transpose_same's forward-only route: the sub-pixel conv, then
    one depth-to-space copy that adds the bias, into the layout the conv
    returned (channels-last stays channels-last)."""
    (sh, sw), f = stride, w_hwio.shape[3]
    y = _subpixel_conv(x, w_hwio, stride)
    n, _, h, wd = y.shape
    y6 = y.unflatten(1, (sh, sw, f))                # (N, sh, sw, out, H, W)
    if y.is_contiguous(memory_format=torch.channels_last):
        out = y.new_empty((n, h, sh, wd, sw, f))
        src, bias = y6.permute(0, 4, 1, 5, 2, 3), b
        y = out.view(n, h * sh, wd * sw, f).permute(0, 3, 1, 2)
    else:
        out = y.new_empty((n, f, h, sh, wd, sw))
        src, bias = y6.permute(0, 3, 4, 1, 5, 2), b.view(f, 1, 1, 1, 1)
        y = out.view(n, f, h * sh, wd * sw)
    torch.add(src, bias, out=out)
    return y


def conv_transpose_same(x, w_hwio, b, stride):
    """flax ``nn.ConvTranspose`` with SAME padding (a correlation: no kernel
    flip), x NCHW, kernel HWIO: output spatial size = input * stride. With a
    gradient to carry it runs ``F.conv_transpose2d``, else the sub-pixel
    conv (module docstring)."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, w_hwio, b))):
        return _conv_transpose_subpixel(x, w_hwio, b, stride)
    (ph, oph, ch), (pw, opw, cw) = (_transpose_pads(w_hwio.shape[0], stride[0]),
                                    _transpose_pads(w_hwio.shape[1], stride[1]))
    w = w_hwio.permute(2, 3, 0, 1).flip(2, 3)       # (in, out, kh, kw)
    y = F.conv_transpose2d(x, w, b, stride=stride, padding=(ph, pw),
                           output_padding=(oph, opw))
    if ch or cw:
        y = y[:, :, :y.shape[2] - ch, :y.shape[3] - cw]
    return y


conv_transpose_same.subpixel = 0


def channels_last(cfg) -> bool:
    """The conv stacks' memory format, that of cuDNN's conv kernels for the
    compute dtype: channels-last in bf16, NCHW-contiguous in fp32."""
    return compute_dtype(cfg) is not None


def nchw_for(x, cfg):
    """NHWC x -> NCHW in the conv stacks' memory format for ``cfg``: the
    channels-last view, or NCHW-contiguous. When C is 1 a reshape: it gives
    the channel stride H*W, where contiguous() leaves the view's stride of
    1 (a size-1 dim's stride is free), which cuDNN reads as channels-last."""
    n, h, w, c = x.shape
    if channels_last(cfg):
        return x.permute(0, 3, 1, 2)
    if c == 1:
        return x.reshape(n, 1, h, w)
    return x.permute(0, 3, 1, 2).contiguous()


def _nchw_contiguous(x) -> bool:
    """NCHW-contiguous with NCHW strides: a C = 1 channels-last view is
    contiguous too, but its channel stride of 1 reads as channels-last."""
    return x.is_contiguous() and x.stride(1) == x.shape[2] * x.shape[3]


def carries_grad(*tensors) -> bool:
    """Grad mode on and one of ``tensors`` requiring grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gated_conv(conv, x, w, b, stride):
    """h * sigmoid(g) of ``conv(x, w, b, stride)``'s 2F channels, in the
    memory format of x: the gated convs' route with a gradient to carry, and
    in bf16. ``gated_conv.grad_nchw`` counts the calls that carry a
    gradient over an NCHW-contiguous x."""
    if carries_grad(x, w, b) and _nchw_contiguous(x):
        gated_conv.grad_nchw += 1
    h, g = torch.chunk(conv(x, w, b, stride), 2, dim=1)
    return h * torch.sigmoid(g)


gated_conv.grad_nchw = 0


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


class _GemmForward(torch.autograd.Function):
    """A 1x1 conv over NCHW-contiguous x with (out, in) weights w: forward
    as one batched GEMM, (out, in) @ (B, in, H*W); backward the conv's own.
    cuBLAS's input gradient at K = out is the slow half of a GEMM here (at
    the ConvHVAE's Config 4 heads on an H100, 0.149 ms against cuDNN's
    dgrad's 0.047)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        n, _, h, wd = x.shape
        y = torch.bmm(w.expand(n, -1, -1), x.flatten(2))
        return (y + b[:, None]).view(n, -1, h, wd)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.convolution_backward(
            dy, x, w[:, :, None, None], [w.shape[0]], [1, 1], [0, 0],
            [1, 1], False, [0, 0], 1, list(ctx.needs_input_grad))
        return gx, None if gw is None else gw.view(w.shape), gb


class GemmConv(Conv):
    """``Conv`` whose forward, with a gradient to carry over NCHW-contiguous
    fp32 input, is one batched GEMM (``_GemmForward``): the ConvHVAE's
    likelihood heads, whose fp32 training takes NCHW input. The GEMM sums
    each output's channels in one order on any number of CPU threads; the
    CPU's NCHW 1x1 conv splits that sum across threads, and the saturated
    logistic bins of the likelihood carry its last-bit differences into the
    gradients. Otherwise the conv, so that the no-gradient route keeps its
    bits. (The PixelHVAE keeps ``Conv``: its two routes are bitwise one.)"""

    def forward(self, x):
        if (x.dtype == torch.float32 and self.dtype is None
                and _nchw_contiguous(x)
                and carries_grad(x, self.kernel, self.bias)):
            return _GemmForward.apply(x, self.kernel[0, 0].t().contiguous(),
                                      self.bias)
        return super().forward(x)


class _GatedConvBase(nn.Module):
    """h * sigmoid(g) of one 2F-channel conv over separate value and gate
    params (HWIO kernels), no activation (the conv stacks use none).

    With no gradient to carry (grad mode off, or neither x nor a param
    requiring grad) and an fp32 compute dtype, the conv runs NCHW-contiguous
    without its bias (a transposed conv: its sub-pixel conv, no
    depth-to-space copy) and ``ops/gated_epilogue.py`` adds the biases, moves
    the phases to space and gates in one pass, in the unfused chain's order
    (the same bits from the same conv output). Otherwise ``gated_conv``:
    the conv with its bias, ``chunk``, sigmoid and product."""

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

    def _fused_route(self, x, dt) -> bool:
        return dt == torch.float32 and not carries_grad(x, *self.parameters())

    def forward(self, x):
        dt = self.dtype or self.h_kernel.dtype
        w = torch.cat([self.h_kernel.to(dt), self.g_kernel.to(dt)], dim=-1)
        if self._fused_route(x, dt):
            if not _nchw_contiguous(x):
                raise ValueError("the fused route takes NCHW-contiguous "
                                 f"input, got strides {x.stride()}")
            y, phases = self._raw_conv(x, w)
            return gated_epilogue(y, self.h_bias, self.g_bias, phases)
        b = torch.cat([self.h_bias.to(dt), self.g_bias.to(dt)])
        return gated_conv(self._conv, x.to(dt), w, b, self.strides)


class GatedConv2d(_GatedConvBase):
    """Gated convolution, SAME padding."""
    _conv = staticmethod(conv_same)

    def _raw_conv(self, x, w):
        return conv_same(x, w, None, self.strides), (1, 1)


class GatedConvTranspose2d(_GatedConvBase):
    """Gated transposed convolution, SAME padding (output = input * s)."""
    _conv = staticmethod(conv_transpose_same)

    def _raw_conv(self, x, w):
        return _subpixel_conv(x, w, self.strides), self.strides


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

    def forward(self, x, *, bias: bool = True):
        """The masked conv; with ``bias=False`` its raw sum, for a caller
        that adds the bias in an epilogue of its own."""
        dt = self.dtype or self.kernel.dtype
        return conv_same(x.to(dt), (self.kernel * self.mask).to(dt),
                         self.bias.to(dt) if bias else None, (1, 1))


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
