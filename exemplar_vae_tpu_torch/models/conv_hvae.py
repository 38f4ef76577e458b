"""Two-level convolutional hierarchical VAE (counterpart of
exemplar_vae_tpu/models/conv_hvae.py).

The HVAE's factorization with gated-conv encoder stacks for q(z2|x) and the
x-side of q(z1|x,z2), and a decoder dense -> (H/s, W/s, conv_proj_channels)
-> gated transposed convs -> 1x1 likelihood heads. The stacks come from
cfg.conv_enc_spec / cfg.conv_dec_spec (config.parse_conv_spec); the default
is enc GC(32,7,s1) GC(32,3,s2) GC(64,5,s1) GC(64,3,s2), dec GCT(64,3,s2)
GCT(32,3,s2) GC(32,3,s1).

Data is NHWC at the model's boundary, as in the JAX package. The convs run
on NCHW tensors in the memory format of cuDNN's conv kernels for the
compute dtype, chosen once at that boundary (``layers.nchw_for``, the
PixelHVAE's rule too), on every route: NCHW-contiguous in fp32, so that the
convs, their weight and input gradients and the gate's ``chunk`` halves
transpose nothing; the channels-last view in bf16, whose tensor-core kernels
are NHWC. The dense heads read the conv features in NHWC flatten order.
Requires H and W divisible by the encoder's total downsampling, which must
equal the decoder's upsampling.
Submodules carry the flax names (``q_z2_conv_0``, ``p_x_deconv_2``).
"""

from __future__ import annotations

from fractions import Fraction

import torch
from torch import nn

from exemplar_vae_tpu_torch.config import parse_conv_spec
from exemplar_vae_tpu_torch.models.base import PriorMixin, likelihood_params
from exemplar_vae_tpu_torch.models.hvae import TwoLevelMLPCore
from exemplar_vae_tpu_torch.models.layers import (
    Dense,
    GatedConv2d,
    GatedConvTranspose2d,
    GatedDense,
    GemmConv,
    NonLinear,
    compute_dtype,
    nchw_for,
    p_logvar_activation,
    q_logvar_activation_for,
)


def _build_stack(module, prefix: str, spec: str, c_in: int, dt, g):
    """Declare ``{prefix}_{i}`` gated (transposed) convs of ``spec`` on
    ``module``; returns them in order and the last layer's channels."""
    layers = []
    for i, (kind, feat, k, s) in enumerate(parse_conv_spec(spec)):
        cls = GatedConvTranspose2d if kind == "t" else GatedConv2d
        layer = cls(c_in, feat, (k, k), (s, s), dtype=dt, generator=g)
        setattr(module, f"{prefix}_{i}", layer)
        layers.append(layer)
        c_in = feat
    return tuple(layers), c_in


def _net_scale(spec: str) -> Fraction:
    """Net spatial scale of a stack: a stride-s conv divides H, W by s, a
    stride-s transposed conv multiplies them by s (SAME padding); both kinds
    count, so a strided conv inside a decoder fails the setup check."""
    scale = Fraction(1)
    for kind, _, _, s in parse_conv_spec(spec):
        scale = scale * s if kind == "t" else scale / s
    return scale


def _run(layers, h):
    for layer in layers:
        h = layer(h)
    return h


def _flat_nhwc(h):
    """NCHW features -> (B, H*W*C) in flax's NHWC flatten order."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class ConvHVAE(TwoLevelMLPCore, PriorMixin, nn.Module):

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        dt = compute_dtype(cfg)
        g = generator
        c_in, ih, iw = cfg.input_size
        enc_scale = _net_scale(cfg.conv_enc_spec)
        dec_scale = _net_scale(cfg.conv_dec_spec)
        if enc_scale.numerator != 1:
            raise ValueError(
                f"encoder spec must be net-downsampling, got scale "
                f"{enc_scale} (conv_enc_spec={cfg.conv_enc_spec!r})")
        down = enc_scale.denominator
        if dec_scale != down:
            raise ValueError(
                f"encoder downsampling x{down} != decoder net upsampling "
                f"x{dec_scale} (conv_enc_spec={cfg.conv_enc_spec!r}, "
                f"conv_dec_spec={cfg.conv_dec_spec!r})")
        if ih % down or iw % down:
            raise ValueError(f"ConvHVAE needs H, W divisible by {down}, got "
                             f"{ih}x{iw}")
        self._dec_hw = (ih // down, iw // down)
        # q(z2 | x)
        self._q_z2_conv, c_enc = _build_stack(self, "q_z2_conv",
                                              cfg.conv_enc_spec, c_in, dt, g)
        enc_dim = self._dec_hw[0] * self._dec_hw[1] * c_enc
        self.q_z2_mean_head = Dense(enc_dim, cfg.z2_size, dtype=dt, generator=g)
        self.q_z2_logvar_head = NonLinear(enc_dim, cfg.z2_size,
                                          q_logvar_activation_for(cfg),
                                          dtype=dt, generator=g)
        # q(z1 | x, z2) and p(z1 | z2)
        self._q_z1_conv, _ = _build_stack(self, "q_z1_conv", cfg.conv_enc_spec,
                                          c_in, dt, g)
        self._setup_z1_nets(enc_dim, dt, g)
        # p(x | z1, z2)
        self.p_x_z1 = GatedDense(cfg.z1_size, h, dtype=dt, generator=g)
        self.p_x_z2 = GatedDense(cfg.z2_size, h, dtype=dt, generator=g)
        dh, dw = self._dec_hw
        self.p_x_project = Dense(2 * h, dh * dw * cfg.conv_proj_channels,
                                 dtype=dt, generator=g)
        self._p_x_deconv, c_dec = _build_stack(
            self, "p_x_deconv", cfg.conv_dec_spec, cfg.conv_proj_channels, dt, g)
        self.p_x_mean_head = GemmConv(c_dec, c_in, dtype=dt, generator=g)
        if cfg.input_type != "binary":
            self.p_x_logvar_head = GemmConv(c_dec, c_in, dtype=dt,
                                            generator=g)
        self._setup_prior(generator)

    # --- inference net ---
    def encode_top(self, x):
        h = _flat_nhwc(_run(self._q_z2_conv, nchw_for(x, self.cfg)))
        return (self.q_z2_mean_head(h).to(torch.float32),
                self.q_z2_logvar_head(h).to(torch.float32))

    def q_z1_cache(self, x):
        """The x-only conv features of q(z1|x,z2): in the encode-once IWAE
        the whole q_z1 conv stack stays out of the importance-sample loop."""
        return _flat_nhwc(_run(self._q_z1_conv, nchw_for(x, self.cfg)))

    # --- generative net ---
    def decode(self, z1, z2):
        h = self.p_x_project(torch.cat([self.p_x_z1(z1), self.p_x_z2(z2)],
                                       dim=-1))
        dh, dw = self._dec_hw
        h = _run(self._p_x_deconv, nchw_for(
            h.reshape(h.shape[0], dh, dw, self.cfg.conv_proj_channels),
            self.cfg))
        x_mean, x_logvar = likelihood_params(
            torch.sigmoid(self.p_x_mean_head(h)).to(torch.float32),
            lambda: p_logvar_activation(self.p_x_logvar_head(h)),
            self.cfg.input_type)
        # NCHW -> NHWC, a view (NHWC-contiguous in bf16)
        return x_mean.permute(0, 2, 3, 1), x_logvar.permute(0, 2, 3, 1)
