"""Two-level hierarchical MLP VAE (counterpart of exemplar_vae_tpu/models/hvae.py).

Factorization:
  inference   q(z2 | x) q(z1 | x, z2)
  generative  p(z2) p(z1 | z2) p(x | z1, z2)
The standard / vamp / exemplar prior sits on z2, the top latent.

Noise: ``forward`` draws z2's noise, then z1's (the order of the JAX
model's ``split(key)`` into (k2, k1)); either comes injected as
``eps=(eps2, eps1)``. ``generate_from_top`` draws z1 from p(z1|z2), its
noise injected as ``eps`` or drawn from ``generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from exemplar_vae_tpu_torch.models.base import (ForwardOut, PriorMixin,
                                                likelihood_params,
                                                reparameterize)
from exemplar_vae_tpu_torch.models.layers import (
    Dense,
    GatedDense,
    NonLinear,
    compute_dtype,
    p_logvar_activation,
    q_logvar_activation,
    q_logvar_activation_for,
)
from exemplar_vae_tpu_torch.ops.distributions import log_normal_diag


class TwoLevelMLPCore:
    """The two-level machinery shared by HVAE, ConvHVAE and PixelHVAE:
    q(z1 | x, z2) from x-side features (``q_z1_cache``, the model's own) and
    z2, p(z1 | z2), the two-level forward and generation. Attribute names
    are the flax param-tree names."""

    def _setup_z1_nets(self, hx_dim: int, dt, g):
        """q(z1 | x, z2) over ``hx_dim`` x-side features, and p(z1 | z2)."""
        cfg = self.cfg
        h = cfg.hidden_size
        self.q_z1_z2 = GatedDense(cfg.z2_size, h, dtype=dt, generator=g)
        self.q_z1_joint = GatedDense(hx_dim + h, h, dtype=dt, generator=g)
        self.q_z1_mean_head = Dense(h, cfg.z1_size, dtype=dt, generator=g)
        self.q_z1_logvar_head = NonLinear(h, cfg.z1_size,
                                          q_logvar_activation_for(cfg),
                                          dtype=dt, generator=g)
        self.p_z1_layers_0 = GatedDense(cfg.z2_size, h, dtype=dt, generator=g)
        self.p_z1_layers_1 = GatedDense(h, h, dtype=dt, generator=g)
        self.p_z1_mean_head = Dense(h, cfg.z1_size, dtype=dt, generator=g)
        self.p_z1_logvar_head = NonLinear(h, cfg.z1_size, q_logvar_activation,
                                          dtype=dt, generator=g)

    def _setup_two_level_mlp(self, dt, g):
        """The MLP inference net: q(z2 | x), the x-side of q(z1 | x, z2)."""
        cfg = self.cfg
        h = cfg.hidden_size
        self.q_z2_layers_0 = GatedDense(cfg.input_dim, h, dtype=dt, generator=g)
        self.q_z2_layers_1 = GatedDense(h, h, dtype=dt, generator=g)
        self.q_z2_mean_head = Dense(h, cfg.z2_size, dtype=dt, generator=g)
        self.q_z2_logvar_head = NonLinear(h, cfg.z2_size,
                                          q_logvar_activation_for(cfg),
                                          dtype=dt, generator=g)
        self.q_z1_x = GatedDense(cfg.input_dim, h, dtype=dt, generator=g)
        self._setup_z1_nets(h, dt, g)

    # --- inference net ---
    def encode_top(self, x):
        h = x.reshape(x.shape[0], -1)
        h = self.q_z2_layers_1(self.q_z2_layers_0(h))
        return (self.q_z2_mean_head(h).to(torch.float32),
                self.q_z2_logvar_head(h).to(torch.float32))

    def encode_top_mean(self, x):
        return self.encode_top(x)[0]

    @property
    def top_dim(self) -> int:
        """The width of z2, the latent the prior scores."""
        return self.cfg.z2_size

    def draw_eps(self, b: int, generator=None, device=None):
        """The forward's reparameterization noise for ``b`` rows, the pair
        (eps2 (b, z2), eps1 (b, z1)), drawn in that order."""
        return tuple(torch.randn((b, n), generator=generator, device=device)
                     for n in (self.cfg.z2_size, self.cfg.z1_size))

    def q_z1_cache(self, x):
        """The x-only half of q(z1|x,z2): computed once per test point and
        reused across importance samples (the encode-once IWAE)."""
        return self.q_z1_x(x.reshape(x.shape[0], -1))

    def q_z1_from_cache(self, hx, z2):
        hz = self.q_z1_z2(z2)
        h = self.q_z1_joint(torch.cat([hx.to(hz.dtype), hz], dim=-1))
        return (self.q_z1_mean_head(h).to(torch.float32),
                self.q_z1_logvar_head(h).to(torch.float32))

    def q_z1(self, x, z2):
        return self.q_z1_from_cache(self.q_z1_cache(x), z2)

    # --- generative net ---
    def p_z1(self, z2):
        h = self.p_z1_layers_1(self.p_z1_layers_0(z2))
        return (self.p_z1_mean_head(h).to(torch.float32),
                self.p_z1_logvar_head(h).to(torch.float32))

    def forward(self, x, *, eps=None, generator=None):
        """``eps``: None or the pair (eps2 (B, z2), eps1 (B, z1))."""
        eps2, eps1 = (None, None) if eps is None else eps
        q2_mean, q2_logvar = self.encode_top(x)
        z2 = reparameterize(q2_mean, q2_logvar, eps=eps2, generator=generator)
        q1_mean, q1_logvar = self.q_z1(x, z2)
        z1 = reparameterize(q1_mean, q1_logvar, eps=eps1, generator=generator)
        p1_mean, p1_logvar = self.p_z1(z2)
        # sampled lower-level KL: E_q[log q(z1|x,z2) - log p(z1|z2)]
        extra_kl = (log_normal_diag(z1, q1_mean, q1_logvar)
                    - log_normal_diag(z1, p1_mean, p1_logvar))
        x_mean, x_logvar = self.decode_x(x, z1, z2)
        return ForwardOut(z2, q2_mean, q2_logvar, x_mean, x_logvar, extra_kl)

    def decode_x(self, x, z1, z2):
        """The likelihood params of the observed x given (z1, z2): the
        decoder's, which reads x only in the PixelHVAE (teacher forcing)."""
        return self.decode(z1, z2)

    def generate_from_top(self, z2, *, eps=None, generator=None):
        """Decoder means of z2 with z1 ~ p(z1 | z2); ``eps`` (B, z1)."""
        p1_mean, p1_logvar = self.p_z1(z2)
        z1 = reparameterize(p1_mean, p1_logvar, eps=eps, generator=generator)
        return self.decode(z1, z2)[0]


class HVAE(TwoLevelMLPCore, PriorMixin, nn.Module):

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        dt = compute_dtype(cfg)
        g = generator
        self._setup_two_level_mlp(dt, g)
        # p(x | z1, z2)
        self.p_x_z1 = GatedDense(cfg.z1_size, h, dtype=dt, generator=g)
        self.p_x_z2 = GatedDense(cfg.z2_size, h, dtype=dt, generator=g)
        self.p_x_joint = GatedDense(2 * h, h, dtype=dt, generator=g)
        self.p_x_mean_head = NonLinear(h, cfg.input_dim, torch.sigmoid,
                                       dtype=dt, generator=g)
        if cfg.input_type != "binary":
            self.p_x_logvar_head = NonLinear(h, cfg.input_dim,
                                             p_logvar_activation, dtype=dt,
                                             generator=g)
        self._setup_prior(generator)

    def decode(self, z1, z2):
        h = self.p_x_joint(torch.cat([self.p_x_z1(z1), self.p_x_z2(z2)],
                                     dim=-1))
        x_mean, x_logvar = likelihood_params(
            self.p_x_mean_head(h).to(torch.float32),
            lambda: self.p_x_logvar_head(h), self.cfg.input_type)
        c, hh, ww = self.cfg.input_size
        shape = (z1.shape[0], hh, ww, c)
        return x_mean.reshape(shape), x_logvar.reshape(shape)
