"""Single-stochastic-layer MLP VAE (counterpart of exemplar_vae_tpu/models/vae.py).

Encoder: flatten NHWC -> GatedDense(h) x2 -> (mu_z, logvar_z).
Decoder: GatedDense(h) x2 -> likelihood head(s), reshaped to NHWC.
Submodule and parameter names are the flax ones, so a flax param tree maps
onto ``state_dict`` one to one (weights.py).
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
    q_logvar_activation_for,
)


class VAE(PriorMixin, nn.Module):

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        dt = compute_dtype(cfg)
        g = generator
        self.q_layers_0 = GatedDense(cfg.input_dim, h, dtype=dt, generator=g)
        self.q_layers_1 = GatedDense(h, h, dtype=dt, generator=g)
        self.q_mean_head = Dense(h, cfg.z1_size, dtype=dt, generator=g)
        self.q_logvar_head = NonLinear(h, cfg.z1_size,
                                       q_logvar_activation_for(cfg),
                                       dtype=dt, generator=g)
        self.p_layers_0 = GatedDense(cfg.z1_size, h, dtype=dt, generator=g)
        self.p_layers_1 = GatedDense(h, h, dtype=dt, generator=g)
        self.p_mean_head = NonLinear(h, cfg.input_dim, torch.sigmoid,
                                     dtype=dt, generator=g)
        if cfg.input_type != "binary":
            self.p_logvar_head = NonLinear(h, cfg.input_dim,
                                           p_logvar_activation, dtype=dt,
                                           generator=g)
        self._setup_prior(generator)

    # --- inference net ---
    def encode_top(self, x):
        h = x.reshape(x.shape[0], -1)
        h = self.q_layers_1(self.q_layers_0(h))
        # distribution parameters are always fp32
        return (self.q_mean_head(h).to(torch.float32),
                self.q_logvar_head(h).to(torch.float32))

    def encode_top_mean(self, x):
        return self.encode_top(x)[0]

    @property
    def top_dim(self) -> int:
        """The width of z, the latent the prior scores."""
        return self.cfg.z1_size

    def draw_eps(self, b: int, generator=None, device=None):
        """The forward's reparameterization noise for ``b`` rows, (b, z1)."""
        return torch.randn((b, self.cfg.z1_size), generator=generator,
                           device=device)

    # --- generative net ---
    def decode(self, z):
        h = self.p_layers_1(self.p_layers_0(z))
        x_mean, x_logvar = likelihood_params(
            self.p_mean_head(h).to(torch.float32),
            lambda: self.p_logvar_head(h), self.cfg.input_type)
        c, hh, ww = self.cfg.input_size
        shape = (z.shape[0], hh, ww, c)
        return x_mean.reshape(shape), x_logvar.reshape(shape)

    def forward(self, x, *, eps=None, generator=None):
        q_mean, q_logvar = self.encode_top(x)
        z = reparameterize(q_mean, q_logvar, eps=eps, generator=generator)
        x_mean, x_logvar = self.decode(z)
        return ForwardOut(z, q_mean, q_logvar, x_mean, x_logvar,
                          torch.zeros(x.shape[0], dtype=torch.float32,
                                      device=x.device))

    def generate_from_top(self, z, *, eps=None, generator=None):
        """Decoder means of z; ``eps`` and ``generator`` are unused (the
        two-level models draw their lower latent from them)."""
        return self.decode(z)[0]
