"""Plain reference of the MLP VAE with the exact exemplar prior (the
``vae`` family): tools/torch_twin.py's ``TorchTwin`` math, frozen here.

Encoder: flatten -> gated dense (h) x 2 -> mean head, log-variance head
clamped to [q_logvar_min, 2]. Decoder: gated dense (h) x 2 -> sigmoid
Bernoulli probabilities. Training: the whole bank re-encoded with
gradients every step, the leave-one-out mask, the denominator N - 1;
AdamNormGrad. Evaluation: the bank encoded once, no mask, denominator N.
"""

from __future__ import annotations

import torch

from portbench.reference.common import (Family, exact_log_prior,
                                        log_bernoulli, log_normal, preprocess,
                                        rows_of)


def _dense(spec, name, d_in, d_out, init):
    spec[f"{name}/kernel"] = ((d_in, d_out), init)
    spec[f"{name}/bias"] = ((d_out,), "bias")


def _gated(spec, name, d_in, d_out):
    for part in ("h", "g"):
        spec[f"{name}/{part}_kernel"] = ((d_in, d_out), "he")
    for part in ("h", "g"):
        spec[f"{name}/{part}_bias"] = ((d_out,), "bias")


def input_dim(cfg) -> int:
    c, h, w = cfg["input_size"]
    return c * h * w


def param_spec(cfg: dict) -> dict:
    """Every leaf of the VAE in the flax layout, with its initializer."""
    h, z, x = cfg["hidden_size"], cfg["z1_size"], input_dim(cfg)
    spec = {}
    _gated(spec, "q_layers_0", x, h)
    _gated(spec, "q_layers_1", h, h)
    _dense(spec, "q_mean_head", h, z, "lecun")
    _dense(spec, "q_logvar_head/Dense_0", h, z, "he")
    _gated(spec, "p_layers_0", z, h)
    _gated(spec, "p_layers_1", h, h)
    _dense(spec, "p_mean_head/Dense_0", h, x, "he")
    if cfg["input_type"] != "binary":
        raise ValueError("the vae reference covers binary data only")
    spec["prior_log_var"] = ((), "zero")
    return spec


def eps_widths(cfg: dict) -> tuple:
    """The widths of the reparameterization noise, in the draw order."""
    return (cfg["z1_size"],)


class Reference(Family):

    def encode(self, x2d):
        h = self.gated(self.gated(x2d, "q_layers_0"), "q_layers_1")
        return (self.dense(h, "q_mean_head"),
                self.q_logvar(h, "q_logvar_head/Dense_0"))

    def encode_mean(self, x):
        h = self.gated(self.gated(x.reshape(x.shape[0], -1), "q_layers_0"),
                       "q_layers_1")
        return self.dense(h, "q_mean_head")

    def decode_probs(self, z):
        h = self.gated(self.gated(z, "p_layers_0"), "p_layers_1")
        return torch.sigmoid(self.dense(h, "p_mean_head/Dense_0"))

    def batch_loss(self, x_raw, u, eps, data_idx, bank, beta):
        cfg = self.cfg
        b = x_raw.shape[0]
        x2d = preprocess(x_raw, cfg["input_type"], u).reshape(b, -1)
        mean, logvar = self.encode(x2d)
        z = mean + torch.exp(0.5 * logvar) * eps[0]
        re = log_bernoulli(x2d, self.decode_probs(z))
        log_q = log_normal(z, mean, logvar)
        means = self.encode_mean(preprocess(bank["images"], cfg["input_type"]))
        log_p = exact_log_prior(z, means, self.prior_log_var(),
                                self.exemplar_denominator(bank, True),
                                data_idx=data_idx, bank_idx=bank["idx"])
        return torch.mean(-re + beta * (log_q - log_p))

    def encode_once(self, x2d):
        return self.encode(x2d)

    def iwae_log_weights(self, x2d, enc, eps, lo, r, bank_means, log_denom,
                         block):
        n = eps[0].shape[0]
        mean, logvar = (rows_of(a, lo, n, r) for a in enc)
        z = mean + torch.exp(0.5 * logvar) * eps[0]
        re = log_bernoulli(rows_of(x2d, lo, n, r), self.decode_probs(z))
        log_q = log_normal(z, mean, logvar)
        log_p = exact_log_prior(z, bank_means, self.prior_log_var(),
                                log_denom, block=block)
        return re - (log_q - log_p)
