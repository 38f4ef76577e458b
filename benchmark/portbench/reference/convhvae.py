"""Plain reference of the two-level ConvHVAE with the approximate (kNN)
exemplar prior (the ``convhvae`` family): tools/torch_twin.py's
``TorchTwinConvHVAE`` math, frozen here, its conv spec parsed by the
benchmark itself.

q(z2|x): gated conv stack -> dense mean and clamped log-variance heads;
q(z1|x,z2): a second conv stack on x, gated dense on z2, a joint gated
dense, heads; p(z1|z2): gated dense x 2, heads; p(x|z1,z2): gated dense on
each, a dense projection to (H/4, W/4, proj), gated transposed convs
(flax SAME: the input dilated by the stride, padded by lax's rule, a
stride-1 correlation), 1x1 heads: a sigmoid mean clipped to
[1/512, 1 - 1/512] and a log-variance clamped to [-4.5, 0] for the
logistic-256 likelihood. Training: k nearest rows of a cache of the bank's
means (encoded once with the starting weights, no gradient), those rows
re-encoded with gradients, a per-row mixture with the leave-one-out mask
and the denominator N - 1; AdamNormGrad. Evaluation: the exact prior over
the whole bank, encoded once.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from portbench.reference.common import (P_LOGVAR_RANGE, Family,
                                        exact_log_prior, log_bernoulli,
                                        log_logistic_256, log_normal,
                                        preprocess, rows_log_prior, rows_of)
from portbench.reference.vae import _dense, _gated


def parse_conv_spec(spec: str):
    """"32k7s1,t64k3s2" -> (("c", 32, 7, 1), ("t", 64, 3, 2))."""
    out = []
    for part in spec.split(","):
        m = re.fullmatch(r"([tc]?)(\d+)k(\d+)s(\d+)", part.strip())
        if not m:
            raise ValueError(f"bad conv-spec layer {part!r}")
        out.append((m.group(1) or "c", int(m.group(2)), int(m.group(3)),
                    int(m.group(4))))
    return tuple(out)


def geometry(cfg: dict):
    """(enc layers, dec layers, downsampling, enc feature width)."""
    enc = parse_conv_spec(cfg["conv_enc_spec"])
    dec = parse_conv_spec(cfg["conv_dec_spec"])
    down = 1
    for _, _, _, s in enc:
        down *= s
    _, h, w = cfg["input_size"]
    return enc, dec, down, (h // down) * (w // down) * enc[-1][1]


def _gated_conv(spec, name, k, c_in, c_out):
    for part in ("h", "g"):
        spec[f"{name}/{part}_kernel"] = ((k, k, c_in, c_out), "he")
    for part in ("h", "g"):
        spec[f"{name}/{part}_bias"] = ((c_out,), "bias")


def param_spec(cfg: dict) -> dict:
    """Every leaf of the ConvHVAE in the flax layout, with its
    initializer."""
    h, z1, z2 = cfg["hidden_size"], cfg["z1_size"], cfg["z2_size"]
    c_in = cfg["input_size"][0]
    enc, dec, down, enc_dim = geometry(cfg)
    _, ih, iw = cfg["input_size"]
    spec = {}
    for stack in ("q_z2_conv", "q_z1_conv"):
        c = c_in
        for i, (_, f, k, _) in enumerate(enc):
            _gated_conv(spec, f"{stack}_{i}", k, c, f)
            c = f
        if stack == "q_z2_conv":
            _dense(spec, "q_z2_mean_head", enc_dim, z2, "lecun")
            _dense(spec, "q_z2_logvar_head/Dense_0", enc_dim, z2, "he")
    _gated(spec, "q_z1_z2", z2, h)
    _gated(spec, "q_z1_joint", enc_dim + h, h)
    _dense(spec, "q_z1_mean_head", h, z1, "lecun")
    _dense(spec, "q_z1_logvar_head/Dense_0", h, z1, "he")
    _gated(spec, "p_z1_layers_0", z2, h)
    _gated(spec, "p_z1_layers_1", h, h)
    _dense(spec, "p_z1_mean_head", h, z1, "lecun")
    _dense(spec, "p_z1_logvar_head/Dense_0", h, z1, "he")
    _gated(spec, "p_x_z1", z1, h)
    _gated(spec, "p_x_z2", z2, h)
    proj = cfg["conv_proj_channels"]
    _dense(spec, "p_x_project", 2 * h, (ih // down) * (iw // down) * proj,
           "lecun")
    c = proj
    for i, (_, f, k, _) in enumerate(dec):
        _gated_conv(spec, f"p_x_deconv_{i}", k, c, f)
        c = f
    heads = ("p_x_mean_head",) if cfg["input_type"] == "binary" else (
        "p_x_mean_head", "p_x_logvar_head")
    for name in heads:
        spec[f"{name}/kernel"] = ((1, 1, c, c_in), "lecun")
        spec[f"{name}/bias"] = ((c_in,), "bias")
    spec["prior_log_var"] = ((), "zero")
    return spec


def eps_widths(cfg: dict) -> tuple:
    """The widths of the reparameterization noise, in the draw order (z2's,
    then z1's)."""
    return (cfg["z2_size"], cfg["z1_size"])


class Reference(Family):

    def __init__(self, cfg: dict, params: dict):
        super().__init__(cfg, params)
        self.enc, self.dec, self.down, _ = geometry(cfg)
        self.c, self.h, self.w = cfg["input_size"]

    # --- conv primitives (flax SAME semantics, HWIO kernels) ---
    def _conv(self, x, w, b, stride):
        k = w.shape[0]

        def pads(n):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            return total // 2, total - total // 2
        (t, bo), (le, ri) = pads(x.shape[2]), pads(x.shape[3])
        x = F.pad(x, (le, ri, t, bo))
        return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride)

    def _conv_t(self, x, w, b, stride):
        k = w.shape[0]
        if stride > 1:
            n, c, hh, ww = x.shape
            d = x.new_zeros(n, c, (hh - 1) * stride + 1, (ww - 1) * stride + 1)
            d[:, :, ::stride, ::stride] = x
            x = d
        pad_len = k + stride - 2
        pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
        pad_b = pad_len - pad_a
        x = F.pad(x, (pad_a, pad_b, pad_a, pad_b))
        return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=1)

    def _gated_conv(self, x, name, stride, transposed):
        w = torch.cat([self.p[f"{name}/h_kernel"], self.p[f"{name}/g_kernel"]],
                      dim=3)
        b = torch.cat([self.p[f"{name}/h_bias"], self.p[f"{name}/g_bias"]])
        hg = (self._conv_t if transposed else self._conv)(x, w, b, stride)
        h, g = hg.chunk(2, dim=1)
        return h * torch.sigmoid(g)

    def _nchw_flat(self, x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def conv_stack(self, x2d, prefix):
        x = x2d.reshape(-1, self.h, self.w, self.c).permute(0, 3, 1, 2)
        for i, (_, _, _, s) in enumerate(self.enc):
            x = self._gated_conv(x, f"{prefix}_{i}", s, False)
        return self._nchw_flat(x)

    # --- inference and generative nets ---
    def encode(self, x2d):
        h = self.conv_stack(x2d, "q_z2_conv")
        return (self.dense(h, "q_z2_mean_head"),
                self.q_logvar(h, "q_z2_logvar_head/Dense_0"))

    def encode_mean(self, x):
        h = self.conv_stack(x.reshape(x.shape[0], -1), "q_z2_conv")
        return self.dense(h, "q_z2_mean_head")

    def q_z1(self, hx, z2):
        h = self.gated(torch.cat([hx, self.gated(z2, "q_z1_z2")], -1),
                       "q_z1_joint")
        return (self.dense(h, "q_z1_mean_head"),
                self.q_logvar(h, "q_z1_logvar_head/Dense_0"))

    def p_z1(self, z2):
        h = self.gated(self.gated(z2, "p_z1_layers_0"), "p_z1_layers_1")
        return (self.dense(h, "p_z1_mean_head"),
                torch.clamp(self.dense(h, "p_z1_logvar_head/Dense_0"), -6.0,
                            2.0))

    def log_lik(self, x2d, z1, z2):
        h = self.dense(torch.cat([self.gated(z1, "p_x_z1"),
                                  self.gated(z2, "p_x_z2")], -1),
                       "p_x_project")
        dh, dw = self.h // self.down, self.w // self.down
        h = h.reshape(-1, dh, dw, self.cfg["conv_proj_channels"]).permute(
            0, 3, 1, 2)
        for i, (kind, _, _, s) in enumerate(self.dec):
            h = self._gated_conv(h, f"p_x_deconv_{i}", s, kind == "t")
        mean = torch.sigmoid(self._conv(h, self.p["p_x_mean_head/kernel"],
                                        self.p["p_x_mean_head/bias"], 1))
        if self.cfg["input_type"] == "binary":
            return log_bernoulli(x2d, self._nchw_flat(mean))
        mean = torch.clamp(mean, 1.0 / 512.0, 1.0 - 1.0 / 512.0)
        logvar = torch.clamp(self._conv(h, self.p["p_x_logvar_head/kernel"],
                                        self.p["p_x_logvar_head/bias"], 1),
                             *P_LOGVAR_RANGE)
        return log_logistic_256(x2d, self._nchw_flat(mean),
                                self._nchw_flat(logvar))

    # --- the approximate prior ---
    def refresh_cache(self, images, block: int):
        """The cache of the bank's means, encoded with the current weights
        (the program's per-epoch refresh)."""
        self.cache = self.bank_means(images, block)

    def knn(self, q_mean, k: int):
        """(B, k) nearest cache rows, nearest first, ties to the lowest
        index."""
        q = q_mean.detach()
        d = torch.clamp(torch.sum(q * q, -1, keepdim=True)
                        + torch.sum(self.cache * self.cache, -1)[None, :]
                        - 2.0 * (q @ self.cache.T), min=0.0)
        return torch.sort(d, dim=1, stable=True).indices[:, :k]

    def batch_loss(self, x_raw, u, eps, data_idx, bank, beta):
        cfg = self.cfg
        b = x_raw.shape[0]
        x2d = preprocess(x_raw, cfg["input_type"], u).reshape(b, -1)
        eps2, eps1 = eps
        q2_mean, q2_logvar = self.encode(x2d)
        z2 = q2_mean + torch.exp(0.5 * q2_logvar) * eps2
        q1_mean, q1_logvar = self.q_z1(self.conv_stack(x2d, "q_z1_conv"), z2)
        z1 = q1_mean + torch.exp(0.5 * q1_logvar) * eps1
        p1_mean, p1_logvar = self.p_z1(z2)
        extra_kl = (log_normal(z1, q1_mean, q1_logvar)
                    - log_normal(z1, p1_mean, p1_logvar))
        re_ = self.log_lik(x2d, z1, z2)
        log_q = log_normal(z2, q2_mean, q2_logvar)
        idx = self.knn(q2_mean, cfg["approximate_k"])           # (B, K)
        sel = bank["images"][idx.reshape(-1)]
        means = self.encode_mean(preprocess(sel, cfg["input_type"]))
        log_p = rows_log_prior(
            z2, means.reshape(idx.shape + (means.shape[-1],)),
            self.prior_log_var(), self.exemplar_denominator(bank, True),
            bank["idx"][idx] == data_idx[:, None])
        kl = log_q - log_p + extra_kl
        return torch.mean(-re_ + beta * kl)

    # --- evaluation ---
    def encode_once(self, x2d):
        mean, logvar = self.encode(x2d)
        return mean, logvar, self.conv_stack(x2d, "q_z1_conv")

    def iwae_log_weights(self, x2d, enc, eps, lo, r, bank_means, log_denom,
                         block):
        n = eps[0].shape[0]
        mean, logvar, hx = (rows_of(a, lo, n, r) for a in enc)
        eps2, eps1 = eps
        z2 = mean + torch.exp(0.5 * logvar) * eps2
        q1_mean, q1_logvar = self.q_z1(hx, z2)
        z1 = q1_mean + torch.exp(0.5 * q1_logvar) * eps1
        p1_mean, p1_logvar = self.p_z1(z2)
        extra_kl = (log_normal(z1, q1_mean, q1_logvar)
                    - log_normal(z1, p1_mean, p1_logvar))
        re_ = self.log_lik(rows_of(x2d, lo, n, r), z1, z2)
        log_q = log_normal(z2, mean, logvar)
        log_p = exact_log_prior(z2, bank_means, self.prior_log_var(),
                                log_denom, block=block)
        return re_ - (log_q - log_p + extra_kl)
