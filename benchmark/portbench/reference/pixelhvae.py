"""Plain reference of the two-level hierarchical VAE with a PixelCNN decoder
and the exact exemplar prior (the ``pixelhvae`` family):
tools/torch_twin.py's ``TorchTwinPixelHVAE`` math and the ``TorchTwinHVAE``
math it inherits, frozen here, its causal masks built by the benchmark
itself. Binary data only.

q(z2|x): gated dense (h) x 2 on the flattened image -> dense mean and
clamped log-variance heads; q(z1|x,z2): gated dense on x and on z2, a joint
gated dense, heads; p(z1|z2): gated dense x 2, heads (log-variance in [-6,
2]); p(x|z1,z2) = prod_i p(x_i | x_<i, z1, z2), teacher-forced: a dense
context map ctx_proj(z1 || z2) reshaped to (H, W, F) in NHWC order, a 5x5
masked conv of type 'A' over x, then masked 3x3 convs of type 'B', each
fed the ReLU of the layer before; the context map is added to the output
of every masked layer; a 1x1 head on the last ReLU gives the Bernoulli
means (a sigmoid). Masks are spatial (every input channel of a tap alike):
'A' drops the centre tap and every tap after it in raster order, 'B' keeps
the centre. Convs are stride-1 SAME (odd kernels, k // 2 on each side).
Evaluation: the exact prior over the whole bank, encoded once.

No cell trains this family, so ``batch_loss`` (the training half of the
``Family`` interface) is not given and raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (Family, exact_log_prior,
                                        log_bernoulli, log_normal, rows_of)
from portbench.reference.vae import _dense, _gated, input_dim

IN_KERNEL, STACK_KERNEL = 5, 3


def causal_mask(k: int, kind: str) -> torch.Tensor:
    """(k, k) taps of a masked conv of ``kind`` 'A' or 'B'."""
    mask = torch.ones(k, k)
    c = k // 2
    mask[c, c + (1 if kind == "B" else 0):] = 0.0
    mask[c + 1:] = 0.0
    return mask


def masked_layers(cfg: dict) -> list:
    """[(name, kind, kernel size)] of the stack, input layer first."""
    return [("pix_in", "A", IN_KERNEL)] + [
        (f"pix_layers_{i}", "B", STACK_KERNEL)
        for i in range(cfg["pixelcnn_layers"])]


def param_spec(cfg: dict) -> dict:
    """Every leaf of the PixelHVAE in the flax layout, with its
    initializer."""
    if cfg["input_type"] != "binary":
        raise ValueError("the pixelhvae reference covers binary data only")
    h, z1, z2 = cfg["hidden_size"], cfg["z1_size"], cfg["z2_size"]
    x = input_dim(cfg)
    c_in, ih, iw = cfg["input_size"]
    pf = cfg["pixelcnn_features"]
    spec = {}
    _gated(spec, "q_z2_layers_0", x, h)
    _gated(spec, "q_z2_layers_1", h, h)
    _dense(spec, "q_z2_mean_head", h, z2, "lecun")
    _dense(spec, "q_z2_logvar_head/Dense_0", h, z2, "he")
    _gated(spec, "q_z1_x", x, h)
    _gated(spec, "q_z1_z2", z2, h)
    _gated(spec, "q_z1_joint", 2 * h, h)
    _dense(spec, "q_z1_mean_head", h, z1, "lecun")
    _dense(spec, "q_z1_logvar_head/Dense_0", h, z1, "he")
    _gated(spec, "p_z1_layers_0", z2, h)
    _gated(spec, "p_z1_layers_1", h, h)
    _dense(spec, "p_z1_mean_head", h, z1, "lecun")
    _dense(spec, "p_z1_logvar_head/Dense_0", h, z1, "he")
    _dense(spec, "ctx_proj", z1 + z2, ih * iw * pf, "lecun")
    c = c_in
    for name, _, k in masked_layers(cfg):
        spec[f"{name}/kernel"] = ((k, k, c, pf), "he")
        spec[f"{name}/bias"] = ((pf,), "bias")
        c = pf
    spec["p_x_mean_head/kernel"] = ((1, 1, pf, c_in), "lecun")
    spec["p_x_mean_head/bias"] = ((c_in,), "bias")
    spec["prior_log_var"] = ((), "zero")
    return spec


def eps_widths(cfg: dict) -> tuple:
    """The widths of the reparameterization noise, in the draw order (z2's,
    then z1's)."""
    return (cfg["z2_size"], cfg["z1_size"])


class Reference(Family):

    def __init__(self, cfg: dict, params: dict):
        super().__init__(cfg, params)
        self.c, self.h, self.w = cfg["input_size"]
        self.pf = cfg["pixelcnn_features"]

    # --- inference and generative nets ---
    def encode(self, x2d):
        h = self.gated(self.gated(x2d, "q_z2_layers_0"), "q_z2_layers_1")
        return (self.dense(h, "q_z2_mean_head"),
                self.q_logvar(h, "q_z2_logvar_head/Dense_0"))

    def encode_mean(self, x):
        return self.encode(x.reshape(x.shape[0], -1))[0]

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

    # --- the PixelCNN decoder ---
    def masked_conv(self, x, name, kind):
        """Stride-1 SAME conv of NCHW ``x`` with the HWIO kernel ``name``
        under the causal mask of ``kind``."""
        w = self.p[f"{name}/kernel"]
        k = w.shape[0]
        mask = causal_mask(k, kind).to(w.device)[:, :, None, None]
        return F.conv2d(x, (w * mask).permute(3, 2, 0, 1),
                        self.p[f"{name}/bias"], padding=k // 2)

    def masked_layer(self, h, ctx, name, kind):
        """One masked layer of the stack: its conv, the context added."""
        return self.masked_conv(h, name, kind) + ctx

    def context(self, z1, z2):
        """The context map, NCHW, from its NHWC-ordered projection."""
        ctx = self.dense(torch.cat([z1, z2], -1), "ctx_proj")
        return ctx.reshape(-1, self.h, self.w, self.pf).permute(0, 3, 1, 2)

    def bernoulli_means(self, x2d, z1, z2):
        """(n, H*W*C) teacher-forced Bernoulli means in NHWC order: one
        masked pass over the observed pixels."""
        ctx = self.context(z1, z2)
        h = x2d.reshape(-1, self.h, self.w, self.c).permute(0, 3, 1, 2)
        for i, (name, kind, _) in enumerate(masked_layers(self.cfg)):
            h = self.masked_layer(h if i == 0 else torch.relu(h), ctx, name,
                                  kind)
        head = self.p["p_x_mean_head/kernel"]
        mean = torch.sigmoid(F.conv2d(torch.relu(h), head.permute(3, 2, 0, 1),
                                      self.p["p_x_mean_head/bias"]))
        return mean.permute(0, 2, 3, 1).reshape(mean.shape[0], -1)

    # --- training: no cell trains this family ---
    def batch_loss(self, x_raw, u, eps, data_idx, bank, beta):
        raise NotImplementedError(
            "the pixelhvae reference gives the IWAE only: no cell trains "
            "this family")

    # --- evaluation ---
    def encode_once(self, x2d):
        mean, logvar = self.encode(x2d)
        return mean, logvar, self.gated(x2d, "q_z1_x")

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
        x_rows = rows_of(x2d, lo, n, r)
        re_ = log_bernoulli(x_rows, self.bernoulli_means(x_rows, z1, z2))
        log_q = log_normal(z2, mean, logvar)
        log_p = exact_log_prior(z2, bank_means, self.prior_log_var(),
                                log_denom, block=block)
        return re_ - (log_q - log_p + extra_kl)
