"""Two-level hierarchical VAE with a PixelCNN decoder (counterpart of
exemplar_vae_tpu/models/pixel_hvae.py).

The HVAE's inference nets and p(z1 | z2) (``TwoLevelMLPCore``, the same
param names), and an autoregressive likelihood over pixels in raster order:

    p(x | z1, z2) = prod_i p(x_i | x_<i, z1, z2)

Training and evaluation are teacher-forced: one pass of the masked stack
over the observed x, the masks enforcing causality (``decode(x, z1, z2)``).
The latents enter as a context map ``ctx_proj(z1 || z2)`` reshaped to (H, W,
F) in flax's NHWC order, added to the input of every masked layer. The
stack runs in the memory format of cuDNN's conv kernels for the compute
dtype, so that cuDNN transposes nothing: in fp32 NCHW-contiguous (x
reshaped when C is 1, else copied; ``ctx_proj``'s GEMM writes the context
NCHW, its kernel's columns and bias permuted into (F, H, W) order, so that
each value is the same dot product), in bf16 channels-last (x's permuted
view, the context a permuted view of the NHWC-ordered projection). The
likelihood params come back NHWC. Under a profiler the teacher-forced
decode opens ``evae.pixelcnn.context`` (the context map) and
``evae.pixelcnn.stack`` (the masked stack and heads); ``masked_stack.rows``
counts the rows that its stack calls decode.

The teacher-forced stack takes one of two routes. With a gradient to carry
(grad mode on and x, z or a parameter requiring grad), or in bf16, each
masked layer is the conv with its bias, the context added in place and a
ReLU. Otherwise (scoring, validation, the naive sampler) each masked conv
runs without its bias, followed by one in-place pass of relu((conv + bias)
+ ctx) (``ops/masked_epilogue.py``; a CUDA kernel on the card), the other
route's three passes in their order. ``masked_epilogue.launches`` counts
1 + pixelcnn_layers a call of that route.

Generation is sequential over the H*W pixels. ``generate_from_top`` decodes
only the (w+1, 2w+1) receptive-field crop around each pixel, w = 2 +
pixelcnn_layers, with the positions outside the image forced to zero before
every 'B' layer (as SAME padding supplies them to the full-canvas pass);
``generate_from_top_naive`` re-runs the whole teacher-forced decode per
pixel and is the equivalence oracle. Both return samples: for binary input
``u < mean`` in {0, 1}, for gray/continuous input the mean. Noise: ``eps``
is None or the pair (eps1 (B, z1), u (H*W, B, C)), z1's noise and one
uniform per pixel in raster order (the JAX model's split into (k1, k_pix),
``fold_in(k_pix, i)``); what is not injected is drawn from ``generator``,
z1's noise first, then every uniform in one call. The pixel loop reads
nothing back to the host.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn

from exemplar_vae_tpu_torch.models.base import (PriorMixin,
                                                likelihood_params,
                                                reparameterize)
from exemplar_vae_tpu_torch.models.hvae import TwoLevelMLPCore
from exemplar_vae_tpu_torch.models.layers import (Conv, Dense, MaskedConv2d,
                                                  carries_grad, channels_last,
                                                  compute_dtype, nchw_for,
                                                  p_logvar_activation)
from exemplar_vae_tpu_torch.ops.masked_epilogue import masked_epilogue
from exemplar_vae_tpu_torch.train.profiling import profiler_active, span


class PixelHVAE(TwoLevelMLPCore, PriorMixin, nn.Module):

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        g = generator
        c_in, ih, iw = cfg.input_size
        self._hw = (ih, iw)
        self._setup_two_level_mlp(dt, g)
        # p(x | x_<i, z1, z2): the latent context map and the masked stack
        pf = cfg.pixelcnn_features
        self.ctx_proj = Dense(cfg.z1_size + cfg.z2_size, ih * iw * pf,
                              dtype=dt, generator=g)
        self.pix_in = MaskedConv2d(c_in, pf, (5, 5), "A", dtype=dt,
                                   generator=g)
        self._pix_layers = []
        for i in range(cfg.pixelcnn_layers):
            layer = MaskedConv2d(pf, pf, (3, 3), "B", dtype=dt, generator=g)
            setattr(self, f"pix_layers_{i}", layer)
            self._pix_layers.append(layer)
        self.p_x_mean_head = Conv(pf, c_in, dtype=dt, generator=g)
        if cfg.input_type != "binary":
            self.p_x_logvar_head = Conv(pf, c_in, dtype=dt, generator=g)
        self._setup_prior(generator)

    def _ctx(self, z1, z2):
        """The context map (B, F, H, W) in the stack's memory format. In
        fp32 NCHW-contiguous, from ``ctx_proj``'s GEMM over its kernel's
        columns and its bias permuted from flax's (H, W, F) order into
        (F, H, W) order."""
        (ih, iw), pf = self._hw, self.cfg.pixelcnn_features
        z = torch.cat([z1, z2], dim=-1)
        if channels_last(self.cfg):
            ctx = self.ctx_proj(z)
            return ctx.reshape(z.shape[0], ih, iw, pf).permute(0, 3, 1, 2)
        d = self.ctx_proj
        kernel = d.kernel.view(-1, ih, iw, pf).permute(0, 3, 1, 2)
        bias = d.bias.view(ih, iw, pf).permute(2, 0, 1)
        ctx = torch.addmm(bias.reshape(-1), z,
                          kernel.reshape(d.kernel.shape[0], -1))
        return ctx.view(z.shape[0], pf, ih, iw)

    def _fused_route(self, *inputs) -> bool:
        """Whether the teacher-forced stack takes the fused epilogue: fp32
        (so NCHW), and no gradient to carry (grad mode off, or nothing of
        ``inputs`` and the params requiring grad)."""
        if channels_last(self.cfg):
            return False
        return not carries_grad(*inputs, *self.parameters())

    def _stack(self, x, ctx, valid=None):
        """Masked stack and heads over NCHW ``x``: (mean, logvar), NCHW.
        ``valid`` (1, 1, h, w) zeroes the positions outside the image
        before every 'B' layer (the crop sampler)."""
        h = self.pix_in(x).add_(ctx)
        for layer in self._pix_layers:
            h = torch.relu(h)
            if valid is not None:
                h = h * valid
            h = layer(h).add_(ctx)
        return self._heads(torch.relu(h))

    def _teacher_forced(self, x, ctx, fused):
        """The stack and heads over NHWC ``x`` in the stack's memory format
        (in NCHW a reshape when C is 1) and the context map ``ctx``:
        (mean, logvar), NCHW; with ``fused`` through ``_stack_fused``."""
        return (self._stack_fused if fused else self._stack)(
            nchw_for(x, self.cfg), ctx)

    def _stack_fused(self, x, ctx):
        """``_stack`` without a gradient, in fp32, over NCHW-contiguous x
        and ctx: each masked conv without its bias, then relu((conv + bias)
        + ctx) in one in-place pass."""
        h = x
        for layer in (self.pix_in, *self._pix_layers):
            h = masked_epilogue(layer(h, bias=False), layer.bias, ctx)
        return self._heads(h)

    def _heads(self, h):
        return likelihood_params(
            torch.sigmoid(self.p_x_mean_head(h)).to(torch.float32),
            lambda: p_logvar_activation(self.p_x_logvar_head(h)),
            self.cfg.input_type)

    def decode(self, x, z1, z2):
        """Teacher-forced likelihood params of NHWC ``x``: causal in x by
        the masks, parallel over pixels."""
        fused = self._fused_route(x, z1, z2)
        with span("evae.pixelcnn.context"):
            ctx = self._ctx(z1, z2)
        with span("evae.pixelcnn.stack"):
            mean, logvar = masked_stack(self, x, ctx, fused)
        return mean.permute(0, 2, 3, 1), logvar.permute(0, 2, 3, 1)

    decode_x = decode

    def _receptive_halfwidth(self) -> int:
        """The 5x5 'A' layer reaches 2 pixels, each 3x3 'B' layer 1 more."""
        return 2 + self.cfg.pixelcnn_layers

    def _sampler_noise(self, z2, eps, generator):
        """(z1 ~ p(z1 | z2), the per-pixel uniforms (H*W, B, C) or None for
        a mean fill)."""
        eps1, u = (None, None) if eps is None else eps
        p1_mean, p1_logvar = self.p_z1(z2)
        z1 = reparameterize(p1_mean, p1_logvar, eps=eps1, generator=generator)
        if self.cfg.input_type != "binary":
            return z1, None
        ih, iw = self._hw
        shape = (ih * iw, z2.shape[0], self.cfg.input_size[0])
        if u is None:
            return z1, torch.rand(shape, generator=generator, device=z2.device)
        u = torch.as_tensor(u, dtype=torch.float32, device=z2.device)
        if tuple(u.shape) != shape:
            raise ValueError(f"u must be {shape}, got {tuple(u.shape)}")
        return z1, u

    @staticmethod
    def _sample(mean, u, i):
        """Pixel i of every row from its (B, C) mean."""
        return mean if u is None else (u[i] < mean).to(torch.float32)

    @torch.no_grad()
    def generate_from_top(self, z2, *, eps=None, generator=None):
        """(B, H, W, C) samples, one receptive-field crop per pixel: the
        canvas is padded to (H + w, W + 2w) so that the (w + 1, 2w + 1) crop
        at image (r, col) holds the target at (w, w); rows below the target
        are never read (causal), so no bottom padding."""
        z1, u = self._sampler_noise(z2, eps, generator)
        ih, iw = self._hw
        w = self._receptive_halfwidth()
        ch, cw = w + 1, 2 * w + 1
        ctx = self._ctx(z1, z2)
        pad = (w, w, w, 0)
        ctx_p = F.pad(ctx, pad)
        valid_p = F.pad(torch.ones((1, 1, ih, iw), dtype=ctx.dtype,
                                   device=ctx.device), pad)
        canvas = torch.zeros((z2.shape[0], self.cfg.input_size[0], ih + w,
                              iw + 2 * w), device=z2.device)
        for i in range(ih * iw):
            r, col = divmod(i, iw)
            win = (slice(None), slice(None), slice(r, r + ch),
                   slice(col, col + cw))
            mean, _ = self._stack(canvas[win], ctx_p[win], valid_p[win])
            canvas[:, :, r + w, col + w] = self._sample(mean[:, :, w, w], u, i)
        return canvas[:, :, w:, w:w + iw].permute(0, 2, 3, 1)

    @torch.no_grad()
    def generate_from_top_naive(self, z2, *, eps=None, generator=None):
        """(B, H, W, C) samples, the whole teacher-forced decode per pixel
        (the reference's strategy): the oracle of ``generate_from_top``."""
        z1, u = self._sampler_noise(z2, eps, generator)
        ih, iw = self._hw
        canvas = torch.zeros((z2.shape[0], ih, iw, self.cfg.input_size[0]),
                             device=z2.device)
        for i in range(ih * iw):
            r, col = divmod(i, iw)
            mean, _ = self.decode(canvas, z1, z2)
            canvas[:, r, col, :] = self._sample(mean[:, r, col, :], u, i)
        return canvas


def masked_stack(model, x, ctx, fused):
    """``model``'s teacher-forced masked stack and heads over NHWC ``x``
    with its context map ``ctx`` (``PixelHVAE._teacher_forced``), counted.

    ``masked_stack.rows`` sums the rows of every call. While a profiler
    runs, ``masked_stack.kept`` also keeps each call's count before it and
    the model's Config (the stack's shape), so that a reader can take the
    count's change over the profiled stretch."""
    if profiler_active():
        masked_stack.kept.append((masked_stack.rows, model.cfg))
    masked_stack.rows += x.shape[0]
    return model._teacher_forced(x, ctx, fused)


masked_stack.rows = 0
masked_stack.kept = collections.deque(maxlen=256)
