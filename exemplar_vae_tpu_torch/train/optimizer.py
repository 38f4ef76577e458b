"""AdamNormGrad and plain Adam (counterpart of
exemplar_vae_tpu/train/optimizer.py).

AdamNormGrad is Adam where each parameter tensor's gradient is first
L2-normalized, ``g <- g / (||g||_2 + 1e-7)``, and the moments then update in
the old-torch form

    m <- b1 m + (1-b1) g ;  v <- b2 v + (1-b2) g^2
    p <- p - lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)

with t counted from 1 and the scale computed in fp32. ``torch.optim.Adam``
is not this rule: it divides by sqrt(v_hat) + eps, an effective eps
sqrt(1 - b2^t) times smaller. Plain Adam (optax.scale_by_adam, which
``torch.optim.Adam`` equals) is the variance-reduced harness mode:

    p <- p - lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

Both work per tensor, so the gated layers' h_* and g_* tensors normalize
apart. The update runs as foreach ops over all tensors (a few launches per
step, not a few per tensor). Gradients are read and left as they are: after
a step each ``.grad`` still holds the raw gradient.
"""

from __future__ import annotations

import numpy as np
import torch

NORM_EPS = 1e-7


class Adam(torch.optim.Optimizer):
    """Adam over ``params``; ``norm_grad=True`` is AdamNormGrad (per-tensor
    normalization and the old-torch update form), False is plain Adam."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, *, norm_grad: bool):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.norm_grad = norm_grad
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        self.count += 1
        c = np.float32(self.count)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["m"] = torch.zeros_like(p)
                    self.state[p]["v"] = torch.zeros_like(p)
            m = [self.state[p]["m"] for p in params]
            v = [self.state[p]["v"] for p in params]
            if self.norm_grad:
                norms = torch._foreach_norm(grads)
                torch._foreach_add_(norms, NORM_EPS)
                grads = torch._foreach_div(grads, norms)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
            bc1 = float(np.float32(1) - np.float32(b1) ** c)
            bc2 = float(np.float32(1) - np.float32(b2) ** c)
            if self.norm_grad:
                denom = torch._foreach_sqrt(v)
                torch._foreach_add_(denom, eps)
                upd = torch._foreach_mul(m, float(np.float32(np.sqrt(
                    np.float32(bc2))) / np.float32(bc1)))
                torch._foreach_div_(upd, denom)
            else:
                denom = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, eps)
                upd = torch._foreach_div(m, bc1)
                torch._foreach_div_(upd, denom)
            torch._foreach_add_(params, upd, alpha=-group["lr"])


def adam_norm_grad(params, lr: float, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> Adam:
    """AdamNormGrad, the reference optimizer."""
    return Adam(params, lr, b1, b2, eps, norm_grad=True)


def plain_adam(params, lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> Adam:
    """Standard Adam with the same hyperparameters, without the per-tensor
    normalization (the trajectory-parity harness mode)."""
    return Adam(params, lr, b1, b2, eps, norm_grad=False)


def make_optimizer(cfg, params) -> Adam:
    """cfg.optimizer -> the optimizer over ``params``."""
    if cfg.optimizer == "adam_norm_grad":
        return adam_norm_grad(params, cfg.lr)
    if cfg.optimizer == "adam":
        return plain_adam(params, cfg.lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
