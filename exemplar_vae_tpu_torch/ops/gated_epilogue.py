"""The gated convs' epilogue, depth-to-space, bias and sigmoid gate in one
pass: the CUDA kernel's wrapper and its plain PyTorch version.

``y`` is a gated conv's output computed without its bias, (R, s_h*s_w*2F,
h, w) fp32 NCHW-contiguous, its channels phase-major: channel
(a*s_w + b)*2F + c holds output phase (a, b) of channel c of the 2F value
and gate channels (the order ``models/layers.py``'s sub-pixel conv builds;
s_h = s_w = 1 for a plain conv). The result is the fresh (R, F, s_h*h,
s_w*w) NCHW-contiguous tensor

    out[r, f, s_h*q + a, s_w*p + b] = (v + h_bias[f]) * sigmoid(g + g_bias[f])

with v and g the value and gate channels f and F + f of phase (a, b) at
(q, p). The arithmetic goes in the order of the unfused chain (the
depth-to-space copy that adds the bias, or the conv's bias add; ``chunk``;
sigmoid; product), so that both routes give the same bits from the same
conv output.

``gated_epilogue`` checks its inputs and calls the op
``torch.ops.exemplar_vae_tpu_torch.gated_epilogue`` (a ``torch.library``
custom op, so that ``torch.export`` keeps it as one node), whose CUDA kernel
launches csrc/gated_epilogue.cu, built at first use, and whose CPU kernel is
``gated_epilogue_plain``; there is no fallback between them.
``gated_epilogue.launches`` counts the op's calls on either device. The op
is forward-only: a call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from exemplar_vae_tpu_torch.ops.nvcc import Library, forward_only

# csrc/gated_epilogue.cu, built into _build/ at first use
LIB = Library(
    Path(__file__).resolve().parents[1] / "csrc" / "gated_epilogue.cu",
    "gated_epilogue", {"gated_epilogue_forward": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_void_p], ctypes.c_int)})
build = LIB.build


def _features(y, phases):
    """F of ``y`` (R, s_h*s_w*2F, h, w) for ``phases`` (s_h, s_w)."""
    sh, sw = phases
    if sh < 1 or sw < 1 or y.shape[1] % (2 * sh * sw):
        raise ValueError(f"{y.shape[1]} channels do not split into "
                         f"{sh}x{sw} phases of value and gate")
    return y.shape[1] // (2 * sh * sw)


def _check(y, h_bias, g_bias, phases):
    if y.dim() != 4:
        raise ValueError(f"want y (R, s_h*s_w*2F, h, w), got "
                         f"{tuple(y.shape)}")
    f = _features(y, phases)
    for name, t in (("y", y), ("h_bias", h_bias), ("g_bias", g_bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if h_bias.shape != (f,) or g_bias.shape != (f,):
        raise ValueError(f"want h_bias and g_bias ({f},); got "
                         f"{tuple(h_bias.shape)} and {tuple(g_bias.shape)}")
    if not y.is_contiguous():
        raise ValueError("y must be NCHW-contiguous")
    if len({t.device for t in (y, h_bias, g_bias)}) != 1:
        raise ValueError("gated_epilogue inputs lie on different devices")


def gated_epilogue_plain(y, h_bias, g_bias, sh: int, sw: int):
    """The unfused chain: the depth-to-space copy that adds the bias
    (a plain bias add when s_h = s_w = 1) into (R, 2F, s_h*h, s_w*w), the
    value and gate halves, sigmoid, product into a fresh NCHW tensor."""
    n, _, h, w = y.shape
    f = _features(y, (sh, sw))
    src = y.view(n, sh, sw, 2 * f, h, w).permute(0, 3, 4, 1, 5, 2)
    full = y.new_empty((n, 2 * f, h, sh, w, sw))
    torch.add(src, torch.cat([h_bias, g_bias]).view(2 * f, 1, 1, 1, 1),
              out=full)
    value, gate = torch.chunk(full.view(n, 2 * f, h * sh, w * sw), 2, dim=1)
    out = y.new_empty((n, f, h * sh, w * sw))
    return torch.mul(value, torch.sigmoid(gate), out=out)


@torch.library.custom_op("exemplar_vae_tpu_torch::gated_epilogue",
                         mutates_args=(), device_types="cpu")
def _epilogue_op(y: torch.Tensor, h_bias: torch.Tensor, g_bias: torch.Tensor,
                 sh: int, sw: int) -> torch.Tensor:
    """The op's CPU kernel: the plain version."""
    gated_epilogue.launches += 1
    return gated_epilogue_plain(y, h_bias, g_bias, sh, sw)


@_epilogue_op.register_fake
def _epilogue_fake(y, h_bias, g_bias, sh, sw):
    n, _, h, w = y.shape
    return y.new_empty((n, _features(y, (sh, sw)), h * sh, w * sw))


@_epilogue_op.register_kernel("cuda")
def _epilogue_launch(y, h_bias, g_bias, sh, sw):
    """The op's CUDA kernel: csrc/gated_epilogue.cu over R in launches of
    fewer than 2^31 units."""
    if not y.is_contiguous():
        raise ValueError("y must be NCHW-contiguous on the card")
    n, _, h, w = y.shape
    f = _features(y, (sh, sw))
    out = y.new_empty((n, f, h * sh, w * sw))
    if out.numel() == 0:
        return out
    _launch(y, h_bias.contiguous(), g_bias.contiguous(), out, n, f, sh, sw,
            h, w)
    gated_epilogue.launches += 1
    return out


def _launch(y, h_bias, g_bias, out, rows, features, sh, sw, h, w):
    """One call of the C interface on y's current stream; raises where the
    kernel refuses it."""
    LIB.launch("gated_epilogue_forward", y.device, y.data_ptr(),
               h_bias.data_ptr(), g_bias.data_ptr(), out.data_ptr(), rows,
               features, sh, sw, h, w)


def gated_epilogue(y, h_bias, g_bias, phases=(1, 1)):
    """``(v + h_bias) * sigmoid(g + g_bias)`` of ``y``'s value and gate
    channels, phases (s_h, s_w) moved to space: a fresh (R, F, s_h*h, s_w*w)
    NCHW tensor. y (R, s_h*s_w*2F, h, w) float32 NCHW-contiguous, the biases
    (F,) float32, on one device (cuda or cpu). Checks the inputs, then calls
    the op ``torch.ops.exemplar_vae_tpu_torch.gated_epilogue``."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gated_epilogue runs on cuda or cpu, not {y.device}")
    _check(y, h_bias, g_bias, phases)
    forward_only("gated-epilogue", "a conv that carries a gradient adds "
                 "the bias and the gate unfused", y, h_bias, g_bias)
    return _epilogue_op(y, h_bias, g_bias, *phases)


gated_epilogue.launches = 0
