"""The PixelHVAE masked layers' epilogue, ``h <- relu((h + bias) + ctx)``
in place: the CUDA kernel's wrapper and its plain PyTorch version.

``h`` is a masked conv's output computed without its bias, (R, C, H, W)
fp32; ``bias`` its (C,) bias; ``ctx`` the context map, of h's shape. The
sums go in this order, the order of the unfused conv + bias, context add and
ReLU (``models/pixel_hvae.py``), so that both routes give the same bits
from the same conv output.

``masked_epilogue`` checks its inputs and calls the op
``torch.ops.exemplar_vae_tpu_torch.masked_epilogue`` (a ``torch.library``
custom op that mutates ``h``, so that ``torch.export`` keeps it as one
node), whose CUDA kernel launches csrc/masked_epilogue.cu on NCHW-contiguous
h and ctx, built at first use, and whose CPU kernel is
``masked_epilogue_plain``; there is no fallback between them. A CUDA tensor
in another memory format is refused. ``masked_epilogue.launches`` counts the
op's calls on either device. The op is forward-only: a call that needs a
gradient raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from exemplar_vae_tpu_torch.ops.nvcc import Library, forward_only

# csrc/masked_epilogue.cu, built into _build/ at first use
LIB = Library(
    Path(__file__).resolve().parents[1] / "csrc" / "masked_epilogue.cu",
    "masked_epilogue", {"masked_epilogue_forward": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
        + [ctypes.c_void_p], ctypes.c_int)})
build = LIB.build


def _check(h, bias, ctx):
    if h.dim() != 4 or ctx.shape != h.shape or bias.shape != (h.shape[1],):
        raise ValueError(f"want h and ctx (R, C, H, W) of one shape and bias "
                         f"(C,); got {tuple(h.shape)}, {tuple(ctx.shape)} and "
                         f"{tuple(bias.shape)}")
    for name, t in (("h", h), ("bias", bias), ("ctx", ctx)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if len({t.device for t in (h, bias, ctx)}) != 1:
        raise ValueError("masked_epilogue inputs lie on different devices")


def masked_epilogue_plain(h, bias, ctx):
    """relu((h + bias[c]) + ctx) into ``h`` in three in-place passes, any
    memory format; returns h."""
    return torch.relu_(h.add_(bias.view(-1, 1, 1)).add_(ctx))


@torch.library.custom_op("exemplar_vae_tpu_torch::masked_epilogue",
                         mutates_args=("h",), device_types="cpu")
def _epilogue_op(h: torch.Tensor, bias: torch.Tensor,
                 ctx: torch.Tensor) -> None:
    """The op's CPU kernel: the plain version."""
    masked_epilogue_plain(h, bias, ctx)
    masked_epilogue.launches += 1


@_epilogue_op.register_fake
def _epilogue_fake(h, bias, ctx):
    return None


@_epilogue_op.register_kernel("cuda")
def _epilogue_launch(h, bias, ctx):
    """The op's CUDA kernel: one launch of csrc/masked_epilogue.cu."""
    for name, t in (("h", h), ("ctx", ctx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be NCHW-contiguous on the card")
    if h.numel() == 0:
        return
    n, c, hh, w = h.shape
    _launch(h, bias.contiguous(), ctx, n * c, c, hh * w)
    masked_epilogue.launches += 1


def _launch(h, bias, ctx, planes, channels, hw):
    """One call of the C interface over ``planes`` (rows x channels)
    planes of ``hw`` values on h's current stream; raises where the kernel
    refuses it."""
    LIB.launch("masked_epilogue_forward", h.device, h.data_ptr(),
               bias.data_ptr(), ctx.data_ptr(), planes, channels, hw)


def masked_epilogue(h, bias, ctx):
    """``h <- relu((h + bias[c]) + ctx)`` in place; returns h. h and ctx
    (R, C, H, W) float32 (NCHW-contiguous on the card), bias (C,) float32,
    on one device (cuda or cpu). Checks the inputs, then calls the op
    ``torch.ops.exemplar_vae_tpu_torch.masked_epilogue``."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_epilogue runs on cuda or cpu, not {h.device}")
    _check(h, bias, ctx)
    forward_only("masked-epilogue", "a stack that carries a gradient adds "
                 "the bias, the context and the ReLU unfused", h, bias, ctx)
    _epilogue_op(h, bias, ctx)
    return h


masked_epilogue.launches = 0
