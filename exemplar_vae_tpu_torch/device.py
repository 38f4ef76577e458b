"""Device rule of the port: entry points run on the card unless the caller
asks for the CPU, and never fall back silently; ``as_tensor`` puts host
arrays on the chosen device. Imports no model code (the serving loader
relies on that)."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for ``device``; raises if it names CUDA and no card is
    present. On CUDA it also turns TF32 off for matmuls and cuDNN, so fp32
    products run in full fp32 as they do in the JAX reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    return dev


def as_tensor(x, device, dtype=None):
    """numpy array or tensor -> tensor on ``device`` (no copy if already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
