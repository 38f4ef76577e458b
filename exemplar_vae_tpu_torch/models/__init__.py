"""Model registry (counterpart of exemplar_vae_tpu/models/__init__.py)."""

from __future__ import annotations

import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.device import resolve_device

_LATER = {
    "hvae_2level": "the HVAE slice",
    "convhvae_2level": "the ConvHVAE slice",
    "pixelhvae_2level": "the beyond-parity slice (PixelHVAE)",
}
_ALIASES = {"hvae": "hvae_2level", "convhvae": "convhvae_2level",
            "conv_hvae": "convhvae_2level", "pixelhvae": "pixelhvae_2level",
            "pixel_hvae": "pixelhvae_2level"}


def create_model(cfg: Config, device="cuda", seed=None):
    """The model of ``cfg`` on ``device``, its weights drawn from ``seed``
    (default cfg.seed) with the flax initializers' distributions. Raises if
    ``device`` is CUDA and no card is present."""
    dev = resolve_device(device)
    name = cfg.model_name.lower()
    name = _ALIASES.get(name, name)
    if name in _LATER:
        raise NotImplementedError(
            f"model_name={cfg.model_name!r} is not ported yet: it comes with "
            f"{_LATER[name]} (ROADMAP.md, Queue 1)")
    if name != "vae":
        raise ValueError(f"unknown model_name: {cfg.model_name}")
    from exemplar_vae_tpu_torch.models.vae import VAE
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return VAE(cfg, generator=gen).to(dev)
