"""Model registry (counterpart of exemplar_vae_tpu/models/__init__.py)."""

from __future__ import annotations

import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.device import resolve_device
from exemplar_vae_tpu_torch.models.conv_hvae import ConvHVAE
from exemplar_vae_tpu_torch.models.hvae import HVAE
from exemplar_vae_tpu_torch.models.pixel_hvae import PixelHVAE
from exemplar_vae_tpu_torch.models.vae import VAE

_MODELS = {"vae": VAE, "hvae_2level": HVAE, "convhvae_2level": ConvHVAE,
           "pixelhvae_2level": PixelHVAE}

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
    if name not in _MODELS:
        raise ValueError(f"unknown model_name: {cfg.model_name}")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return _MODELS[name](cfg, generator=gen).to(dev)
