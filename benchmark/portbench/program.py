"""The system under test, as the benchmark drives it: the port's Config
from a configuration file's ``program`` entry, and its model carrying the
benchmark's seeded weights. The port's own modules are imported by the
kinds where they use them; this file holds what both kinds share."""

from __future__ import annotations

import torch

from portbench.weights import program_state


def config(program: dict):
    from exemplar_vae_tpu_torch.config import Config
    fields = dict(program)
    fields["input_size"] = tuple(fields["input_size"])
    return Config(**fields)


def build_model(cfg, weights: dict, device):
    """The port's model of ``cfg`` on ``device`` with the benchmark's
    weights (flax names) copied in; every leaf must match by name and
    shape."""
    from exemplar_vae_tpu_torch.models import create_model
    model = create_model(cfg, device=str(device))
    with torch.no_grad():
        model.load_state_dict(program_state(weights), strict=True)
    return model


def lse_launches() -> int:
    """The port's count of pairwise-LSE kernel launches so far."""
    from exemplar_vae_tpu_torch.ops.pairwise_lse import pairwise_lse
    return pairwise_lse.launches


def flax_name(name: str) -> str:
    """A port parameter name in the flax layout's spelling."""
    return name.replace(".", "/")
