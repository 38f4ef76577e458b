"""The one way weights cross between the JAX package and the port.

A flax param tree ``{'q_layers_0': {'h_kernel': ...}, ...}`` maps onto the
port's ``state_dict`` by joining the path with dots
(``q_layers_0.h_kernel``): the port's modules carry the flax names and
layouts (dense kernels (in, out)). ``arrays.npz`` of a serving bundle and
the npz checkpoints key leaves by ``jax.tree_util.keystr`` paths
(``"['q_layers_0']['h_kernel']"``); ``params_from_keystr`` parses those.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_KEYSTR_PART = re.compile(r"\['([^'\]]*)'\]")


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def params_from_flax(tree: Mapping) -> dict:
    """Nested dict of arrays (a flax ``params`` tree) -> state_dict of CPU
    tensors. ``model.load_state_dict`` moves them to the model's device."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in _flatten(tree)}


def params_to_flax(state_dict: Mapping) -> dict:
    """state_dict -> nested dict of numpy arrays in the flax layout."""
    tree: dict = {}
    for k, v in state_dict.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return tree


def keystr_path(key: str) -> list:
    """"['a']['b']" -> ['a', 'b']; raises on anything else."""
    parts = _KEYSTR_PART.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"not a keystr path of dict keys: {key!r}")
    return parts


def params_from_keystr(flat: Mapping) -> dict:
    """{keystr path: array} -> state_dict of CPU tensors."""
    return {".".join(keystr_path(k)): torch.from_numpy(np.array(v, copy=True))
            for k, v in flat.items()}
