"""The one way weights cross between the JAX package and the port.

A flax param tree ``{'q_layers_0': {'h_kernel': ...}, ...}`` maps onto the
port's ``state_dict`` by joining the path with dots
(``q_layers_0.h_kernel``): the port's modules carry the flax names and
layouts (dense kernels (in, out)). ``arrays.npz`` of a serving bundle and
the npz checkpoints key leaves by ``jax.tree_util.keystr`` paths
(``"['q_layers_0']['h_kernel']"``); ``params_from_keystr`` parses those and
``params_to_keystr`` writes them. ``train_state_to_keystr`` and
``train_state_from_keystr`` map the whole train state (params, the Adam
moments and count, the step) onto the JAX TrainState's keystr paths, so a
checkpoint moves between the packages in both directions.
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


def params_to_keystr(state_dict: Mapping, prefix: str = "") -> dict:
    """state_dict -> {prefix + keystr path: numpy array}, the inverse of
    params_from_keystr."""
    return {prefix + "".join(f"['{p}']" for p in k.split(".")):
            v.detach().cpu().numpy() for k, v in state_dict.items()}


def adam_state_prefix(norm_grad: bool) -> str:
    """keystr of optax's ScaleByAdamState inside the JAX TrainState: the
    AdamNormGrad chain is (normalize, adam, scale), plain Adam's (adam,
    scale)."""
    return f".opt_state[{1 if norm_grad else 0}]"


def train_state_to_keystr(model, opt, step: int) -> dict:
    """The port's train state (the model's params, the Adam optimizer's
    per-parameter ``m``, ``v`` and its ``count``, the step) -> the entries
    of the JAX TrainState's npz: ``.params[...]``, ``.opt_state[i].mu[...]``
    / ``.nu[...]`` / ``.count`` (int32) and ``.step`` (int32). Moments of
    a parameter the optimizer has not stepped yet are zeros, as optax
    initializes them."""
    adam = adam_state_prefix(opt.norm_grad)
    mu, nu = {}, {}
    for name, p in model.named_parameters():
        st = opt.state.get(p) or {}
        mu[name] = st.get("m", torch.zeros_like(p))
        nu[name] = st.get("v", torch.zeros_like(p))
    flat = params_to_keystr(model.state_dict(), ".params")
    flat.update(params_to_keystr(mu, f"{adam}.mu"))
    flat.update(params_to_keystr(nu, f"{adam}.nu"))
    flat[f"{adam}.count"] = np.asarray(opt.count, np.int32)
    flat[".step"] = np.asarray(step, np.int32)
    return flat


def train_state_from_keystr(flat: Mapping, norm_grad: bool):
    """Inverse of train_state_to_keystr: (params, mu, nu) as state_dicts of
    CPU tensors, the optimizer's count and the step."""
    adam = adam_state_prefix(norm_grad)
    trees = {".params": {}, f"{adam}.mu": {}, f"{adam}.nu": {}}
    for k, v in flat.items():
        for prefix, tree in trees.items():
            if k.startswith(prefix + "["):
                tree[k[len(prefix):]] = v
    params, mu, nu = (params_from_keystr(t) for t in trees.values())
    return params, mu, nu, int(flat[f"{adam}.count"]), int(flat[".step"])
