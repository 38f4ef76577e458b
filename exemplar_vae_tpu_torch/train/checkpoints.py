"""Full train-state checkpoints (counterpart of
exemplar_vae_tpu/train/checkpoints.py, its npz backend).

A checkpoint holds what a crashed run needs to go on: the params, the
optimizer's moments and count, the step, the epoch, the early-stopping
bookkeeping, the best-on-validation params and the approximate prior's
cache. The random draws need no saved state: each epoch's generator is
seeded from (cfg.seed, epoch) (trainer.fold_seed).

The files are the JAX package's, in its layout, so a checkpoint moves
between the packages in both directions:

    ckpt_<tag>/state.npz        keyed by the JAX TrainState's keystr paths
                                (.params[...], .opt_state[i].mu/.nu/.count,
                                .step; weights.train_state_to_keystr)
    ckpt_<tag>/best_params.npz  keyed ['q_layers_0']['h_kernel'], ...
    ckpt_<tag>/cache.npz        the cache means, when the prior has a cache
    ckpt_<tag>/meta.json        epoch, best_val, bad_epochs, backend

The directory is the atomic unit: everything is written into
ckpt_<tag>.tmp, then committed with two renames (current -> .old, .tmp ->
current). A crash at any instant leaves a complete checkpoint at ckpt_<tag>
or, between the renames, at ckpt_<tag>.old, which restore falls back to and
the next save promotes back before it cleans up. A restore checks every key,
shape and dtype against the live state and raises CheckpointMismatch on any
difference, so a config-drifted restore fails loudly.

On a mesh every rank enters save: the sharded cache is gathered to every
rank (a collective), rank 0 alone writes, and a barrier after the commit
keeps the other ranks from running ahead of a half-written checkpoint (into
a restore, say). The saved cache has the
padded bank's rows, as the JAX package saves it on a mesh; restore gives
each rank its rows back.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from exemplar_vae_tpu_torch.weights import (params_from_keystr,
                                            params_to_keystr,
                                            train_state_from_keystr,
                                            train_state_to_keystr)


class CheckpointMismatch(ValueError):
    """Checkpoint does not structurally match the current Config's state."""


def _load_npz(path, template: dict) -> dict:
    """{key: array} of ``path``, checked against ``template``'s keys,
    shapes and dtypes."""
    with np.load(path) as data:
        saved, want = set(data.files), set(template)
        if saved != want:
            raise CheckpointMismatch(
                f"checkpoint tree structure mismatch for {path}: "
                f"missing={sorted(want - saved)[:5]} "
                f"extra={sorted(saved - want)[:5]}")
        out = {}
        for k, t in template.items():
            arr = data[k]
            if arr.shape != t.shape or arr.dtype != t.dtype:
                raise CheckpointMismatch(
                    f"checkpoint leaf {k!r} in {path} has shape {arr.shape} "
                    f"dtype {arr.dtype}; current config expects {t.shape} "
                    f"{t.dtype}")
            out[k] = arr
    return out


def _promote_crashed(d):
    """If a previous save crashed between the two commit renames, the only
    complete checkpoint sits at d.old: promote it back to d before any
    cleanup, so that a crash during this save still leaves one."""
    old = d + ".old"
    if (not os.path.exists(os.path.join(d, "meta.json"))
            and os.path.exists(os.path.join(old, "meta.json"))):
        if os.path.exists(d):
            shutil.rmtree(d)        # partial or empty dir of the crashed commit
        os.replace(old, d)


def _cache(exp):
    bank = exp.bank
    return None if bank is None else bank.cache_means


def _whole_cache(exp):
    """The cache of the whole (padded) bank: on a mesh gathered from every
    rank's shard, a collective that every rank enters."""
    cache = _cache(exp)
    if cache is None or exp.mesh is None:
        return cache
    return exp.mesh.all_gather_rows(cache)


def save_checkpoint(exp, tag: str = "last"):
    """Write ``exp``'s full state to <exp_dir>/ckpt_<tag>, atomically. On a
    mesh every rank calls it and rank 0 writes."""
    st = exp.state
    cache = _whole_cache(exp)
    d = os.path.join(exp.exp_dir, f"ckpt_{tag}")
    tmp_d = d + ".tmp"
    if exp._is_main:
        _promote_crashed(d)
        if os.path.exists(tmp_d):
            shutil.rmtree(tmp_d)        # stale tmp of a crashed save
        os.makedirs(tmp_d)
        np.savez(os.path.join(tmp_d, "state.npz"),
                 **train_state_to_keystr(st.model, st.opt, st.step))
        np.savez(os.path.join(tmp_d, "best_params.npz"),
                 **params_to_keystr(exp.best_params))
        if cache is not None:
            np.savez(os.path.join(tmp_d, "cache.npz"),
                     cache=cache.cpu().numpy())
        with open(os.path.join(tmp_d, "meta.json"), "w") as f:
            json.dump({"epoch": exp.epoch, "best_val": exp.best_val,
                       "bad_epochs": exp.bad_epochs, "backend": "npz"}, f)
        # commit: swap the whole directory in two renames
        old_d = d + ".old"
        if os.path.exists(old_d):
            shutil.rmtree(old_d)
        if os.path.exists(d):
            os.replace(d, old_d)
        os.replace(tmp_d, d)
        if os.path.exists(old_d):
            shutil.rmtree(old_d)
    if exp.mesh is not None:
        exp.mesh.barrier()


def restore_checkpoint(exp, tag: str = "last") -> bool:
    """Load <exp_dir>/ckpt_<tag> (or its .old twin) into ``exp``: params,
    moments and the cache on the Experiment's device, best params on the
    CPU as the trainer keeps them. False when there is no checkpoint. On a
    mesh every rank reads the files and keeps its rows of the cache."""
    d = os.path.join(exp.exp_dir, f"ckpt_{tag}")
    if (not os.path.exists(os.path.join(d, "meta.json"))
            and os.path.exists(os.path.join(d + ".old", "meta.json"))):
        d = d + ".old"              # crash landed between the commit renames
    meta_p = os.path.join(d, "meta.json")
    if not os.path.exists(meta_p):
        return False
    with open(meta_p) as f:
        meta = json.load(f)
    if meta.get("backend", "npz") != "npz":
        raise NotImplementedError(
            f"{d} was written by the {meta['backend']!r} backend; the port "
            f"reads npz checkpoints only (orbax is a JAX library; ROADMAP.md, "
            f"Queue 3)")
    st = exp.state
    flat = _load_npz(os.path.join(d, "state.npz"),
                     train_state_to_keystr(st.model, st.opt, st.step))
    best = _load_npz(os.path.join(d, "best_params.npz"),
                     params_to_keystr(exp.best_params))
    params, mu, nu, count, step = train_state_from_keystr(flat,
                                                          st.opt.norm_grad)
    st.model.load_state_dict(params)        # copies onto the params' device
    for name, p in st.model.named_parameters():
        st.opt.state[p] = {"m": mu[name].to(p.device),
                           "v": nu[name].to(p.device)}
    st.opt.count, st.step = count, step
    exp.best_params = params_from_keystr(best)
    cache = _cache(exp)
    cache_p = os.path.join(d, "cache.npz")
    if cache is not None and os.path.exists(cache_p):
        mesh = exp.mesh
        n = cache.shape[0] * (mesh.size if mesh else 1)
        arr = _load_npz(cache_p, {"cache": np.zeros(
            (n,) + tuple(cache.shape[1:]), np.float32)})["cache"]
        lo, hi = mesh.shard_range(n) if mesh else (0, n)
        exp.bank = exp.bank._replace(
            cache_means=torch.from_numpy(arr[lo:hi]).to(cache.device))
    exp.epoch = int(meta["epoch"])
    exp.best_val = float(meta["best_val"])
    exp.bad_epochs = int(meta["bad_epochs"])
    return True
