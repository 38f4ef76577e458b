"""The bank mesh over torch.distributed (counterpart of
exemplar_vae_tpu/parallel/mesh.py).

One axis, ``data``: the exemplar bank and the approximate prior's cache are
split by rows over the ranks of the process group; the params, the batch and
every draw from the step's generator are replicated, so each rank computes
the whole step and only the bank-sized work is divided. Rank r holds rows
[r * n_loc, (r + 1) * n_loc) of the bank padded to a multiple of the world
size (``pad_to_shards``); padding rows carry exemplar index -2 and ``valid``
False.

The process group comes from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR / MASTER_PORT), or from an ``init_method`` such as
``file://`` that the caller gives ``init_distributed``. NCCL on CUDA, gloo
on the CPU; a caller may name the backend (two gloo ranks can share one
card). Each rank's card is ``cuda:LOCAL_RANK``.

Every gather is written as "each rank writes its block into a zero buffer,
then all_reduce SUM": exact (x + 0 = x, inf + 0 = inf), and all_reduce is
the one collective that NCCL, gloo on the CPU and gloo on CUDA tensors all
take.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def pad_to_shards(arr, n_shards: int, pad_value=0):
    """Pad axis 0 to a multiple of ``n_shards``: (array, true row count)."""
    n = arr.shape[0]
    pad = (-n) % n_shards
    if pad:
        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(np.asarray(arr), widths, constant_values=pad_value)
    return arr, n


def row_range(n_padded: int, n_shards: int, rank: int) -> tuple:
    """[lo, hi) of rank ``rank``'s rows in a bank of ``n_padded`` rows."""
    if n_padded % n_shards:
        raise ValueError(f"{n_padded} rows do not split into {n_shards} "
                         f"shards; pad them first (pad_to_shards)")
    n_loc = n_padded // n_shards
    return rank * n_loc, (rank + 1) * n_loc


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``cuda`` without an index becomes
    cuda:LOCAL_RANK; an explicit index or the CPU stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def init_distributed(device="cuda", *, backend: Optional[str] = None,
                     init_method: str = "env://") -> torch.device:
    """Join the process group that RANK / WORLD_SIZE / LOCAL_RANK describe
    (torchrun sets them) and return the rank's device. ``init_method``
    defaults to torchrun's MASTER_ADDR / MASTER_PORT; tests pass a
    ``file://`` path."""
    for var in ("RANK", "WORLD_SIZE"):
        if var not in os.environ:
            raise RuntimeError(
                f"{var} is not set: launch the ranks with torchrun "
                f"(torchrun --nproc_per_node W -m exemplar_vae_tpu_torch.main "
                f"--mesh W ...)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda"
                                        else "gloo"),
                            init_method=init_method, rank=rank,
                            world_size=world)
    return dev


def shutdown():
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the ``data`` axis: ``size`` ranks, this one
    ``rank``, its tensors on ``device``."""
    size: int
    rank: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard_range(self, n_padded: int) -> tuple:
        return row_range(n_padded, self.size, self.rank)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all_reduce of ``t`` (no gradient); returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        return t

    def all_gather_rows(self, shard: torch.Tensor) -> torch.Tensor:
        """(size * n_loc, ...) of every rank's (n_loc, ...) shard, rank-major:
        the shard written into a zero buffer, then all_reduce SUM. Bool
        shards travel as uint8."""
        n_loc = shard.shape[0]
        dt = torch.uint8 if shard.dtype == torch.bool else shard.dtype
        out = torch.zeros((self.size * n_loc,) + tuple(shard.shape[1:]),
                          dtype=dt, device=shard.device)
        out[self.rank * n_loc:(self.rank + 1) * n_loc] = shard
        self.all_reduce(out)
        return out.bool() if shard.dtype == torch.bool else out

    def all_reduce_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable all_reduce SUM: its backward all-reduces the
        cotangent (see AllReduceSum)."""
        return AllReduceSum.apply(t)

    def average_grads(self, params):
        """Replace each parameter's .grad by its mean over the ranks: one
        all_reduce SUM over the flattened gradients, then / size; the
        tensors stay separate (AdamNormGrad normalizes each)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce(flat)
        flat.div_(self.size)
        start = 0
        for g in grads:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()

    def barrier(self):
        if self.device.type == "cuda" and dist.get_backend() == "nccl":
            index = self.device.index
            dist.barrier(device_ids=[torch.cuda.current_device()
                                     if index is None else index])
        else:
            dist.barrier()

    def shard_generator(self, generator):
        """A generator for draws over this rank's shard alone: seeded from
        one draw of ``generator`` (the same on every rank, so the ranks'
        step generators stay in step) folded with the rank, so shards draw
        independent noise, as the JAX package folds the axis index into its
        key. The seed is read on the host: one synchronization."""
        if generator is None:
            return None
        from exemplar_vae_tpu_torch.train.trainer import fold_seed
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        return torch.Generator(device=generator.device).manual_seed(
            fold_seed(seed, self.rank))


class AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, with an explicit backward that all-reduces
    the cotangent too.

    Every rank computes the same replicated loss L from y, so rank r's
    backward gives dL/dx_r summed over the W identical copies of L: W times
    the true gradient of its own shard's contribution, while a parameter
    path that does not pass through the collective gets its gradient once.
    Averaging each parameter's gradient over the ranks afterwards
    (Mesh.average_grads) then yields sum over shards + the replicated part:
    the one-rank gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def create_mesh(cfg, device="cuda") -> Optional[Mesh]:
    """The mesh of ``cfg.mesh_shape`` over the process group, or None for a
    one-device run (mesh_shape (1,) and no group of more than one rank).
    Joins the group from torchrun's environment when this process is not in
    one yet. Raises when the mesh size differs from the world size: a run
    asked to be sharded never runs on one process."""
    if len(cfg.mesh_shape) != 1 or tuple(cfg.mesh_axes) != ("data",):
        raise ValueError(f"mesh_shape={cfg.mesh_shape} mesh_axes="
                         f"{cfg.mesh_axes}: the port shards the bank over "
                         f"one axis, ('data',)")
    n = int(math.prod(cfg.mesh_shape))
    if not dist.is_initialized():
        if n == 1 and int(os.environ.get("WORLD_SIZE", "1")) == 1:
            return None
        dev = init_distributed(device)
    else:
        dev = rank_device(device, int(os.environ.get("LOCAL_RANK",
                                                     dist.get_rank())))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh_shape={cfg.mesh_shape} asks for {n} ranks, "
                         f"but the process group has {world}")
    if n == 1:
        return None
    return Mesh(size=n, rank=dist.get_rank(), device=dev)
