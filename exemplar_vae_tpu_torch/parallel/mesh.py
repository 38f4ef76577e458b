"""The data mesh over torch.distributed (counterpart of
exemplar_vae_tpu/parallel/mesh.py).

One axis, ``data``, on which both the batch rows and the exemplar bank are
split, as in the JAX package; the params and the optimizer state are
replicated.

* The batch: every rank gathers the step's whole batch and draws the
  step's whole noise from the replicated step generator (so the ranks'
  generators stay in step and each row sees the numbers one process gives
  it), then keeps its own rows, ``batch_rows``: B rows split as
  ``torch.tensor_split`` splits them, the first B mod W ranks one row
  longer. Each rank runs the forward and backward of its rows only.
* The bank and the approximate prior's cache: rank r holds rows
  [r * n_loc, (r + 1) * n_loc) of the bank padded to a multiple of the
  world size (``pad_to_shards``); padding rows carry exemplar index -2 and
  ``valid`` False.

The process group comes from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR / MASTER_PORT), or from an ``init_method`` such as
``file://`` that the caller gives ``init_distributed``. NCCL on CUDA, gloo
on the CPU; a caller may name the backend (two gloo ranks can share one
card). Each rank's card is ``cuda:LOCAL_RANK``.

Every gather is written as "each rank writes its block into a zero buffer,
then all_reduce SUM": exact (x + 0 = x, inf + 0 = inf), and all_reduce is
the one collective that NCCL, gloo on the CPU and gloo on CUDA tensors all
take. Every all_reduce of the mesh goes through ``all_reduce``, which
counts the bytes this rank puts through it.

Under a profiler the collectives are ranges of their own
(train/profiling.py's ``span``): ``evae.mesh.grads`` (Mesh.average_grads),
``evae.mesh.gather`` (Mesh.all_gather_rows and the kNN prior's row gather
and candidate merge, parallel/sharded_knn.py), ``evae.mesh.metrics`` (the
epoch's metric sums, train/steps.py).
"""

from __future__ import annotations

import collections
import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from exemplar_vae_tpu_torch.train.profiling import profiler_active, span


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place; returns ``t``.

    ``all_reduce.bytes`` counts the bytes of every buffer this rank has put
    through it. While a profiler runs, ``all_reduce.kept`` also keeps each
    call's count before it and its buffer's bytes, so that a reader can take
    the bytes and the calls of a profiled stretch."""
    nbytes = t.numel() * t.element_size()
    if profiler_active():
        all_reduce.kept.append((all_reduce.bytes, nbytes))
    all_reduce.bytes += nbytes
    dist.all_reduce(t, op=op)
    return t


all_reduce.bytes = 0
# (bytes before the call, its buffer's bytes) of the latest calls made under
# a profiler, newest last
all_reduce.kept = collections.deque(maxlen=4096)


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

    def batch_rows(self, b: int) -> tuple:
        """[lo, hi) of this rank's rows of a batch of ``b``, split as
        torch.tensor_split splits it: 100 rows on 3 ranks give 34 / 33 /
        33. A rank with no rows is a configuration error."""
        if b < self.size:
            raise ValueError(f"a batch of {b} rows leaves ranks of the "
                             f"{self.size}-rank mesh without rows: raise "
                             f"batch_size to at least {self.size}")
        q, extra = divmod(b, self.size)
        lo = self.rank * q + min(self.rank, extra)
        return lo, lo + q + (self.rank < extra)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all_reduce of ``t`` (no gradient); returns ``t``."""
        return all_reduce(t, dist.ReduceOp.MAX if op == "max"
                          else dist.ReduceOp.SUM)

    def all_gather_rows(self, shard: torch.Tensor,
                        total: Optional[int] = None) -> torch.Tensor:
        """Every rank's rows, rank-major, with no gradient: the shard
        written into a zero buffer, then all_reduce SUM. The ``total`` rows
        (default: ``size`` times the shard's) are split over the ranks as
        batch_rows splits them, so the blocks may differ in size. Bool
        shards travel as uint8."""
        total = self.size * shard.shape[0] if total is None else total
        lo, hi = self.batch_rows(total)
        if hi - lo != shard.shape[0]:
            raise ValueError(f"rank {self.rank} holds {shard.shape[0]} rows, "
                             f"not its {hi - lo} of {total}")
        dt = torch.uint8 if shard.dtype == torch.bool else shard.dtype
        with span("evae.mesh.gather"):
            out = torch.zeros((total,) + tuple(shard.shape[1:]), dtype=dt,
                              device=shard.device)
            out[lo:hi] = shard
            self.all_reduce(out)
        return out.bool() if shard.dtype == torch.bool else out

    def all_gather_rows_grad(self, rows: torch.Tensor,
                             total: int) -> torch.Tensor:
        """Differentiable all_gather_rows of this rank's batch rows into
        the (total, ...) batch (see AllGatherRows)."""
        return AllGatherRows.apply(rows, self, total)

    def all_reduce_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable all_reduce SUM: its backward all-reduces the
        cotangent (see AllReduceSum)."""
        return AllReduceSum.apply(t)

    def average_grads(self, params):
        """Replace each parameter's .grad by its mean over the ranks: one
        all_reduce SUM over the flattened gradients, then / size; the
        tensors stay separate (AdamNormGrad normalizes each).

        The gradient accounting of the data-parallel step: rank r's loss
        is L_r = (W / B) * sum over b in rows(r) of l_b, for any split of
        the B rows over the W ranks. The collectives' backwards (
        AllReduceSum, AllGatherRows) carry each cotangent to the rank whose
        tensor produced it, so the ranks' gradients sum to the gradient of
        sum_r L_r = (W / B) * sum_b l_b, whatever rank computed which part
        of l_b (its row's forward, or a bank shard's share of its prior).
        Their mean, this function's result, is then the gradient of
        (1 / B) * sum_b l_b: the one-process batch mean."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        with span("evae.mesh.grads"):
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

    y_b, a whole-batch row, is computed on every rank, but only the rank
    that owns row b uses it in its loss L_r (the others' cotangent of y_b
    is zero). The all-reduced cotangent is therefore, on every rank, each
    row's cotangent from the rank that owns the row: rank r's backward
    then gives d(sum_s L_s)/dx_r, its shard's contribution to every rank's
    loss, which Mesh.average_grads turns into the one-process gradient."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone())


class AllGatherRows(torch.autograd.Function):
    """The (total, ...) batch from every rank's rows (Mesh.batch_rows), and
    a backward that all-reduces the cotangent and keeps the rank's own
    rows (a reduce-scatter): every rank uses the whole gathered batch (its
    bank shard scores every row), so the gradient of a rank's rows is the
    sum of the cotangents that every rank's use of them produced."""

    @staticmethod
    def forward(ctx, x, mesh, total):
        ctx.rows = mesh.batch_rows(total)
        return mesh.all_gather_rows(x, total)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone())
        lo, hi = ctx.rows
        return g[lo:hi], None, None


def create_mesh(cfg, device="cuda") -> Optional[Mesh]:
    """The mesh of ``cfg.mesh_shape`` over the process group, or None for a
    one-device run (mesh_shape (1,) and no group of more than one rank).
    Joins the group from torchrun's environment when this process is not in
    one yet. Raises when the mesh size differs from the world size: a run
    asked to be sharded never runs on one process."""
    if len(cfg.mesh_shape) != 1 or tuple(cfg.mesh_axes) != ("data",):
        raise ValueError(f"mesh_shape={cfg.mesh_shape} mesh_axes="
                         f"{cfg.mesh_axes}: the port shards the batch and the "
                         f"bank over one axis, ('data',)")
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
