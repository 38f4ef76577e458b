"""Training traffic on the data mesh: the port's data-parallel epoch
function on W ranks, one a card.

run.py runs one process on the card it was given. This kind keeps rank 0
in that process and starts ranks 1 .. W-1 (W: the program's
``mesh_shape``) as child processes (``python -m portbench.kinds.
train_mesh``), each on a card of its own (the others in index order). The
ranks join one process group, NCCL on cards and gloo on the CPU
(``Program``'s ``backend``), through a TCP store on localhost that carries
only the rank program's spec and each child's readiness; every command and
tensor travels in the group.

CPUs. run.py narrows its process to two of the CPUs it may use before the
kind runs. Each child takes CPUS_PER_RANK CPUs of its own among the others
that process may use (its parent's mask), outside rank 0's; the run fails
where there are too few, or where a child cannot take its CPUs. A rank 0
that was not narrowed (the CPU tests) keeps no CPUs apart: the children
share its mask.

Each rank builds what the port's Experiment builds on a mesh
(train/trainer.py): ``create_mesh``'s mesh, the model with the benchmark's
weights and its AdamNormGrad state, ``make_epoch_fn(cfg, mesh)``, the
whole training set on its card, and its rows of the bank padded to a
multiple of W (``pad_to_shards``, ``Mesh.shard_range``) with the cache of
its rows from ``make_cache_refresh(model, cfg, mesh)``. Rank 0 makes the
data, the weights, the first steps' rows and noise and every call's rows,
as train_epochs does, and broadcasts them: every rank is given the whole
batch, as the mesh's step expects, and keeps its own rows of it. Each of
rank 0's commands ("call", "gap", "stop") is a broadcast of three
integers: the command, the call's steps and whether noise follows.

The traffic is train_epochs': ``check_steps`` first steps, a warm call,
then a closed loop of calls of ``steps_per_call`` steps, each ended by one
host read of the mesh's mean loss on rank 0; ``train_images_per_s`` counts
the whole mesh's images, batch_size a step. After the first steps
``rank_params_gap`` is the largest difference, over the leaves and the
ranks, of a rank's params from rank 0's: the replicated state must stay
bitwise equal. Under ``--trace 1`` rank 0 profiles the stretch while the
others run it unprofiled, and the FLOPs of a unit are the rank's share,
``step_flops / W``.

Failure. A thread of rank 0 watches the children: when one exits with a
code other than 0, it stops the others and aborts an NCCL group, so that a
collective that waits for the lost rank returns, and rank 0 raises; where
rank 0 is still held GRACE_S later, its process exits (EXIT_LOST). A child
that fails exits at once, without leaving the group (which could wait for
the others), and a child exits when rank 0's process is gone. A collective
that waits longer than GROUP_TIMEOUT_S, a child's wait for rank 0's next
command included, fails the group. Each child checks for banned modules
before it exits, and a hit fails the run.

After the window every rank sends rank 0 its card's memory peak
(``memory_peak_bytes`` is the largest) and its banned modules, and stops;
rank 0 frees the program, and the plain reference follows the first steps
on rank 0's card, the whole batch in one process
(train_epochs.reference_outputs).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
import weakref
from datetime import timedelta

import torch
import torch.distributed as dist

from portbench import manifest, program
from portbench.common import Readings, banned_loaded, release, sub_seed
from portbench.kinds import train_epochs
from portbench.kinds.train_epochs import Slices
from portbench.trace import profile_stretch

KIND = "train"
ROOT = manifest.BENCH_DIR.parent
CPUS_PER_RANK = 2
WAIT_S = 180.0            # a child's start, or its exit after "stop"
GROUP_TIMEOUT_S = 50.0    # one collective
GRACE_S = 10.0            # rank 0's return after a lost rank
POLL_S = 0.05
EXIT_LOST = 5
COMMANDS = ("call", "gap", "stop")

make_inputs = train_epochs.make_inputs
reference_outputs = train_epochs.reference_outputs


def world_size(config: dict) -> int:
    return math.prod(config["program"]["mesh_shape"])


def _log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


# --- the planted fault of the mesh ---

def _plant(mesh, plant):
    """The mesh the rank trains on: ``create_mesh``'s, or with the planted
    fault ``"grads_over_w_minus_1"`` its gradient sum divided by W - 1."""
    if plant != "grads_over_w_minus_1":
        return mesh

    class Faulty(type(mesh)):
        def average_grads(self, params):
            params = list(params)
            super().average_grads(params)
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(self.size / (self.size - 1))

    return Faulty(size=mesh.size, rank=mesh.rank, device=mesh.device)


# --- one rank's program, the same on every rank ---

def _shape_of(config: dict):
    cfg = config["program"]
    c, h, w = cfg["input_size"]
    pixels = torch.uint8 if config["data"]["pixels"] == "uint8" \
        else torch.float32
    return (cfg["training_set_size"], h, w, c), pixels


def _broadcast(t, shape, dtype, device):
    """Rank 0's ``t``, on every rank (``t`` None on the others)."""
    if t is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    dist.broadcast(t, 0)
    return t


def _broadcast_weights(weights, spec: dict, device) -> dict:
    """Rank 0's weights ({flax name: tensor}, ``spec``'s order) on every
    rank, in one buffer."""
    sizes = [math.prod(shape) for shape, _ in spec.values()]
    flat = (torch.cat([weights[k].reshape(-1) for k in spec])
            if weights is not None else None)
    flat = _broadcast(flat, (sum(sizes),), torch.float32, device)
    return {k: v.view(shape) for (k, (shape, _)), v in
            zip(spec.items(), flat.split(sizes))}


class RankProgram:
    """One rank's training objects, built as the port's Experiment builds
    them on the mesh. Rank 0 passes the data and the weights; the others
    receive them."""

    def __init__(self, config: dict, seed: int, device, plant=None,
                 train_x=None, weights=None):
        from exemplar_vae_tpu_torch.parallel.mesh import (create_mesh,
                                                          pad_to_shards)
        from exemplar_vae_tpu_torch.train import steps as psteps
        from exemplar_vae_tpu_torch.train.loss import Bank
        reference, _ = manifest.family(config)
        cfg = program.config(config["program"])
        self.cfg = cfg = cfg.replace(mesh_shape=tuple(cfg.mesh_shape))
        mesh = create_mesh(cfg, device)
        if mesh is None or mesh.size != world_size(config):
            raise RuntimeError(f"no mesh of {world_size(config)} ranks")
        self.mesh = mesh = _plant(mesh, plant)
        self.device = device
        self.beta = float(config["beta"])
        shape, pixels = _shape_of(config)
        self.train_x = _broadcast(train_x, shape, pixels, device)
        wts = _broadcast_weights(weights, reference.param_spec(
            config["program"]), device)
        self.model = program.build_model(cfg, wts, device)
        del wts
        self.state = psteps.init_train_state(self.model, cfg)
        self.epoch_fn = psteps.make_epoch_fn(cfg, mesh)
        n = shape[0]
        self.train_idx = torch.arange(n, dtype=torch.int32, device=device)
        nb = cfg.number_components
        idx, _ = pad_to_shards(torch.arange(nb, dtype=torch.int32).numpy(),
                               mesh.size, pad_value=-2)
        lo, hi = mesh.shard_range(len(idx))
        images = self.train_x[lo:min(hi, nb)]
        if images.shape[0] < hi - lo:
            images = torch.cat([images, images.new_zeros(
                (hi - lo - images.shape[0],) + tuple(images.shape[1:]))])
        data_idx = torch.from_numpy(idx[lo:hi]).to(device)
        self.bank = Bank(images=images, data_idx=data_idx,
                         valid=data_idx >= 0, cache_means=None,
                         n_effective=nb)
        self.gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "program"))
        self.eps_widths = reference.eps_widths(config["program"])
        if cfg.approximate_prior:
            refresh = psteps.make_cache_refresh(self.model, cfg, mesh)
            self.bank = self.bank._replace(
                cache_means=refresh(self.bank.images, generator=self.gen))

    def receive(self, steps: int, with_noise: bool, perm=None, noise=None):
        """The call's rows (steps, B) and its per-step noise, rank 0's on
        every rank."""
        b = self.cfg.batch_size
        perm = _broadcast(perm, (steps, b), torch.int64, self.device)
        if not with_noise:
            return perm, None
        c, h, w = self.cfg.input_size
        out = []
        for i in range(steps):
            u, eps = noise[i] if noise is not None else (None, None)
            eps = (eps,) if isinstance(eps, torch.Tensor) else eps
            u = _broadcast(u, (b, h, w, c), torch.float32, self.device)
            eps = tuple(_broadcast(None if eps is None else eps[j], (b, k),
                                   torch.float32, self.device)
                        for j, k in enumerate(self.eps_widths))
            out.append((u, eps[0] if len(eps) == 1 else eps))
        return perm, out

    def command(self, op: str = "", steps: int = 0, noise: bool = False):
        """Rank 0's command ``op`` (a call's ``steps`` and whether noise
        follows) on every rank; the others pass nothing."""
        t = torch.tensor([COMMANDS.index(op) if op else -1, steps,
                          int(noise)], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0)
        op, steps, noise = t.tolist()
        return COMMANDS[op], steps, bool(noise)

    def report(self):
        """Every rank's card memory peak and banned modules, on rank 0 (a
        list by rank; None on the others)."""
        mine = {"peak": self.memory_peak(), "banned": banned_loaded()}
        got = [None] * self.mesh.size if self.mesh.rank == 0 else None
        dist.gather_object(mine, got, dst=0)
        return got

    def call(self, perm, noise=None):
        """One call of the epoch function; its mean loss over the mesh, on
        the device."""
        self.state, metrics = self.epoch_fn(
            self.state, self.train_x, self.train_idx, perm, self.bank,
            self.beta, generator=self.gen, noise=noise)
        return metrics["loss"]

    def params_gap(self) -> torch.Tensor:
        """The largest |p_r - p_0| over every leaf and rank (NaN as inf),
        on every rank's device."""
        flat = torch.cat([p.detach().reshape(-1)
                          for p in self.model.parameters()])
        ref = _broadcast(flat.clone() if self.mesh.rank == 0 else None,
                         flat.shape, flat.dtype, self.device)
        gap = (flat - ref).abs().max().reshape(1)
        gap = torch.nan_to_num(gap, nan=math.inf)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return gap

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def _join(backend: str, store, rank: int, world: int, device):
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S), **kw)


def _leave(graceful: bool = True):
    """Leave the group: with every rank (``graceful``), or alone after a
    failure, when NCCL's teardown could wait for a lost rank: the group is
    aborted."""
    if not dist.is_initialized():
        return
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if graceful or dist.get_backend() != "nccl" or abort is None:
        dist.destroy_process_group()
    else:
        abort()


# --- rank 0's side ---

def _cpu_sets(n_ranks: int, own=None, allowed=None) -> list:
    """CPUS_PER_RANK CPUs for each of ``n_ranks`` children, the highest
    first, from ``allowed`` (default: the parent's mask, the CPUs run.py
    could use before it narrowed its own) outside ``own`` (this process's).
    Empty lists where this process was not narrowed; raises where too few
    CPUs are left."""
    own = set(os.sched_getaffinity(0) if own is None else own)
    if allowed is None:
        allowed = set(os.sched_getaffinity(os.getppid()))
    free = sorted(set(allowed) - own)
    if not free:
        return [[] for _ in range(n_ranks)]
    if len(free) < CPUS_PER_RANK * n_ranks:
        raise RuntimeError(
            f"the mesh's {n_ranks} child ranks need {CPUS_PER_RANK} CPUs "
            f"each outside rank 0's {sorted(own)}; only {free} are left")
    return [free[len(free) - CPUS_PER_RANK * (i + 1):
                 len(free) - CPUS_PER_RANK * i] for i in range(n_ranks)]


def _child_devices(device, n: int) -> list:
    if device.type != "cuda":
        return [str(device)] * n
    others = [i for i in range(torch.cuda.device_count())
              if i != device.index]
    if len(others) < n:
        raise RuntimeError(f"the mesh needs {n + 1} cards; found "
                           f"{torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in others[:n]]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


class Ranks:
    """Ranks 1 .. W-1 as child processes, the store they start from, and
    the thread that watches them."""

    def __init__(self, spec: dict, device):
        w = spec["world"]
        self.store = dist.TCPStore("127.0.0.1", 0, w, is_master=True,
                                   timeout=timedelta(seconds=WAIT_S),
                                   wait_for_workers=False)
        self.kv = dist.PrefixStore("kind", self.store)
        self.kv.set("spec", json.dumps(spec))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(manifest.BENCH_DIR), str(ROOT)]
            + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        cpus = _cpu_sets(w - 1)
        devices = _child_devices(device, w - 1)
        self.procs = []
        self._finalizer = weakref.finalize(self, _kill, self.procs)
        for r in range(1, w):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.kinds.train_mesh",
                 "--rank", str(r), "--port", str(self.store.port),
                 "--device", devices[r - 1],
                 "--cpus", ",".join(map(str, cpus[r - 1])),
                 "--threads", str(torch.get_num_threads())],
                cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL))
        _log(f"ranks 1-{w - 1} started on {devices}, CPUs {cpus} (rank 0: "
             f"{sorted(os.sched_getaffinity(0))}), backend {spec['backend']}")
        self.backend = spec["backend"]
        self.failure = None
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watcher, daemon=True)
        self._watch.start()

    def _watcher(self):
        while not self._done.wait(POLL_S):
            # every rank found exited at once: the first to fail makes the
            # others' collectives fail, and may be seen in the same sweep
            lost = [f"rank {r} exited with code {p.returncode}"
                    for r, p in enumerate(self.procs, 1)
                    if p.poll() not in (None, 0)]
            if lost:
                self._lost("; ".join(lost))
                return

    def _lost(self, why: str):
        """A rank failed: stop the others and abort an NCCL group, whose
        collectives would otherwise wait GROUP_TIMEOUT_S for the lost rank
        (gloo's raise at once). Where rank 0's thread still has not
        returned GRACE_S later, this process exits."""
        if self.failure is None:
            self.failure = why
        _log(f"{why}: stopping every rank")
        _kill(self.procs)
        if self.backend != "nccl":
            return
        try:
            _leave(graceful=False)
        except (RuntimeError, ValueError) as e:
            _log(f"the group could not be aborted: {e}")
        if not self._done.wait(GRACE_S):
            _log(f"rank 0 still waits on the lost rank {GRACE_S} s later: "
                 f"exiting")
            os._exit(EXIT_LOST)

    def check(self):
        if self.failure is not None:
            raise RuntimeError(f"the mesh lost a rank: {self.failure}")

    def settle(self, seconds: float = 2.0):
        """After an error on rank 0: give a failing child ``seconds`` to
        exit, so that its code names the failure."""
        end = time.monotonic() + seconds
        while self.failure is None and time.monotonic() < end:
            if any(p.poll() not in (None, 0) for p in self.procs):
                time.sleep(2 * POLL_S)
                break
            time.sleep(POLL_S)

    def wait_ready(self):
        """Once every child has set its ``ready`` key; raises when a child
        exits or WAIT_S pass first."""
        keys = [f"ready/{r}" for r in range(1, len(self.procs) + 1)]
        end = time.monotonic() + WAIT_S
        while not self.kv.check(keys):
            self.check()
            if time.monotonic() > end:
                self.failure = self.failure or (
                    f"the ranks were not ready within {WAIT_S} s")
                self.kill()
                self.check()
            time.sleep(POLL_S)

    def stop(self):
        """Wait for the children to exit (after a "stop" command), then
        stop the watcher; kills what is left."""
        end = time.monotonic() + WAIT_S
        for p in self.procs:
            try:
                p.wait(timeout=max(end - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        self._done.set()
        self._watch.join(timeout=5)
        _kill(self.procs)
        codes = [p.returncode for p in self.procs]
        if self.failure is None and any(codes):
            self.failure = f"the ranks exited with codes {codes}"

    def kill(self):
        self._done.set()
        _kill(self.procs)


class Program:
    """The port's training objects on every rank of the mesh: ranks 1 ..
    W-1 in child processes, rank 0 here, on ``ctx.device``. ``backend``:
    NCCL on cards, gloo on the CPU by default. ``plant`` a fault for the
    tests: ``"grads_over_w_minus_1"`` on every rank, or ``"rank_raises"``
    (the last rank raises at its first call). Freed, it stops its ranks."""

    def __init__(self, ctx, inputs, *, backend=None, plant=None):
        dev = ctx.device
        w = world_size(ctx.config)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        self.ranks = Ranks(dict(config=ctx.config, seed=ctx.seed, world=w,
                                backend=backend, plant=plant), dev)
        self._stopped = False
        with self._guard():
            self.ranks.wait_ready()
            _join(backend, self.ranks.store, 0, w, dev)
            self.rank = RankProgram(ctx.config, ctx.seed, dev, plant,
                                    train_x=inputs.train_x,
                                    weights=inputs.weights)
        self.cfg, self.model = self.rank.cfg, self.rank.model
        self.world = w

    @contextlib.contextmanager
    def _guard(self):
        """Any error: stop every rank, and raise naming the rank that
        failed where one did."""
        try:
            yield
        except Exception as e:
            self.ranks.settle()
            why = self.ranks.failure
            self.abort()
            if why is None:
                raise
            raise RuntimeError(f"the mesh lost a rank: {why}") from e

    def send(self, perm, noise=None):
        """Give every rank the call's rows and noise."""
        with self._guard():
            self.rank.command("call", perm.shape[0], noise is not None)
            return self.rank.receive(perm.shape[0], noise is not None,
                                     perm=perm, noise=noise)

    def run(self, perm, noise=None) -> float:
        """Rank 0's part of a call that send() announced; the host read of
        the mesh's mean loss."""
        with self._guard():
            loss = float(self.rank.call(perm, noise))
            self.ranks.check()
        return loss

    def call(self, perm, noise=None) -> float:
        """One call of the epoch function on every rank on ``perm``
        (steps, B), ended by the host read of the mesh's mean loss."""
        perm, noise = self.send(perm, noise)
        return self.run(perm, noise)

    def params_gap(self) -> float:
        with self._guard():
            self.rank.command("gap")
            return float(self.rank.params_gap())

    def stop(self) -> int:
        """Stop every rank; the largest memory peak of their cards. Raises
        when a rank failed or loaded a banned module."""
        with self._guard():
            self.rank.command("stop")
            reports = self.rank.report()
        self._stopped = True
        _leave()
        self.ranks.stop()
        for r, a in enumerate(reports):
            if a["banned"]:
                raise RuntimeError(f"rank {r} loaded modules that the port "
                                   f"must not load: {a['banned']}")
        self.ranks.check()
        return max(a["peak"] for a in reports)

    def abort(self):
        """Stop every rank (after a failure; after stop() a no-op)."""
        self._stopped = True
        self.ranks.kill()
        try:
            _leave(graceful=False)
        except (RuntimeError, ValueError) as e:   # the watcher's abort won
            _log(f"the group was left already: {e}")

    def __del__(self):
        if not getattr(self, "_stopped", True):
            try:
                self.stop()
            except RuntimeError:
                self.abort()


def first_steps(prog: Program, inputs) -> dict:
    """train_epochs.first_steps on the mesh, and after them
    ``rank_params_gap``."""
    got = train_epochs.first_steps(prog, inputs)
    got["rank_params_gap"] = prog.params_gap()
    return got


def numbers(got: dict, want: dict) -> dict:
    """train_epochs.numbers and ``rank_params_gap`` (0 for one process,
    the reference: it holds one copy of the params)."""
    out = train_epochs.numbers(got, want)
    out["rank_params_gap"] = float(got.get("rank_params_gap", 0.0))
    return out


def checks(ctx, got: dict, want: dict) -> list:
    found = numbers(got, want)
    return [(name, found[name], limit)
            for name, limit in ctx.config["limits"][KIND].items()]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    dev, traffic = ctx.device, ctx.traffic
    ctx.mark("imports")
    inputs = make_inputs(ctx)
    ctx.mark("data and weights")
    prog = Program(ctx, inputs)
    try:
        ctx.mark("program")
        got = first_steps(prog, inputs)
        ctx.mark("first steps")
        ctx.say(f"first steps: losses {got['losses']}, rank_params_gap "
                f"{got['rank_params_gap']}")
        cfg, w = prog.cfg, prog.world
        n = inputs.train_x.shape[0]
        wgen = torch.Generator(device=dev).manual_seed(
            sub_seed(ctx.seed, "window"))
        prog.call(Slices(n, cfg.batch_size, traffic["warm_steps"], wgen,
                         dev).next())
        ctx.mark("warm-up call")
        slices = Slices(n, cfg.batch_size, traffic["steps_per_call"], wgen,
                        dev)
        _sync(dev)

        t_start = time.perf_counter()
        setup_s = t_start - ctx.t0
        steps = failed = 0
        t_end = t_start
        while True:
            perm = slices.next()
            loss = prog.call(perm)
            t_call, t_end = t_end, time.perf_counter()
            ctx.say(f"call of {perm.shape[0]} steps: {t_end - t_call:.4f} s")
            steps += perm.shape[0]
            if not math.isfinite(loss):
                failed += perm.shape[0]
            if t_end - t_start >= ctx.seconds:
                break
        window_s = t_end - t_start
        ctx.say(f"window: {steps} steps in {window_s:.3f} s")

        readings = None
        if ctx.trace:
            before = program.lse_launches()
            perm, _ = prog.send(Slices(n, cfg.batch_size,
                                       traffic["profile_steps"], wgen,
                                       dev).next())
            _, summary = profile_stretch(lambda: prog.run(perm), dev)
            pcfg = ctx.config["program"]
            readings = Readings(
                kind=KIND, units=perm.shape[0], trace=summary,
                window_s=window_s, window_units=steps,
                flops_per_unit=ctx.flops.step_flops(pcfg) / w,
                lse_calls_per_unit=ctx.flops.lse_calls_step(pcfg),
                lse_launches=program.lse_launches() - before)
        peak = prog.stop()
    finally:
        prog.abort()
    del prog
    release()

    want = reference_outputs(ctx, inputs)
    return {"e2e": {"train_images_per_s": steps * cfg.batch_size / window_s,
                    "setup_s": setup_s},
            "attempted": steps, "failed": failed,
            "checks": checks(ctx, got, want), "memory_peak_bytes": peak,
            "readings": readings}


# --- ranks 1 .. W-1 ---

def _pin(cpus: str):
    """Take the CPUs ``cpus`` ("2,3"; none given: keep the inherited
    mask); raises where they are not taken."""
    if not cpus:
        return
    want = {int(c) for c in cpus.split(",")}
    try:
        os.sched_setaffinity(0, want)
    except OSError as e:
        raise RuntimeError(f"CPUs {sorted(want)} not taken: {e}") from e
    if os.sched_getaffinity(0) != want:
        raise RuntimeError(f"CPUs {sorted(want)} not taken: the mask is "
                           f"{sorted(os.sched_getaffinity(0))}")


def _watch_parent():
    """Exit when rank 0's process is gone (this process is handed to
    another parent), wherever this rank waits."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(EXIT_LOST)

    threading.Thread(target=watch, daemon=True).start()


def child(argv=None) -> int:
    """One rank; returns its exit code. An error prints its traceback and
    ends the process at once, without leaving the group, which could wait
    for the others (rank 0 then stops them)."""
    try:
        return _child(argv)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _child(argv=None) -> int:
    _watch_parent()
    p = argparse.ArgumentParser(description="one rank of train_mesh")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--cpus", default="")
    p.add_argument("--threads", type=int, default=1)
    a = p.parse_args(argv)
    _pin(a.cpus)
    torch.set_num_threads(a.threads)
    store = dist.TCPStore("127.0.0.1", a.port, is_master=False,
                          timeout=timedelta(seconds=WAIT_S))
    kv = dist.PrefixStore("kind", store)
    spec = json.loads(kv.get("spec"))
    dev = torch.device(a.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kv.set(f"ready/{a.rank}", "1")
    _join(spec["backend"], store, a.rank, spec["world"], dev)
    rank = RankProgram(spec["config"], spec["seed"], dev, spec["plant"])
    while True:
        op, steps, noise = rank.command()
        if op == "call":
            if (spec["plant"] == "rank_raises"
                    and a.rank == spec["world"] - 1):
                raise RuntimeError("the planted fault: this rank raises")
            rank.call(*rank.receive(steps, noise))
        elif op == "gap":
            rank.params_gap()
        else:
            rank.report()
            _leave()
            return 4 if banned_loaded() else 0


if __name__ == "__main__":
    sys.exit(child())
