"""Training traffic: a closed loop over the port's epoch function.

Set-up makes the data (the training set, whose first N images are the
exemplar bank), the weights and the program: the model, its AdamNormGrad
state, ``make_epoch_fn``'s epoch function and, for the approximate prior,
the cache from ``make_cache_refresh``. It then drives that same state
through the traffic's ``check_steps`` first steps, each one call of the
epoch function on rows of a seeded permutation (all different) with the
noise injected through its ``noise=`` argument, and keeps each step's
loss, every leaf's first gradient as the optimizer got it (``.grad``, which
AdamNormGrad leaves as it was: its own state holds only the normalized
gradient) and every leaf's change over the steps. A short call warms up
the generator's draws.

The window then calls the epoch function on ``steps_per_call`` steps of
batch B at a time, each call ended by one host read of its mean loss, as
Experiment.train_epoch does: whole epochs when ``steps_per_call`` is
"epoch", else consecutive slices of one epoch's permutation (a new one
when it runs out). ``train_images_per_s`` is the batch images of all
completed calls over the time from the window's start to the read that
ended the last one.

Once the window has closed and the memory peak is read, the program is
freed and the plain reference follows the first steps from the same
weights, rows and noise; ``correct`` compares the losses, the first
gradients and the changes (portbench/compare.py)."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

from portbench import compare, data, program, weights
from portbench.common import Readings, release, sub_seed
from portbench.trace import profile_stretch

KIND = "train"


@dataclass
class Inputs:
    train_x: torch.Tensor
    weights: dict
    rows: torch.Tensor        # (check_steps, B) dataset rows of the first steps
    noise: list               # per step (u, eps tuple)


def make_inputs(ctx) -> Inputs:
    cfg, dev, seed = ctx.config["program"], ctx.device, ctx.seed
    c, h, w = cfg["input_size"]
    n, b = cfg["training_set_size"], cfg["batch_size"]
    pixels = torch.uint8 if ctx.config["data"]["pixels"] == "uint8" \
        else torch.float32
    train_x = data.blob_images(n, h, w, c, seed=seed, tag="train",
                               device=dev, out_dtype=pixels)
    wts = weights.make_weights(ctx.reference.param_spec(cfg), seed=seed,
                               device=dev)
    g = torch.Generator(device=dev).manual_seed(sub_seed(seed, "first_steps"))
    steps = ctx.traffic["check_steps"]
    rows = torch.randperm(n, generator=g, device=dev)[:steps * b].reshape(
        steps, b)
    noise = [(torch.rand((b, h, w, c), generator=g, device=dev),
              tuple(torch.randn((b, k), generator=g, device=dev)
                    for k in ctx.reference.eps_widths(cfg)))
             for _ in range(steps)]
    return Inputs(train_x, wts, rows, noise)


class Program:
    """The port's training objects for one run."""

    def __init__(self, ctx, inputs: Inputs):
        from exemplar_vae_tpu_torch.train import steps as psteps
        from exemplar_vae_tpu_torch.train.loss import Bank
        dev = ctx.device
        self.cfg = cfg = program.config(ctx.config["program"])
        self.beta = float(ctx.config["beta"])
        self.model = program.build_model(cfg, inputs.weights, dev)
        self.state = psteps.init_train_state(self.model, cfg)
        self.epoch_fn = psteps.make_epoch_fn(cfg)
        self.train_x = inputs.train_x
        n = inputs.train_x.shape[0]
        self.train_idx = torch.arange(n, dtype=torch.int32, device=dev)
        nb = cfg.number_components
        self.bank = Bank(images=inputs.train_x[:nb],
                         data_idx=torch.arange(nb, dtype=torch.int32,
                                               device=dev),
                         valid=torch.ones(nb, dtype=torch.bool, device=dev),
                         cache_means=None, n_effective=nb)
        self.gen = torch.Generator(device=dev).manual_seed(
            sub_seed(ctx.seed, "program"))
        if cfg.approximate_prior:
            refresh = psteps.make_cache_refresh(self.model, cfg)
            self.bank = self.bank._replace(
                cache_means=refresh(self.bank.images, generator=self.gen))

    def call(self, perm, noise=None) -> float:
        """One call of the epoch function on ``perm`` (steps, B), ended by
        the host read of its mean loss."""
        self.state, metrics = self.epoch_fn(
            self.state, self.train_x, self.train_idx, perm, self.bank,
            self.beta, generator=self.gen, noise=noise)
        return float(metrics["loss"])


def _eps_arg(eps: tuple):
    """The port's form of the noise: a tensor for one latent, the pair
    (eps2, eps1) for two."""
    return eps[0] if len(eps) == 1 else eps


def _leaf_norms(tensors: dict) -> dict:
    names = list(tensors)
    norms = torch.stack([tensors[k].detach().float().norm() for k in names])
    return dict(zip(names, norms.tolist()))


def first_steps(prog: Program, inputs: Inputs) -> dict:
    """Drive the program through the first steps; their losses, the first
    gradient and the change per leaf (flax names)."""
    params = {program.flax_name(k): p
              for k, p in prog.model.named_parameters()}
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grads = [], None
    for i, (u, eps) in enumerate(inputs.noise):
        losses.append(prog.call(inputs.rows[i:i + 1], noise=[(u, _eps_arg(eps))]))
        if grads is None:
            grads = _leaf_norms({k: p.grad if p.grad is not None
                                 else torch.zeros_like(p)
                                 for k, p in params.items()})
    change = _leaf_norms({k: p.detach() - start[k] for k, p in params.items()})
    return {"losses": losses, "grads": grads, "change": change}


class Slices:
    """Consecutive (steps, B) slices of seeded epoch permutations."""

    def __init__(self, n: int, batch: int, steps, generator, device):
        self.n, self.batch, self.gen, self.dev = n, batch, generator, device
        self.epoch_steps = n // batch
        self.steps = self.epoch_steps if steps == "epoch" else int(steps)
        self.perm, self.pos = None, self.epoch_steps

    def next(self):
        if self.pos + self.steps > self.epoch_steps:
            self.perm = torch.randperm(
                self.n, generator=self.gen, device=self.dev)[
                :self.epoch_steps * self.batch].reshape(-1, self.batch)
            self.pos = 0
        out = self.perm[self.pos:self.pos + self.steps]
        self.pos += self.steps
        return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference_outputs(ctx, inputs: Inputs, *, tf32: bool = False,
                      half_batch: bool = False) -> dict:
    """The plain reference through the same first steps: fp32 with TF32
    off, or (the control) with TF32 on; ``half_batch`` plants the fault
    that leaves out half of each batch."""
    cfg = ctx.config["program"]
    dev = ctx.device
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        ref = ctx.reference.Reference(cfg, weights.reference_params(
            inputs.weights))
        nb = cfg["number_components"]
        bank = {"images": inputs.train_x[:nb], "n": nb,
                "idx": torch.arange(nb, device=dev)}
        if cfg["approximate_prior"]:
            ref.refresh_cache(bank["images"], ctx.config["reference_block"])
        batches = [(inputs.train_x[r], u, eps, r)
                   for r, (u, eps) in zip(inputs.rows, inputs.noise)]
        rows = slice(0, cfg["batch_size"] // 2) if half_batch else None
        losses, grads = ref.train_steps(batches, bank,
                                        float(ctx.config["beta"]), rows=rows)
        grads = _leaf_norms(grads)
        change = _leaf_norms({k: p.detach() - inputs.weights[k]
                              for k, p in ref.p.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    return {"losses": losses, "grads": grads, "change": change}


def numbers(got: dict, want: dict) -> dict:
    """Every number a train cell can compare: the widest relative gap of
    the steps' losses; of the first gradient's norms and of the changes'
    norms the worst leaf's gap (``*_gap``) and the median leaf's
    (``*_median_gap``), the changes leaving out the leaves whose reference
    gradient is negligible."""
    skip = compare.negligible_leaves(want["grads"])
    return {
        "loss_gap": compare.relative_gap(got["losses"], want["losses"]),
        "grad_gap": compare.worst_leaf(got["grads"], want["grads"])[0],
        "change_gap": compare.worst_leaf(got["change"], want["change"],
                                         skip)[0],
        "grad_median_gap": compare.median_leaf(got["grads"], want["grads"]),
        "change_median_gap": compare.median_leaf(got["change"],
                                                 want["change"], skip)}


def checks(ctx, got: dict, want: dict) -> list:
    """[(name, value, limit)] for the numbers that the configuration's
    limits name, in their order."""
    found = numbers(got, want)
    return [(name, found[name], limit)
            for name, limit in ctx.config["limits"][KIND].items()]


def run(ctx) -> dict:
    dev, traffic = ctx.device, ctx.traffic
    ctx.mark("imports")
    inputs = make_inputs(ctx)
    ctx.mark("data and weights")
    prog = Program(ctx, inputs)
    ctx.mark("program")
    got = first_steps(prog, inputs)
    ctx.mark("first steps")
    ctx.say(f"first steps: losses {got['losses']}")
    cfg = prog.cfg
    n = inputs.train_x.shape[0]
    wgen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, "window"))
    prog.call(Slices(n, cfg.batch_size, traffic["warm_steps"], wgen,
                     dev).next())
    ctx.mark("warm-up call")
    slices = Slices(n, cfg.batch_size, traffic["steps_per_call"], wgen, dev)
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
        prof_perm = Slices(n, cfg.batch_size, traffic["profile_steps"], wgen,
                           dev).next()
        _, summary = profile_stretch(lambda: prog.call(prof_perm), dev)
        pcfg = ctx.config["program"]
        readings = Readings(
            kind=KIND, units=prof_perm.shape[0], trace=summary,
            window_s=window_s, window_units=steps,
            flops_per_unit=ctx.flops.step_flops(pcfg),
            lse_calls_per_unit=ctx.flops.lse_calls_step(pcfg),
            lse_launches=program.lse_launches() - before)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del prog
    release()

    want = reference_outputs(ctx, inputs)
    return {"e2e": {"train_images_per_s": steps * cfg.batch_size / window_s,
                    "setup_s": setup_s},
            "attempted": steps, "failed": failed,
            "checks": checks(ctx, got, want), "memory_peak_bytes": peak,
            "readings": readings}
