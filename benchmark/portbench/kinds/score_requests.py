"""Scoring traffic: one client in a closed loop of IWAE requests.

Set-up makes the bank's images (the training set, N = number_components),
the test set (binarized once where the data are dynamically binarized),
the weights and the program: the model, its eval bank from
``make_eval_bank_fn`` and ``serve.make_serving_fns(...)``'s ``score_nll``
at S samples in rounds of MB. Two requests outside the window warm it up.

Request i scores ``points`` consecutive test points (the test set's blocks
in turn) with its IWAE noise drawn on the device from a generator seeded by
(seed, i) and injected through ``eps=``; the client sends the next request
once the host has read this one's NLLs. ``score_points_per_s`` is the
points whose NLLs reached the host over the time from the window's start
to the last read; ``score_p95_ms`` the 95th percentile of the requests'
latencies, each from the call (the noise's draw included) to that read.

Once the window has closed, the memory peak is read and the program is
freed, the plain reference encodes the bank again itself and scores a
sample of the window's requests, drawn from the seed, with the same points
and noise; ``correct`` holds the widest relative gap of the NLLs to its
limit."""

from __future__ import annotations

import random
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import data, program, weights
from portbench.common import Readings, release, sub_seed
from portbench.trace import profile_stretch

KIND = "score"


@dataclass
class Inputs:
    bank_x: torch.Tensor
    test_x: torch.Tensor
    weights: dict


def make_inputs(ctx) -> Inputs:
    cfg, dev, seed = ctx.config["program"], ctx.device, ctx.seed
    c, h, w = cfg["input_size"]
    pixels = torch.uint8 if ctx.config["data"]["pixels"] == "uint8" \
        else torch.float32
    bank_x = data.blob_images(cfg["number_components"], h, w, c, seed=seed,
                              tag="train", device=dev, out_dtype=pixels)
    test_x = data.blob_images(cfg["test_set_size"], h, w, c, seed=seed,
                              tag="test", device=dev, out_dtype=pixels)
    if cfg["input_type"] == "binary" and cfg["dynamic_binarization"]:
        test_x = data.binarize(test_x, seed=seed, tag="test")
    wts = weights.make_weights(ctx.reference.param_spec(cfg), seed=seed,
                               device=dev)
    return Inputs(bank_x, test_x, wts)


def rounds(cfg: dict) -> int:
    return -(-cfg["S"] // cfg["MB"])


def request_points(ctx, inputs: Inputs, i: int):
    t = ctx.traffic["points"]
    blocks = inputs.test_x.shape[0] // t
    start = (i % blocks) * t
    return inputs.test_x[start:start + t]


def request_noise(ctx, i) -> tuple:
    """(rounds, t * MB, width) per latent, drawn on the device from
    (seed, i)."""
    cfg, dev = ctx.config["program"], ctx.device
    g = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, "iwae", i))
    shape = (rounds(cfg), ctx.traffic["points"] * cfg["MB"])
    return tuple(torch.randn(shape + (k,), generator=g, device=dev)
                 for k in ctx.reference.eps_widths(cfg))


class Program:
    """The port's serving objects for one run."""

    def __init__(self, ctx, inputs: Inputs):
        from exemplar_vae_tpu_torch import serve
        from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn
        from exemplar_vae_tpu_torch.train.loss import Bank
        dev = ctx.device
        self.cfg = cfg = program.config(ctx.config["program"])
        self.model = program.build_model(cfg, inputs.weights, dev).eval()
        nb = cfg.number_components
        self.bank = make_eval_bank_fn(self.model, cfg)(Bank(
            images=inputs.bank_x,
            data_idx=torch.arange(nb, dtype=torch.int32, device=dev),
            valid=torch.ones(nb, dtype=torch.bool, device=dev),
            cache_means=None, n_effective=nb))
        _, _, self.score = serve.make_serving_fns(
            self.model, cfg, nb, 1, rounds(ctx.config["program"]), cfg.MB)

    def request(self, x, eps: tuple) -> np.ndarray:
        """One request's NLLs, read back to the host."""
        out = self.score(x, self.bank.cache_means, self.bank.data_idx,
                         self.bank.valid,
                         eps=eps[0] if len(eps) == 1 else eps)
        return out.cpu().numpy()


def serve(ctx, prog: Program, inputs: Inputs, i: int) -> np.ndarray:
    return prog.request(request_points(ctx, inputs, i), request_noise(ctx, i))


def reference_nlls(ctx, inputs: Inputs, ids, *, tf32: bool = False) -> dict:
    """{request: NLLs} of the plain reference, which encodes the bank
    again itself; fp32 with TF32 off, or (the control) on."""
    cfg = ctx.config["program"]
    block = ctx.config["reference_block"]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        ref = ctx.reference.Reference(cfg, weights.reference_params(
            inputs.weights))
        means = ref.bank_means(inputs.bank_x, block)
        return {i: ref.iwae_nll(request_points(ctx, inputs, i),
                                request_noise(ctx, i), means,
                                cfg["number_components"], block).cpu().numpy()
                for i in ids}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags


def nll_gap(got: dict, want: dict) -> float:
    """The widest |NLL - reference NLL| / |reference NLL| over the
    compared requests' points."""
    return max(float(np.max(np.abs(got[i].astype(np.float64) - want[i])
                            / np.abs(want[i].astype(np.float64))))
               for i in want)


def sample(ctx, done: int) -> list:
    k = min(ctx.traffic["checked_requests"], done)
    return sorted(random.Random(sub_seed(ctx.seed, "sample")).sample(
        range(done), k))


def checks(ctx, got: dict, want: dict) -> list:
    return [("nll_gap", nll_gap(got, want),
             ctx.config["limits"][KIND]["nll_gap"])]


def run(ctx) -> dict:
    dev, traffic = ctx.device, ctx.traffic
    ctx.mark("imports")
    inputs = make_inputs(ctx)
    ctx.mark("data and weights")
    prog = Program(ctx, inputs)
    ctx.mark("program and eval bank")
    for i in range(traffic["warm_requests"]):
        prog.request(request_points(ctx, inputs, i),
                     request_noise(ctx, f"warm{i}"))
        ctx.mark(f"warm-up request {i}")

    nlls, lat = [], []
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    while True:
        t0 = time.perf_counter()
        nlls.append(serve(ctx, prog, inputs, len(nlls)))
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        if t_end - t_start >= ctx.seconds:
            break
    window_s = t_end - t_start
    done = len(nlls)
    failed = sum(not np.all(np.isfinite(x)) for x in nlls)
    ctx.say(f"window: {done} requests in {window_s:.3f} s")

    readings = None
    if ctx.trace:
        units = traffic["profile_requests"]
        before = program.lse_launches()
        _, summary = profile_stretch(
            lambda: [serve(ctx, prog, inputs, done + j) for j in range(units)],
            dev)
        cfg = ctx.config["program"]
        readings = Readings(
            kind=KIND, units=units, trace=summary, window_s=window_s,
            window_units=done,
            flops_per_unit=ctx.flops.request_flops(cfg, traffic["points"]),
            lse_calls_per_unit=ctx.flops.lse_calls_request(
                cfg, traffic["points"]),
            lse_launches=program.lse_launches() - before)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del prog
    release()

    ids = sample(ctx, done)
    want = reference_nlls(ctx, inputs, ids)
    got = {i: nlls[i] for i in ids}
    p95 = (statistics.quantiles(lat, n=20)[18] if len(lat) > 1 else lat[0])
    return {"e2e": {"score_points_per_s": done * traffic["points"] / window_s,
                    "score_p95_ms": 1e3 * p95, "setup_s": setup_s},
            "attempted": done, "failed": int(failed),
            "checks": checks(ctx, got, want), "memory_peak_bytes": peak,
            "readings": readings}
