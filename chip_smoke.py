#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (exemplar_vae_tpu_torch) on one NVIDIA card
and check it. Run from the repository root:

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result lines:

1. a CUDA card is present, and importing the port loads no JAX;
2. every kernel is built from the sources in the checkout (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, fp32 and
   bf16 inputs, at the serving shape (B = N = 50 000, D = 40, no LOO) and
   the train shape (B = 100, N = 50 000, LOO), with ~1% invalid exemplars
   and an N that no tile divides; kernel, plain, library-yardstick and
   bound times (the library yardstick is freed before phase 4);
4. the serving path of BASELINE Config 1 at full width: a seeded VAE
   (784-300-300-40, fp32), a 50 000-image synthetic binarized bank encoded
   by make_eval_bank_fn, 3 score_nll requests of 100 points at S = 5000,
   MB = 500, generate of 100 and reference_generate of 16. The launch
   counts, set to 0 just before and read just after, must show the kernel
   ran once per round; the first request is re-scored with the blockwise
   scan prior on the card with the same noise;
5. the kernels line, the card's name and power limit, and the ok line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# fp32: the kernel's three TF32 products carry fp32 accuracy (the dropped
# lo.lo is ~2^-22 relative) and both sides sum in another order; bf16: exact
# products of bf16-rounded inputs, summed in another order (stated looser for
# margin).
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 1e-4)}     # (atol, rtol)
NLL_RTOL = 1e-5
# H100 SXM data sheet: HBM rate and dense peak rates (fp32 SIMT pipes, TF32
# and bf16 tensor cores); exponentials: 16 per clock per SM on the SFU
HBM_BYTES_PER_S = 3.35e12
FP32_OPS, TF32_OPS, BF16_OPS = 67e12, 495e12, 989e12
SFU_EXP_PER_CLOCK = 16
N_BANK, D = 50_000, 40
# pairwise_lse times of the SIMT fp32 kernel that the tensor-core design
# replaced (PERF.md, same script, H100 80GB HBM3 at 700 W), printed beside
# this run's for reference only
SIMT_MS = {("serving", "float32"): 10.3132, ("serving", "bfloat16"): 10.3422,
          ("train", "float32"): 0.0761, ("train", "bfloat16"): 0.0829}
N_REQUESTS, T, N_GEN, N_REF = 3, 100, 100, 16


def check(cond, msg):
    if not cond:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean ms per call over ``reps`` calls, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn):
    """Host-clock ms of one call that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_ms(fn, top=8):
    """(wall ms, device-busy ms, [(kernel, ms, calls)] of the ``top``
    kernels) of one call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return wall, busy, [(e.key[:90], e.self_device_time_total / 1e3, e.count)
                        for e in kernels[:top]]


def max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def lse_bound_ms(b, n, d, dtype, loo, sm_count, sm_hz):
    """Least time for one pairwise-LSE call, whatever implements it: the
    largest of its bytes (each input read and the output written once) over
    HBM, its 2*B*N*D cross-term flops by the fastest route that keeps the
    input type's accuracy (fp32: the SIMT pipes, or three TF32 products of
    an error-compensated split; bf16: one bf16 product) and its B*N
    exponentials on the SFU. Returns (ms, "bytes" or "operations", term)."""
    es = 4 if dtype == "float32" else 2
    nbytes = (b * d + n * d) * es + n * 4 + n + 4 + b * 4 + (b * 4 if loo else 0)
    flops = 2.0 * b * n * d
    if dtype == "float32":
        t_mma, mma = min((flops / FP32_OPS, "fp32 SIMT flops"),
                         (3 * flops / TF32_OPS, "3xTF32 tensor flops"))
    else:
        t_mma, mma = flops / BF16_OPS, "bf16 tensor flops"
    terms = {"HBM bytes": nbytes / HBM_BYTES_PER_S, mma: t_mma,
             "SFU exponentials": b * n / (sm_count * SFU_EXP_PER_CLOCK * sm_hz)}
    term = max(terms, key=terms.get)
    return (terms[term] * 1e3, "bytes" if term == "HBM bytes" else "operations",
            term)


def lse_library(z, means, log_var, data_idx, ex_idx, valid, in_dtype):
    """Yardstick only: the (B, N) logits materialised by one torch.mm and
    updated in place, then torch.logsumexp; bf16 rounds the inputs first and
    computes in fp32, the function of the kernel's bf16 variant. The port
    never calls it."""
    z = z.to(in_dtype).float()
    means = means.to(in_dtype).float()
    d = z.shape[1]
    x = torch.mm(z, means.T)
    x.mul_(-2.0).add_((z * z).sum(-1, keepdim=True))
    x.add_((means * means).sum(-1)[None]).clamp_min_(0.0)
    x.mul_(-0.5 * torch.exp(-log_var)).add_(-0.5 * d * log_var)
    eff = torch.where(valid, ex_idx, torch.full_like(ex_idx, -2))
    if data_idx is None:      # rows carry NO_LOO_IDX = -1: a column mask
        x.masked_fill_(((eff == -2) | (eff == -1))[None], -1e30)
    else:
        x.masked_fill_((eff == -2)[None] | (data_idx[:, None] == eff[None]),
                       -1e30)
    return torch.logsumexp(x, dim=-1)


def kernel_phase(pl):
    g = torch.Generator("cuda").manual_seed(0)
    dev = torch.device("cuda")
    means = torch.randn((N_BANK, D), generator=g, device=dev)
    ex_idx = torch.arange(N_BANK, dtype=torch.int32, device=dev)
    valid = torch.rand(N_BANK, generator=g, device=dev) >= 0.01
    log_var = torch.tensor(-0.5, device=dev)
    check(N_BANK % 64 and N_BANK % 2048, "N must be ragged for every tile")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    sm_hz = max_sm_clock_hz()
    log(f"[kernel] bound inputs: {sm_count} SMs, max SM clock "
        f"{sm_hz / 1e6:.0f} MHz")
    results = {}
    for shape, b, loo in (("serving", 50_000, False), ("train", 100, True)):
        own = torch.randint(0, N_BANK, (b,), generator=g, device=dev)
        z = means[own] + 0.7 * torch.randn((b, D), generator=g, device=dev)
        data_idx = own.to(torch.int32) if loo else None
        args = (z, means, log_var, data_idx, ex_idx, valid)
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            got = pl.pairwise_lse(*args, in_dtype=dt)
            torch.cuda.synchronize()
            want = pl.pairwise_lse_plain(*args, in_dtype=dt)
            atol, rtol = TOL[dt_name]
            err = (got - want).abs()
            max_abs = float(err.max())
            max_rel = float((err / want.abs().clamp_min(1e-30)).max())
            ok = bool((err <= atol + rtol * want.abs()).all())
            check(bool(torch.isfinite(got).all()), f"{shape}/{dt_name}: "
                  f"non-finite kernel output")
            check(ok, f"{shape}/{dt_name}: kernel vs plain max abs "
                  f"{max_abs:.3g} rel {max_rel:.3g} > atol {atol} rtol {rtol}")
            reps = 20 if b == 50_000 else 200
            ms = cuda_ms(lambda: pl.pairwise_lse(*args, in_dtype=dt), reps)
            plain_ms = cuda_ms(
                lambda: pl.pairwise_lse_plain(*args, in_dtype=dt),
                max(reps // 10, 3), warmup=1)
            lib = lse_library(*args, in_dtype=dt)
            check(bool(((lib - want).abs()
                        <= atol + rtol * want.abs()).all()),
                  f"{shape}/{dt_name}: library yardstick disagrees")
            del lib
            library_ms = cuda_ms(lambda: lse_library(*args, in_dtype=dt),
                                 3 if b == 50_000 else 50, warmup=1)
            torch.cuda.empty_cache()
            bound_ms, bound_by, term = lse_bound_ms(b, N_BANK, D, dt_name, loo,
                                                    sm_count, sm_hz)
            results[(shape, dt_name)] = dict(
                shape=shape, dtype=dt_name, B=b, N=N_BANK, D=D, loo=loo,
                max_abs_err=max_abs, max_rel_err=max_rel, atol=atol,
                rtol=rtol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_term=term)
            log(f"[kernel] pairwise_lse {shape} B={b} N={N_BANK} D={D} "
                f"loo={loo} {dt_name}: max_abs_err={max_abs:.3e} "
                f"max_rel_err={max_rel:.3e} (atol {atol}, rtol {rtol}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
                f"({bound_by}: {term}; {100 * bound_ms / ms:.1f}% of it) "
                f"SIMT kernel {SIMT_MS[(shape, dt_name)]} ms (recorded)")
    return results


def serving_phase(pl):
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.data.loaders import (EVAL_BIN_SEED,
                                                     binarize_eval_split)
    from exemplar_vae_tpu_torch.data.synthetic import synthetic_images
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.serve import make_serving_fns
    from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn
    from exemplar_vae_tpu_torch.train.loss import Bank

    cfg = Config()          # BASELINE Config 1: fp32, exemplar prior, kernel
    check(cfg.model_name == "vae" and cfg.hidden_size == 300
          and cfg.z1_size == D and cfg.S == 5000 and cfg.MB == 500
          and cfg.use_pallas_prior and cfg.compute_dtype == "float32",
          "Config defaults are not BASELINE Config 1")
    t0 = time.perf_counter()
    bank_x, _ = synthetic_images(N_BANK, 28, 28, 1, seed=1)
    bank_x = binarize_eval_split(bank_x, np.random.RandomState(EVAL_BIN_SEED))
    test_x, _ = synthetic_images(N_REQUESTS * T, 28, 28, 1, seed=2)
    test_x = binarize_eval_split(test_x, np.random.RandomState(EVAL_BIN_SEED))
    data_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    model = create_model(cfg, device="cuda", seed=0).eval()
    rounds = -(-cfg.S // cfg.MB)
    r = cfg.MB
    gen, ref, score = make_serving_fns(model, cfg, N_BANK, N_GEN, rounds, r)
    g = torch.Generator("cuda").manual_seed(cfg.seed)
    eps0 = torch.randn((rounds, T * r, D), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts 0 just before, read just after ----
    pl.pairwise_lse.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = Bank(images=torch.from_numpy(bank_x).to(dev),
                data_idx=torch.arange(N_BANK, dtype=torch.int32, device=dev),
                valid=torch.ones(N_BANK, dtype=torch.bool, device=dev),
                cache_means=None, n_effective=N_BANK)
    eb = make_eval_bank_fn(model, cfg)(bank)
    torch.cuda.synchronize()
    bank_ms = (time.perf_counter() - t0) * 1e3
    nlls, req_ms = [], []
    for i in range(N_REQUESTS):
        xc = test_x[i * T:(i + 1) * T]
        t0 = time.perf_counter()
        out = score(xc, eb.cache_means, eb.data_idx, eb.valid,
                    eps=eps0 if i == 0 else None, generator=g)
        nlls.append(out.cpu())
        req_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    imgs = gen(eb.cache_means, generator=g)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    refs = ref(test_x[:N_REF], generator=g)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    launches = pl.pairwise_lse.launches
    # ---- end of the main path ----

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == N_REQUESTS * rounds,
          f"pairwise_lse launched {launches} times on the serving path, "
          f"want requests x rounds = {N_REQUESTS * rounds}")
    for i, nll in enumerate(nlls):
        check(nll.shape == (T,) and bool(torch.isfinite(nll).all())
              and bool((nll > 0).all()), f"request {i}: NLL not finite "
              f"and positive: {nll[:5]}")
    check(tuple(imgs.shape) == (N_GEN, 28, 28, 1)
          and bool(torch.isfinite(imgs).all())
          and float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0,
          f"generate gave {tuple(imgs.shape)} outside [0, 1]")
    check(tuple(refs.shape) == (N_REF, 28, 28, 1)
          and bool(torch.isfinite(refs).all()), "reference_generate output")

    # reference on the same inputs: the blockwise scan prior, same noise
    _, _, score_scan = make_serving_fns(
        model, cfg.replace(use_pallas_prior=False), N_BANK, N_GEN, rounds, r)
    plain = score_scan(test_x[:T], eb.cache_means, eb.data_idx, eb.valid,
                       eps=eps0).cpu()
    nll_err = float((nlls[0] - plain).abs().max())
    check(bool(((nlls[0] - plain).abs() <= NLL_RTOL * plain.abs()).all()),
          f"kernel vs scan NLL max abs diff {nll_err:.3g} > rtol {NLL_RTOL}")
    steady = sorted(req_ms[1:])[len(req_ms[1:]) // 2]
    gen_warm_ms = wall_ms(lambda: gen(eb.cache_means, generator=g))
    ref_warm_ms = wall_ms(lambda: ref(test_x[:N_REF], generator=g))
    prof = profile_ms(lambda: score(test_x[T:2 * T], eb.cache_means,
                                    eb.data_idx, eb.valid, generator=g))
    log(f"[serve] Config 1: VAE 784-{cfg.hidden_size}-{cfg.hidden_size}-"
        f"{cfg.z1_size} fp32, bank N={N_BANK}, S={cfg.S}, MB={r}, "
        f"{rounds} rounds of B={T * r} rows per request")
    log(f"[serve] synthetic data {data_s:.2f} s (host); bank encode "
        f"{bank_ms:.2f} ms")
    log(f"[serve] score_nll ms per request of {T} points: "
        f"{[round(v, 3) for v in req_ms]} (first includes warm-up); "
        f"steady {steady:.3f} ms = {T / steady * 1e3:.1f} points/s, "
        f"{T * cfg.S / steady * 1e3:.4g} importance samples/s")
    log(f"[serve] mean NLL per request: {[float(n.mean()) for n in nlls]}; "
        f"kernel vs scan on request 0: max abs diff {nll_err:.3e} "
        f"(rtol {NLL_RTOL})")
    log(f"[serve] generate {N_GEN}: first {gen_ms:.3f} ms, warm "
        f"{gen_warm_ms:.3f} ms = {N_GEN / gen_warm_ms * 1e3:.1f} samples/s; "
        f"reference_generate {N_REF}: first {ref_ms:.3f} ms, warm "
        f"{ref_warm_ms:.3f} ms = {N_REF / ref_warm_ms * 1e3:.1f} samples/s")
    wall, busy, top = prof
    if top:
        log(f"[profile] one score_nll request (outside the counted run): "
            f"wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
        for name, ms, calls in top:
            log(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}% "
                f"x{calls:<4d} {name}")
    else:
        log(f"[profile] wall {wall:.3f} ms; the profiler recorded no device "
            f"time: device busy share not measured")
    log(f"[serve] pairwise_lse launches on the path: {launches} "
        f"(= {N_REQUESTS} requests x {rounds} rounds); peak memory "
        f"{peak_gb:.2f} GB")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    from exemplar_vae_tpu_torch.device import resolve_device
    from exemplar_vae_tpu_torch.ops import pairwise_lse as pl

    banned = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "flax", "optax",
                                     "exemplar_vae_tpu")]
    check(not banned, f"the port imported {banned}")
    resolve_device("cuda")            # TF32 off for matmuls and cuDNN
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    build_s = pl.build(verbose=True)       # prints ptxas registers/spills
    log(f"[build] pairwise_lse.cu: nvcc + load {build_s:.2f} s")

    kern = kernel_phase(pl)
    launches = serving_phase(pl)

    main_v = kern[("serving", "float32")]
    entry = {
        "name": "pairwise_lse", "route": "cuda",
        "source": "exemplar_vae_tpu_torch/csrc/pairwise_lse.cu",
        "replaces": "exemplar_vae_tpu/ops/pallas_lse.py:45",
        "launches": launches, "max_abs_err": main_v["max_abs_err"],
        "ms": main_v["ms"], "plain_ms": main_v["plain_ms"],
        "bound_ms": main_v["bound_ms"], "bound_by": main_v["bound_by"],
        "library_ms": main_v["library_ms"],
        "variants": list(kern.values()),
    }
    log(f"[done] {time.perf_counter() - t0:.1f} s after the build started")
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
