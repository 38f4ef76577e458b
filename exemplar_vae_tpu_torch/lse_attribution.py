"""Attribute the pairwise-LSE kernel's time on the card to its parts.

Builds variants of csrc/pairwise_lse.cu, each with one part taken out, and
times them at the serving shape (B = N = 50 000, D = 40, no LOO), fp32 and
bf16 inputs, beside the kernel itself:

    no_exp        ex2 of each logit replaced by the logit (the SFU's share)
    no_epilogue   logits, masks and online LSE replaced by a plain sum
    hi_hi_only    fp32: the one TF32 product hi.hi (two of three MMA passes)
    no_mma        the MMAs replaced by one integer op (the tensor cores' share)
    interleaved   fp32: hi.lo, lo.hi, hi.hi per k-chunk instead of the two
                  small products over all of D first (the accumulation order)

The kernel and the interleaved order are also held against the plain version,
as the worst |error| / (atol + rtol*|lse|) at the card tolerance, at the
serving inputs and with |z|, |mu| ~ 10; the other variants compute wrong
results on purpose and only their times mean anything. Then, at the train
shape (B = 100, LOO), it compares the event time per call with the device
time of its kernels under torch.profiler, which tells launch- and host-bound
from device-bound. Run from the
repository root on a machine with a card:

    python3 -m exemplar_vae_tpu_torch.lse_attribution
"""

from __future__ import annotations

import re
import subprocess
import time

import torch

from exemplar_vae_tpu_torch.ops import pairwise_lse as pl
from exemplar_vae_tpu_torch.ops.nvcc import BUILD_DIR

_EPILOGUE = ("    // Epilogue, per row in base 2", "    __syncthreads();   // this stage is read")
_SUM = """#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      fence_operands(acc[mb]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ns = 0; ns < NS; ++ns) s[mb][h] += acc[mb][4 * ns + 2 * h] + acc[mb][4 * ns + 2 * h + 1];
    }
"""
_WGMMA_HEAD = "int accumulate) {\n  asm volatile("
_SMALL = ("          wgmma_tf32(acc[mb], za(mb, PLANES * kc), mu(PLANES * kc + 1), kc > 0);  // hi . lo\n",
          "          wgmma_tf32(acc[mb], za(mb, PLANES * kc + 1), mu(PLANES * kc), 1);       // lo . hi\n")
_HI_HI = "          wgmma_tf32(acc[mb], za(mb, PLANES * kc), mu(PLANES * kc), 1);           // hi . hi\n"
_PHASE2 = "#pragma unroll 1\n        for (int kc = 0; kc < ks; ++kc)\n" + _HI_HI


def _index(src: str, anchor: str) -> int:
    if anchor not in src:
        raise RuntimeError(f"variant anchor not found in {pl.LIB.source.name}: {anchor[:60]!r}")
    return src.index(anchor)


def _replace(src: str, old: str, new: str) -> str:
    _index(src, old)
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    a, b = (_index(src, x) for x in _EPILOGUE)
    no_mma = _replace(src, _WGMMA_HEAD, _WGMMA_HEAD.replace(
        "{\n", "{\n  d[0] += __uint_as_float((uint32_t)(a ^ b));\n  return;\n", 1))
    hi_hi = src
    for line in _SMALL:
        hi_hi = _replace(hi_hi, line, "")
    interleaved = _replace(_replace(src, _PHASE2, ""), _SMALL[1], _SMALL[1] + _HI_HI)
    return {
        "kernel": src,
        "no_exp": _replace(src, "sum += ex2(l[4 * ns + 2 * h] - tmax) + ex2(l[4 * ns + 2 * h + 1] - tmax);",
                           "sum += (l[4 * ns + 2 * h] - tmax) + (l[4 * ns + 2 * h + 1] - tmax);"),
        "no_epilogue": src[:a] + _SUM + src[b:],
        "hi_hi_only": hi_hi,
        "no_mma": no_mma,
        "interleaved": interleaved,
    }


def _tol_ratio(got, want, atol=1e-4, rtol=1e-5):
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _kernel_name(key: str) -> str:
    found = re.search(r"\w+_kernel\w*(<\w+>)?", key)
    return found.group(0) if found else key[:40]


def cuda_ms(fn, reps, warmup=2):
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


def _inputs(b, n, d, loo, g):
    dev = torch.device("cuda")
    means = torch.randn((n, d), generator=g, device=dev)
    ex_idx = torch.arange(n, dtype=torch.int32, device=dev)
    valid = torch.rand(n, generator=g, device=dev) >= 0.01
    own = torch.randint(0, n, (b,), generator=g, device=dev)
    z = means[own] + 0.7 * torch.randn((b, d), generator=g, device=dev)
    return (z, means, torch.tensor(-0.5, device=dev),
            own.to(torch.int32) if loo else None, ex_idx, valid)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("lse_attribution needs a CUDA card")
    from exemplar_vae_tpu_torch.device import resolve_device
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[attribution] {smi}", flush=True)
    g = torch.Generator("cuda").manual_seed(0)
    args = _inputs(50_000, 50_000, 40, False, g)
    s10 = 10 / 40 ** 0.5
    checks = {"serving": args,
              "norms 10": (args[0] * s10, args[1] * s10) + args[2:]}
    want = {k: pl.pairwise_lse_plain(*a) for k, a in checks.items()}
    source = pl.LIB.source
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        for name, src in variants(source.read_text()).items():
            path = out_dir / f"{name}.cu"
            path.write_text(src)
            pl.LIB.source, pl.LIB.lib = path, None
            pl.build()
            for dt in (torch.float32, torch.bfloat16):
                if name in ("hi_hi_only", "interleaved") and dt == torch.bfloat16:
                    continue
                ms = cuda_ms(lambda: pl.pairwise_lse(*args, in_dtype=dt), 20)
                err = ""
                if name in ("kernel", "interleaved") and dt == torch.float32:
                    err = "; worst error / tolerance: " + ", ".join(
                        f"{k} {_tol_ratio(pl.pairwise_lse(*a), want[k]):.3f}"
                        for k, a in checks.items())
                print(f"[attribution] serving {str(dt)[6:]:8s} {name:12s} "
                      f"ms={ms:.4f}{err}", flush=True)
    finally:
        pl.LIB.source, pl.LIB.lib = source, None
    pl.build()

    from torch.profiler import ProfilerActivity, profile
    targs = _inputs(100, 50_000, 40, True, g)
    for dt in (torch.float32, torch.bfloat16):
        call = lambda: pl.pairwise_lse(*targs, in_dtype=dt)  # noqa: E731
        event_ms = cuda_ms(call, 200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host_ms = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                call()
            torch.cuda.synchronize()
        kernels = [(_kernel_name(e.key), e.self_device_time_total / 50e3)
                   for e in prof.key_averages() if e.self_device_time_total > 0]
        device_ms = sum(ms for _, ms in kernels)
        print(f"[attribution] train {str(dt)[6:]:8s} event ms/call "
              f"{event_ms:.4f}, host enqueue ms/call {host_ms:.4f}, device "
              f"ms/call {device_ms:.4f}: "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in kernels), flush=True)


if __name__ == "__main__":
    main()
