#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (exemplar_vae_tpu_torch) on one NVIDIA card
and check it. Run from the repository root:

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result lines:

1. a CUDA card is present, and importing the port loads no JAX;
2. every kernel is built from the sources in the checkout (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, fp32 and
   bf16 inputs, at every shape the paths give it (KERNEL_SHAPES): serving
   (B = N = 50 000, D = 40, no LOO; also Config 3's IWAE shape), train
   (B = 100, N = 50 000, LOO), validation (B = 100 and its tail of 56, no
   LOO), the CLI runs' IWAE chunks (B = 800 and its tail of 448, no LOO),
   Config 4's IWAE round (B = 5000) and validation (B = 100 and 56) over
   N = 200 000, and one rank's train step on a mesh of 2 (B = 100, N =
   25 000, LOO), with ~1% invalid exemplars (N = 50 000: an N that no tile
   divides); kernel, plain, library-yardstick and bound times (the library
   yardstick is freed before phase 5); at the train shape, the entry
   against the custom op's CUDA kernel function alone (the op's host cost).
   [epilogue]: the PixelHVAE masked layers' epilogue (ops/masked_epilogue.py)
   at the serving shape, one masked layer of a pixelhvae-exact-score round
   (50 000 rows of (64, 28, 28), fp32), against its plain version (bias
   add, context add, ReLU) on a copy of the same inputs: bitwise; kernel
   and plain ms by CUDA events and the bound (h and ctx read and h written
   once over HBM). [gate]: the gated convs' epilogue
   (ops/gated_epilogue.py) at Config 4's three decoder layers, one
   convhvae-knn-score round each (5 000 rows: (512, 16, 16) and (256, 32,
   32) with 2x2 phases, (64, 64, 64) without), and at Config 3's, one
   round of [config3]'s IWAE request (50 000 rows: (512, 7, 7) and (256,
   14, 14) with 2x2 phases, which take the scalar kernel, (64, 28, 28)
   without) and its encoder's last layer over the eval bank (50 000 rows
   of (128, 7, 7), the scalar kernel without phases), against its plain
   version (depth-to-space bias add, sigmoid, product) on the same input:
   bitwise; kernel and plain ms by CUDA events and the bound (the 2F
   channels read and the F gated ones written once over HBM), each Config
   4 call within 1.25x it; the launches counted over the phase;
4. [ingest]: the native parsers (data/native_ingest.py, built with g++)
   against numpy on a 60 000 x 28 x 28 IDX file and a 10 000-row .amat
   file: equal arrays, the build's and both parsers' times (host only);
5. the serving path of BASELINE Config 1 at full width: a seeded VAE
   (784-300-300-40, fp32), a 50 000-image synthetic binarized bank encoded
   by make_eval_bank_fn, 3 score_nll requests of 100 points at S = 5000,
   MB = 500, generate of 100 and reference_generate of 16. The launch
   counts, set to 0 just before and read just after, must show the kernel
   ran once per round; the first request is re-scored with the blockwise
   scan prior on the card with the same noise. Then the export round trip:
   export_serving_bundle writes the model, the eval bank and three
   torch.export programs exported on the card; a child process
   (``--serve-bundle``) that loads no model code, no JAX and nothing of the
   JAX package serves them through ServingBundle.load: the first request's
   score_nll (its live noise injected) and a generate with injected noise
   equal the live functions' bitwise, each program request launches the
   kernel once per round (counted in the child, the kernels line's
   "serve_program"); export, load and child seconds, the bundle's MB, the
   program's ms per request beside the live path's;
6. the training path of BASELINE Config 1 at the settings of the JAX
   package's bench.py::measure_ours: the VAE at 784-300-300-40 on 50 000
   synthetic 28x28 images with dynamic binarization, the exact exemplar
   prior over all N = 50 000 (LOO, N-1 denominator) through the kernel,
   batch 100, bf16 compute, the bank re-encoded in one piece without
   recompute. (a) a warm-up, then one timed 200-step epoch call: ms/step,
   images/s, exemplar distances/s, peak memory; (b) the launch count, set
   to 0 just before the timed call and read just after, must equal the
   steps; (c) a 10-step call under torch.profiler: the device's busy and
   idle shares, the top kernels and host operators, and the host
   synchronizations of a 3-step call; the prior alone at the train shape
   (kernel forward, torch backward, device ms of each and the backward's
   bound); (d) one train step at fp32 compute from
   the same params and noise with the kernel prior and with the scan prior:
   loss within rtol 1e-5, each gradient tensor within GRAD_REL of its
   largest element. Then the CLI (python -m exemplar_vae_tpu_torch.main)
   trains one epoch into a temporary snapshot directory (val/test 256,
   S = MB = 8) and its metrics.jsonl and results.json must hold finite
   numbers;
7. [trajectory], Config 1's whole training run through the port's
   Experiment at full width: the VAE at 784-300-300-40 on 50 000 static
   binary synthetic 28x28 images, the exact prior over all N = 50 000
   (LOO), batch 100, fp32 with TF32 off, plain Adam, 3 epochs with a
   2-epoch warm-up, validation over 10 000 images after each epoch, the
   final IWAE on the best params cut to 100 test points at S = 5000,
   MB = 500. It runs twice from one seed (the same Philox draws), once
   through the kernel and once through the blockwise scan prior: every
   epoch's validation loss and the final IWAE NLL within TRAJ_NATS, the
   same best flags and epochs trained; the kernel run launches the kernel
   once per train step (1500), per validation batch (400) and per IWAE
   round (10), counted per path, and the scan run never; each run's
   seconds per epoch;
8. BASELINE Config 3, the JAX package's bench row 3 at full width: the
   two-level ConvHVAE (default conv spec, hidden 300, z1 = z2 = 40) on
   fashion_mnist (with no IDX files on disk its 28x28 gray synthetic
   stand-in, logistic-256 likelihood), the approximate kNN exemplar prior
   (K = 10, per-row support, a stale cache of all N = 50 000 exemplars),
   batch 100, bf16 compute, the bank encoded in one piece. (a) The cache
   refresh, timed; (b) a warm-up, then one timed 200-step epoch call:
   ms/step, images/s, peak memory, and no kernel launch (the train step's
   prior is a per-row LSE over K); (c) a 10-step call under torch.profiler:
   busy and idle shares, launches per step, device time by group, host
   synchronizations of a 3-step call, and the B*K re-encode alone; (d) the
   validation ELBO over 10 000 images, timed, one kernel launch per batch;
   (e) a warm-up, then one timed 200-step epoch call of an fp32 copy of the
   model (NCHW-contiguous convs): ms/step, images/s; then one IWAE request
   of 100 points at S = 5000, MB = 500 against the
   50 000-row eval bank at fp32, through the kernel (one launch per round)
   and through the scan on the same noise, within rtol 1e-5, its time and
   peak memory, and its device time by group under the profiler; (f) the
   CLI trains one epoch of it, finite metrics, and the
   exact kernel launch count computed from its config. The gated epilogue's
   launches, counted per path: 4 in (e)'s fp32 eval-bank encode (one
   chunk), 3 a round + 4 + 4 in (e)'s IWAE request, none in the bf16 cache
   refresh, training, validation and CLI epoch, nor in (e)'s fp32 training.
   The gated convs that carry a gradient over NCHW-contiguous input
   (``gated_conv.grad_nchw``), counted per path: 15 a step of (e)'s fp32
   training (4 + 4 of q(z2|x) over the batch and its B*K neighbours, 4 of
   q(z1|x,z2), 3 of the decoder), none on every other path;
9. [pixel], the PixelHVAE at the JAX package's default width (hidden 300,
   z1 = z2 = 40, PixelCNN of a 5x5 'A' and four 3x3 'B' masked convs of 64
   features) on the 50 000-image synthetic binarized stand-in, the exact
   prior over N = 50 000 (LOO) through the kernel, batch 100, bf16, the
   bank in one piece. (a) A warm-up, then one timed 200-step epoch call:
   ms/step, images/s, peak memory, one launch per step; (b) a 10-step call
   under torch.profiler and the host syncs of a 3-step call; (c) one fp32
   step kernel prior vs scan prior (loss rtol 1e-5, gradients within
   GRAD_REL); (d) the validation ELBO over 10 000 images, one launch per
   batch; (e) one fp32 IWAE request of 100 points at S = 5000, MB = 500
   (the decoder teacher-forced on 50 000 rows a round), kernel vs scan on
   the same noise, one launch per round, time, peak memory, device time by
   group; (f) the crop sampler and the full-canvas oracle on the same 100
   z2 rows and injected uniforms: time, CUDA launches, binary samples that
   agree except where a row parts at a pixel whose uniform lies within
   1e-5 of its mean; the model exported, loaded on the card, its generate
   equal to the live sampler bitwise; (g) one CLI epoch (validation/test
   256, S = MB = 8): finite metrics, the five PNG grids, the launches its
   config implies. The masked epilogue's launches, counted per path: 5 a
   round of (e) and 5 a pixel of the naive sampler (the no-grad fp32
   stack), none in training, in the bf16 validation and CLI epoch or in
   the crop sampler;
10. BASELINE Config 5, the run's lifecycle and exemplar-guided augmentation
   at Config 1's full width: the VAE 784-300-300-40 on dynamic_mnist (with
   no IDX files on disk its labelled synthetic stand-in, 50 000 training
   images), the exact prior over N = 50 000, batch 100, the CLI's defaults
   otherwise (fp32, bank chunks of 8192 with recompute). Cut: validation
   and test to 256 images, S = MB = 8. (a) A child process runs the CLI
   for one epoch with --checkpoint_every 1: ckpt_last, ckpt_final,
   results.json with no artifact_error, and the five PNG grids decoding to
   their sizes; (b) a second child resumes it (--resume --epochs 2): it
   prints "resumed from epoch 1" and appends only epoch 2; (c) in this
   process the run is loaded, saved and restored into a fresh Experiment:
   params, moments, count, step, best params and cache bitwise equal, one
   train step from each with the same noise gives the same loss (rtol
   1e-6), save and restore times and the size on disk; three augmented
   classifier steps make no host synchronization; a 10-step call of the
   CLI-default train step under torch.profiler; (d) --eval_only in this
   process reproduces results.json's test_nll (rtol 1e-6) with the kernel
   launches its config implies; (e) a child runs python -m
   exemplar_vae_tpu_torch.classify_mnist --classifier_epochs 2 --pi 0.5
   (784-512-512-10 on all 50 000 labels): both test errors finite and
   below 0.9, classifier_results.json written, seconds per classifier
   epoch and augmented rows/s; each child's wall time;
11. BASELINE Config 4 at full width on the card, unsharded: the ConvHVAE
   (default conv spec, hidden 300, z1 = z2 = 40) on celeba's stand-in,
   synthetic_continuous (200 000 + 256 + 10 images of 64x64x3 uint8; the
   CelebA files are not in the repository), the approximate prior (K = 10,
   per-row support) over N = 200 000, batch 100, bf16, bank chunks of
   4096. Cut: validation to 256 images, test to one IWAE request of 10
   points. (a) The cache refresh of all 200 000 rows: ms, peak memory;
   (b) a warm-up, then one timed 200-step epoch call: ms/step, images/s,
   peak memory, no kernel launch; (c) a 10-step call under torch.profiler:
   busy and idle shares, launches per step, device time by group, host
   synchronizations of a 3-step call; (d) the validation ELBO, one launch
   per batch at B = 100, 100, 56 over N = 200 000; (e) a 3-step epoch
   call of an fp32 copy of the model (NCHW-contiguous convs), finite loss;
   (f) one fp32 IWAE
   request at S = 5000, MB = 500, chunked by the autotune into one chunk of
   10 points (B = 5000 rows a round, one launch per round), through the
   kernel and through the scan on the same noise within rtol 1e-5, its
   time, peak memory and device time by group. The gated epilogue's
   launches, counted per path: 38 in (f)'s request (3 decoder layers a
   round, 4 + 4 encoder layers once), 4 a chunk of (f)'s fp32 eval-bank
   encode, none in the bf16 cache refresh, training, validation and (e);
   the gated convs that carry a gradient over NCHW-contiguous input, 15 a
   step of (e) (4 + 4 of q(z2|x) over the batch and its B*K neighbours,
   4 of q(z1|x,z2), 3 of the decoder), none on any other path (the bf16
   training keeps its convs channels-last);
12. [sharded], data-parallel training on the mesh: torchrun starts
   SHARD_W = 2 child processes of this script (``--sharded-rank``), gloo
   ranks sharing the card, each training on TRAIN_B / SHARD_W = 50 rows of
   every batch and holding half the bank, against one process here from
   the same params and injected noise. (a) Config 1's exact-prior step at
   full width (fp32, batch 100, LOO), the bank split 25 000 / 25 000: each
   rank's loss (the ranks' shares summed) within rtol 1e-5 and each
   gradient within 1e-4 of its largest element, one kernel launch per rank
   (B = 100 after the gather of z, N = 25 000, LOO); the backend and world
   size printed. (b) Config 4's approximate step at full width (fp32, TF32
   off): [config4]'s 200 000 images, the ConvHVAE, K = 10 per row, batch
   100, the bank split 100 000 / 100 000; the parent refreshes the cache of
   all 200 000 rows and gives the ranks its params, noise and cache; each
   rank's (100, 10) kNN selection must equal one process's (a near tie is
   printed with both distances and fails the phase), then its loss and
   gradients as in (a), and no kernel launch. (c) For (b), per rank and for
   one process: the rows the batch forward and the re-encode saw (50 and
   500 against 100 and 1000) and the device ms of a profiled step (two
   ranks share one card: no sharding speed). (d) On a host with NCCL_W = 4
   cards, (b) and (c) again on 4 NCCL ranks, one a card (torchrun,
   ``--sharded-rank <dir> nccl``), the bank split 50 000 a rank, 25 rows
   of each batch: the first run of the mesh over NCCL across cards; on
   fewer cards it is skipped and says so. In (d) a row's K selected rows
   may stand in another order than one process's only where they are the
   same set and, at every position that differs, the two rows' distances
   (recomputed from one process's q and cache) lie within the kNN's own
   rounding, TIE_ULPS ulps of |q|^2 + |c|^2 (its distances are
   |q|^2 + |c|^2 - 2 q.c in fp32, and a rank's q comes from 25 rows, not
   100); any other difference fails;
13. the kernels line, the card's name and power limit, and the ok line.
"""

import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# Config 4: its bank of 200 000 exemplars; validation and test cut to 256
# images and to one IWAE request of 10 points (the IWAE chunk autotune's
# 10 points per chunk at 64x64x3 and MB = 500: B = 5000 rows per round)
C4_N, C4_VAL, C4_T, C4_CHUNK = 200_000, 256, 10, 4096
C4_FP32_STEPS = 3       # [config4] (e): the fp32 training call's steps
# the sharded phase: ranks sharing the card, each holding N_BANK / SHARD_W
# of Config 1's bank (C4_N / SHARD_W of Config 4's) and TRAIN_B / SHARD_W
# rows of every batch; Config 4's images and config as [config4] left them
SHARD_W = 2
# [sharded] (d): NCCL ranks, one a card, on a host with this many cards
NCCL_W = 4
C4_X_FILE, C4_CFG_FILE = "c4_train_x.npy", "c4_cfg.json"
# (name, B, N, LOO) of every pairwise_lse call the paths below make:
# serving and Config 3's IWAE (B = points x MB = N), the train step,
# validation batches of test_batch_size = 100 and their tail (256 images:
# 56), the CLI runs' IWAE chunks (test_batch_size x MB = 800 rows at S = MB
# = 8) and their tail (256 test images: 56 x 8 = 448), Config 4's IWAE round
# and validation over N = 200 000, and one rank's step on a mesh of 2
KERNEL_SHAPES = (("serving", 50_000, N_BANK, False),
                 ("train", 100, N_BANK, True),
                 ("validation", 100, N_BANK, False),
                 ("validation_tail", 56, N_BANK, False),
                 ("iwae_chunk", 800, N_BANK, False),
                 ("iwae_tail", 448, N_BANK, False),
                 ("config4_iwae", C4_T * 500, C4_N, False),
                 ("config4_validation", 100, C4_N, False),
                 ("config4_validation_tail", 56, C4_N, False),
                 ("sharded_train", 100, N_BANK // SHARD_W, True))
# pairwise_lse times of the SIMT fp32 kernel that the tensor-core design
# replaced (PERF.md, same script, H100 80GB HBM3 at 700 W), printed beside
# this run's for reference only
SIMT_MS = {("serving", "float32"): 10.3132, ("serving", "bfloat16"): 10.3422,
          ("train", "float32"): 0.0761, ("train", "bfloat16"): 0.0829}
N_REQUESTS, T, N_GEN, N_REF = 3, 100, 100, 16
# training: bench.py::measure_ours times a 200-step epoch call of batch 100
TRAIN_B, TRAIN_STEPS, WARM_STEPS, PROF_STEPS = 100, 200, 20, 10
# kernel-prior vs scan-prior train step at fp32: the kernel's LSE differs
# from the scan's by up to ~2e-5, which scales each row's prior weights by
# 1 +- 2e-5 in the shared backward
STEP_LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
# [sharded] (d): two selected rows tie where their distances differ by at
# most this many fp32 ulps of |q|^2 + |c|^2 (pairwise_sq_dist's rounding)
TIE_ULPS = 8
# [trajectory]: Config 1's run through the kernel and through the scan
# prior from one seed, plain Adam; validation images, IWAE points (cut from
# the test split), epochs, warm-up and the limit on each per-epoch
# validation loss and the final IWAE NLL: both runs draw the same noise,
# so the kernel's ~1e-5 rounding against the scan is their one difference
TRAJ_VAL, TRAJ_T, TRAJ_EPOCHS, TRAJ_WARMUP, TRAJ_NATS = 10_000, 100, 3, 2, 1e-2
# Config 3: validation images, IWAE points per request, B*K re-encode calls
C3_VAL, C3_T, C3_REENCODE = 10_000, 100, 5
C3_S, C3_MB = 5000, 500                  # the IWAE protocol (Config defaults)
# Config 5: validation/test images, classifier epochs, replacement
# probability; a resumed or reloaded state is bitwise the saved one, so its
# step's loss and the eval-only NLL agree to float rounding at most
C5_EVAL, C5_CLF_EPOCHS, C5_PI = 256, 2, 0.5
C5_RTOL = 1e-6
# the artifacts: 5x5 grids of 28x28 images with 2-pixel separators
C5_GRIDS = ("reconstructions.png", "real.png", "generations.png",
            "exemplar_neighborhoods.png", "latent_knn_retrieval.png")
C5_GRID_SHAPE = (5 * 30 + 2, 5 * 30 + 2, 1)
# the PixelHVAE: IWAE points per request, sampler rows, rows of a bundle's
# generate; a binary sample may part from its oracle only at a pixel whose
# uniform lies within PIX_U_MARGIN of the decoded mean (two float orders on
# either side of u)
PIX_T, PIX_ROWS, PIX_GEN = 100, 100, 16
PIX_U_MARGIN = 1e-5
# the masked epilogue's serving shape: one masked layer's output a round of
# pixelhvae-exact-score (100 points x MB = 500 rows, 64 features, 28 x 28)
EPI_SHAPE = (50_000, 64, 28, 28)
# the gated epilogue's shapes, (config, raw conv output, phases): Config
# 4's decoder layers t64k3s2, t32k3s2, c32k3s1 a round of
# convhvae-knn-score (10 points x MB = 500 rows), each call's time within
# GATE_SLACK of its HBM bound; Config 3's a round of [config3]'s IWAE
# request (100 points x MB = 500 rows; w = 7 and 14 take the scalar kernel)
# and its encoder's 7x7 output over the eval bank (h*w = 49: the scalar
# kernel without phases)
GATE_SHAPES = (("config4", (5_000, 512, 16, 16), (2, 2)),
               ("config4", (5_000, 256, 32, 32), (2, 2)),
               ("config4", (5_000, 64, 64, 64), (1, 1)),
               ("config3", (50_000, 512, 7, 7), (2, 2)),
               ("config3", (50_000, 256, 14, 14), (2, 2)),
               ("config3", (50_000, 64, 28, 28), (1, 1)),
               ("config3", (N_BANK, 128, 7, 7), (1, 1)))
GATE_SLACK = 1.25
GATE_REPS, GATE_WARM = 50, 2
# [ingest]: an MNIST-sized IDX file and a static-MNIST-sized .amat split
INGEST_IDX, INGEST_AMAT = (60_000, 28, 28), (10_000, 784)
CHILD_TIMEOUT_S = 600
ROOT = Path(__file__).resolve().parent


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


def profile_ms(fn):
    """(wall ms, device-busy ms, [(kernel, ms, calls)] of every kernel,
    [(op, self host ms, calls)] of the host's operators) of one call under
    torch.profiler, each list longest first. Annotations (e.g. the
    optimizer's step range) are not kernels and are left out of both."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(fn)
    events = [e for e in prof.key_averages()
              if not getattr(e, "is_user_annotation", False)]
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)
    return (wall, busy,
            [(e.key[:90], e.self_device_time_total / 1e3, e.count)
             for e in kernels],
            [(e.key[:60], e.self_cpu_time_total / 1e3, e.count) for e in ops])


def host_syncs(fn):
    """Messages of the operations that synchronized the host with the card
    during one call (torch.cuda.set_sync_debug_mode)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


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
    log_var = torch.tensor(-0.5, device=dev)
    check(N_BANK % 64 and N_BANK % 2048, "N must be ragged for every tile")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    sm_hz = max_sm_clock_hz()
    log(f"[kernel] bound inputs: {sm_count} SMs, max SM clock "
        f"{sm_hz / 1e6:.0f} MHz")
    results, banks = {}, {}
    for shape, b, n, loo in KERNEL_SHAPES:
        if n not in banks:        # one seeded bank of each size, ~1% invalid
            banks[n] = (torch.randn((n, D), generator=g, device=dev),
                        torch.arange(n, dtype=torch.int32, device=dev),
                        torch.rand(n, generator=g, device=dev) >= 0.01)
        means, ex_idx, valid = banks[n]
        big = b * n >= 1e9
        own = torch.randint(0, n, (b,), generator=g, device=dev)
        z = means[own] + 0.7 * torch.randn((b, D), generator=g, device=dev)
        data_idx = own.to(torch.int32) if loo else None
        args = (z, means, log_var, data_idx, ex_idx, valid)
        if shape == "train":
            train_args = args
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
            reps = 20 if big else 200
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
                                 3 if big else 50, warmup=1)
            torch.cuda.empty_cache()
            bound_ms, bound_by, term = lse_bound_ms(b, n, D, dt_name, loo,
                                                    sm_count, sm_hz)
            results[(shape, dt_name)] = dict(
                shape=shape, dtype=dt_name, B=b, N=n, D=D, loo=loo,
                max_abs_err=max_abs, max_rel_err=max_rel, atol=atol,
                rtol=rtol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_term=term)
            log(f"[kernel] pairwise_lse {shape} B={b} N={n} D={D} "
                f"loo={loo} {dt_name}: max_abs_err={max_abs:.3e} "
                f"max_rel_err={max_rel:.3e} (atol {atol}, rtol {rtol}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
                f"({bound_by}: {term}; {100 * bound_ms / ms:.1f}% of it)"
                + (f" SIMT kernel {SIMT_MS[(shape, dt_name)]} ms (recorded)"
                   if (shape, dt_name) in SIMT_MS else ""))
    # the custom op's host cost where the call is host-bound (the train
    # shape, fp32): the entry (its checks, the op's dispatch, the launch)
    # against the op's CUDA kernel function alone, in turns
    def entry():
        return pl.pairwise_lse(*train_args)

    def alone():
        return pl._lse_launch(*train_args, torch.float32, 2048)

    turns = [cuda_ms(f, 200) for f in (entry, alone, alone, entry)]
    log(f"[kernel] train shape fp32, ms per call: pairwise_lse (checks, the "
        f"custom op's dispatch, the launch) {turns[0]:.4f} / {turns[3]:.4f}; "
        f"the op's CUDA kernel function alone {turns[1]:.4f} / "
        f"{turns[2]:.4f}")
    del banks
    torch.cuda.empty_cache()
    return results


def epilogue_phase(me):
    """The masked layers' epilogue at EPI_SHAPE against its plain version on
    a copy of the same inputs (bitwise: the same fp32 sums in the same
    order), its ms and the plain version's by CUDA events, and its bound:
    h and ctx read and h written once over HBM."""
    g = torch.Generator("cuda").manual_seed(11)
    h = torch.randn(EPI_SHAPE, generator=g, device="cuda")
    bias = torch.randn((EPI_SHAPE[1],), generator=g, device="cuda")
    ctx = torch.randn(EPI_SHAPE, generator=g, device="cuda")
    want = me.masked_epilogue_plain(h.clone(), bias, ctx)
    me.masked_epilogue.launches = 0
    got = me.masked_epilogue(h, bias, ctx)
    torch.cuda.synchronize()
    check(me.masked_epilogue.launches == 1, "masked_epilogue launched "
          f"{me.masked_epilogue.launches} times in one call")
    max_abs = float((got - want).abs().max())
    check(torch.equal(got, want), f"masked_epilogue vs plain at {EPI_SHAPE}: "
          f"not bitwise equal, max abs diff {max_abs:.3e}")
    check(bool((got == 0).any()) and bool((got > 0).any()),
          "masked_epilogue check: no value on each side of the ReLU")
    del want
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: me.masked_epilogue(h, bias, ctx), 50)
    plain_ms = cuda_ms(lambda: me.masked_epilogue_plain(h, bias, ctx), 10,
                       warmup=1)
    nbytes = 3 * h.numel() * h.element_size()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[epilogue] masked_epilogue {EPI_SHAPE} fp32: bitwise equal to "
        f"plain; ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
        f"(HBM bytes: {nbytes / 1e9:.2f} GB; {100 * bound_ms / ms:.1f}% of "
        f"it)")
    del h, ctx
    torch.cuda.empty_cache()
    return dict(shape=list(EPI_SHAPE), max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms)


def gate_phase(ge):
    """The gated convs' epilogue at GATE_SHAPES against its plain version on
    the same input (bitwise: the same fp32 chain in the same order), its ms
    and the plain version's by CUDA events, and its bound: y read and the
    output (half y's size) written once over HBM. Returns the rows and the
    launches counted over the phase."""
    g = torch.Generator("cuda").manual_seed(12)
    rows = []
    ge.gated_epilogue.launches = 0
    for cfg_name, shape, phases in GATE_SHAPES:
        f = shape[1] // (2 * phases[0] * phases[1])
        y = torch.randn(shape, generator=g, device="cuda")
        hb = torch.randn((f,), generator=g, device="cuda")
        gb = torch.randn((f,), generator=g, device="cuda")
        want = ge.gated_epilogue_plain(y, hb, gb, *phases)
        got = ge.gated_epilogue(y, hb, gb, phases)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        check(torch.equal(got, want), f"gated_epilogue vs plain at {shape} "
              f"{phases}: not bitwise equal, max abs diff {max_abs:.3e}")
        del got, want
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: ge.gated_epilogue(y, hb, gb, phases), GATE_REPS,
                     warmup=GATE_WARM)
        plain_ms = cuda_ms(lambda: ge.gated_epilogue_plain(y, hb, gb,
                                                           *phases), 10,
                           warmup=1)
        nbytes = 3 * y.numel() // 2 * y.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[gate] gated_epilogue {cfg_name} {shape} phases {phases} fp32: "
            f"bitwise equal to plain; ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} (HBM bytes: {nbytes / 1e9:.2f} GB; "
            f"{100 * bound_ms / ms:.1f}% of it)")
        if cfg_name == "config4":
            check(ms <= GATE_SLACK * bound_ms, f"gated_epilogue at {shape}: "
                  f"{ms:.4f} ms, over {GATE_SLACK} x its {bound_ms:.4f}-ms "
                  f"bound")
        rows.append(dict(config=cfg_name, shape=list(shape),
                         phases=list(phases), max_abs_err=max_abs, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms))
        del y
        torch.cuda.empty_cache()
    launches = ge.gated_epilogue.launches
    want = len(GATE_SHAPES) * (1 + GATE_WARM + GATE_REPS)
    check(launches == want, f"[gate] counted {launches} gated_epilogue "
          f"launches, not {want}")
    return rows, launches


def serving_phase(pl):
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.data.loaders import (EVAL_BIN_SEED,
                                                     binarize_eval_split)
    from exemplar_vae_tpu_torch.data.synthetic import synthetic_images
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.serve import (ServingBundle,
                                              export_serving_bundle,
                                              make_serving_fns)
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
    wall, busy, top, _ = prof
    top = top[:8]
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

    # the export round trip: export_serving_bundle writes the model, the
    # eval bank and the three torch.export programs; a child process that
    # loads no model code serves them through the programs, request 0 and a
    # generate with injected noise against the live functions
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        manifest = export_serving_bundle(
            model, cfg, str(work / "bundle"), bank_means=eb.cache_means,
            data_idx=eb.data_idx, valid=eb.valid, n_effective=N_BANK,
            n_gen=N_GEN, score_chunk=T, s_total=cfg.S, r=r)
        export_s = time.perf_counter() - t0
        size_mb = sum(f.stat().st_size
                      for f in (work / "bundle").iterdir()) / 1e6
        check(manifest["platforms"] == ["cuda"] and len(manifest["programs"])
              == 3, f"the bundle lists {manifest['platforms']} "
              f"{manifest['programs']}")
        idx = torch.randint(0, N_BANK, (N_GEN,), generator=g, device=dev)
        e = torch.randn((N_GEN, D), generator=g, device=dev)
        torch.save({"x": torch.from_numpy(test_x[:T]),
                    "x_timed": torch.from_numpy(test_x[T:2 * T]),
                    "eps": eps0.cpu(), "nll": nlls[0], "idx": idx.cpu(),
                    "gen_eps": e.cpu(),
                    "gen": gen(eb.cache_means, idx=idx, eps=e).cpu()},
                   work / "requests.pt")
        out, child_s = run_child("serve-export", "chip_smoke",
                                 ["--serve-bundle", str(work)])
    res = json.loads(out.strip().splitlines()[-1])
    log(f"[serve-export] export_serving_bundle with {len(manifest['programs'])}"
        f" torch.export programs {export_s:.3f} s, {size_mb:.3f} MB (programs"
        f", params and the {N_BANK}-row eval bank); child process "
        f"{child_s:.2f} s: ServingBundle.load {res['load_s']:.3f} s without "
        f"model code; score_nll program {res['program_ms']:.3f} ms per request"
        f" of {T} points (median of the last {len(res['request_ms']) - 1} "
        f"of {res['request_ms']}) against the live path's {steady:.3f} ms; "
        f"{res['launches_per_request']} kernel launches per program request")
    return launches, res["launches"]


def _kernel_group(name):
    """Device-time group of a kernel, by its name."""
    n = name.lower()
    if "lse_" in n:
        return "pairwise_lse kernel"
    if any(k in n for k in ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                            "implicit")):
        return "convolutions (cuDNN)"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "sm90_",
                            "sm80_")):
        return "cuBLAS GEMMs"
    if any(k in n for k in ("topk", "sort", "gather", "scatter", "index")):
        return "top-k, sort, gather/scatter"
    if any(k in n for k in ("multi_tensor", "foreach")):
        return "optimizer (foreach)"
    return "elementwise and reductions"


def log_profile(tag, steps, prof, unit="step"):
    """The busy/idle line, the groups and the top kernels of a profiled
    call of ``steps`` steps (or requests: ``unit``); returns (busy ms per
    step, idle share)."""
    wall, busy, kernels, _ = prof
    if not kernels:
        log(f"[{tag}] wall {wall:.3f} ms; the profiler recorded no device "
            f"time: device busy share not measured")
        return None, None
    log(f"[{tag}] {steps}-{unit} call: wall {wall:.3f} ms "
        f"({wall / steps:.4f} ms/{unit}), device busy {busy:.3f} ms "
        f"({busy / steps:.4f} ms/{unit}, {100 * busy / wall:.1f}%), "
        f"idle {100 * (1 - busy / wall):.1f}%")
    groups = {}
    for name, ms, _ in kernels:
        k = _kernel_group(name)
        groups[k] = groups.get(k, 0.0) + ms
    for k, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[{tag}]   group {k}: {ms / steps:.4f} ms/{unit} "
            f"({100 * ms / busy:.1f}%)")
    for name, ms, calls in kernels[:12]:
        log(f"[{tag}]   {ms / steps:8.4f} ms/{unit} {100 * ms / busy:5.1f}% "
            f"x{calls:<5d} {name}")
    return busy / steps, 1 - busy / wall


def training_phase(pl, snap_dir):
    from exemplar_vae_tpu_torch.config import (Config, config_from_args,
                                               reference_arg_parser)
    from exemplar_vae_tpu_torch.main import main as cli_main
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                    make_train_step)
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    cfg = Config(dataset_name="synthetic", model_name="vae",
                 prior="exemplar_prior", number_components=N_BANK,
                 training_set_size=N_BANK, val_set_size=256,
                 test_set_size=256, batch_size=TRAIN_B, hidden_size=300,
                 z1_size=D, warmup=100, S=8, MB=8, use_pallas_prior=True,
                 prior_block_n=2048, exact_reencode_chunk=0,
                 exact_remat=False, compute_dtype="bfloat16",
                 snapshot_dir=str(snap_dir / "timed"), seed=14)
    t0 = time.perf_counter()
    exp = Experiment(cfg, device="cuda", verbose=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    run = lambda perm: exp.epoch_fn(  # noqa: E731
        exp.state, exp.train_x, exp.train_idx, perm, exp.bank, 1.0,
        generator=exp.gen)
    exp.state, _ = run(exp.epoch_perm(WARM_STEPS, TRAIN_B))
    perm = exp.epoch_perm(TRAIN_STEPS, TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts 0 just before, read just after ----
    pl.pairwise_lse.launches = 0
    t0 = time.perf_counter()                # one region: the epoch call
    exp.state, metrics = run(perm)
    loss = float(metrics["loss"])           # host read: ends the timed call
    dt = time.perf_counter() - t0
    launches = pl.pairwise_lse.launches
    # ---- end of the main path ----

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == TRAIN_STEPS, f"pairwise_lse launched {launches} times "
          f"in {TRAIN_STEPS} training steps")
    check(math.isfinite(loss), f"training loss {loss}")
    ms_step = dt / TRAIN_STEPS * 1e3
    ips = TRAIN_STEPS * TRAIN_B / dt
    log(f"[train] Config 1 training at bench.py::measure_ours settings: VAE "
        f"784-{cfg.hidden_size}-{cfg.hidden_size}-{cfg.z1_size} bf16, exact "
        f"prior N={N_BANK} (LOO) through the kernel, batch {TRAIN_B}, bank "
        f"encode in one piece, no recompute; set-up (data, model) "
        f"{setup_s:.2f} s")
    log(f"[train] {TRAIN_STEPS}-step epoch call: {dt * 1e3:.3f} ms = "
        f"{ms_step:.4f} ms/step, {ips:.1f} images/s, "
        f"{ips * N_BANK:.4g} exemplar distances/s; loss {loss:.4f}; "
        f"pairwise_lse launches {launches}; peak memory {peak_gb:.2f} GB")

    prof = profile_ms(lambda: run(exp.epoch_perm(PROF_STEPS, TRAIN_B)))
    log_host(prof, "train-profile", PROF_STEPS)
    log_syncs("train-profile", exp, run)
    log_profile("train-profile", PROF_STEPS, prof)

    prior_timing()

    # (d) one fp32 step, kernel prior vs scan prior, same params and noise
    g = torch.Generator("cuda").manual_seed(3)
    rows = perm[0]
    x_raw = exp.train_x[rows]
    u = torch.rand(x_raw.shape, generator=g, device="cuda")
    eps = torch.randn((TRAIN_B, D), generator=g, device="cuda")
    res = {}
    for kernel in (True, False):
        c = cfg.replace(compute_dtype="float32", use_pallas_prior=kernel)
        m = create_model(c, device="cuda")
        m.load_state_dict(exp.model.state_dict())
        st, aux = make_train_step(c)(init_train_state(m, c), x_raw,
                                     exp.train_idx[rows], exp.bank, 1.0, u=u,
                                     eps=eps)
        res[kernel] = (float(aux["loss"]),
                       {n: p.grad for n, p in m.named_parameters()})
    (lk, gk), (ls, gs) = res[True], res[False]
    check(abs(lk - ls) <= STEP_LOSS_RTOL * abs(ls),
          f"kernel vs scan step loss {lk} vs {ls}")
    worst = ("", -1.0)
    for name, a in gk.items():
        rel = float((a - gs[name]).abs().max()) / max(
            float(gs[name].abs().max()), 1e-30)
        check(bool(torch.isfinite(a).all()), f"non-finite gradient {name}")
        check(rel <= GRAD_REL, f"kernel vs scan gradient {name}: "
              f"{rel:.3g} of its largest element > {GRAD_REL}")
        worst = max(worst, (name, rel), key=lambda t: t[1])
    log(f"[train] fp32 step, kernel vs scan prior: loss {lk:.6f} vs "
        f"{ls:.6f} (rel {abs(lk - ls) / abs(ls):.3e}, rtol "
        f"{STEP_LOSS_RTOL}); worst gradient {worst[0]} at {worst[1]:.3e} of "
        f"its largest element (limit {GRAD_REL})")
    del exp, res, gk, gs
    torch.cuda.empty_cache()

    # the CLI, one epoch
    cli_dir = snap_dir / "cli"
    argv = ["--dataset_name", "synthetic", "--training_set_size",
            str(N_BANK), "--number_components", str(N_BANK),
            "--val_set_size", "256", "--test_set_size", "256", "--epochs",
            "1", "--S", "8", "--MB", "8", "--compute_dtype", "bfloat16",
            "--snapshot_dir", str(cli_dir)]
    out = io.StringIO()
    pl.pairwise_lse.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = cli_main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"[train-cli] | {line}")
    cli_launches = pl.pairwise_lse.launches
    # one launch per train step, per validation batch (after the epoch and
    # again in the final evaluation) and per IWAE chunk and round (a chunk is
    # test_batch_size points: the IWAE row budget does not bind at 784 inputs)
    c = config_from_args(reference_arg_parser().parse_args(argv))
    val_batches = -(-c.val_set_size // c.test_batch_size)
    iwae_calls = (-(-c.test_set_size // c.test_batch_size)
                  * -(-c.S // min(c.MB, c.S)))
    want = (c.epochs * (c.training_set_size // c.batch_size + val_batches)
            + val_batches + iwae_calls)
    check(cli_launches == want, f"the CLI epoch launched the kernel "
          f"{cli_launches} times, not {want}")
    (exp_dir,) = [p for p in cli_dir.iterdir() if p.is_dir()]
    records = [json.loads(line) for line in
               (exp_dir / "metrics.jsonl").read_text().splitlines()]
    on_disk = json.loads((exp_dir / "results.json").read_text())
    nums = [v for r in records + [on_disk] for v in r.values()
            if isinstance(v, (int, float))]
    check(len(records) == 2 and on_disk == results
          and all(math.isfinite(v) for v in nums),
          f"CLI metrics or results not finite: {records} {on_disk}")
    log(f"[train-cli] python -m exemplar_vae_tpu_torch.main {' '.join(argv)}"
        f": {cli_s:.2f} s; epoch {records[0]['epoch_seconds']:.3f} s "
        f"({records[0]['images_per_sec']:.1f} images/s, bank chunk 8192 "
        f"with recompute, the CLI's defaults); loss {records[0]['loss']:.4f}, "
        f"val_loss {records[0]['val_loss']:.4f}, test_nll "
        f"{results['test_nll']:.4f}; pairwise_lse launches {cli_launches}")
    return launches, cli_launches


def trajectory_phase(pl, snap_dir):
    """Config 1's whole training run twice from one seed, through the
    kernel and through the scan prior; returns the kernel run's launches
    per path."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    cfg = Config(dataset_name="synthetic", dynamic_binarization_override=False,
                 model_name="vae", prior="exemplar_prior",
                 number_components=N_BANK, training_set_size=N_BANK,
                 val_set_size=TRAJ_VAL, test_set_size=TRAJ_T,
                 batch_size=TRAIN_B, test_batch_size=TRAIN_B, hidden_size=300,
                 z1_size=D, warmup=TRAJ_WARMUP, epochs=TRAJ_EPOCHS,
                 S=C3_S, MB=C3_MB, optimizer="adam", compute_dtype="float32",
                 prior_block_n=2048, exact_reencode_chunk=0,
                 exact_remat=False, seed=21)
    runs = {}
    for kernel in (True, False):
        c = cfg.replace(use_pallas_prior=kernel,
                        snapshot_dir=str(snap_dir / f"trajectory_{kernel}"))
        exp = Experiment(c, device="cuda", verbose=False)
        counts = {"train": 0, "validation": 0, "iwae": 0}

        def counted(path, fn):
            def call(*args, **kw):
                before = pl.pairwise_lse.launches
                out = fn(*args, **kw)
                counts[path] += pl.pairwise_lse.launches - before
                return out
            return call

        exp.epoch_fn = counted("train", exp.epoch_fn)
        exp.elbo_eval = counted("validation", exp.elbo_eval)
        exp.iwae = counted("iwae", exp.iwae)
        torch.cuda.synchronize()

        # ---- the main path: counts 0 just before, read just after ----
        pl.pairwise_lse.launches = 0
        t0 = time.perf_counter()
        results = exp.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = pl.pairwise_lse.launches
        # ---- end of the main path ----

        records = _epoch_records(Path(exp.exp_dir))
        check(sum(counts.values()) == launches, f"launches by path {counts} "
              f"do not add up to {launches}")
        nums = [r["loss"] for r in records] + [r["val_loss"] for r in records]
        check(all(math.isfinite(v) for v in nums + [results["test_nll"]]),
              f"trajectory (kernel={kernel}): non-finite {records} {results}")
        runs[kernel] = (records, results, counts, secs)
        route = "kernel" if kernel else "scan"
        log(f"[trajectory] {route} run: {secs:.2f} s, "
            + ", ".join(f"epoch {r['epoch']} {r['epoch_seconds']:.3f} s "
                        f"val_loss {r['val_loss']:.6f}" for r in records)
            + f"; test_nll {results['test_nll']:.6f}; pairwise_lse launches "
            f"{counts}")
        del exp
        torch.cuda.empty_cache()

    (krec, kres, kcounts, _), (srec, sres, scounts, _) = runs[True], runs[False]
    steps = N_BANK // TRAIN_B
    val_batches = -(-TRAJ_VAL // TRAIN_B)
    rounds = -(-C3_S // C3_MB)
    # one launch per train step, per validation batch (after each epoch and
    # again in the final evaluation) and per IWAE round (one chunk of 100)
    want = {"train": TRAJ_EPOCHS * steps,
            "validation": (TRAJ_EPOCHS + 1) * val_batches, "iwae": rounds}
    check(kcounts == want, f"kernel run launched {kcounts}, not {want}")
    check(sum(scounts.values()) == 0, f"scan run launched the kernel "
          f"{scounts}")
    check(kres["epochs_trained"] == sres["epochs_trained"] == TRAJ_EPOCHS
          and len(krec) == len(srec) == TRAJ_EPOCHS,
          f"epochs trained {kres['epochs_trained']} vs "
          f"{sres['epochs_trained']}")
    diffs = []
    for a, b in zip(krec, srec):
        check(a.get("best") == b.get("best") and a["beta"] == b["beta"],
              f"epoch {a['epoch']}: best/beta {a} vs {b}")
        diffs.append(abs(a["val_loss"] - b["val_loss"]))
    nll_diff = abs(kres["test_nll"] - sres["test_nll"])
    check(max(diffs) <= TRAJ_NATS and nll_diff <= TRAJ_NATS,
          f"kernel vs scan trajectory: validation diffs {diffs}, test NLL "
          f"diff {nll_diff} > {TRAJ_NATS} nats")
    log(f"[trajectory] Config 1 VAE 784-300-300-{D} fp32 (TF32 off), plain "
        f"Adam, static binary synthetic data ({N_BANK} train, {TRAJ_VAL} "
        f"validation, IWAE cut to {TRAJ_T} test points at S={C3_S}, "
        f"MB={C3_MB}), exact prior N={N_BANK} (LOO), batch {TRAIN_B}, "
        f"{TRAJ_EPOCHS} epochs, warm-up {TRAJ_WARMUP}: kernel vs scan "
        f"validation diffs per epoch {[f'{d:.3e}' for d in diffs]}, test NLL "
        f"diff {nll_diff:.3e} (limit {TRAJ_NATS} nats); best flags "
        f"{[r.get('best', 0) for r in krec]} both; launches {kcounts} = "
        f"{sum(kcounts.values())}, scan run 0")
    return {f"trajectory_{k}": v for k, v in kcounts.items()}


def _chunks(n, cfg):
    """The bank encode's chunks of n rows (train/bank.py::_encode)."""
    chunk = cfg.exact_reencode_chunk
    return 1 if chunk <= 0 or chunk >= n else -(-n // chunk)


def check_gate_counts(gate, *, eval_bank, iwae):
    """The gated epilogue's launches per path of a ConvHVAE phase, read
    from its counter: ``eval_bank`` in the fp32 eval-bank encode (4 encoder
    layers a chunk), ``iwae`` in the fp32 IWAE request (3 decoder layers a
    round, 4 + 4 encoder layers once), none on a bf16 or gradient path."""
    for path, n in gate.items():
        want = (eval_bank if path.endswith("_eval_bank") else
                iwae if path.endswith("_iwae") else 0)
        check(n == want, f"{path} launched the gated epilogue {n} times, "
              f"not {want}")
    log(f"[gate-counts] gated_epilogue launches per path: {gate}")


def check_grad_nchw(nchw, *, train_fp32=0):
    """The gated convs that carried a gradient over NCHW-contiguous input
    per path of a ConvHVAE phase, read from ``gated_conv.grad_nchw``:
    ``train_fp32`` on the fp32 training path (15 a step), none on a bf16 or
    no-gradient path."""
    for path, n in nchw.items():
        want = train_fp32 if path.endswith("_train_fp32") else 0
        check(n == want, f"{path} counted {n} gated convs with a gradient "
              f"over NCHW input, not {want}")
    log(f"[grad-nchw] gated_conv.grad_nchw per path: {nchw}")


def config3_phase(pl, snap_dir):
    """BASELINE Config 3 (docstring item 8): the pairwise_lse launches per
    path, and the gated epilogue's (gate_counts)."""
    from exemplar_vae_tpu_torch.config import (Config, config_from_args,
                                               reference_arg_parser)
    from exemplar_vae_tpu_torch.main import main as cli_main
    from exemplar_vae_tpu_torch.models import create_model, layers
    from exemplar_vae_tpu_torch.ops import gated_epilogue as ge
    from exemplar_vae_tpu_torch.train.evaluation import (make_eval_bank_fn,
                                                         make_iwae_fn)
    from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                    make_epoch_fn)
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    data_dir = snap_dir / "no_data"        # no IDX files: the gray stand-in
    data_dir.mkdir()
    cfg = Config(dataset_name="fashion_mnist", model_name="convhvae_2level",
                 prior="exemplar_prior", approximate_prior=True,
                 approximate_k=10, approximate_support="per_row",
                 number_components=N_BANK, training_set_size=N_BANK,
                 val_set_size=C3_VAL, test_set_size=C3_T, batch_size=TRAIN_B,
                 hidden_size=300, z1_size=D, z2_size=D, S=C3_S, MB=C3_MB,
                 exact_reencode_chunk=0, compute_dtype="bfloat16",
                 use_pallas_prior=True, data_dir=str(data_dir),
                 snapshot_dir=str(snap_dir / "c3"), seed=14)
    check(cfg.conv_enc_spec == "32k7s1,32k3s2,64k5s1,64k3s2"
          and cfg.conv_dec_spec == "t64k3s2,t32k3s2,c32k3s1"
          and cfg.conv_proj_channels == 64, "Config's conv spec is not the "
          "default of the JAX package")
    t0 = time.perf_counter()
    exp = Experiment(cfg, device="cuda", verbose=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(exp.cfg.input_type == "gray" and exp.splits.source == "synthetic"
          and tuple(exp.train_x.shape) == (N_BANK, 28, 28, 1),
          f"Config 3 data: {exp.cfg.input_type} {exp.splits.source} "
          f"{tuple(exp.train_x.shape)}")
    n_params = sum(p.numel() for p in exp.model.parameters())

    # (a) the cache refresh: the whole bank through q(z2|x), no gradient
    refresh = lambda: exp.cache_refresh(exp.bank.images,  # noqa: E731
                                        generator=exp.gen)
    torch.cuda.reset_peak_memory_stats()
    ge.gated_epilogue.launches = layers.gated_conv.grad_nchw = 0
    refresh_ms = cuda_ms(refresh, 3, warmup=1)
    refresh_gb = torch.cuda.max_memory_allocated() / 1e9
    exp.bank = exp.bank._replace(cache_means=refresh())
    gate = {"config3_cache_refresh": ge.gated_epilogue.launches}
    nchw = {"config3_cache_refresh": layers.gated_conv.grad_nchw}
    check(bool(torch.isfinite(exp.bank.cache_means).all()),
          "non-finite cache means")

    # (b) the timed 200-step call
    run = lambda perm: exp.epoch_fn(  # noqa: E731
        exp.state, exp.train_x, exp.train_idx, perm, exp.bank, 1.0,
        generator=exp.gen)
    exp.state, _ = run(exp.epoch_perm(WARM_STEPS, TRAIN_B))
    perm = exp.epoch_perm(TRAIN_STEPS, TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the train part of the path: counts 0 just before, read after ----
    pl.pairwise_lse.launches = ge.gated_epilogue.launches = 0
    layers.gated_conv.grad_nchw = 0
    t0 = time.perf_counter()
    exp.state, metrics = run(perm)
    loss = float(metrics["loss"])           # host read: ends the timed call
    dt = time.perf_counter() - t0
    train_launches = pl.pairwise_lse.launches
    gate["config3_train"] = ge.gated_epilogue.launches
    nchw["config3_train"] = layers.gated_conv.grad_nchw
    # ---- end ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(math.isfinite(loss), f"Config 3 training loss {loss}")
    check(train_launches == 0, f"the approximate train step launched the "
          f"kernel {train_launches} times (its prior is a per-row LSE)")
    ms_step = dt / TRAIN_STEPS * 1e3
    log(f"[config3] BASELINE Config 3 (bench row 3 at full width): ConvHVAE "
        f"enc {cfg.conv_enc_spec} dec {cfg.conv_dec_spec} proj "
        f"{cfg.conv_proj_channels}, hidden {cfg.hidden_size}, z1 = z2 = {D}, "
        f"{n_params} params, bf16 compute; fashion_mnist -> synthetic gray "
        f"28x28 (logistic-256); approximate prior K={cfg.approximate_k} "
        f"{cfg.approximate_support} over N={N_BANK}, batch {TRAIN_B}, bank "
        f"encode in one piece; set-up (data, model) {setup_s:.2f} s")
    log(f"[config3] cache refresh (N={N_BANK}, one encode): {refresh_ms:.3f} "
        f"ms (events, mean of 3); peak memory {refresh_gb:.2f} GB")
    log(f"[config3] {TRAIN_STEPS}-step epoch call: {dt * 1e3:.3f} ms = "
        f"{ms_step:.4f} ms/step, {TRAIN_STEPS * TRAIN_B / dt:.1f} images/s; "
        f"loss {loss:.4f}; pairwise_lse launches {train_launches} (none "
        f"expected); peak memory {peak_gb:.2f} GB")

    # (c) profile, host syncs, the B*K re-encode alone
    prof = profile_ms(lambda: run(exp.epoch_perm(PROF_STEPS, TRAIN_B)))
    launches_step = log_host(prof, "config3-profile", PROF_STEPS)
    n_syncs = log_syncs("config3-profile", exp, run)
    busy_step, idle = log_profile("config3-profile", PROF_STEPS, prof)
    check(n_syncs == 0, f"the Config 3 step synchronized the host "
          f"{n_syncs} times in 3 steps")
    x_bk = exp.train_x[:TRAIN_B * cfg.approximate_k].to(torch.bfloat16)

    def reencode():
        exp.model.encode_top_mean(x_bk).float().sum().backward()

    _, re_busy, _, _ = profile_ms(
        lambda: [reencode() for _ in range(C3_REENCODE)])
    exp.state.opt.zero_grad(set_to_none=True)
    log(f"[config3-profile] the B*K = {x_bk.shape[0]}-row re-encode through "
        f"q(z2|x) alone, forward + backward: {re_busy / C3_REENCODE:.4f} ms "
        f"of device time per call")

    # (d) the validation ELBO (eval bank encode + 100 batches)
    pl.pairwise_lse.launches = ge.gated_epilogue.launches = 0
    layers.gated_conv.grad_nchw = 0
    t0 = time.perf_counter()
    val = exp.validate()
    val_s = time.perf_counter() - t0
    val_launches = pl.pairwise_lse.launches
    gate["config3_validation"] = ge.gated_epilogue.launches
    nchw["config3_validation"] = layers.gated_conv.grad_nchw
    want_val = -(-C3_VAL // cfg.test_batch_size)
    check(all(math.isfinite(v) for v in val), f"Config 3 validation {val}")
    check(val_launches == want_val, f"validation launched the kernel "
          f"{val_launches} times, not {want_val}")
    log(f"[config3] validation ELBO over {C3_VAL} images (bf16): "
        f"{val_s:.3f} s (host clock, eval bank encode included); loss "
        f"{val[0]:.4f}; pairwise_lse launches {val_launches}")

    # (e) fp32 training of a copy (NCHW-contiguous convs), then one
    # IWAE request at fp32, through the kernel and the scan
    c32 = exp.cfg.replace(compute_dtype="float32")
    m32 = create_model(c32, device="cuda")
    m32.load_state_dict(exp.model.state_dict())
    epoch32 = make_epoch_fn(c32)
    run32 = lambda state, perm: epoch32(  # noqa: E731
        state, exp.train_x, exp.train_idx, perm, exp.bank, 1.0,
        generator=exp.gen)
    t32 = create_model(c32, device="cuda")
    t32.load_state_dict(exp.model.state_dict())
    state32, _ = run32(init_train_state(t32, c32),
                       exp.epoch_perm(WARM_STEPS, TRAIN_B))
    perm = exp.epoch_perm(TRAIN_STEPS, TRAIN_B)
    torch.cuda.synchronize()
    ge.gated_epilogue.launches = layers.gated_conv.grad_nchw = 0
    t0 = time.perf_counter()
    state32, metrics = run32(state32, perm)
    loss32 = float(metrics["loss"])         # host read: ends the timed call
    dt32 = time.perf_counter() - t0
    gate["config3_train_fp32"] = ge.gated_epilogue.launches
    nchw["config3_train_fp32"] = layers.gated_conv.grad_nchw
    check(math.isfinite(loss32), f"Config 3 fp32 training loss {loss32}")
    log(f"[config3] fp32 {TRAIN_STEPS}-step epoch call (NCHW-contiguous "
        f"convs): {dt32 * 1e3:.3f} ms = {dt32 / TRAIN_STEPS * 1e3:.4f} "
        f"ms/step, {TRAIN_STEPS * TRAIN_B / dt32:.1f} images/s; loss "
        f"{loss32:.4f}; gated_conv.grad_nchw "
        f"{nchw['config3_train_fp32']} (15 a step)")
    del state32, t32, run32, epoch32
    m32.eval()
    ge.gated_epilogue.launches = layers.gated_conv.grad_nchw = 0
    eb = make_eval_bank_fn(m32, c32)(exp.bank)
    gate["config3_eval_bank"] = ge.gated_epilogue.launches
    nchw["config3_eval_bank"] = layers.gated_conv.grad_nchw
    rounds, r = -(-c32.S // c32.MB), c32.MB
    g = torch.Generator("cuda").manual_seed(7)
    eps = (torch.randn((rounds, C3_T * r, D), generator=g, device="cuda"),
           torch.randn((rounds, C3_T * r, D), generator=g, device="cuda"))
    iwae_k = make_iwae_fn(m32, c32).chunk_nll
    iwae_k(exp.test_x, eb, rounds, r, eps=eps)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the IWAE part of the path: counts 0 just before, read after ----
    pl.pairwise_lse.launches = ge.gated_epilogue.launches = 0
    layers.gated_conv.grad_nchw = 0
    t0 = time.perf_counter()
    nll_k = iwae_k(exp.test_x, eb, rounds, r, eps=eps).cpu()
    iwae_ms = (time.perf_counter() - t0) * 1e3
    iwae_launches = pl.pairwise_lse.launches
    gate["config3_iwae"] = ge.gated_epilogue.launches
    nchw["config3_iwae"] = layers.gated_conv.grad_nchw
    # ---- end ----
    iwae_gb = torch.cuda.max_memory_allocated() / 1e9
    nll_s = make_iwae_fn(m32, c32.replace(use_pallas_prior=False)).chunk_nll(
        exp.test_x, eb, rounds, r, eps=eps).cpu()
    err = float((nll_k - nll_s).abs().max())
    check(iwae_launches == rounds, f"the IWAE request launched the kernel "
          f"{iwae_launches} times, not {rounds}")
    check(nll_k.shape == (C3_T,) and bool(torch.isfinite(nll_k).all()),
          "Config 3 IWAE NLL not finite")
    check(bool(((nll_k - nll_s).abs() <= NLL_RTOL * nll_s.abs()).all()),
          f"Config 3 IWAE kernel vs scan max abs diff {err:.3g} > rtol "
          f"{NLL_RTOL}")
    log(f"[config3] IWAE request of {C3_T} points, S={c32.S}, MB={r} "
        f"({rounds} rounds of {C3_T * r} rows), fp32, eval bank N={N_BANK}: "
        f"{iwae_ms:.3f} ms (warm, host clock); mean NLL "
        f"{float(nll_k.mean()):.4f}; kernel vs scan max abs diff {err:.3e} "
        f"(rtol {NLL_RTOL}); pairwise_lse launches {iwae_launches}; peak "
        f"memory {iwae_gb:.2f} GB")
    log_profile("config3-iwae", 1, profile_ms(
        lambda: iwae_k(exp.test_x, eb, rounds, r, eps=eps)), unit="request")
    del exp, m32, eb, eps, run, prof
    torch.cuda.empty_cache()

    # (f) the CLI, one epoch
    cli_dir = snap_dir / "c3_cli"
    argv = ["--model_name", "convhvae_2level", "--dataset_name",
            "fashion_mnist", "--data_dir", str(data_dir),
            "--approximate_prior", "--approximate_k", "10",
            "--training_set_size", str(N_BANK), "--number_components",
            str(N_BANK), "--batch_size", str(TRAIN_B), "--val_set_size",
            "256", "--test_set_size", "100",
            "--epochs", "1", "--S", "8", "--MB", "8", "--compute_dtype",
            "bfloat16", "--snapshot_dir", str(cli_dir)]
    out = io.StringIO()
    pl.pairwise_lse.launches = ge.gated_epilogue.launches = 0
    layers.gated_conv.grad_nchw = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = cli_main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = pl.pairwise_lse.launches
    gate["config3_cli_epoch"] = ge.gated_epilogue.launches
    nchw["config3_cli_epoch"] = layers.gated_conv.grad_nchw
    for line in out.getvalue().splitlines():
        log(f"[config3-cli] | {line}")
    # the approximate train step launches none; one per validation batch
    # (after the epoch and again in the final evaluation) and per IWAE chunk
    # and round
    c = config_from_args(reference_arg_parser().parse_args(argv))
    val_batches = -(-c.val_set_size // c.test_batch_size)
    want = (val_batches * (c.epochs + 1)
            + -(-c.test_set_size // c.test_batch_size) * -(-c.S // c.MB))
    check(cli_launches == want, f"the Config 3 CLI epoch launched the kernel "
          f"{cli_launches} times, not {want}")
    (exp_dir,) = [p for p in cli_dir.iterdir() if p.is_dir()]
    records = [json.loads(line) for line in
               (exp_dir / "metrics.jsonl").read_text().splitlines()]
    on_disk = json.loads((exp_dir / "results.json").read_text())
    nums = [v for rec in records + [on_disk] for v in rec.values()
            if isinstance(v, (int, float))]
    check(len(records) == 2 and on_disk == results
          and all(math.isfinite(v) for v in nums),
          f"Config 3 CLI metrics or results not finite: {records} {on_disk}")
    log(f"[config3-cli] python -m exemplar_vae_tpu_torch.main "
        f"{' '.join(argv)}: {cli_s:.2f} s; epoch "
        f"{records[0]['epoch_seconds']:.3f} s "
        f"({records[0]['images_per_sec']:.1f} images/s, cache refresh and "
        f"bank encode in chunks of 8192, the CLI's defaults); loss "
        f"{records[0]['loss']:.4f}, val_loss {records[0]['val_loss']:.4f}, "
        f"test_nll {results['test_nll']:.4f}; pairwise_lse launches "
        f"{cli_launches}")
    # fp32 only: the bf16 paths (refresh, training, validation, CLI) none
    check_gate_counts(gate, eval_bank=4 * _chunks(N_BANK, c32),
                      iwae=3 * rounds + 8)
    check_grad_nchw(nchw, train_fp32=15 * TRAIN_STEPS)
    return ({"config3_train": train_launches,
             "config3_validation": val_launches, "config3_iwae": iwae_launches,
             "config3_cli_epoch": cli_launches}, gate)


def config4_phase(pl, snap_dir):
    """BASELINE Config 4 (docstring item 11): the pairwise_lse launches per
    path, and the gated epilogue's (gate_counts)."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model, layers
    from exemplar_vae_tpu_torch.ops import gated_epilogue as ge
    from exemplar_vae_tpu_torch.train.evaluation import (make_eval_bank_fn,
                                                         make_iwae_fn)
    from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                    make_epoch_fn)
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    cfg = Config(dataset_name="synthetic_continuous",
                 model_name="convhvae_2level", prior="exemplar_prior",
                 approximate_prior=True, approximate_k=10,
                 approximate_support="per_row", number_components=C4_N,
                 training_set_size=C4_N, val_set_size=C4_VAL,
                 test_set_size=C4_T, batch_size=TRAIN_B, hidden_size=300,
                 z1_size=D, z2_size=D, S=C3_S, MB=C3_MB,
                 exact_reencode_chunk=C4_CHUNK, compute_dtype="bfloat16",
                 use_pallas_prior=True, snapshot_dir=str(snap_dir / "c4"),
                 seed=14)
    check(cfg.conv_enc_spec == "32k7s1,32k3s2,64k5s1,64k3s2"
          and cfg.conv_dec_spec == "t64k3s2,t32k3s2,c32k3s1"
          and cfg.conv_proj_channels == 64, "Config's conv spec is not the "
          "default of the JAX package")
    t0 = time.perf_counter()
    exp = Experiment(cfg, device="cuda", verbose=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(exp.cfg.input_type == "continuous" and exp.splits.source ==
          "synthetic" and tuple(exp.train_x.shape) == (C4_N, 64, 64, 3)
          and exp.train_x.dtype == torch.uint8, f"Config 4 data: "
          f"{exp.cfg.input_type} {exp.splits.source} "
          f"{tuple(exp.train_x.shape)} {exp.train_x.dtype}")
    check(exp.bank.images.data_ptr() == exp.train_x.data_ptr(),
          "the bank is not a view of train_x")
    n_params = sum(p.numel() for p in exp.model.parameters())
    bank_gb = exp.bank.images.numel() / 1e9
    persistent_gb = torch.cuda.memory_allocated() / 1e9

    # (a) the cache refresh: all 200 000 rows through q(z2|x) in chunks
    refresh = lambda: exp.cache_refresh(exp.bank.images,  # noqa: E731
                                        generator=exp.gen)
    torch.cuda.reset_peak_memory_stats()
    ge.gated_epilogue.launches = layers.gated_conv.grad_nchw = 0
    refresh_ms = cuda_ms(refresh, 2, warmup=1)
    refresh_gb = torch.cuda.max_memory_allocated() / 1e9
    exp.bank = exp.bank._replace(cache_means=refresh())
    gate = {"config4_cache_refresh": ge.gated_epilogue.launches}
    nchw = {"config4_cache_refresh": layers.gated_conv.grad_nchw}
    check(bool(torch.isfinite(exp.bank.cache_means).all())
          and tuple(exp.bank.cache_means.shape) == (C4_N, D),
          "Config 4 cache means")

    # (b) the timed 200-step call
    run = lambda perm: exp.epoch_fn(  # noqa: E731
        exp.state, exp.train_x, exp.train_idx, perm, exp.bank, 1.0,
        generator=exp.gen)
    exp.state, _ = run(exp.epoch_perm(WARM_STEPS, TRAIN_B))
    perm = exp.epoch_perm(TRAIN_STEPS, TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the train part of the path: counts 0 just before, read after ----
    pl.pairwise_lse.launches = ge.gated_epilogue.launches = 0
    layers.gated_conv.grad_nchw = 0
    t0 = time.perf_counter()
    exp.state, metrics = run(perm)
    loss = float(metrics["loss"])           # host read: ends the timed call
    dt = time.perf_counter() - t0
    train_launches = pl.pairwise_lse.launches
    gate["config4_train"] = ge.gated_epilogue.launches
    nchw["config4_train"] = layers.gated_conv.grad_nchw
    # ---- end ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(math.isfinite(loss), f"Config 4 training loss {loss}")
    check(train_launches == 0, f"the approximate train step launched the "
          f"kernel {train_launches} times (its prior is a per-row LSE)")
    ms_step = dt / TRAIN_STEPS * 1e3
    log(f"[config4] BASELINE Config 4 at full width: ConvHVAE enc "
        f"{cfg.conv_enc_spec} dec {cfg.conv_dec_spec} proj "
        f"{cfg.conv_proj_channels}, hidden {cfg.hidden_size}, z1 = z2 = {D}, "
        f"{n_params} params, bf16 compute; celeba -> synthetic_continuous "
        f"64x64x3 uint8 (logistic-256 over 12288 values); approximate prior "
        f"K={cfg.approximate_k} {cfg.approximate_support} over N={C4_N}, "
        f"batch {TRAIN_B}, bank chunks of {C4_CHUNK}; set-up (data, model) "
        f"{setup_s:.2f} s; bank {bank_gb:.3f} GB (a view of train_x); "
        f"{persistent_gb:.3f} GB on the card after set-up")
    log(f"[config4] cache refresh (N={C4_N}, {-(-C4_N // C4_CHUNK)} chunks): "
        f"{refresh_ms:.3f} ms (events, mean of 2); peak memory "
        f"{refresh_gb:.2f} GB")
    log(f"[config4] {TRAIN_STEPS}-step epoch call: {dt * 1e3:.3f} ms = "
        f"{ms_step:.4f} ms/step, {TRAIN_STEPS * TRAIN_B / dt:.1f} images/s; "
        f"loss {loss:.4f}; pairwise_lse launches {train_launches} (none "
        f"expected); peak memory {peak_gb:.2f} GB")

    # (c) profile and host syncs
    prof = profile_ms(lambda: run(exp.epoch_perm(PROF_STEPS, TRAIN_B)))
    log_host(prof, "config4-profile", PROF_STEPS)
    n_syncs = log_syncs("config4-profile", exp, run)
    log_profile("config4-profile", PROF_STEPS, prof)
    check(n_syncs == 0, f"the Config 4 step synchronized the host "
          f"{n_syncs} times in 3 steps")

    # (d) the validation ELBO (eval bank encode + batches of 100, 100, 56)
    pl.pairwise_lse.launches = ge.gated_epilogue.launches = 0
    layers.gated_conv.grad_nchw = 0
    t0 = time.perf_counter()
    val = exp.validate()
    val_s = time.perf_counter() - t0
    val_launches = pl.pairwise_lse.launches
    gate["config4_validation"] = ge.gated_epilogue.launches
    nchw["config4_validation"] = layers.gated_conv.grad_nchw
    want_val = -(-C4_VAL // cfg.test_batch_size)
    check(all(math.isfinite(v) for v in val), f"Config 4 validation {val}")
    check(val_launches == want_val, f"validation launched the kernel "
          f"{val_launches} times, not {want_val}")
    log(f"[config4] validation ELBO over {C4_VAL} images (bf16, eval bank "
        f"of N={C4_N} encoded first): {val_s:.3f} s (host clock); loss "
        f"{val[0]:.4f}; pairwise_lse launches {val_launches}")

    # (e) fp32 training of a copy (NCHW-contiguous convs), one short call
    c32 = exp.cfg.replace(compute_dtype="float32")
    t32 = create_model(c32, device="cuda")
    t32.load_state_dict(exp.model.state_dict())
    ge.gated_epilogue.launches = layers.gated_conv.grad_nchw = 0
    _, metrics = make_epoch_fn(c32)(
        init_train_state(t32, c32), exp.train_x, exp.train_idx,
        exp.epoch_perm(C4_FP32_STEPS, TRAIN_B), exp.bank, 1.0,
        generator=exp.gen)
    loss32 = float(metrics["loss"])
    gate["config4_train_fp32"] = ge.gated_epilogue.launches
    nchw["config4_train_fp32"] = layers.gated_conv.grad_nchw
    check(math.isfinite(loss32), f"Config 4 fp32 training loss {loss32}")
    log(f"[config4] fp32 {C4_FP32_STEPS}-step epoch call (NCHW-contiguous "
        f"convs): loss {loss32:.4f}; gated_conv.grad_nchw "
        f"{nchw['config4_train_fp32']} (15 a step)")
    del t32

    # (f) one IWAE request at fp32, through the kernel and the scan, chunked
    # by the autotune (10 points: one chunk of 10 x MB = 5000 rows a round)
    m32 = create_model(c32, device="cuda")
    m32.load_state_dict(exp.model.state_dict())
    m32.eval()
    bank, test_x = exp.bank, exp.test_x
    # the [sharded] phase's Config 4 step reads the same images from here
    np.save(snap_dir / C4_X_FILE, exp.train_x.cpu().numpy())
    (snap_dir / C4_CFG_FILE).write_text(exp.cfg.to_json())
    del exp, run, prof
    torch.cuda.empty_cache()
    ge.gated_epilogue.launches = layers.gated_conv.grad_nchw = 0
    eb = make_eval_bank_fn(m32, c32)(bank)
    gate["config4_eval_bank"] = ge.gated_epilogue.launches
    nchw["config4_eval_bank"] = layers.gated_conv.grad_nchw
    rounds, r = -(-c32.S // c32.MB), c32.MB
    g = torch.Generator("cuda").manual_seed(7)
    eps = [(torch.randn((rounds, C4_T * r, D), generator=g, device="cuda"),
            torch.randn((rounds, C4_T * r, D), generator=g, device="cuda"))]
    iwae_k = make_iwae_fn(m32, c32)
    iwae_k(test_x, eb, eps=eps)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the IWAE part of the path: counts 0 just before, read after ----
    pl.pairwise_lse.launches = ge.gated_epilogue.launches = 0
    layers.gated_conv.grad_nchw = 0
    t0 = time.perf_counter()
    mean_k, nll_k = iwae_k(test_x, eb, eps=eps)
    iwae_ms = (time.perf_counter() - t0) * 1e3
    iwae_launches = pl.pairwise_lse.launches
    gate["config4_iwae"] = ge.gated_epilogue.launches
    nchw["config4_iwae"] = layers.gated_conv.grad_nchw
    # ---- end ----
    iwae_gb = torch.cuda.max_memory_allocated() / 1e9
    _, nll_s = make_iwae_fn(m32, c32.replace(use_pallas_prior=False))(
        test_x, eb, eps=eps)
    err = float(np.abs(nll_k - nll_s).max())
    check(iwae_launches == rounds, f"the IWAE request launched the kernel "
          f"{iwae_launches} times, not {rounds} (one chunk of {C4_T})")
    check_gate_counts(gate, eval_bank=4 * _chunks(C4_N, c32),
                      iwae=3 * rounds + 8)
    check_grad_nchw(nchw, train_fp32=15 * C4_FP32_STEPS)
    check(nll_k.shape == (C4_T,) and bool(np.isfinite(nll_k).all()),
          "Config 4 IWAE NLL not finite")
    check(bool((np.abs(nll_k - nll_s) <= NLL_RTOL * np.abs(nll_s)).all()),
          f"Config 4 IWAE kernel vs scan max abs diff {err:.3g} > rtol "
          f"{NLL_RTOL}")
    log(f"[config4] IWAE request of {C4_T} points (one autotuned chunk), "
        f"S={c32.S}, MB={r} ({rounds} rounds of {C4_T * r} rows), fp32, eval "
        f"bank N={C4_N}: {iwae_ms:.3f} ms (warm, host clock); mean NLL "
        f"{mean_k:.4f}; kernel vs scan max abs diff {err:.3e} (rtol "
        f"{NLL_RTOL}); pairwise_lse launches {iwae_launches}; gated_epilogue "
        f"launches {gate['config4_iwae']}; peak memory {iwae_gb:.2f} GB")
    log_profile("config4-iwae", 1, profile_ms(
        lambda: iwae_k(test_x, eb, eps=eps)), unit="request")
    del m32, eb, eps, bank, test_x
    torch.cuda.empty_cache()
    return {"config4_train": train_launches, "config4_validation": val_launches,
            "config4_iwae": iwae_launches}, gate


def parting_rows(model, got, want, u, z2, eps1):
    """Rows in which binary samples ``got`` and ``want`` (B, H, W, 1)
    differ; fails unless each parts at a pixel whose uniform lies within
    PIX_U_MARGIN of its mean, decoded teacher-forced from ``want`` (the
    pixels before the first difference are shared, the decoder causal)."""
    b = got.shape[0]
    with torch.no_grad():
        p1_mean, p1_logvar = model.p_z1(z2)
        z1 = p1_mean + torch.exp(0.5 * p1_logvar) * eps1
        mean = model.decode(want, z1, z2)[0].reshape(b, -1).cpu()
    got, want = got.reshape(b, -1).cpu(), want.reshape(b, -1).cpu()
    u = u.reshape(u.shape[0], b).cpu()
    rows = 0
    for row in range(b):
        diff = torch.nonzero(got[row] != want[row]).flatten()
        if diff.numel():
            i = int(diff[0])
            gap = abs(float(u[i, row]) - float(mean[row, i]))
            check(gap < PIX_U_MARGIN, f"samples part at row {row} pixel {i} "
                  f"where |u - mean| = {gap:.3g} >= {PIX_U_MARGIN}")
            rows += 1
    return rows


def pixel_phase(pl, snap_dir):
    from exemplar_vae_tpu_torch.config import (Config, config_from_args,
                                               reference_arg_parser)
    from exemplar_vae_tpu_torch.main import main as cli_main
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.ops import masked_epilogue as me
    from exemplar_vae_tpu_torch.serve import (ServingBundle,
                                              export_serving_bundle,
                                              make_serving_fns)
    from exemplar_vae_tpu_torch.train.evaluation import (make_eval_bank_fn,
                                                         make_iwae_fn)
    from exemplar_vae_tpu_torch.train.plots import read_png
    from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                    make_train_step)
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    cfg = Config(dataset_name="synthetic", model_name="pixelhvae_2level",
                 prior="exemplar_prior", number_components=N_BANK,
                 training_set_size=N_BANK, val_set_size=C3_VAL,
                 test_set_size=PIX_T, batch_size=TRAIN_B, hidden_size=300,
                 z1_size=D, z2_size=D, S=C3_S, MB=C3_MB,
                 use_pallas_prior=True, exact_reencode_chunk=0,
                 exact_remat=False, compute_dtype="bfloat16",
                 snapshot_dir=str(snap_dir / "pixel"), seed=14)
    check(cfg.pixelcnn_features == 64 and cfg.pixelcnn_layers == 4
          and not cfg.approximate_prior, "Config's PixelCNN stack is not the "
          "JAX package's default")
    t0 = time.perf_counter()
    exp = Experiment(cfg, device="cuda", verbose=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(exp.cfg.input_type == "binary" and exp.cfg.dynamic_binarization
          and tuple(exp.train_x.shape) == (N_BANK, 28, 28, 1),
          f"PixelHVAE data: {exp.cfg.input_type} {tuple(exp.train_x.shape)}")
    n_params = sum(p.numel() for p in exp.model.parameters())

    # (a) the timed 200-step call
    run = lambda perm: exp.epoch_fn(  # noqa: E731
        exp.state, exp.train_x, exp.train_idx, perm, exp.bank, 1.0,
        generator=exp.gen)
    exp.state, _ = run(exp.epoch_perm(WARM_STEPS, TRAIN_B))
    perm = exp.epoch_perm(TRAIN_STEPS, TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the train part of the path: counts 0 just before, read after ----
    pl.pairwise_lse.launches = me.masked_epilogue.launches = 0
    t0 = time.perf_counter()
    exp.state, metrics = run(perm)
    loss = float(metrics["loss"])           # host read: ends the timed call
    dt = time.perf_counter() - t0
    train_launches = pl.pairwise_lse.launches
    epi = {"pixel_train": me.masked_epilogue.launches}
    # ---- end ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(math.isfinite(loss), f"PixelHVAE training loss {loss}")
    check(train_launches == TRAIN_STEPS, f"pairwise_lse launched "
          f"{train_launches} times in {TRAIN_STEPS} exact PixelHVAE steps")
    log(f"[pixel] PixelHVAE at full width: hidden {cfg.hidden_size}, z1 = z2 "
        f"= {D}, PixelCNN 5x5 'A' + {cfg.pixelcnn_layers} 3x3 'B' masked "
        f"convs of {cfg.pixelcnn_features} features, {n_params} params, bf16 "
        f"compute; synthetic 28x28 dynamically binarized; exact prior "
        f"N={N_BANK} (LOO) through the kernel, batch {TRAIN_B}, bank encode "
        f"in one piece; set-up (data, model) {setup_s:.2f} s")
    log(f"[pixel] {TRAIN_STEPS}-step epoch call: {dt * 1e3:.3f} ms = "
        f"{dt / TRAIN_STEPS * 1e3:.4f} ms/step, {TRAIN_STEPS * TRAIN_B / dt:.1f} "
        f"images/s; loss {loss:.4f}; pairwise_lse launches {train_launches}; "
        f"peak memory {peak_gb:.2f} GB")

    # (b) profile and host syncs
    prof = profile_ms(lambda: run(exp.epoch_perm(PROF_STEPS, TRAIN_B)))
    log_host(prof, "pixel-profile", PROF_STEPS)
    log_syncs("pixel-profile", exp, run)
    log_profile("pixel-profile", PROF_STEPS, prof)

    # (c) one fp32 step, kernel prior vs scan prior, same params and noise
    g = torch.Generator("cuda").manual_seed(3)
    rows = perm[0]
    x_raw = exp.train_x[rows]
    u = torch.rand(x_raw.shape, generator=g, device="cuda")
    eps = (torch.randn((TRAIN_B, D), generator=g, device="cuda"),
           torch.randn((TRAIN_B, D), generator=g, device="cuda"))
    res = {}
    for kernel in (True, False):
        c = cfg.replace(compute_dtype="float32", use_pallas_prior=kernel)
        m = create_model(c, device="cuda")
        m.load_state_dict(exp.model.state_dict())
        _, aux = make_train_step(c)(init_train_state(m, c), x_raw,
                                    exp.train_idx[rows], exp.bank, 1.0, u=u,
                                    eps=eps)
        res[kernel] = (float(aux["loss"]),
                       {n: p.grad for n, p in m.named_parameters()})
    (lk, gk), (ls, gs) = res[True], res[False]
    check(abs(lk - ls) <= STEP_LOSS_RTOL * abs(ls),
          f"PixelHVAE kernel vs scan step loss {lk} vs {ls}")
    worst = ("", -1.0)
    for name, a in gk.items():
        rel = float((a - gs[name]).abs().max()) / max(
            float(gs[name].abs().max()), 1e-30)
        check(bool(torch.isfinite(a).all()), f"non-finite gradient {name}")
        check(rel <= GRAD_REL, f"PixelHVAE kernel vs scan gradient {name}: "
              f"{rel:.3g} of its largest element > {GRAD_REL}")
        worst = max(worst, (name, rel), key=lambda t: t[1])
    log(f"[pixel] fp32 step, kernel vs scan prior: loss {lk:.6f} vs {ls:.6f} "
        f"(rel {abs(lk - ls) / abs(ls):.3e}, rtol {STEP_LOSS_RTOL}); worst "
        f"gradient {worst[0]} at {worst[1]:.3e} of its largest element "
        f"(limit {GRAD_REL})")
    del res, gk, gs, m

    # (d) the validation ELBO (eval bank encode + 100 batches)
    pl.pairwise_lse.launches = me.masked_epilogue.launches = 0
    t0 = time.perf_counter()
    val = exp.validate()
    val_s = time.perf_counter() - t0
    val_launches = pl.pairwise_lse.launches
    epi["pixel_validation"] = me.masked_epilogue.launches
    want_val = -(-C3_VAL // cfg.test_batch_size)
    check(all(math.isfinite(v) for v in val), f"PixelHVAE validation {val}")
    check(val_launches == want_val, f"validation launched the kernel "
          f"{val_launches} times, not {want_val}")
    log(f"[pixel] validation ELBO over {C3_VAL} images (bf16): {val_s:.3f} s "
        f"(host clock, eval bank encode included); loss {val[0]:.4f}; "
        f"pairwise_lse launches {val_launches}")

    # (e) one IWAE request at fp32, through the kernel and the scan
    c32 = exp.cfg.replace(compute_dtype="float32")
    m32 = create_model(c32, device="cuda")
    m32.load_state_dict(exp.model.state_dict())
    m32.eval()
    bank, test_x = exp.bank, exp.test_x
    del exp, run, prof
    torch.cuda.empty_cache()
    eb = make_eval_bank_fn(m32, c32)(bank)
    rounds, r = -(-c32.S // c32.MB), c32.MB
    g = torch.Generator("cuda").manual_seed(7)
    eps = (torch.randn((rounds, PIX_T * r, D), generator=g, device="cuda"),
           torch.randn((rounds, PIX_T * r, D), generator=g, device="cuda"))
    iwae_k = make_iwae_fn(m32, c32).chunk_nll
    iwae_k(test_x, eb, rounds, r, eps=eps)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the IWAE part of the path: counts 0 just before, read after ----
    pl.pairwise_lse.launches = me.masked_epilogue.launches = 0
    t0 = time.perf_counter()
    nll_k = iwae_k(test_x, eb, rounds, r, eps=eps).cpu()
    iwae_ms = (time.perf_counter() - t0) * 1e3
    iwae_launches = pl.pairwise_lse.launches
    epi["pixel_iwae"] = epilogue_launches = me.masked_epilogue.launches
    # ---- end ----
    iwae_gb = torch.cuda.max_memory_allocated() / 1e9
    nll_s = make_iwae_fn(m32, c32.replace(use_pallas_prior=False)).chunk_nll(
        test_x, eb, rounds, r, eps=eps).cpu()
    err = float((nll_k - nll_s).abs().max())
    check(iwae_launches == rounds, f"the PixelHVAE IWAE request launched the "
          f"kernel {iwae_launches} times, not {rounds}")
    want_epi = rounds * (1 + c32.pixelcnn_layers)
    check(epilogue_launches == want_epi, f"the PixelHVAE IWAE request "
          f"launched the masked epilogue {epilogue_launches} times, not "
          f"{want_epi}")
    check(nll_k.shape == (PIX_T,) and bool(torch.isfinite(nll_k).all()),
          "PixelHVAE IWAE NLL not finite")
    check(bool(((nll_k - nll_s).abs() <= NLL_RTOL * nll_s.abs()).all()),
          f"PixelHVAE IWAE kernel vs scan max abs diff {err:.3g} > rtol "
          f"{NLL_RTOL}")
    log(f"[pixel] IWAE request of {PIX_T} points, S={c32.S}, MB={r} "
        f"({rounds} rounds of {PIX_T * r} rows), fp32, eval bank N={N_BANK}, "
        f"the decoder teacher-forced on the repeated x: {iwae_ms:.3f} ms "
        f"(warm, host clock); mean NLL {float(nll_k.mean()):.4f}; kernel vs "
        f"scan max abs diff {err:.3e} (rtol {NLL_RTOL}); pairwise_lse "
        f"launches {iwae_launches}; masked_epilogue launches "
        f"{epilogue_launches}; peak memory {iwae_gb:.2f} GB")
    log_profile("pixel-iwae", 1, profile_ms(
        lambda: iwae_k(test_x, eb, rounds, r, eps=eps)), unit="request")
    del eps
    torch.cuda.empty_cache()

    # (f) the two samplers on the same z2 rows and injected noise, fp32
    g = torch.Generator("cuda").manual_seed(9)
    idx = torch.randint(0, N_BANK, (PIX_ROWS,), generator=g, device="cuda")
    z2 = eb.cache_means[idx] + torch.exp(0.5 * m32.get_prior_log_var()) * \
        torch.randn((PIX_ROWS, D), generator=g, device="cuda")
    noise = (torch.randn((PIX_ROWS, D), generator=g, device="cuda"),
             torch.rand((28 * 28, PIX_ROWS, 1), generator=g, device="cuda"))
    out, ms, launches = {}, {}, {}
    samplers = {"crop": m32.generate_from_top,
                "naive": m32.generate_from_top_naive}
    pl.pairwise_lse.launches = 0
    for name, fn in samplers.items():
        fn(z2, eps=noise)                                # warm-up
        me.masked_epilogue.launches = 0
        ms[name] = wall_ms(lambda: out.setdefault(name, fn(z2, eps=noise)))
        epi[f"pixel_sampler_{name}"] = me.masked_epilogue.launches
        prof = profile_ms(lambda: fn(z2, eps=noise))
        launches[name] = sum(c for op, _, c in prof[3]
                             if "LaunchKernel" in op)
        log_profile(f"pixel-sampler-{name}", 1, prof, unit="call")
    sampler_launches = pl.pairwise_lse.launches
    check(sampler_launches == 0, "a sampler launched pairwise_lse")
    for name, s in out.items():
        check(tuple(s.shape) == (PIX_ROWS, 28, 28, 1)
              and set(torch.unique(s).tolist()) <= {0.0, 1.0},
              f"{name} sampler output {tuple(s.shape)} not binary")
    parted = parting_rows(m32, out["crop"], out["naive"], noise[1], z2,
                          noise[0])
    log(f"[pixel] samplers on {PIX_ROWS} rows, 28x28 = 784 steps, fp32: crop "
        f"(receptive field {m32._receptive_halfwidth() + 1}x"
        f"{2 * m32._receptive_halfwidth() + 1}) {ms['crop']:.3f} ms, "
        f"{launches['crop']} CUDA launches = "
        f"{launches['crop'] / 784:.1f} per pixel; naive (full canvas) "
        f"{ms['naive']:.3f} ms, {launches['naive']} launches = "
        f"{launches['naive'] / 784:.1f} per pixel (host clock, warm); "
        f"samples binary, {parted} of {PIX_ROWS} rows part (each where "
        f"|u - mean| < {PIX_U_MARGIN})")

    # the bundle of this model: export, load on the card, generate again
    bdir = snap_dir / "pixel_bundle"
    t0 = time.perf_counter()
    export_serving_bundle(m32, c32, str(bdir), bank_means=eb.cache_means,
                          data_idx=eb.data_idx, valid=eb.valid,
                          n_gen=PIX_GEN, s_total=c32.S, r=r)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = ServingBundle.load(str(bdir))
    load_s = time.perf_counter() - t0
    gen, _, _ = make_serving_fns(m32, c32, N_BANK, PIX_GEN, rounds, r)
    e = (idx[:PIX_GEN], noise[0][:PIX_GEN])
    e1 = (noise[0][:PIX_GEN], noise[1][:, :PIX_GEN])
    live = gen(eb.cache_means, idx=e[0], eps=e[1], eps1=e1)
    served = bundle.generate(idx=e[0], eps=e[1], eps1=e1)
    check(torch.equal(live, served), "the loaded PixelHVAE bundle's generate "
          "differs from the live sampler")
    size_mb = sum(f.stat().st_size for f in bdir.iterdir()) / 1e6
    log(f"[pixel-export] export {export_s:.3f} s, load on the card "
        f"{load_s:.3f} s, {size_mb:.3f} MB; generate of {PIX_GEN} with "
        f"injected noise equals the live sampler bitwise")
    del m32, eb, bank, test_x, bundle, live, served, out
    torch.cuda.empty_cache()

    # (g) the CLI, one epoch
    cli_dir = snap_dir / "pixel_cli"
    argv = ["--model_name", "pixelhvae_2level", "--dataset_name", "synthetic",
            "--training_set_size", str(N_BANK), "--number_components",
            str(N_BANK), "--val_set_size", "256", "--test_set_size", "256",
            "--epochs", "1", "--S", "8", "--MB", "8", "--compute_dtype",
            "bfloat16", "--snapshot_dir", str(cli_dir)]
    buf = io.StringIO()
    pl.pairwise_lse.launches = me.masked_epilogue.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = cli_main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = pl.pairwise_lse.launches
    epi["pixel_cli_epoch"] = me.masked_epilogue.launches
    for line in buf.getvalue().splitlines():
        log(f"[pixel-cli] | {line}")
    c = config_from_args(reference_arg_parser().parse_args(argv))
    val_batches = -(-c.val_set_size // c.test_batch_size)
    iwae_calls = (-(-c.test_set_size // c.test_batch_size)
                  * -(-c.S // min(c.MB, c.S)))
    want = (c.epochs * (c.training_set_size // c.batch_size + val_batches)
            + val_batches + iwae_calls)
    check(cli_launches == want, f"the PixelHVAE CLI epoch launched the "
          f"kernel {cli_launches} times, not {want}")
    (exp_dir,) = [p for p in cli_dir.iterdir() if p.is_dir()]
    records = [json.loads(line) for line in
               (exp_dir / "metrics.jsonl").read_text().splitlines()]
    on_disk = json.loads((exp_dir / "results.json").read_text())
    nums = [v for rec in records + [on_disk] for v in rec.values()
            if isinstance(v, (int, float))]
    check(len(records) == 2 and on_disk == results
          and "artifact_error" not in results
          and all(math.isfinite(v) for v in nums),
          f"PixelHVAE CLI metrics or results: {records} {on_disk}")
    for name in C5_GRIDS:
        shape = read_png(str(exp_dir / name)).shape
        check(shape == C5_GRID_SHAPE, f"{name} decodes to {shape}, not "
              f"{C5_GRID_SHAPE}")
    log(f"[pixel-cli] python -m exemplar_vae_tpu_torch.main "
        f"{' '.join(argv)}: {cli_s:.2f} s; epoch "
        f"{records[0]['epoch_seconds']:.3f} s "
        f"({records[0]['images_per_sec']:.1f} images/s, bank chunks of 8192 "
        f"with recompute); loss {records[0]['loss']:.4f}, val_loss "
        f"{records[0]['val_loss']:.4f}, test_nll {results['test_nll']:.4f}; "
        f"five PNG grids decode; pairwise_lse launches {cli_launches}")
    # the epilogue runs on the no-grad fp32 teacher-forced stack alone: the
    # IWAE request (1 + layers a round) and the naive sampler (a decode a
    # pixel); never in training, the bf16 validation and CLI epoch or the
    # crop sampler
    layers = 1 + cfg.pixelcnn_layers
    want_epi = {"pixel_train": 0, "pixel_validation": 0,
                "pixel_iwae": rounds * layers, "pixel_sampler_crop": 0,
                "pixel_sampler_naive": 28 * 28 * layers, "pixel_cli_epoch": 0}
    check(epi == want_epi, f"masked_epilogue launches per path {epi}, not "
          f"{want_epi}")
    log(f"[pixel] masked_epilogue launches per path: {epi}")
    return ({"pixel_train": train_launches, "pixel_validation": val_launches,
             "pixel_iwae": iwae_launches, "pixel_samplers": sampler_launches,
             "pixel_cli_epoch": cli_launches}, epi)


def ingest_phase():
    """The native parsers against numpy on an MNIST-sized IDX file and a
    static-MNIST-sized .amat split (host only)."""
    from exemplar_vae_tpu_torch.data import native_ingest

    build_s = native_ingest.build()
    rng = np.random.default_rng(0)
    idx_arr = rng.integers(0, 256, INGEST_IDX, dtype=np.uint8)
    amat_arr = (rng.random(INGEST_AMAT) < 0.3).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        idx_path, amat_path = f"{d}/train-images-idx3-ubyte", f"{d}/x.amat"
        with open(idx_path, "wb") as f:
            f.write(bytes([0, 0, 0x08, idx_arr.ndim]))
            for n in idx_arr.shape:
                f.write(n.to_bytes(4, "big"))
            f.write(idx_arr.tobytes())
        with open(amat_path, "w") as f:
            f.writelines(" ".join("1" if v else "0" for v in row) + " \n"
                         for row in amat_arr)
        t = {}
        t0 = time.perf_counter()
        got_idx = native_ingest.load_idx(idx_path)
        t["idx_native"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = Path(idx_path).read_bytes()
        want_idx = np.frombuffer(data, np.uint8, offset=16).reshape(
            INGEST_IDX)
        t["idx_numpy"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_amat = native_ingest.load_amat(amat_path, INGEST_AMAT[1])
        t["amat_native"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_amat = np.loadtxt(amat_path, dtype=np.float32).reshape(
            -1, INGEST_AMAT[1])
        t["amat_numpy"] = time.perf_counter() - t0
        mb = (Path(idx_path).stat().st_size / 1e6,
              Path(amat_path).stat().st_size / 1e6)
    check(np.array_equal(got_idx, idx_arr) and np.array_equal(got_idx,
                                                              want_idx),
          "the native IDX parser differs from numpy")
    check(np.array_equal(got_amat, amat_arr)
          and np.array_equal(got_amat, want_amat),
          "the native .amat parser differs from numpy")
    log(f"[ingest] g++ build + load {build_s:.3f} s; IDX {INGEST_IDX} "
        f"({mb[0]:.1f} MB): native {t['idx_native'] * 1e3:.3f} ms, numpy "
        f"frombuffer {t['idx_numpy'] * 1e3:.3f} ms; .amat {INGEST_AMAT} "
        f"({mb[1]:.1f} MB): native {t['amat_native'] * 1e3:.3f} ms, numpy "
        f"loadtxt {t['amat_numpy'] * 1e3:.3f} ms; arrays equal (host clock)")


def _sharded_cfg():
    """Config 1 training at full width, fp32 (TF32 off) so that one process
    and the ranks agree to float rounding: the exact prior over N_BANK with
    LOO, the bank encoded in one piece."""
    from exemplar_vae_tpu_torch.config import Config
    return Config(dataset_name="synthetic", model_name="vae",
                  prior="exemplar_prior", number_components=N_BANK,
                  hidden_size=300, z1_size=D, batch_size=TRAIN_B,
                  use_pallas_prior=True, exact_reencode_chunk=0,
                  exact_remat=False, compute_dtype="float32", seed=14)


def _sharded_c4_cfg(snap_dir):
    """[config4]'s Config 4 (ConvHVAE, approximate prior K = 10 per row over
    C4_N, batch 100, bank chunks of C4_CHUNK) at fp32, TF32 off."""
    from exemplar_vae_tpu_torch.config import Config
    return Config.from_json((snap_dir / C4_CFG_FILE).read_text()).replace(
        compute_dtype="float32")


def _sharded_bank(dev):
    from exemplar_vae_tpu_torch.data.synthetic import synthetic_images
    return torch.from_numpy(synthetic_images(N_BANK, 28, 28, 1,
                                             seed=1)[0]).to(dev)


def _watch_rows(model):
    """The rows the model's batch forward (a pre-hook) and its re-encodes
    (encode_top_mean) see, appended to lists as they run."""
    seen = {"forward": [], "reencode": []}
    model.register_forward_pre_hook(
        lambda _, args: seen["forward"].append(args[0].shape[0]))
    encode = model.encode_top_mean

    def counted(x):
        seen["reencode"].append(x.shape[0])
        return encode(x)

    model.encode_top_mean = counted
    return seen


def _device_split(prof):
    """(device ms, of it the copies' ms) of a profile_ms result: gloo
    stages a CUDA tensor through the host, as Memcpy events."""
    return prof[1], sum(t for name, t, _ in prof[2] if "Memcpy" in name)


def _copy_rows(seen):
    return {k: list(v) for k, v in seen.items()}


def _step_grads(model):
    return {k: p.grad.cpu() for k, p in model.named_parameters()}


def _sharded_child_exact(work, cfg, mesh, dev, terms):
    """[sharded] (a) on one rank: Config 1's exact step from the parent's
    params and noise, then a second step outside the count."""
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.ops import pairwise_lse as pl
    from exemplar_vae_tpu_torch.train.loss import Bank
    from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                    make_train_step)

    inp = torch.load(work / "inputs.pt", weights_only=True)
    model = create_model(cfg, device=dev)
    model.load_state_dict(inp["params"])
    seen_a = _watch_rows(model)
    bank_x = _sharded_bank(dev)
    lo, hi = mesh.shard_range(N_BANK)
    bank = Bank(images=bank_x[lo:hi],
                data_idx=torch.arange(lo, hi, dtype=torch.int32,
                                      device=dev),
                valid=torch.ones(hi - lo, dtype=torch.bool, device=dev),
                cache_means=None, n_effective=N_BANK)
    rows = inp["rows"].to(dev)
    step = make_train_step(cfg, mesh=mesh)
    torch.cuda.synchronize()
    # ---- the path's step: counts 0 just before, read after ----
    pl.pairwise_lse.launches = 0
    t0 = time.perf_counter()
    _, aux = step(init_train_state(model, cfg), bank_x[rows],
                  rows.to(torch.int32), bank, 1.0, u=inp["u"].to(dev),
                  eps=inp["eps"].to(dev))
    loss_a = terms(aux)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = pl.pairwise_lse.launches
    # ---- end ----
    out = {"loss": loss_a[0], "launches": launches, "step_ms": step_ms,
           "grads": _step_grads(model), "rows": _copy_rows(seen_a)}
    # a second step, outside the count: the first pays the process's
    # first cuBLAS, kernel-module and collective calls
    t0 = time.perf_counter()
    _, aux = step(init_train_state(model, cfg), bank_x[rows],
                  rows.to(torch.int32), bank, 1.0, u=inp["u"].to(dev),
                  eps=inp["eps"].to(dev))
    terms(aux)
    out["step2_ms"] = (time.perf_counter() - t0) * 1e3
    del model, bank_x, bank, step
    torch.cuda.empty_cache()

    return out


def sharded_child(work, backend="gloo"):
    """One rank of the [sharded] phase (torchrun sets RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT), data-parallel (TRAIN_B / W rows of each
    batch), each holding 1 / W of the bank: gloo ranks sharing cuda:0, or
    NCCL ranks on cuda:LOCAL_RANK. (a) One Config 1 exact step from the
    parent's params and noise (gloo only); (b) one Config 4 approximate
    step from the parent's params, noise and cache, its kNN selection
    recorded, then a profiled step. Writes rank<r>.pt into ``work``."""
    import os

    import torch.distributed as dist

    from exemplar_vae_tpu_torch.device import resolve_device
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.ops import pairwise_lse as pl
    from exemplar_vae_tpu_torch.parallel import sharded_knn
    from exemplar_vae_tpu_torch.parallel.mesh import (create_mesh,
                                                      init_distributed,
                                                      shutdown)
    from exemplar_vae_tpu_torch.train.loss import Bank
    from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                    make_train_step)

    world = int(os.environ["WORLD_SIZE"])
    dev = resolve_device("cuda:0" if backend == "gloo" else
                         f"cuda:{os.environ['LOCAL_RANK']}")
    init_distributed(dev, backend=backend)
    try:
        cfg = _sharded_cfg().replace(mesh_shape=(world,))
        mesh = create_mesh(cfg, dev)
        check(mesh is not None and mesh.size == world, "no mesh")
        log(f"[sharded] rank {mesh.rank}: backend {dist.get_backend()}, "
            f"world_size {dist.get_world_size()}, device {mesh.device}, "
            f"{'' if banned_modules() == [] else 'JAX LOADED '}"
            f"kernel build {pl.build():.2f} s (reused from _build/)")

        def terms(aux):
            """The step's loss, RE and KL: the ranks' shares, summed."""
            t = mesh.all_reduce(torch.stack([aux[k] for k in
                                             ("loss", "re", "kl")]))
            return [float(v) for v in t]

        out = {}
        if backend == "gloo":
            out = _sharded_child_exact(work, cfg, mesh, dev, terms)

        # (b) Config 4, approximate prior per row
        c4 = torch.load(work / "c4_inputs.pt", weights_only=True)
        cfg4 = _sharded_c4_cfg(work.parent).replace(mesh_shape=(world,))
        images = np.load(work.parent / C4_X_FILE, mmap_mode="r")
        lo, hi = mesh.shard_range(C4_N)
        rows = c4["rows"]
        x = torch.from_numpy(images[rows.numpy()]).to(dev)
        shard = Bank(images=torch.from_numpy(np.ascontiguousarray(
            images[lo:hi])).to(dev),
            data_idx=torch.arange(lo, hi, dtype=torch.int32, device=dev),
            valid=torch.ones(hi - lo, dtype=torch.bool, device=dev),
            cache_means=c4["cache"][lo:hi].to(dev), n_effective=C4_N)
        model = create_model(cfg4, device=dev)
        model.load_state_dict(c4["params"])
        seen_b = _watch_rows(model)
        u, eps = c4["u"].to(dev), tuple(e.to(dev) for e in c4["eps"])
        idx = rows.to(dev, torch.int32)
        selections = []
        select = sharded_knn.sharded_knn_select

        def recording(*args, **kw):
            sel = select(*args, **kw)
            selections.append(sel.cpu())
            return sel

        step = make_train_step(cfg4, mesh=mesh)
        sharded_knn.sharded_knn_select = recording
        try:
            # ---- the path's step: counts 0 just before, read after ----
            pl.pairwise_lse.launches = 0
            _, aux = step(init_train_state(model, cfg4), x, idx, shard, 1.0,
                          u=u, eps=eps)
            loss_b = terms(aux)
            launches_b = pl.pairwise_lse.launches
            # ---- end ----
        finally:
            sharded_knn.sharded_knn_select = select
        out["c4"] = {"loss": loss_b[0], "launches": launches_b,
                     "selection": selections[0],
                     "grads": _step_grads(model), "rows": _copy_rows(seen_b)}
        prof = profile_ms(lambda: terms(step(
            init_train_state(model, cfg4), x, idx, shard, 1.0, u=u,
            eps=eps)[1]))
        out["c4"]["device_ms"], out["c4"]["copy_ms"] = _device_split(prof)
        out["c4"]["wall_ms"] = prof[0]
        out.update(backend=dist.get_backend(),
                   world_size=dist.get_world_size(), banned=banned_modules())
        torch.save(out, work / f"rank{mesh.rank}.pt")
    finally:
        shutdown()


def _sharded_c4_reference(snap_dir, work):
    """Part (b)'s one-process reference: Config 4 at fp32 from seeded params
    over [config4]'s images, the cache refresh of all C4_N rows, one step's
    kNN selection (the batch's q(z2|x) means against the cache), loss and
    gradients, and a profiled step's device ms; writes the ranks' inputs
    (params, rows, noise, cache) into ``work``."""
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.ops.knn import knn_indices
    from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch
    from exemplar_vae_tpu_torch.train.loss import Bank
    from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                    make_cache_refresh,
                                                    make_train_step)

    cfg = _sharded_c4_cfg(snap_dir)
    dev = torch.device("cuda")
    images = torch.from_numpy(np.load(snap_dir / C4_X_FILE)).to(dev)
    check(tuple(images.shape) == (C4_N, 64, 64, 3) and cfg.input_type ==
          "continuous", f"[config4]'s images {tuple(images.shape)}")
    model = create_model(cfg, device=dev, seed=0)
    params = {k: v.cpu() for k, v in model.state_dict().items()}
    bank = Bank(images=images,
                data_idx=torch.arange(C4_N, dtype=torch.int32, device=dev),
                valid=torch.ones(C4_N, dtype=torch.bool, device=dev),
                cache_means=None, n_effective=C4_N)
    refresh = make_cache_refresh(model, cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = refresh(images)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    refresh_gb = torch.cuda.max_memory_allocated() / 1e9
    bank = bank._replace(cache_means=cache)
    g = torch.Generator("cuda").manual_seed(12)
    rows = torch.randperm(C4_N, generator=g, device=dev)[:TRAIN_B]
    u = torch.rand((TRAIN_B, 64, 64, 3), generator=g, device=dev)
    eps = tuple(torch.randn((TRAIN_B, n), generator=g, device=dev)
                for n in (cfg.z2_size, cfg.z1_size))
    torch.save({"params": params, "rows": rows.cpu(), "u": u.cpu(),
                "eps": tuple(e.cpu() for e in eps), "cache": cache.cpu()},
               work / "c4_inputs.pt")
    with torch.no_grad():
        x = preprocess_batch(images[rows], input_type=cfg.input_type,
                             dynamic_binarization=cfg.dynamic_binarization,
                             train=True, u=u)
        q = model.encode_top(x)[0]
    selection = knn_indices(q, cache, cfg.approximate_k, valid=bank.valid)
    seen = _watch_rows(model)
    step = make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    _, aux = step(init_train_state(model, cfg), images[rows],
                  rows.to(torch.int32), bank, 1.0, u=u, eps=eps)
    loss = float(aux["loss"])
    step_gb = torch.cuda.max_memory_allocated() / 1e9
    ref = {"loss": loss, "grads": _step_grads(model), "rows": _copy_rows(seen),
           "selection": selection.cpu(), "q": q, "cache": cache,
           "refresh_ms": refresh_ms, "refresh_gb": refresh_gb,
           "step_gb": step_gb}
    prof = profile_ms(lambda: float(step(
        init_train_state(model, cfg), images[rows], rows.to(torch.int32),
        bank, 1.0, u=u, eps=eps)[1]["loss"]))
    ref["device_ms"], ref["copy_ms"] = _device_split(prof)
    ref["wall_ms"] = prof[0]
    return ref


def _check_grads(tag, got, want, dev):
    """Each gradient within GRAD_REL of its largest element; the worst
    (name, share)."""
    worst = ("", -1.0)
    for name, w in want.items():
        w = w.to(dev)
        e = float((got[name].to(dev) - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        check(e <= GRAD_REL, f"{tag} gradient {name}: {e:.3g} of its "
              f"largest element > {GRAD_REL}")
        worst = max(worst, (name, e), key=lambda t: t[1])
    return worst


def _tied_reorders(sel, want, q, cache, dev):
    """The rows of ``sel`` (B, K) whose order differs from ``want``'s
    within a tie: the same K rows, and at each position that differs, the
    two rows' distances to q (recomputed in fp32 as (q - c)^2) within
    TIE_ULPS ulps of |q|^2 + |c|^2. (tied rows, rows that differ otherwise,
    the log lines of the first five that differ)."""
    tied, other, lines = [], [], []
    for b in (sel != want).any(1).nonzero().flatten().tolist():
        qb = q[b].to(dev)

        def dist(cols):
            c = cache[cols.to(dev)]
            return ((qb[None] - c) ** 2).sum(-1), (c * c).sum(-1)

        d_got, c2_got = dist(sel[b])
        d_want, c2_want = dist(want[b])
        tol = TIE_ULPS * 2.0 ** -23 * (float((qb * qb).sum())
                                       + torch.maximum(c2_got, c2_want))
        moved = sel[b] != want[b]
        ok = (torch.equal(sel[b].sort().values, want[b].sort().values)
              and bool(((d_got - d_want).abs() <= tol)[moved.to(dev)].all()))
        (tied if ok else other).append(b)
        if len(lines) < 5:
            lines.append(
                f"row {b}: one process's rows {want[b].tolist()} at "
                f"distances {d_want.tolist()}; the rank's {sel[b].tolist()} "
                f"at {d_got.tolist()}; tie allowance "
                f"{tol[moved.to(dev)].tolist()}: "
                f"{'a tie' if ok else 'not a tie'}")
    return tied, other, lines


def _check_c4_rank(tag, r, out, c4, dev, note, ties=False):
    """[sharded]'s Config 4 checks of rank ``r`` (``out``: its rank<r>.pt):
    each batch row's K selected bank rows equal to one process's, in order
    (``ties``: or in another order within a tie, _tied_reorders), no
    kernel launch, the loss and gradients as in (a), the rows its forward
    and re-encode saw; and the log lines."""
    o4, world = out["c4"], out["world_size"]
    k = c4["selection"].shape[1]
    b_r = TRAIN_B // world
    sel, want = o4["selection"], c4["selection"]
    tied, other, lines = _tied_reorders(sel, want, c4["q"], c4["cache"], dev)
    for line in lines:
        log(f"[sharded] {tag} rank {r} {line}")
    check(not other and (ties or not tied), f"{tag} rank {r}'s Config 4 kNN "
          f"selection differs from one process's in rows {other or tied}")
    check(o4["launches"] == 0, f"{tag} rank {r}'s approximate step launched "
          f"the kernel {o4['launches']} times")
    rel4 = abs(o4["loss"] - c4["loss"]) / abs(c4["loss"])
    check(rel4 <= STEP_LOSS_RTOL, f"{tag} rank {r} Config 4 loss "
          f"{o4['loss']} vs one process {c4['loss']}")
    worst4 = _check_grads(f"{tag} rank {r} Config 4", o4["grads"],
                          c4["grads"], dev)
    check(o4["rows"] == {"forward": [b_r], "reencode": [b_r * k]},
          f"{tag} rank {r}'s Config 4 step saw rows {o4['rows']}")
    log(f"[sharded] {tag} rank {r} ({out['backend']}, world_size {world}): "
        f"Config 4 approximate step (K={k} per row, N={C4_N} split "
        f"{C4_N // world} per rank, fp32): selection ({TRAIN_B}, {k}) the "
        f"same rows as one process's ({len(tied)} rows in another order "
        f"within a tie); "
        f"loss {o4['loss']:.6f} vs one process "
        f"{c4['loss']:.6f} (rel {rel4:.3e}, rtol {STEP_LOSS_RTOL}); worst "
        f"gradient {worst4[0]} at {worst4[1]:.3e} of its largest element; "
        f"pairwise_lse launches {o4['launches']}")
    log(f"[sharded] {tag} rank {r}: batch forward {o4['rows']['forward']} "
        f"rows, re-encode {o4['rows']['reencode']} rows; a profiled step: "
        f"device {o4['device_ms']:.3f} ms (copies {o4['copy_ms']:.3f} ms), "
        f"wall {o4['wall_ms']:.3f} ms ({note})")


def sharded_phase(pl, snap_dir):
    """Part B on the card: SHARD_W gloo ranks sharing the card (torchrun
    child processes of this script), data-parallel, against one process
    from the same params and injected noise: (a) Config 1's exact step at
    full width, the bank split 25 000 / 25 000; (b) Config 4's approximate
    step at full width, the bank split 100 000 / 100 000, the cache of one
    process's refresh; (c) each rank's rows and device ms against one
    process's."""
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.train.loss import Bank
    from exemplar_vae_tpu_torch.train.steps import (init_train_state,
                                                    make_train_step)

    work = snap_dir / "sharded"
    work.mkdir()
    cfg = _sharded_cfg()
    dev = torch.device("cuda")
    model = create_model(cfg, device=dev, seed=0)
    g = torch.Generator("cuda").manual_seed(11)
    rows = torch.randperm(N_BANK, generator=g, device=dev)[:TRAIN_B]
    u = torch.rand((TRAIN_B, 28, 28, 1), generator=g, device=dev)
    eps = torch.randn((TRAIN_B, D), generator=g, device=dev)
    torch.save({"params": {k: v.cpu() for k, v in model.state_dict().items()},
                "rows": rows.cpu(), "u": u.cpu(), "eps": eps.cpu()},
               work / "inputs.pt")
    bank_x = _sharded_bank(dev)
    bank = Bank(images=bank_x,
                data_idx=torch.arange(N_BANK, dtype=torch.int32, device=dev),
                valid=torch.ones(N_BANK, dtype=torch.bool, device=dev),
                cache_means=None, n_effective=N_BANK)
    _, aux = make_train_step(cfg)(init_train_state(model, cfg), bank_x[rows],
                                  rows.to(torch.int32), bank, 1.0, u=u,
                                  eps=eps)
    ref_loss = float(aux["loss"])
    ref = {k: p.grad for k, p in model.named_parameters()}
    del bank_x, bank
    c4 = _sharded_c4_reference(snap_dir, work)
    torch.cuda.empty_cache()

    outs, wall_s = _torchrun(work, SHARD_W, "gloo")
    launches = {}
    b_r, k = TRAIN_B // SHARD_W, c4["selection"].shape[1]
    for r, out in enumerate(outs):
        check(out["banned"] == [], f"rank {r} imported {out['banned']}")
        # (a)
        check(out["launches"] == 1, f"rank {r} launched the kernel "
              f"{out['launches']} times in one step")
        check(out["rows"] == {"forward": [b_r], "reencode": [N_BANK //
                                                             SHARD_W]},
              f"rank {r}'s Config 1 step saw rows {out['rows']}")
        rel = abs(out["loss"] - ref_loss) / abs(ref_loss)
        check(rel <= STEP_LOSS_RTOL, f"rank {r} loss {out['loss']} vs one "
              f"process {ref_loss}")
        worst = _check_grads(f"rank {r}", out["grads"], ref, dev)
        launches[f"sharded_rank{r}"] = out["launches"]
        log(f"[sharded] (a) rank {r} ({out['backend']}, world_size "
            f"{out['world_size']}): Config 1 exact step, {b_r} of the batch's "
            f"{TRAIN_B} rows: loss (the ranks' shares summed) "
            f"{out['loss']:.6f} vs one process {ref_loss:.6f} (rel "
            f"{rel:.3e}, rtol {STEP_LOSS_RTOL}); worst gradient {worst[0]} "
            f"at {worst[1]:.3e} of its largest element (limit {GRAD_REL}); "
            f"pairwise_lse launches {out['launches']} at B={TRAIN_B} (z "
            f"gathered), N={N_BANK // SHARD_W}, LOO; step "
            f"{out['step_ms']:.3f} ms (the process's first), a second "
            f"{out['step2_ms']:.3f} ms")
        # (b) and (c)
        _check_c4_rank("(b)", r, out, c4, dev, "two ranks share the card: "
                       "no sharding speed")
        launches[f"sharded_config4_rank{r}"] = out["c4"]["launches"]
    check(c4["rows"] == {"forward": [TRAIN_B], "reencode": [TRAIN_B * k]},
          f"one process's Config 4 step saw rows {c4['rows']}")
    log(f"[sharded] (c) one process: batch forward {c4['rows']['forward']} "
        f"rows, re-encode {c4['rows']['reencode']} rows; a profiled step: "
        f"device {c4['device_ms']:.3f} ms (copies {c4['copy_ms']:.3f} ms), "
        f"wall {c4['wall_ms']:.3f} ms; "
        f"step peak memory {c4['step_gb']:.2f} GB; cache refresh of "
        f"{C4_N} rows at fp32 {c4['refresh_ms']:.1f} ms (host clock), peak "
        f"{c4['refresh_gb']:.2f} GB")
    log(f"[sharded] Config 1 and Config 4 steps at full width on {SHARD_W} "
        f"gloo ranks sharing the card, data-parallel ({TRAIN_B // SHARD_W} "
        f"rows each): torchrun wall {wall_s:.2f} s")

    # (d) NCCL across the host's cards, one rank a card
    cards = torch.cuda.device_count()
    if cards < NCCL_W:
        log(f"[sharded] (d) skipped: NCCL across {NCCL_W} cards needs "
            f"{NCCL_W} cards; this host has {cards}")
        return launches
    work4 = snap_dir / "sharded_nccl"
    work4.mkdir()
    shutil.copy(work / "c4_inputs.pt", work4 / "c4_inputs.pt")
    outs, wall_s = _torchrun(work4, NCCL_W, "nccl")
    for r, out in enumerate(outs):
        check(out["banned"] == [], f"rank {r} imported {out['banned']}")
        check(out["backend"] == "nccl" and out["world_size"] == NCCL_W,
              f"rank {r}: backend {out['backend']}, world size "
              f"{out['world_size']}")
        _check_c4_rank("(d)", r, out, c4, dev, "one card a rank",
                       ties=True)
        launches[f"sharded_nccl_config4_rank{r}"] = out["c4"]["launches"]
    log(f"[sharded] (d) Config 4's step at full width on {NCCL_W} NCCL "
        f"ranks, one a card, data-parallel ({TRAIN_B // NCCL_W} rows each): "
        f"torchrun wall {wall_s:.2f} s")
    return launches


def _torchrun(work, world, backend):
    """([rank<r>.pt of each rank], wall s): ``world`` ranks of this script
    (``--sharded-rank work backend``) under torchrun."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(world), "--master_addr", "127.0.0.1", "--master_port",
         str(port), str(ROOT / "chip_smoke.py"), "--sharded-rank", str(work),
         backend], cwd=ROOT, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[sharded] | {line}")
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
    check(proc.returncode == 0, f"the {world} {backend} ranks exited "
          f"{proc.returncode}")
    return [torch.load(work / f"rank{r}.pt", weights_only=True)
            for r in range(world)], wall_s


def banned_modules(*more):
    """Loaded modules of JAX, flax, optax and the JAX package, and of the
    packages ``more``."""
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "flax", "optax", "exemplar_vae_tpu")
            or any(m == p or m.startswith(p + ".") for p in more)]


def serve_bundle_child(work):
    """[serve-export]'s child: serve the bundle in ``work``/bundle through
    its programs, with no model code loaded. Request 0 with the live
    request's noise and a generate with injected noise, held against the
    live outputs (``work``/requests.pt); then timed requests drawn from a
    generator. Prints one JSON line: load s, program ms, launches."""
    from exemplar_vae_tpu_torch.device import resolve_device
    from exemplar_vae_tpu_torch.ops import pairwise_lse as pl
    from exemplar_vae_tpu_torch.serve import ServingBundle

    dev = resolve_device("cuda")
    req = torch.load(work / "requests.pt")
    torch.empty(1, device=dev)                # the CUDA context, not timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = ServingBundle.load(str(work / "bundle"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(bundle.model is None, "the bundle was served by a model, not by "
          "its programs")
    rounds = bundle.manifest["rounds"]

    # ---- the program path: counts 0 just before, read just after ----
    pl.pairwise_lse.launches = 0
    _, per = bundle.score_nll(req["x"].numpy(), eps=[req["eps"].to(dev)])
    first = pl.pairwise_lse.launches
    imgs = bundle.generate(idx=req["idx"].to(dev),
                           eps=req["gen_eps"].to(dev)).cpu()
    g = torch.Generator("cuda").manual_seed(1)
    req_ms = []
    for _ in range(N_REQUESTS + 1):
        t0 = time.perf_counter()
        bundle.score_nll(req["x_timed"].numpy(), generator=g)
        req_ms.append((time.perf_counter() - t0) * 1e3)
    launches = pl.pairwise_lse.launches
    # ---- end of the program path ----

    want = req["nll"].numpy()
    err = float(np.abs(per - want).max())
    check(first == rounds, f"request 0 through the program launched the "
          f"kernel {first} times, want {rounds}")
    check(launches == rounds * (N_REQUESTS + 2),
          f"{N_REQUESTS + 2} program requests launched the kernel {launches} "
          f"times, want {rounds} each")
    check(np.array_equal(per, want), f"the program's request 0 differs from "
          f"the live one: max abs {err:.3e}")
    check(torch.equal(imgs, req["gen"]), "the program's generate differs from"
          " the live one: max abs "
          f"{float((imgs - req['gen']).abs().max()):.3e}")
    banned = banned_modules("exemplar_vae_tpu_torch.models")
    check(not banned, f"serving the bundle loaded {banned}")
    steady = sorted(req_ms[1:])[len(req_ms[1:]) // 2]
    print(json.dumps({"load_s": load_s, "program_ms": steady,
                      "request_ms": [round(v, 3) for v in req_ms],
                      "launches": launches,
                      "launches_per_request": first}), flush=True)


def run_child(tag, module, argv):
    """Run ``python -m module argv`` in a child process from the repository
    root, its output logged under ``tag``; fails the phase on a non-zero
    exit. Returns (stdout, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[{tag}] | {line}")
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
    check(proc.returncode == 0, f"{module} {' '.join(argv)} exited "
          f"{proc.returncode}")
    return proc.stdout, secs


def _epoch_records(exp_dir):
    return [r for r in (json.loads(line) for line in
                        (exp_dir / "metrics.jsonl").read_text().splitlines())
            if "epoch" in r]


def _same_state(a, b):
    """Names of the state entries in which Experiments a and b differ
    (bitwise)."""
    bad = []
    sa, sb = a.state, b.state
    for (name, p), q in zip(sa.model.named_parameters(),
                            sb.model.parameters()):
        if not torch.equal(p, q):
            bad.append(name)
        for k in ("m", "v"):
            if not torch.equal(sa.opt.state[p][k], sb.opt.state[q][k]):
                bad.append(f"{name}.{k}")
        if not torch.equal(a.best_params[name], b.best_params[name]):
            bad.append(f"best {name}")
    ca, cb = a.bank.cache_means, b.bank.cache_means
    if (ca is None) != (cb is None) or (ca is not None
                                        and not torch.equal(ca, cb)):
        bad.append("cache")
    for attr in ("epoch", "best_val", "bad_epochs"):
        if getattr(a, attr) != getattr(b, attr):
            bad.append(attr)
    if (sa.opt.count, sa.step) != (sb.opt.count, sb.step):
        bad.append("count/step")
    return bad


def config5_phase(pl, snap_dir):
    from exemplar_vae_tpu_torch.config import (config_from_args,
                                               reference_arg_parser)
    from exemplar_vae_tpu_torch.main import main as cli_main
    from exemplar_vae_tpu_torch.train.augment import (MLPClassifier,
                                                      load_experiment,
                                                      make_augment_fn,
                                                      make_classifier_step)
    from exemplar_vae_tpu_torch.train.plots import read_png
    from exemplar_vae_tpu_torch.train.steps import make_train_step
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    data_dir = snap_dir / "c5_no_data"      # no IDX files: the stand-in
    data_dir.mkdir()
    base = ["--dataset_name", "dynamic_mnist", "--data_dir", str(data_dir),
            "--training_set_size", str(N_BANK), "--number_components",
            str(N_BANK), "--val_set_size", str(C5_EVAL), "--test_set_size",
            str(C5_EVAL), "--S", "8", "--MB", "8", "--snapshot_dir",
            str(snap_dir / "c5")]
    c = config_from_args(reference_arg_parser().parse_args(base))
    check(c.model_name == "vae" and c.hidden_size == 300 and c.z1_size == D
          and c.batch_size == TRAIN_B and c.prior == "exemplar_prior"
          and not c.approximate_prior and c.use_pallas_prior
          and c.compute_dtype == "float32", "the CLI's defaults are not "
          "BASELINE Config 1's widths")
    exp_dir = snap_dir / "c5" / c.experiment_name()

    # (a) the first run, one epoch, checkpointed
    _, run_s = run_child("config5-run", "exemplar_vae_tpu_torch.main",
                         base + ["--epochs", "1", "--checkpoint_every", "1"])
    for tag in ("last", "final"):
        meta = json.loads((exp_dir / f"ckpt_{tag}" / "meta.json").read_text())
        check(meta["epoch"] == 1 and meta["backend"] == "npz",
              f"ckpt_{tag} meta {meta}")
    first = json.loads((exp_dir / "results.json").read_text())
    check("artifact_error" not in first and math.isfinite(first["test_nll"]),
          f"first run's results {first}")
    for name in C5_GRIDS:
        shape = read_png(str(exp_dir / name)).shape
        check(shape == C5_GRID_SHAPE, f"{name} decodes to {shape}, not "
              f"{C5_GRID_SHAPE}")
    epochs_a = [r["epoch"] for r in _epoch_records(exp_dir)]

    # (b) a second process resumes it
    out, resume_s = run_child(
        "config5-resume", "exemplar_vae_tpu_torch.main",
        base + ["--epochs", "2", "--resume", "--checkpoint_every", "1"])
    records = _epoch_records(exp_dir)
    check("resumed from epoch 1" in out, "the resumed run did not print "
          "'resumed from epoch 1'")
    check(epochs_a == [1] and [r["epoch"] for r in records] == [1, 2],
          f"metrics.jsonl epochs {epochs_a} then "
          f"{[r['epoch'] for r in records]}, want [1] then [1, 2]")
    resumed = json.loads((exp_dir / "results.json").read_text())
    check(resumed["epochs_trained"] == 2 and "artifact_error" not in resumed
          and math.isfinite(resumed["test_nll"]), f"resumed {resumed}")

    # (c) save, then restore into a fresh Experiment, in this process
    t0 = time.perf_counter()
    exp = load_experiment(str(exp_dir))
    load_s = time.perf_counter() - t0
    save_s = wall_ms(lambda: exp.save_checkpoint("roundtrip")) / 1e3
    ckpt = exp_dir / "ckpt_roundtrip"
    size_mb = sum(f.stat().st_size for f in ckpt.iterdir()) / 1e6
    fresh = Experiment(exp.cfg, device="cuda", verbose=False,
                       exp_dir=str(exp_dir))
    ok = []
    restore_s = wall_ms(
        lambda: ok.append(fresh.restore_checkpoint("roundtrip"))) / 1e3
    bad = _same_state(exp, fresh)
    check(ok == [True] and not bad, f"round trip differs in {bad[:8]}")
    check(fresh.model.q_layers_0.h_kernel.is_cuda
          and all(v.is_cuda for st in fresh.state.opt.state.values()
                  for v in st.values()), "restored tensors are not on the card")
    g = torch.Generator("cuda").manual_seed(21)
    rows = torch.randperm(exp.n_train, generator=g, device="cuda")[:TRAIN_B]
    u = torch.rand((TRAIN_B, 28, 28, 1), generator=g, device="cuda")
    eps = torch.randn((TRAIN_B, D), generator=g, device="cuda")
    losses = []
    # ---- the path's train steps: counts 0 just before, read after ----
    pl.pairwise_lse.launches = 0
    for e in (exp, fresh):
        _, aux = make_train_step(e.cfg)(e.state, e.train_x[rows],
                                        e.train_idx[rows], e.bank, 1.0, u=u,
                                        eps=eps)
        losses.append(float(aux["loss"]))
    step_launches = pl.pairwise_lse.launches
    # ---- end ----
    loss_diff = abs(losses[0] - losses[1])
    check(step_launches == 2, f"two exact train steps launched the kernel "
          f"{step_launches} times")
    check(all(math.isfinite(v) for v in losses)
          and loss_diff <= C5_RTOL * abs(losses[0]),
          f"train step after the round trip: loss {losses[1]} vs {losses[0]}")
    # the augmented classifier step makes no host synchronization
    clf = MLPClassifier(784).to("cuda")
    step = make_classifier_step(clf, torch.optim.Adam(clf.parameters(), 1e-3),
                                exp.cfg, make_augment_fn(exp.model, exp.cfg),
                                C5_PI)
    xs = exp.train_x[:TRAIN_B]
    ys = torch.from_numpy(exp.splits.train_labels[:TRAIN_B]).long().cuda()
    step(xs, ys, generator=g)
    aug_syncs = host_syncs(lambda: [step(xs, ys, generator=g)
                                    for _ in range(3)])
    check(not aug_syncs, f"the augmented classifier step synchronized the "
          f"host: {aug_syncs[:1]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()    # one region of 50 steps, ended by a sync
    for _ in range(50):
        step(xs, ys, generator=g)
    torch.cuda.synchronize()
    aug_step_ms = (time.perf_counter() - t0) * 1e3 / 50
    # where the CLI-default step's time goes (fp32, chunks with recompute)
    run = lambda perm: exp.epoch_fn(  # noqa: E731
        exp.state, exp.train_x, exp.train_idx, perm, exp.bank, 1.0,
        generator=exp.gen)
    prof = profile_ms(lambda: run(exp.epoch_perm(PROF_STEPS, TRAIN_B)))
    log_host(prof, "config5-profile", PROF_STEPS)
    log_profile("config5-profile", PROF_STEPS, prof)
    n_params = sum(p.numel() for p in exp.model.parameters())
    del exp, fresh, clf, step, run, prof
    torch.cuda.empty_cache()
    log(f"[config5] BASELINE Config 5 at Config 1's width: VAE 784-"
        f"{c.hidden_size}-{c.hidden_size}-{c.z1_size} ({n_params} params), "
        f"dynamic_mnist -> labelled synthetic stand-in, {N_BANK} training "
        f"images, exact prior N={N_BANK}, batch {c.batch_size}, fp32, "
        f"val/test {C5_EVAL}, S = MB = 8")
    log(f"[config5] checkpoint: save {save_s:.4f} s, restore into a fresh "
        f"Experiment {restore_s:.4f} s, {size_mb:.3f} MB on disk "
        f"(state.npz, best_params.npz, meta.json); load_experiment (data, "
        f"model, restore) {load_s:.3f} s; round trip bitwise; one train step "
        f"from each: loss {losses[0]:.6f} vs {losses[1]:.6f} (abs diff "
        f"{loss_diff:.3e}, rtol {C5_RTOL}); pairwise_lse launches "
        f"{step_launches}")
    log(f"[config5] augmented classifier step (784-512-512-10, batch "
        f"{TRAIN_B}, pi {C5_PI}): {aug_step_ms:.4f} ms/step (host clock, 50 "
        f"steps), 0 host synchronizations in 3 steps")

    # (d) eval only, in this process
    out = io.StringIO()
    # ---- the path's evaluation: counts 0 just before, read after ----
    pl.pairwise_lse.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        again = cli_main(base + ["--eval_only"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = pl.pairwise_lse.launches
    # ---- end ----
    for line in out.getvalue().splitlines():
        log(f"[config5-eval] | {line}")
    # one launch per validation batch (B <= test_batch_size) and per IWAE
    # chunk and round (B <= test_batch_size x MB)
    val_batches = -(-c.val_set_size // c.test_batch_size)
    iwae_calls = (-(-c.test_set_size // c.test_batch_size)
                  * -(-c.S // min(c.MB, c.S)))
    want = val_batches + iwae_calls
    nll_diff = abs(again["test_nll"] - resumed["test_nll"])
    check(eval_launches == want, f"--eval_only launched the kernel "
          f"{eval_launches} times, not {want}")
    check(nll_diff <= C5_RTOL * abs(resumed["test_nll"])
          and "artifact_error" not in again,
          f"--eval_only test_nll {again['test_nll']} vs results.json "
          f"{resumed['test_nll']}")

    # (e) the augmented classifier, in a child process
    clf_argv = ["--vae_dir", str(exp_dir), "--classifier_epochs",
                str(C5_CLF_EPOCHS), "--pi", str(C5_PI)]
    out, clf_s = run_child("config5-classify",
                           "exemplar_vae_tpu_torch.classify_mnist", clf_argv)
    res = json.loads((exp_dir / "classifier_results.json").read_text())
    check(res == json.loads(out.strip().splitlines()[-1]),
          "classifier_results.json differs from the printed results")
    for name in ("plain", "exemplar_augmented"):
        err = res[name]["test_error"]
        check(math.isfinite(err) and err < 0.9, f"{name} classifier test "
              f"error {err} (chance 0.9)")
    rows_per_epoch = (N_BANK // TRAIN_B) * TRAIN_B
    aug_s = res["exemplar_augmented"]["train_seconds"]
    log(f"[config5-classify] {C5_CLF_EPOCHS} epochs on {N_BANK} labels: "
        f"plain {res['plain']['test_error']:.4f} test error, "
        f"{res['plain']['train_seconds'] / C5_CLF_EPOCHS:.3f} s/epoch; "
        f"augmented (pi {C5_PI}) {res['exemplar_augmented']['test_error']:.4f}"
        f", {aug_s / C5_CLF_EPOCHS:.3f} s/epoch, "
        f"{C5_CLF_EPOCHS * rows_per_epoch / aug_s:.1f} augmented rows/s "
        f"(every row is sampled, pi of them kept); test set {C5_EVAL}")
    log(f"[config5] wall time: first run {run_s:.2f} s, resume {resume_s:.2f}"
        f" s (child processes); eval-only {eval_s:.2f} s (this process), "
        f"test_nll {again['test_nll']:.6f} vs {resumed['test_nll']:.6f} "
        f"(abs diff {nll_diff:.3e}), pairwise_lse launches {eval_launches} "
        f"({val_batches} validation at B <= {c.test_batch_size}, "
        f"{iwae_calls} IWAE at B <= {c.test_batch_size * c.MB}); classify "
        f"{clf_s:.2f} s (child)")
    return {"config5_train_steps": step_launches,
            "config5_eval_only": eval_launches}


def log_host(prof, tag, steps):
    """Kernel launches per step and the top host operators of a profiled
    call; returns the launches per step."""
    ops = prof[3]
    per_step = sum(c for name, _, c in ops if "LaunchKernel" in name) / steps
    log(f"[{tag}] host: {per_step:.1f} kernel launches per step; top "
        f"operators by self host time per step: "
        + "; ".join(f"{name} {ms / steps:.4f} ms x{c / steps:g}"
                    for name, ms, c in ops[:10]))
    return per_step


def log_syncs(tag, exp, run, steps=3):
    """Host synchronizations of a ``steps``-step call, beside a positive
    control; returns their number."""
    control = host_syncs(lambda: float(exp.train_x[0].sum()))
    syncs = host_syncs(lambda: run(exp.epoch_perm(steps, exp.cfg.batch_size)))
    log(f"[{tag}] host synchronizations in a {steps}-step call: "
        f"{len(syncs)} (the detector sees {len(control)} in one host read)"
        + (f"; first: {syncs[0][:160]}" if syncs else ""))
    return len(syncs)


def prior_timing(calls=50):
    """The exemplar prior alone at the train shape (B = 100, N = 50 000,
    D = 40, LOO, fp32): forward through the kernel, then the torch backward
    (the logits recomputed in one GEMM, two (B, N)-operand GEMMs and the
    elementwise work between them). Event ms per forward+backward, and the
    device ms per call of the kernel and of the rest, under the profiler;
    the backward's bound: its GEMM flops on the fp32 pipes (TF32 is off),
    or its bytes (z, mu read, dz, dmu written) over HBM."""
    from exemplar_vae_tpu_torch.ops.exemplar_prior import exemplar_log_prob
    g = torch.Generator("cuda").manual_seed(5)
    dev = torch.device("cuda")
    b = TRAIN_B
    means = torch.randn((N_BANK, D), generator=g, device=dev)
    own = torch.randint(0, N_BANK, (b,), generator=g, device=dev)
    z = means[own] + 0.7 * torch.randn((b, D), generator=g, device=dev)
    leaves = [z.requires_grad_(), means.requires_grad_(),
              torch.tensor(-0.5, device=dev, requires_grad=True)]
    ex = torch.arange(N_BANK, dtype=torch.int32, device=dev)
    valid = torch.ones(N_BANK, dtype=torch.bool, device=dev)
    cot = torch.randn((b,), generator=g, device=dev)

    def fwd_bwd():
        out = exemplar_log_prob(*leaves, log_denom=math.log(N_BANK - 1),
                                data_idx=own.to(torch.int32),
                                exemplar_idx=ex, valid=valid, impl="pallas")
        out.backward(cot)

    def library_fwd_bwd():
        # yardstick only: the (B, N) logits materialised with autograd, then
        # torch.logsumexp; the backward is autograd's
        lg_z, lg_mu, lg_lv = leaves
        sq = ((lg_z * lg_z).sum(-1, keepdim=True) - 2.0 * lg_z @ lg_mu.T
              + (lg_mu * lg_mu).sum(-1)[None]).clamp_min(0.0)
        logits = -0.5 * (D * lg_lv + sq * torch.exp(-lg_lv))
        logits = logits.masked_fill(own[:, None] == ex[None], -1e30)
        (torch.logsumexp(logits, dim=-1) - math.log(N_BANK - 1)).backward(cot)

    ms = cuda_ms(fwd_bwd, calls)
    library_ms = cuda_ms(library_fwd_bwd, calls)
    _, busy, kernels, _ = profile_ms(lambda: [fwd_bwd() for _ in range(calls)])
    lse_ms = sum(t for name, t, _ in kernels if "lse_" in name) / calls
    bwd_ms = busy / calls - lse_ms
    terms = {"fp32 GEMM flops": 3 * 2.0 * b * N_BANK * D / FP32_OPS,
             "HBM bytes": 2 * (b * D + N_BANK * D) * 4 / HBM_BYTES_PER_S}
    term = max(terms, key=terms.get)
    log(f"[train-prior] exemplar_log_prob B={b} N={N_BANK} D={D} LOO fp32, "
        f"kernel forward + torch backward: {ms:.4f} ms per call (events); "
        f"device {busy / calls:.4f} ms per call: kernel {lse_ms:.4f} ms, "
        f"backward {bwd_ms:.4f} ms against its bound "
        f"{terms[term] * 1e3:.4f} ms ({term}); library yardstick "
        f"(materialised logits + torch.logsumexp, autograd forward+backward) "
        f"{library_ms:.4f} ms per call (events); top backward kernels: "
        + "; ".join(
            f"{name[:50]} {t / calls:.4f}" for name, t, _ in kernels
            if "lse_" not in name)[:600])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_child(Path(sys.argv[2]), *sys.argv[3:4])
        return
    if sys.argv[1:2] == ["--serve-bundle"]:
        serve_bundle_child(Path(sys.argv[2]))
        return
    from exemplar_vae_tpu_torch.device import resolve_device
    from exemplar_vae_tpu_torch.ops import gated_epilogue as ge
    from exemplar_vae_tpu_torch.ops import masked_epilogue as me
    from exemplar_vae_tpu_torch.ops import pairwise_lse as pl

    banned = banned_modules()
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
    log(f"[build] masked_epilogue.cu: nvcc + load "
        f"{me.build(verbose=True):.2f} s")
    log(f"[build] gated_epilogue.cu: nvcc + load "
        f"{ge.build(verbose=True):.2f} s")

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    kern = timed("kernel", kernel_phase, pl)
    epi = timed("epilogue", epilogue_phase, me)
    gate, gate_launches = timed("gate", gate_phase, ge)
    timed("ingest", ingest_phase)
    launches, program_launches = timed("serve", serving_phase, pl)
    with tempfile.TemporaryDirectory() as snap:
        train_launches, cli_launches = timed("train", training_phase, pl,
                                             Path(snap))
        traj = timed("trajectory", trajectory_phase, pl, Path(snap))
        c3, c3_gate = timed("config3", config3_phase, pl, Path(snap))
        pix, pix_epi = timed("pixel", pixel_phase, pl, Path(snap))
        c5 = timed("config5", config5_phase, pl, Path(snap))
        c4, c4_gate = timed("config4", config4_phase, pl, Path(snap))
        sharded = timed("sharded", sharded_phase, pl, Path(snap))

    main_v = kern[("serving", "float32")]
    entry = {
        "name": "pairwise_lse", "route": "cuda",
        "source": "exemplar_vae_tpu_torch/csrc/pairwise_lse.cu",
        "replaces": "exemplar_vae_tpu/ops/pallas_lse.py:45",
        "launches": (launches + program_launches + train_launches
                     + sum(traj.values())
                     + c3["config3_validation"]
                     + c3["config3_iwae"] + sum(c5.values())
                     + sum(c4.values()) + sum(sharded.values())
                     + pix["pixel_train"] + pix["pixel_validation"]
                     + pix["pixel_iwae"]),
        "launches_per_path": {"serving": launches,
                              "serve_program": program_launches,
                              "training": train_launches,
                              "cli_epoch": cli_launches, **traj, **c3,
                              **pix, **c5, **c4, **sharded},
        "max_abs_err": main_v["max_abs_err"],
        "ms": main_v["ms"], "plain_ms": main_v["plain_ms"],
        "bound_ms": main_v["bound_ms"], "bound_by": main_v["bound_by"],
        "library_ms": main_v["library_ms"],
        "variants": list(kern.values()),
    }
    epi_entry = {
        "name": "masked_epilogue", "route": "cuda",
        "source": "exemplar_vae_tpu_torch/csrc/masked_epilogue.cu",
        "replaces": None,
        "launches": sum(pix_epi.values()), "launches_per_path": pix_epi,
        "max_abs_err": epi["max_abs_err"], "ms": epi["ms"],
        "plain_ms": epi["plain_ms"], "bound_ms": epi["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape": epi["shape"],
    }
    gate4 = [v for v in gate if v["config"] == "config4"]
    gate_entry = {
        "name": "gated_epilogue", "route": "cuda",
        "source": "exemplar_vae_tpu_torch/csrc/gated_epilogue.cu",
        "replaces": None,
        "launches": gate_launches + sum(c3_gate.values())
        + sum(c4_gate.values()),
        "launches_per_path": {"gate": gate_launches, **c3_gate, **c4_gate},
        "max_abs_err": max(v["max_abs_err"] for v in gate),
        # a convhvae-knn-score round's three calls; every shape in variants
        "ms": sum(v["ms"] for v in gate4),
        "plain_ms": sum(v["plain_ms"] for v in gate4),
        "bound_ms": sum(v["bound_ms"] for v in gate4),
        "bound_by": "bytes", "library_ms": None, "variants": gate,
    }
    log(f"[done] {time.perf_counter() - t0:.1f} s after the build started; "
        f"seconds per phase: {phase_s}")
    print(json.dumps({"kernels": [entry, epi_entry, gate_entry]}), flush=True)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
