// Exemplar-prior pairwise log-sum-exp, forward, for Hopper (sm_90a).
//
// Replaces: exemplar_vae_tpu/ops/pallas_lse.py::_lse_kernel (launched by
// pairwise_lse_pallas). For each row b of z (B, D) and the exemplar means
// mu (N, D):
//
//   lse[b] = logsumexp_n -0.5 * (D*log_var + max(|z_b|^2 + |mu_n|^2 - 2 z_b.mu_n, 0) * exp(-log_var))
//
// with the exemplar n masked to the finite -1e30 when it is padding
// (valid[n] == false, effective index PAD_IDX = -2) or when it is the row's
// own data point (data_idx[b] == ex_idx[n], the leave-one-out mask; without
// data_idx the row index is NO_LOO_IDX = -1, which matches an exemplar index
// of -1). No log-denominator is applied. The (B, N) logits matrix is never
// written to device memory.
//
// What bounds it. At the serving shape (B = N = 50 000, D = 40) one call does
// 2*B*N*D = 2.0e11 cross-term flops and B*N = 2.5e9 exponentials on 16 MB of
// input, so it is bound by operations. The cross term must stay fp32-accurate
// (|z|^2 + |mu|^2 - 2 z.mu cancels), which one TF32 pass is not. It runs on
// the tensor cores as three TF32 products of an error-compensated split,
// hi = tf32_rna(x), lo = tf32_rna(x - hi): hi.lo + lo.hi + hi.hi (the dropped
// lo.lo is ~2^-22 relative). On an H100 SXM that is 6.0e11 tensor flops, 1.21
// ms at the 495 TFLOP/s TF32 peak, against 0.60 ms of exponentials on the SFU
// (16 per clock per SM) and ~0.45 ms of epilogue on the fp32 pipes, which run
// beside it: the floor is the tensor term. bf16 inputs take one bf16 pass
// (products of bf16 values are exact in fp32) and are bound by the SFU. At the
// train shape (B = 100, LOO) one pass over mu and the launches bound it.
// The SIMT fp32 kernel this design replaced took 10.31 ms at the serving
// shape (NVIDIA H100 80GB HBM3, 700 W); the times of this design, and what
// holds it back, are in PERF.md (chip_smoke.py, lse_attribution.py).
//
// Design.
//   * lse_prep_kernel runs twice per call, over z and over mu, and writes one
//     record per 64 rows: the rows' TF32 hi and lo planes (bf16: the
//     zero-padded bf16 values) in the K-major core-matrix layout that a wgmma
//     descriptor reads, so that one contiguous copy lands a tile ready to use;
//     then one constant per row, in base 2: for z the row constant
//     C0 - k*|z_b|^2 (k = 0.5*log2(e)/var, C0 = -0.5*log2(e)*D*log_var), for
//     mu the column constant -k*|mu_n|^2, which is the masked logit itself
//     for padding and -inf past N; then one index per row (data_idx or
//     NO_LOO_IDX; the effective exemplar index). A flag per mu tile says
//     whether it holds the index NO_LOO_IDX.
//   * lse_partial_kernel: a grid of (row blocks of MB*64 rows) x (splits of
//     the exemplar axis), with the split count chosen so that B = 100 still
//     fills the card; one warpgroup per block. A block copies its z records
//     into shared memory once, and streams the mu tiles through a ring of
//     STAGES buffers filled by cp.async, so that the copy of tile t+1
//     overlaps the wgmmas and epilogue of tile t. Both operands come from
//     shared memory (wgmma m64n64k8 TF32, m64n64k16 bf16), so a tile's wgmmas
//     issue back to back and wait once. The two small products go over all
//     of D first, then hi.hi: the tensor cores truncate each fp32
//     accumulation to the accumulator's magnitude, so the small terms go in
//     while the accumulator is small. MB = 2 unless two z records and two
//     tiles do not fit in shared memory (TF32 with D > 112).
//   * The epilogue works in base 2 and relative to the row constant: a
//     logit less r_b is fma(2k, z.mu, c_n), one instruction, and the clamp
//     sq >= 0 becomes a min against the row's ceiling C0 - r_b, applied only
//     to a row whose tile maximum exceeds it. Each thread keeps a running
//     (m, s) for its four rows, rescaled once per tile, and adds
//     ex2.approx(l - m). Padding needs no compare (its column constant is the
//     masked logit), and a tile compares indices only when data_idx is given
//     or its flag is set: on the serving path no tile does.
//   * Each split writes a partial (m, s) per row in base 2; lse_merge_kernel
//     (one warp per row) merges the splits and writes (m + log2(s)) * ln(2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;           // one warpgroup
constexpr int TN = 64;                 // rows of a record: exemplars of a tile
constexpr int NS = TN / 8;             // 8-column groups of a tile
constexpr int STAGES = 2;              // cp.async ring depth
// One k-chunk plane of a record: 64 rows x 32 bytes as 8 x 2 core matrices
// of 8 rows x 16 bytes, unswizzled. LBO steps along k, SBO along the rows.
constexpr int CORE_WORDS = TN * 8;     // 2 KB
constexpr int LBO = 128, SBO = 256;
constexpr int MAX_D = 128;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int PAD_IDX = -2;
constexpr int NO_LOO_IDX = -1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = -1e30f * LOG2E;  // NEG_INF (-1e30) in base 2

// Per input type: k-depth of one wgmma, elements per 32-bit word, and the
// planes a record holds per k-chunk (TF32: hi, lo).
template <bool kBF16> struct Op;
template <> struct Op<false> {
  using T = float;
  static constexpr int KC = 8, E = 1, PLANES = 2;
};
template <> struct Op<true> {
  using T = __nv_bfloat16;
  static constexpr int KC = 16, E = 2, PLANES = 1;
};

__host__ __device__ inline int k_chunks(int D, bool bf16) {
  const int kc = bf16 ? 16 : 8;
  return (D + kc - 1) / kc;
}
// 32-bit words of a record: the planes, one constant and one index per row.
__host__ __device__ inline int frag_words(int ks, bool bf16) {
  return ks * (bf16 ? 1 : 2) * CORE_WORDS;
}
__host__ __device__ inline int record_words(int ks, bool bf16) {
  return frag_words(ks, bf16) + 2 * TN;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// TF32 rounding to nearest, ties away from zero: cvt.rna.tf32.f32 for finite
// x, in two integer ops.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// wgmma descriptor of one plane at shared address addr (K-major, no swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

#define WG_D32                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
#define WG_DREGS                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"

// d (64 x 64, fp32) = [d if accumulate] + A (64 x k) . B^T (64 x k), both
// read from shared memory through their descriptors; asynchronous until
// wgmma_wait.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_DREGS
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_DREGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of accumulator registers above the
// wgmma_wait that makes them valid.
__device__ __forceinline__ void fence_operands(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}
// Orders this thread's generic-proxy writes to shared memory (cp.async)
// before the async-proxy reads of wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Copies `words` 32-bit words (a multiple of 4) from global to shared memory.
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint32_t* src,
                                           int words) {
  for (int i = threadIdx.x; i < words / 4; i += THREADS)
    cp_async16(reinterpret_cast<uint4*>(dst) + i,
               reinterpret_cast<const uint4*>(src) + i);
}

struct Plan {
  int mb, row_blocks, z_records, splits, tiles_per_split, n_tiles, ks, rec_words;
  size_t smem_bytes;
};

Plan make_plan(bool bf16, int B, int N, int D, int sm_count) {
  Plan p;
  p.ks = k_chunks(D, bf16);
  p.rec_words = record_words(p.ks, bf16);
  // MB z records and STAGES mu tiles in shared memory
  p.mb = 2;
  if ((size_t)(2 + STAGES) * p.rec_words * 4 > MAX_SMEM) p.mb = 1;
  p.smem_bytes = (size_t)(p.mb + STAGES) * p.rec_words * 4;
  p.row_blocks = (B + 64 * p.mb - 1) / (64 * p.mb);
  p.z_records = p.row_blocks * p.mb;
  p.n_tiles = (N + TN - 1) / TN;
  const int target = 4 * (sm_count > 0 ? sm_count : 1);
  int want = (target + p.row_blocks - 1) / p.row_blocks;
  if (want > p.n_tiles) want = p.n_tiles;
  if (want > 65535) want = 65535;
  if (want < 1) want = 1;
  p.tiles_per_split = (p.n_tiles + want - 1) / want;
  p.splits = (p.n_tiles + p.tiles_per_split - 1) / p.tiles_per_split;
  return p;
}

// One record per 64 rows of x (z when valid is null, else mu); see the note
// at the top. The rows are first read once, coalesced, into shared memory
// (as fp32; bf16 values widen and narrow back exactly).
constexpr int PREP_THREADS = 256;
template <bool kBF16>
__global__ void __launch_bounds__(PREP_THREADS)
lse_prep_kernel(const typename Op<kBF16>::T* __restrict__ x, int rows, int D,
                int ks, const float* __restrict__ log_var,
                const int32_t* __restrict__ idx,
                const uint8_t* __restrict__ valid, uint32_t* __restrict__ rec,
                int32_t* __restrict__ flags) {
  constexpr int KC = Op<kBF16>::KC, E = Op<kBF16>::E;
  constexpr int PLANES = Op<kBF16>::PLANES;
  __shared__ float x_s[TN * (MAX_D + 1)];   // row stride D + 1: odd
  const bool is_mu = valid != nullptr;
  const int row0 = blockIdx.x * TN;
  const int ld = D + 1;
  const int span = max(0, min(TN, rows - row0)) * D;
  for (int i = threadIdx.x; i < span; i += PREP_THREADS)
    x_s[(i / D) * ld + i % D] = widen(x[(size_t)row0 * D + i]);
  __syncthreads();
  // element (c, d) of the record, zero past the rows and past D
  auto at = [&](int c, int d) {
    return (row0 + c < rows && d < D) ? x_s[c * ld + d] : 0.f;
  };

  uint32_t* r = rec + (size_t)blockIdx.x * record_words(ks, kBF16);
  const int fw = frag_words(ks, kBF16);
  for (int w = threadIdx.x; w < fw; w += PREP_THREADS) {
    // word w: plane (kc * PLANES + lo) of CORE_WORDS; in it, core matrix
    // (row group j, k-half h) at j*SBO + h*LBO bytes, row i, word q.
    const int plane = w / CORE_WORDS, in = w % CORE_WORDS;
    const int kc = plane / PLANES, lo = plane % PLANES;
    const int j = in >> 6, h = (in >> 5) & 1, i = (in >> 2) & 7, q = in & 3;
    const int c = j * 8 + i, d = kc * KC + h * 4 * E + q * E;
    if constexpr (kBF16) {
      r[w] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(at(c, d))) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(at(c, d + 1))) << 16);
    } else {
      const float v = at(c, d);
      const uint32_t hi = tf32_rna(v);
      r[w] = lo ? tf32_rna(v - __uint_as_float(hi)) : hi;
    }
  }
  int has_no_loo = 0;
  if (threadIdx.x < TN) {
    const int c = threadIdx.x, n = row0 + c;
    const float lv = *log_var;
    const float k = 0.5f * LOG2E * expf(-lv);
    const float c0 = -0.5f * LOG2E * (float)D * lv;
    float sq = 0.f;
    if (n < rows)
      for (int d = 0; d < D; ++d) sq = fmaf(x_s[c * ld + d], x_s[c * ld + d], sq);
    float cst;
    int e;
    if (!is_mu) {            // z: the row constant and the row's index
      cst = fmaf(-k, sq, c0);
      e = (idx != nullptr && n < rows) ? idx[n] : NO_LOO_IDX;
    } else if (n >= rows) {  // past N: adds exp2(-inf) = 0
      cst = -INFINITY;
      e = PAD_IDX;
    } else if (!valid[n]) {  // padding: the masked logit, whatever the row
      cst = NEG2;
      e = PAD_IDX;
    } else {
      cst = -k * sq;
      e = idx[n];
      has_no_loo = e == NO_LOO_IDX;
    }
    reinterpret_cast<float*>(r + fw)[c] = cst;
    reinterpret_cast<int32_t*>(r + fw + TN)[c] = e;
  }
  if (is_mu) {
    has_no_loo = __syncthreads_or(has_no_loo);
    if (threadIdx.x == 0) flags[blockIdx.x] = has_no_loo;
  }
}

template <bool kBF16, int MB>
__global__ void __launch_bounds__(THREADS, 2)
lse_partial_kernel(const uint32_t* __restrict__ z_rec,
                   const uint32_t* __restrict__ mu_rec,
                   const int32_t* __restrict__ flags,
                   const float* __restrict__ log_var, bool loo, int B, int N,
                   int D, int ks, int tiles_per_split,
                   float* __restrict__ part_m, float* __restrict__ part_s) {
  constexpr int PLANES = Op<kBF16>::PLANES;
  extern __shared__ __align__(128) uint32_t smem[];
  const int rw = record_words(ks, kBF16);
  const int fw = frag_words(ks, kBF16);
  uint32_t* zs = smem;                  // MB z records
  uint32_t* ring = smem + MB * rw;      // STAGES mu records

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * MB * 64;
  const int split = blockIdx.y;
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  copy_async(zs, z_rec + (size_t)blockIdx.x * MB * rw, MB * rw);
  copy_async(ring, mu_rec + (size_t)t_begin * rw, rw);
  cp_async_commit();

  const float lv = *log_var;
  const float k = 0.5f * LOG2E * expf(-lv);
  const float c0 = -0.5f * LOG2E * (float)D * lv;   // row ceiling: sq = 0
  const float scale = 2.f * k;
  const uint32_t zs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(zs));
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  // descriptor of plane p of z record mb
  auto za = [&](int mb, int p) { return smem_desc(zs_addr + (mb * rw + p * CORE_WORDS) * 4); };

  // This thread's rows: (mb, h) -> row warp*16 + h*8 + g of z record mb,
  // whose constant r_b and index arrive with the first copy. m is kept
  // relative to r_b; cap = C0 - r_b is the row's ceiling.
  float rc[MB][2], cap[MB][2], m[MB][2], s[MB][2];
  int dr[MB][2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) m[mb][h] = NEG2, s[mb][h] = 0.f;
  for (int tile = t_begin, i = 0; tile < t_end; ++tile, ++i) {
    if (tile + 1 < t_end)
      copy_async(ring + ((i + 1) % STAGES) * rw, mu_rec + (size_t)(tile + 1) * rw, rw);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + h * 8 + g;
          rc[mb][h] = reinterpret_cast<const float*>(zs + mb * rw + fw)[r];
          cap[mb][h] = c0 - rc[mb][h];
          dr[mb][h] = reinterpret_cast<const int32_t*>(zs + mb * rw + fw + TN)[r];
        }
    }
    const uint32_t* bt = ring + (i % STAGES) * rw;
    const uint32_t bt_addr = ring_addr + (i % STAGES) * rw * 4;
    // descriptor of plane p of this tile
    auto mu = [&](int p) { return smem_desc(bt_addr + p * CORE_WORDS * 4); };

    // acc[mb][4*ns + 2*h + j]: row (mb, h), column 8*ns + 2*t + j. One
    // group, waited for as a whole: an epilogue on one accumulator while
    // wgmmas run into another makes ptxas serialize the wgmmas.
    float acc[MB][32];
    wgmma_fence();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      if constexpr (kBF16) {
#pragma unroll 1
        for (int kc = 0; kc < ks; ++kc) wgmma_bf16(acc[mb], za(mb, kc), mu(kc), kc > 0);
      } else {
        // planes: PLANES*kc hi, PLANES*kc + 1 lo
#pragma unroll 1
        for (int kc = 0; kc < ks; ++kc) {
          wgmma_tf32(acc[mb], za(mb, PLANES * kc), mu(PLANES * kc + 1), kc > 0);  // hi . lo
          wgmma_tf32(acc[mb], za(mb, PLANES * kc + 1), mu(PLANES * kc), 1);       // lo . hi
        }
#pragma unroll 1
        for (int kc = 0; kc < ks; ++kc)
          wgmma_tf32(acc[mb], za(mb, PLANES * kc), mu(PLANES * kc), 1);           // hi . hi
      }
    }
    wgmma_commit();
    wgmma_wait<0>();

    // Epilogue, per row in base 2 and relative to the row constant r_b:
    // l = fma(2k, z.mu, c_n) = logit - r_b, clamped to the row's ceiling
    // C0 - r_b only where the tile's maximum exceeds it (sq < 0 by rounding);
    // masks where the tile can need them; the online (m, s) of each of the
    // thread's four rows.
    const float2* colc = reinterpret_cast<const float2*>(bt + fw);
    const int2* eff = reinterpret_cast<const int2*>(bt + fw + TN);
    const bool masked = loo || flags[tile];
    float2 cc[NS];
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) cc[ns] = colc[ns * 4 + t];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      fence_operands(acc[mb]);
      float* l = acc[mb];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int ns = 0; ns < NS; ++ns) {
          l[4 * ns + 2 * h] = fmaf(scale, l[4 * ns + 2 * h], cc[ns].x);
          l[4 * ns + 2 * h + 1] = fmaf(scale, l[4 * ns + 2 * h + 1], cc[ns].y);
        }
        if (masked) {
#pragma unroll
          for (int ns = 0; ns < NS; ++ns) {
            const int2 e = eff[ns * 4 + t];
            if (e.x == dr[mb][h]) l[4 * ns + 2 * h] = fminf(l[4 * ns + 2 * h], NEG2);
            if (e.y == dr[mb][h]) l[4 * ns + 2 * h + 1] = fminf(l[4 * ns + 2 * h + 1], NEG2);
          }
        }
        float tmax = m[mb][h];
#pragma unroll
        for (int ns = 0; ns < NS; ++ns)
          tmax = fmaxf(tmax, fmaxf(l[4 * ns + 2 * h], l[4 * ns + 2 * h + 1]));
        if (tmax > cap[mb][h]) {
#pragma unroll
          for (int ns = 0; ns < NS; ++ns) {
            l[4 * ns + 2 * h] = fminf(l[4 * ns + 2 * h], cap[mb][h]);
            l[4 * ns + 2 * h + 1] = fminf(l[4 * ns + 2 * h + 1], cap[mb][h]);
          }
          tmax = cap[mb][h];
        }
        float sum = s[mb][h] * ex2(m[mb][h] - tmax);
#pragma unroll
        for (int ns = 0; ns < NS; ++ns)
          sum += ex2(l[4 * ns + 2 * h] - tmax) + ex2(l[4 * ns + 2 * h + 1] - tmax);
        m[mb][h] = tmax;
        s[mb][h] = sum;
      }
    }
    __syncthreads();   // this stage is read before the next copy refills it
  }

  // Merge the four lanes (t = 0..3) that hold the same rows.
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mi = m[mb][h], si = s[mb][h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, mi, off);
        const float so = __shfl_xor_sync(0xffffffffu, si, off);
        const float mn = fmaxf(mi, mo);
        si = si * ex2(mi - mn) + so * ex2(mo - mn);
        mi = mn;
      }
      const int row = row0 + mb * 64 + warp * 16 + h * 8 + g;
      if (t == 0 && row < B) {
        part_m[(size_t)split * B + row] = mi + rc[mb][h];
        part_s[(size_t)split * B + row] = si;
      }
    }
}

// One warp per row: the lanes merge the splits in a strided online pass,
// then across the warp (at B = 100 there are hundreds of splits per row).
constexpr int MERGE_THREADS = 256;
__global__ void __launch_bounds__(MERGE_THREADS)
lse_merge_kernel(const float* __restrict__ part_m,
                 const float* __restrict__ part_s, int B, int splits,
                 float* __restrict__ out) {
  const int row = blockIdx.x * (MERGE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;   // the whole warp
  float m = NEG2, s = 0.f;
  for (int k = lane; k < splits; k += 32) {
    const float mk = part_m[(size_t)k * B + row];
    const float mn = fmaxf(m, mk);
    s = s * exp2f(m - mn) + part_s[(size_t)k * B + row] * exp2f(mk - mn);
    m = mn;
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, mo);
    s = s * exp2f(m - mn) + so * exp2f(mo - mn);
    m = mn;
  }
  if (lane == 0) out[row] = (m + log2f(s)) * LN2;
}

template <bool kBF16, int MB>
cudaError_t launch_partial(const uint32_t* z_rec, const uint32_t* mu_rec,
                           const int32_t* flags, const float* log_var,
                           bool loo, int B, int N, int D, const Plan& p,
                           float* part_m, float* part_s, cudaStream_t stream) {
  // The dynamic shared-memory limit is raised once per device (context).
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(lse_partial_kernel<kBF16, MB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  lse_partial_kernel<kBF16, MB><<<dim3(p.row_blocks, p.splits), THREADS,
                                  p.smem_bytes, stream>>>(
      z_rec, mu_rec, flags, log_var, loo, B, N, D, p.ks, p.tiles_per_split,
      part_m, part_s);
  return cudaGetLastError();
}

template <bool kBF16>
cudaError_t launch(const void* z, const void* mu, const void* log_var,
                   const void* data_idx, const void* ex_idx, const void* valid,
                   int B, int N, int D, const Plan& p, uint32_t* z_rec,
                   uint32_t* mu_rec, int32_t* flags, float* part_m,
                   float* part_s, float* out, cudaStream_t stream) {
  using T = typename Op<kBF16>::T;
  const float* lv = static_cast<const float*>(log_var);
  lse_prep_kernel<kBF16><<<p.z_records, PREP_THREADS, 0, stream>>>(
      static_cast<const T*>(z), B, D, p.ks, lv,
      static_cast<const int32_t*>(data_idx), nullptr, z_rec, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_prep_kernel<kBF16><<<p.n_tiles, PREP_THREADS, 0, stream>>>(
      static_cast<const T*>(mu), N, D, p.ks, lv,
      static_cast<const int32_t*>(ex_idx), static_cast<const uint8_t*>(valid),
      mu_rec, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool loo = data_idx != nullptr;
  err = p.mb == 2
            ? launch_partial<kBF16, 2>(z_rec, mu_rec, flags, lv, loo, B, N, D, p,
                                       part_m, part_s, stream)
            : launch_partial<kBF16, 1>(z_rec, mu_rec, flags, lv, loo, B, N, D, p,
                                       part_m, part_s, stream);
  if (err != cudaSuccess) return err;
  const int rows_per_block = MERGE_THREADS / 32;
  lse_merge_kernel<<<(B + rows_per_block - 1) / rows_per_block, MERGE_THREADS,
                     0, stream>>>(part_m, part_s, B, p.splits, out);
  return cudaGetLastError();
}

// Scratch, in 4-byte words: z records, mu records, tile flags, partial m, s.
size_t scratch_words(const Plan& p, int B) {
  return (size_t)(p.z_records + p.n_tiles) * p.rec_words +
         ((p.n_tiles + 3) / 4) * 4 + 2 * (size_t)p.splits * B;
}

}  // namespace

extern "C" {

// Largest latent width the kernel takes.
int pairwise_lse_max_d() { return MAX_D; }

// Floats of scratch that pairwise_lse_forward needs for these sizes.
long long pairwise_lse_scratch_floats(int dtype, int B, int N, int D,
                                      int sm_count) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  return (long long)scratch_words(make_plan(dtype == 1, B, N, D, sm_count), B);
}

// dtype: 0 = float32 z and mu, 1 = bfloat16. data_idx may be null (no LOO).
// valid is one byte per exemplar. scratch must be 16-byte aligned. Returns
// the cudaError_t of the launches.
int pairwise_lse_forward(int dtype, const void* z, const void* mu,
                         const void* log_var, const void* data_idx,
                         const void* ex_idx, const void* valid, int B, int N,
                         int D, int sm_count, void* scratch, void* out,
                         void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || D > MAX_D || (dtype != 0 && dtype != 1) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(dtype == 1, B, N, D, sm_count);
  uint32_t* z_rec = static_cast<uint32_t*>(scratch);
  uint32_t* mu_rec = z_rec + (size_t)p.z_records * p.rec_words;
  int32_t* flags = reinterpret_cast<int32_t*>(mu_rec + (size_t)p.n_tiles * p.rec_words);
  float* part_m = reinterpret_cast<float*>(flags + ((p.n_tiles + 3) / 4) * 4);
  float* part_s = part_m + (size_t)p.splits * B;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch<false>(z, mu, log_var, data_idx, ex_idx, valid, B, N, D, p,
                          z_rec, mu_rec, flags, part_m, part_s,
                          static_cast<float*>(out), st)
          : launch<true>(z, mu, log_var, data_idx, ex_idx, valid, B, N, D, p,
                         z_rec, mu_rec, flags, part_m, part_s,
                         static_cast<float*>(out), st);
  return (int)err;
}

}  // extern "C"
