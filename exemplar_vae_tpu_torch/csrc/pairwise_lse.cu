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
// data_idx the row index is NO_LOO_IDX = -1). No log-denominator is applied.
// The (B, N) logits matrix is never written to device memory.
//
// What bounds it. At the serving shape (B = N = 50 000, D = 40) one call does
// 2*B*N*D = 2.0e11 fp32 flops of cross terms and B*N = 2.5e9 exponentials on
// 16 MB of input, so it is bound by operations: the fp32 SIMT pipes (67
// TFLOP/s on the data sheet) give a floor of 2.99 ms. TF32 tensor cores are
// not used: |z|^2 + |mu|^2 - 2 z.mu cancels, and TF32's 10-bit mantissa would
// move the result far outside the fp32 parity tolerance. At the train shape
// (B = 100) the work is ~4e8 flops against 8 MB of mu: launch cost and the
// single pass over mu bound it. Measured by chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W: 10.3 ms at the serving shape (the floor is 29% of it;
// bf16 inputs take the same time, since they are widened to fp32) and
// 0.077 ms at the train shape against a 0.006 ms floor. Each thread issues
// 12 shared-memory loads per 32 FMAs and ~10 epilogue instructions per pair;
// register tiles fed by vector loads, or tensor cores with an
// error-compensated split, are the ways to the floor.
//
// Design. Blocks run in no order on 132 SMs, so the TPU kernel's sequential
// sweep over N tiles with a carried (max, sumexp) becomes:
//   * a grid of (row blocks of TB rows) x (splits of the exemplar axis). The
//     split count is chosen so that ~4 blocks per SM exist even at B = 100,
//     where a single row block would leave 131 SMs idle;
//   * inside a block, a loop over TN-exemplar tiles staged in shared memory
//     (with their squared norms and effective indices); each thread owns an
//     RM x CN register tile of cross terms, computed with IEEE fp32 FMAs, and
//     a running (m, s) per row, rescaled once per tile;
//   * each split writes one partial (m, s) per row to scratch that the caller
//     allocates; lse_merge_kernel merges the splits with the lse_combine rule
//     and writes m + log(s).
// Shared-memory rows are padded to an odd stride so that the 16 threads that
// read 16 different exemplar rows hit 16 different banks.
// One template serves fp32 and bf16 inputs: bf16 values are widened to fp32
// when staged, so the cross term and both norms use the bf16-rounded values
// with fp32 accumulation, as the TPU kernel does with in_dtype=bfloat16.
//
// Measured times are in PERF.md (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;            // threads along the exemplar axis
constexpr int TY = 16;            // threads along the row axis
constexpr int RM = 8;             // rows per thread
constexpr int CN = 4;             // exemplars per thread and tile
constexpr int TB = TY * RM;       // 128 rows per block
constexpr int TN = TX * CN;       // 64 exemplars per tile
constexpr int THREADS = TX * TY;  // 256
constexpr int MAX_D = 128;
constexpr int PAD_IDX = -2;
constexpr int NO_LOO_IDX = -1;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Plan {
  int row_blocks;
  int splits;
  int tiles_per_split;
};

Plan make_plan(int B, int N, int sm_count) {
  Plan p;
  p.row_blocks = (B + TB - 1) / TB;
  const int n_tiles = (N + TN - 1) / TN;
  const int target = 4 * (sm_count > 0 ? sm_count : 1);
  int want = (target + p.row_blocks - 1) / p.row_blocks;
  if (want > n_tiles) want = n_tiles;
  if (want > 65535) want = 65535;
  if (want < 1) want = 1;
  p.tiles_per_split = (n_tiles + want - 1) / want;
  p.splits = (n_tiles + p.tiles_per_split - 1) / p.tiles_per_split;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
lse_partial_kernel(const T* __restrict__ z, const T* __restrict__ mu,
                   const float* __restrict__ log_var,
                   const int32_t* __restrict__ data_idx,
                   const int32_t* __restrict__ ex_idx,
                   const uint8_t* __restrict__ valid,
                   int B, int N, int D, int tiles_per_split,
                   float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ float smem[];
  const int ld = D | 1;                 // odd row stride: no bank conflicts
  float* zs = smem;                     // TB x ld
  float* ms = zs + TB * ld;             // TN x ld
  float* msq = ms + TN * ld;            // TN
  int* eid = reinterpret_cast<int*>(msq + TN);  // TN

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * TB;
  const int split = blockIdx.y;

  const float lv = *log_var;
  const float d_lv = (float)D * lv;
  const float inv_var = expf(-lv);

  for (int i = tid; i < TB * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int row = row0 + r;
    zs[r * ld + d] = row < B ? widen(z[(size_t)row * D + d]) : 0.f;
  }
  __syncthreads();

  float zsq[RM], m[RM], s[RM];
  int didx[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    const int row = row0 + r;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(zs[r * ld + d], zs[r * ld + d], acc);
    zsq[i] = acc;
    didx[i] = (data_idx != nullptr && row < B) ? data_idx[row] : NO_LOO_IDX;
    m[i] = NEG_INF;
    s[i] = 0.f;
  }

  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * TN;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < TN * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const int col = col0 + c;
      ms[c * ld + d] = col < N ? widen(mu[(size_t)col * D + d]) : 0.f;
    }
    if (tid < TN) {
      const int col = col0 + tid;
      eid[tid] = (col < N && valid[col]) ? ex_idx[col] : PAD_IDX;
    }
    __syncthreads();
    if (tid < TN) {
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(ms[tid * ld + d], ms[tid * ld + d], acc);
      msq[tid] = acc;
    }

    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = zs[(ty * RM + i) * ld + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = ms[(tx + TX * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // msq is written

    float bsq[CN];
    int e[CN];
    bool in_range[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = tx + TX * j;
      bsq[j] = msq[c];
      e[j] = eid[c];
      in_range[j] = col0 + c < N;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float l[CN];
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float sq = fmaxf(zsq[i] + bsq[j] - 2.f * acc[i][j], 0.f);
        float v = -0.5f * (d_lv + sq * inv_var);
        if (e[j] == PAD_IDX || e[j] == didx[i]) v = NEG_INF;
        // Columns past N are not exemplars at all: they add exp(-inf) = 0.
        if (!in_range[j]) v = -INFINITY;
        l[j] = v;
        mt = fmaxf(mt, v);
      }
      float acc_s = s[i] * __expf(m[i] - mt);
#pragma unroll
      for (int j = 0; j < CN; ++j) acc_s += __expf(l[j] - mt);
      m[i] = mt;
      s[i] = acc_s;
    }
  }

  // Merge the TX partial states of each row (16 lanes of one half-warp).
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float mi = m[i], si = s[i];
#pragma unroll
    for (int off = TX / 2; off >= 1; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mi, off);
      const float so = __shfl_xor_sync(0xffffffffu, si, off);
      const float mn = fmaxf(mi, mo);
      si = si * __expf(mi - mn) + so * __expf(mo - mn);
      mi = mn;
    }
    const int row = row0 + ty * RM + i;
    if (tx == 0 && row < B) {
      part_m[(size_t)split * B + row] = mi;
      part_s[(size_t)split * B + row] = si;
    }
  }
}

__global__ void lse_merge_kernel(const float* __restrict__ part_m,
                                 const float* __restrict__ part_s,
                                 int B, int splits, float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float m = NEG_INF;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, part_m[(size_t)k * B + row]);
  float s = 0.f;
  for (int k = 0; k < splits; ++k)
    s += part_s[(size_t)k * B + row] * expf(part_m[(size_t)k * B + row] - m);
  out[row] = m + logf(s);
}

template <typename T>
cudaError_t launch(const void* z, const void* mu, const void* log_var,
                   const void* data_idx, const void* ex_idx, const void* valid,
                   int B, int N, int D, const Plan& p, float* part_m,
                   float* part_s, float* out, cudaStream_t stream) {
  const size_t smem = ((size_t)(TB + TN) * (D | 1) + 2 * TN) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lse_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.row_blocks, p.splits);
  lse_partial_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(mu),
      static_cast<const float*>(log_var),
      static_cast<const int32_t*>(data_idx),
      static_cast<const int32_t*>(ex_idx),
      static_cast<const uint8_t*>(valid), B, N, D, p.tiles_per_split,
      part_m, part_s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_merge_kernel<<<(B + 255) / 256, 256, 0, stream>>>(part_m, part_s, B,
                                                        p.splits, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest latent width the kernel takes (one shared-memory row of z and mu).
int pairwise_lse_max_d() { return MAX_D; }

// Floats of scratch that pairwise_lse_forward needs for these sizes.
long long pairwise_lse_scratch_floats(int B, int N, int sm_count) {
  if (B <= 0 || N <= 0) return 0;
  const Plan p = make_plan(B, N, sm_count);
  return 2LL * p.splits * B;
}

// dtype: 0 = float32 z and mu, 1 = bfloat16. data_idx may be null (no LOO).
// valid is one byte per exemplar. Returns the cudaError_t of the launches.
int pairwise_lse_forward(int dtype, const void* z, const void* mu,
                         const void* log_var, const void* data_idx,
                         const void* ex_idx, const void* valid, int B, int N,
                         int D, int sm_count, void* scratch, void* out,
                         void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || D > MAX_D || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, N, sm_count);
  float* part_m = static_cast<float*>(scratch);
  float* part_s = part_m + (size_t)p.splits * B;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch<float>(z, mu, log_var, data_idx, ex_idx, valid, B, N, D, p,
                          part_m, part_s, static_cast<float*>(out), st)
          : launch<__nv_bfloat16>(z, mu, log_var, data_idx, ex_idx, valid, B,
                                  N, D, p, part_m, part_s,
                                  static_cast<float*>(out), st);
  return (int)err;
}

}  // extern "C"
