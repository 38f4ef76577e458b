// The gated convs' epilogue, for Hopper (sm_90a): depth-to-space, bias and
// sigmoid gate in one pass,
//
//   out[r, f, sh*q + a, sw*p + b] =
//       (y[r, (a*sw + b)*2F + f, q, p] + bh[f])
//       * sigmoid(y[r, (a*sw + b)*2F + F + f, q, p] + bg[f])
//
// over fp32 y, a gated conv's raw output (no bias), NCHW-contiguous of shape
// (R, sh*sw*2F, h, w) in phase-major channel order, into a fresh
// NCHW-contiguous out of shape (R, F, sh*h, sw*w). With sh = sw = 1 it is a
// plain gated conv's epilogue; with a stride it is also the depth-to-space
// step of a transposed conv's sub-pixel form (models/layers.py). The
// arithmetic is the unfused chain's, in its order: the biased value, the
// biased gate, the sigmoid as torch computes it for fp32 on the card
// (1 / (1 + expf(-x)), no fast math), one product; so both give the same
// bits from the same conv output.
//
// Replaces no TPU kernel. The JAX package leaves the bias and the gate to
// XLA, which fuses them into the convolution's output; on the card cuDNN's
// fp32 fprop returns the raw sum, and PyTorch then added the bias (or the
// depth-to-space copy that adds it), the sigmoid over the gate half and the
// product in three more passes over strided halves.
//
// What bounds it: HBM bytes. It reads the 2F channels once and writes the F
// gated ones once, 12 bytes and ~30 instructions an output value (the
// accurate expf and the IEEE division): at 5000 rows of Config 4's decoder
// layers 3.93, 7.86 and 7.86 GB a call, 1.17, 2.35 and 2.35 ms at
// 3.35 TB/s. The design does what a streaming pass can:
//   * a thread takes 4 neighbouring input columns of one input row in every
//     phase (128-bit loads, neighbouring threads on neighbouring vectors),
//     and writes them as 128-bit stores: with sh = sw = 2 the two column
//     phases interleave into two float4s of each of the two output rows;
//   * every load of a thread is issued before its first store, 128 bytes a
//     thread in flight (4 units a thread without a stride, 1 with);
//   * index arithmetic in 32 bits, divisions by multiply and shift; the
//     host splits R into launches of fewer than 2^31 units;
//   * other strides, a w (or h*w without a stride) that is not a multiple
//     of 4, or a pointer off a 16-byte boundary take one scalar kernel, one
//     output value a unit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned long long MAX_UNITS = (1ULL << 31) - (1ULL << 16);

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31: (umulhi(n, m) + n) >> s
struct Div {
  unsigned d, m, s;
};

Div make_div(unsigned d) {
  unsigned s = 0;
  while ((1ULL << s) < d) ++s;
  const unsigned long long m = ((1ULL << 32) * ((1ULL << s) - d)) / d + 1;
  return Div{d, (unsigned)m, s};
}

__device__ __forceinline__ unsigned divide(const Div& q, unsigned n) {
  return (__umulhi(n, q.m) + n) >> q.s;
}

__device__ __forceinline__ float gate(float v, float g, float bh, float bg) {
  const float x = g + bg;
  return (v + bh) * (1.f / (1.f + expf(-x)));
}

__device__ __forceinline__ float4 gate(float4 v, float4 g, float bh,
                                       float bg) {
  return make_float4(gate(v.x, g.x, bh, bg), gate(v.y, g.y, bh, bg),
                     gate(v.z, g.z, bh, bg), gate(v.w, g.w, bh, bg));
}

// S phases along each axis (1 or 2). Unit u: float4 column pv of input row
// q of plane (r, f); units = R * F * h * w4. With S = 1 the host passes a
// plane as one row (h = 1, w4 = h*w / 4).
template <int S>
__global__ void __launch_bounds__(THREADS)
    gated_vec_kernel(const float4* __restrict__ y,
                     const float* __restrict__ bh,
                     const float* __restrict__ bg, float4* __restrict__ out,
                     unsigned units, Div w4, Div h, Div feats) {
  constexpr int P = S * S;
  constexpr int UNITS = 4 / P;
  const unsigned hw4 = h.d * w4.d, F = feats.d;
  float4 v[UNITS][P], g[UNITS][P];
  float vb[UNITS], gb[UNITS];
  unsigned long long dst[UNITS];
  const unsigned first = blockIdx.x * (THREADS * UNITS) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const unsigned u = first + k * THREADS;
    if (u < units) {
      const unsigned row = divide(w4, u), pv = u - row * w4.d;
      const unsigned plane = divide(h, row), q = row - plane * h.d;
      const unsigned r = divide(feats, plane), f = plane - r * F;
      const unsigned long long src =
          ((unsigned long long)r * (P * 2 * F) + f) * hw4 + q * w4.d + pv;
#pragma unroll
      for (int ph = 0; ph < P; ++ph) {
        const unsigned long long at = src + (unsigned long long)ph * 2 * F * hw4;
        v[k][ph] = __ldg(y + at);
        g[k][ph] = __ldg(y + at + (unsigned long long)F * hw4);
      }
      vb[k] = __ldg(bh + f);
      gb[k] = __ldg(bg + f);
      dst[k] = (unsigned long long)plane * P * hw4 + S * q * S * w4.d + S * pv;
    }
  }
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    if (first + k * THREADS >= units) continue;
    if (S == 1) {
      out[dst[k]] = gate(v[k][0], g[k][0], vb[k], gb[k]);
    } else {
#pragma unroll
      for (int a = 0; a < S; ++a) {
        const float4 o0 = gate(v[k][a * S], g[k][a * S], vb[k], gb[k]);
        const float4 o1 = gate(v[k][a * S + 1], g[k][a * S + 1], vb[k], gb[k]);
        float4* row = out + dst[k] + (unsigned long long)a * S * w4.d;
        row[0] = make_float4(o0.x, o1.x, o0.y, o1.y);
        row[1] = make_float4(o0.z, o1.z, o0.w, o1.w);
      }
    }
  }
}

// Any strides and sizes: unit u is output value u; units = R * F * OH * OW.
__global__ void __launch_bounds__(THREADS)
    gated_any_kernel(const float* __restrict__ y,
                     const float* __restrict__ bh,
                     const float* __restrict__ bg, float* __restrict__ out,
                     unsigned units, Div ow, Div oh, Div feats, Div sw,
                     Div sh, unsigned h, unsigned w) {
  const unsigned u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= units) return;
  const unsigned orow = divide(ow, u), ox = u - orow * ow.d;
  const unsigned plane = divide(oh, orow), oy = orow - plane * oh.d;
  const unsigned r = divide(feats, plane), f = plane - r * feats.d;
  const unsigned q = divide(sh, oy), a = oy - q * sh.d;
  const unsigned p = divide(sw, ox), b = ox - p * sw.d;
  const unsigned F = feats.d, hw = h * w;
  const unsigned long long src =
      ((unsigned long long)r * (sh.d * sw.d * 2 * F) + (a * sw.d + b) * 2 * F +
       f) * hw + q * w + p;
  out[u] = gate(__ldg(y + src), __ldg(y + src + (unsigned long long)F * hw),
                __ldg(bh + f), __ldg(bg + f));
}

}  // namespace

extern "C" {

// y: rows * (sh*sw*2*features) * h * w floats, NCHW, phase-major channels;
// h_bias, g_bias: features floats each; out: rows * features * (sh*h) *
// (sw*w) floats, NCHW. Returns the cudaError_t of the first failed launch, 0
// after the last: cudaErrorInvalidValue where a size is not positive, and
// cudaErrorInvalidConfiguration where one row of R holds 2^31 - 2^16 units
// or more, both without a launch.
int gated_epilogue_forward(const void* y, const void* h_bias,
                           const void* g_bias, void* out, long long rows,
                           int features, int sh, int sw, int h, int w,
                           void* stream) {
  if (rows <= 0 || features <= 0 || sh <= 0 || sw <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long hw = (unsigned long long)h * w;
  const unsigned long long in_row = (unsigned long long)sh * sw * 2 * features * hw;
  const unsigned long long out_row = (unsigned long long)features * sh * sw * hw;
  const bool aligned = ((reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  // 1: no stride, a plane as one row; 2: sh = sw = 2; 0: the scalar kernel
  const int vec = !aligned ? 0
                  : (sh == 1 && sw == 1 && hw % 4 == 0) ? 1
                  : (sh == 2 && sw == 2 && w % 4 == 0) ? 2 : 0;
  const unsigned long long per_row =
      vec ? (unsigned long long)features * hw / 4 : out_row;
  if (per_row >= MAX_UNITS) return (int)cudaErrorInvalidConfiguration;
  const unsigned long long chunk = MAX_UNITS / per_row;
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  const float* bh = static_cast<const float*>(h_bias);
  const float* bg = static_cast<const float*>(g_bias);
  const Div feats = make_div((unsigned)features);
  for (long long r0 = 0; r0 < rows; r0 += (long long)chunk) {
    const unsigned long long n =
        (unsigned long long)rows - r0 < chunk ? (unsigned long long)rows - r0
                                              : chunk;
    const unsigned units = (unsigned)(n * per_row);
    const float* ys = yf + r0 * in_row;
    float* os = of + r0 * out_row;
    if (vec == 1) {
      const unsigned blocks = (units + THREADS * 4 - 1) / (THREADS * 4);
      gated_vec_kernel<1><<<blocks, THREADS, 0, st>>>(
          reinterpret_cast<const float4*>(ys), bh, bg,
          reinterpret_cast<float4*>(os), units, make_div((unsigned)(hw / 4)),
          make_div(1), feats);
    } else if (vec == 2) {
      const unsigned blocks = (units + THREADS - 1) / THREADS;
      gated_vec_kernel<2><<<blocks, THREADS, 0, st>>>(
          reinterpret_cast<const float4*>(ys), bh, bg,
          reinterpret_cast<float4*>(os), units, make_div((unsigned)(w / 4)),
          make_div((unsigned)h), feats);
    } else {
      const unsigned blocks = (units + THREADS - 1) / THREADS;
      gated_any_kernel<<<blocks, THREADS, 0, st>>>(
          ys, bh, bg, os, units, make_div((unsigned)(sw * w)),
          make_div((unsigned)(sh * h)), feats, make_div((unsigned)sw),
          make_div((unsigned)sh), (unsigned)h, (unsigned)w);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
