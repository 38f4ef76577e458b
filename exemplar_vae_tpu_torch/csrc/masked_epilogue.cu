// The PixelHVAE masked layers' epilogue, in place, for Hopper (sm_90a):
//
//   h[n, c, y, x] = relu((h[n, c, y, x] + bias[c]) + ctx[n, c, y, x])
//
// over fp32 h (a masked conv's output, computed without its bias) and the
// context map ctx, both NCHW-contiguous of one shape, with the sums in this
// order: the order of the unfused conv + bias, add, ReLU it replaces, so that
// both give the same bits from the same conv output. NaN stays NaN, as in
// torch.relu.
//
// Replaces no TPU kernel. The JAX package leaves the bias, the context add
// and the ReLU to XLA, which fuses them into the convolution's output; the
// port's convs run on cuDNN, whose fp32 fprop returns the raw sum, and
// PyTorch then adds the bias, the context and the ReLU in three more passes.
// This kernel is those three passes in one.
//
// What bounds it: HBM bytes. It reads h and ctx and writes h once, 12 bytes
// and 3 flops a value: at 50 000 rows of (64, 28, 28) that is 3 x 10.0 GB a
// call, 8.99 ms at 3.35 TB/s. The design does what a streaming pass can:
//   * 128-bit loads and stores (float4), neighbouring threads on neighbouring
//     vectors. H*W = 784 is a multiple of 4, so a vector never straddles two
//     channels and one bias value serves it; an H*W that is not a multiple
//     of 4, or a pointer that is not 16-byte aligned, takes the same kernel
//     one float at a time;
//   * each thread starts the loads of VECTORS vectors of h and of ctx before
//     it stores any, so that 128 bytes a thread are in flight;
//   * one block of THREADS threads for every THREADS * VECTORS vectors, so
//     that the grid covers
//     the tensor once and the hardware keeps every SM full to the last wave.
//     A grid sized to the 132 SMs, each thread striding over the tensor,
//     was measured 5% slower at the serving shape (10.19 against 9.69 ms,
//     NVIDIA H100 80GB HBM3, 700 W), whatever its blocks per SM (4-16) or
//     unroll (1-4).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECTORS = 4;

__device__ __forceinline__ float apply(float h, float b, float c) {
  const float v = (h + b) + c;
  return v < 0.f ? 0.f : v;
}

__device__ __forceinline__ float4 apply(float4 h, float b, float4 c) {
  return make_float4(apply(h.x, b, c.x), apply(h.y, b, c.y),
                     apply(h.z, b, c.z), apply(h.w, b, c.w));
}

// V is float4 or float: one unit is one V. q units make one plane (one
// channel of one row), and unit u lies in channel (u / q) % channels.
template <typename V>
__global__ void __launch_bounds__(THREADS)
    masked_epilogue_kernel(V* __restrict__ h, const float* __restrict__ bias,
                           const V* __restrict__ ctx, unsigned long long units,
                           unsigned q, unsigned channels) {
  const unsigned long long first =
      (unsigned long long)blockIdx.x * THREADS * VECTORS + threadIdx.x;
  V hv[VECTORS], cv[VECTORS];
  float bv[VECTORS];
#pragma unroll
  for (int k = 0; k < VECTORS; ++k) {
    const unsigned long long u = first + (unsigned long long)k * THREADS;
    if (u < units) {
      hv[k] = h[u];
      cv[k] = __ldg(ctx + u);
      bv[k] = __ldg(bias + (unsigned)((u / q) % channels));
    }
  }
#pragma unroll
  for (int k = 0; k < VECTORS; ++k) {
    const unsigned long long u = first + (unsigned long long)k * THREADS;
    if (u < units) h[u] = apply(hv[k], bv[k], cv[k]);
  }
}

template <typename V>
cudaError_t launch(void* h, const void* bias, const void* ctx,
                   unsigned long long units, unsigned q, unsigned channels,
                   cudaStream_t stream) {
  const unsigned long long per_block = (unsigned long long)THREADS * VECTORS;
  const unsigned long long blocks = (units + per_block - 1) / per_block;
  if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
  masked_epilogue_kernel<V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<V*>(h), static_cast<const float*>(bias),
      static_cast<const V*>(ctx), units, q, channels);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h and ctx: planes * hw floats each (planes = rows * channels), NCHW; bias:
// channels floats. Returns the cudaError_t of the launch: cudaErrorInvalidValue
// where planes is not a positive multiple of channels or hw is not positive,
// and cudaErrorInvalidConfiguration where the grid would pass 2^31 - 1
// blocks, both without a launch.
int masked_epilogue_forward(void* h, const void* bias, const void* ctx,
                            long long planes, int channels, int hw,
                            void* stream) {
  if (planes <= 0 || channels <= 0 || hw <= 0 || planes % channels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = hw % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(h) |
                     reinterpret_cast<uintptr_t>(ctx)) & 15) == 0;
  const cudaError_t err =
      vec ? launch<float4>(h, bias, ctx, (unsigned long long)planes * (hw / 4),
                           (unsigned)(hw / 4), (unsigned)channels, st)
          : launch<float>(h, bias, ctx, (unsigned long long)planes * hw,
                          (unsigned)hw, (unsigned)channels, st);
  return (int)err;
}

}  // extern "C"
