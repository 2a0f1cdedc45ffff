// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * (1 + scale).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py `_kernel` (reached
// through `rmsnorm`), which keeps a block of rows with the whole feature
// dim resident in VMEM.  Same arithmetic: f32 math, the (1 + scale)
// convention of core/tmp.py `rms_norm`, output in x's dtype.
//
// Bound on the H100: bytes.  Each row is read once for the sum of squares
// and once more (from L1/L2) for the output, and written once; a few
// flops per element.  At decode the call is 8 rows x 4096, about 130 KB,
// which the card moves in well under the launch latency, so the launch
// itself bounds the decode-time call.  Design: one block of 256 threads
// per row (a row of 4096 values is 16 per thread), a warp-shuffle then
// shared-memory reduction for the sum, one rsqrt per row.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::to_float(xr[i]);
    ss += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float warp_sums[kWarps];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    inv_rms = rsqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float y = repro::to_float(xr[i]) * r;
    orow[i] = repro::from_float<T>(y * (1.f + scale[i]));
  }
}

}  // namespace

// x, out: [rows, d] contiguous, dtype code `dtype`; scale: [d] f32.
// Returns a cudaError_t code (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             long long rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (dtype == repro::kF32) {
    rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), d, eps);
  } else if (dtype == repro::kBF16) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
        d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
