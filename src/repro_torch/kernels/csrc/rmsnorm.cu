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
//
// Backward (training path; the TPU kernel has none, JAX lets XLA
// differentiate core/tmp.py `rms_norm`): with w = 1 + scale and
// r = rsqrt(mean(x^2) + eps), dx = r * (w*dy - x * r^2 * mean(x*w*dy)) and
// dscale = sum over rows of dy * x * r.  Bound: bytes (x and dy read, dx
// written, a few flops each).  Design: a grid of at most a few hundred
// blocks walks the rows (one row per block at a time, reduced as in the
// forward); each block adds its rows' dy * x * r into its own f32 row
// of `partial` [nblocks, d] held in shared memory, and a second small
// kernel sums the nblocks partials per column in a fixed order.  No
// atomics, so dscale is deterministic.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int64_t rows, int d,
                       float eps) {
  extern __shared__ float dsc[];  // [d] this block's dscale partial
  __shared__ float warp_sums[2][kWarps];
  __shared__ float stats[2];      // r, mean(x * w * dy)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < d; i += kThreads) dsc[i] = 0.f;

  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    float ss = 0.f, dot = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xv = repro::to_float(xr[i]);
      const float wdy = (1.f + scale[i]) * repro::to_float(dyr[i]);
      ss += xv * xv;
      dot += xv * wdy;
    }
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (lane == 0) {
      warp_sums[0][warp] = ss;
      warp_sums[1][warp] = dot;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float ts = 0.f, td = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        ts += warp_sums[0][w];
        td += warp_sums[1][w];
      }
      stats[0] = rsqrtf(ts / static_cast<float>(d) + eps);
      stats[1] = td / static_cast<float>(d);
    }
    __syncthreads();
    const float r = stats[0];
    const float mdot = stats[1];
    T* dxr = dx + row * d;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xv = repro::to_float(xr[i]);
      const float dyv = repro::to_float(dyr[i]);
      const float wdy = (1.f + scale[i]) * dyv;
      dxr[i] = repro::from_float<T>(r * (wdy - xv * (r * r) * mdot));
      dsc[i] += dyv * xv * r;  // column i belongs to this thread only
    }
    __syncthreads();  // warp_sums/stats are rewritten by the next row
  }
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) prow[i] = dsc[i];
}

// dscale[i] = sum over blocks of partial[block, i], in block order
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial,
                              float* __restrict__ dscale, int nblocks, int d) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d) return;
  float acc = 0.f;
  for (int b = 0; b < nblocks; ++b) acc += partial[static_cast<int64_t>(b) * d + i];
  dscale[i] = acc;
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, void* partial, long long rows, int d,
               int nblocks, float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_kernel<T><<<nblocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, d, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_reduce_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale),
      nblocks, d);
  return static_cast<int>(cudaGetLastError());
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

// Backward of repro_rmsnorm.  x, dy, dx: [rows, d] of dtype code `dtype`;
// scale, dscale: [d] f32; partial: [nblocks, d] f32 scratch with
// 1 <= nblocks <= rows.  Returns a cudaError_t code (0 on success).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* dy, void* dx, void* dscale,
                                 void* partial, long long rows, int d,
                                 int nblocks, float eps, int dtype,
                                 void* stream) {
  if (d <= 0 || rows <= 0 || nblocks <= 0 || nblocks > rows ||
      nblocks > 65535 || static_cast<size_t>(d) * sizeof(float) > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch_bwd<float>(x, scale, dy, dx, dscale, partial, rows, d,
                             nblocks, eps, s);
  if (dtype == repro::kBF16)
    return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows,
                                     d, nblocks, eps, s);
  return cudaErrorInvalidValue;
}
