// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * (1 + scale).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py `_kernel` (reached
// through `rmsnorm`), which keeps a block of rows with the whole feature
// dim resident in VMEM.  Same arithmetic: f32 math, the (1 + scale)
// convention of core/tmp.py `rms_norm`, output in x's dtype.
//
// Bound on the H100: bytes.  Each row is read once and written once; a
// few flops per element.  At decode the call is 8 rows x 4096, about
// 130 KB, which the card moves in well under the launch latency, so the
// launch itself bounds the decode-time call.  Design, for d <= 4096
// (kernels/rmsnorm.py `fwd_geometry`): a group of W warps owns a row, a
// thread two 16-byte words of it (bf16 16 columns, f32 8: W = ceil(d /
// 512) in bf16, ceil(d / 256) in f32), both loaded with ordinary loads
// before either is used, read once and kept in registers; blocks of 16
// warps take 16 / W rows (mamba2's `ln`, d 768 in bf16: 8 rows; gpt-h2048's
// d 2048: 4), a row a group, as many blocks as rows need.  A row's sum of
// squares goes through shuffles and, for W > 1, across the group's warps
// through shared memory behind a named barrier of that group only, every
// thread adding the group's W partials in order (no thread sums for the
// others).  Scalar loads where d or the pointers rule out 16-byte words.
// Chosen by measurement (my chip calls 5-12, PR 21): groups walking rows
// over a grid cut to the card (one or two rows prefetched into registers,
// or a ring of rows filled by bulk copies), and 1, 4 or 8 words a thread
// or 4- and 8-warp blocks, were as fast or slower; evict-first loads
// (`__ldcs`) cost ~20% where x stays in L2 from its producer.  Wider rows
// (d > 4096) take a block a row and read x twice.
//
// Backward (training path; the TPU kernel has none, JAX lets XLA
// differentiate core/tmp.py `rms_norm`): with w = 1 + scale and
// r = rsqrt(mean(x^2) + eps), dx = r * (w*dy - x * r^2 * mean(x*w*dy)) and
// dscale = sum over rows of dy * x * r.  Bound: bytes (x and dy read, dx
// written, a few flops each).  Design, for d <= 4096: a group of W warps
// owns one row at a time (W = ceil(d / 256), a thread 8 columns), R = 16 / W
// groups a block, each walking its rows with the next row's x and dy
// already in flight.  x and dy are read once, with 16-byte loads where
// d and the pointers allow (else 8 strided scalar loads, the same
// arithmetic), and stay in registers for both passes; a row's two sums are
// reduced by shuffles and, for W > 1, across the group's warps through
// shared memory behind a named barrier of that group only (slots
// alternate by row parity, so one barrier a row suffices).  Each thread
// sums its columns' dy * x * r over its rows in registers; the block adds
// its groups in order into one f32 row of `partial` [nblocks, d], and a
// second small kernel sums the nblocks rows per column in a fixed order.
// No atomics, so every run gives the same bits; no dynamic shared memory,
// so no per-call attribute.  Wider rows (d > 4096) take a block a row and
// read x and dy twice, adding into the block's row of `partial` itself.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kBwdThreads = 512;  // 16 warps: R groups of W warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kCols = 8;             // columns a thread holds
constexpr int kRowCols = kBwdWarps * 32 * kCols;  // 4096: widest held row

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A thread's 8 columns of a row: with VEC, 16-byte vectors (bf16: one at
// column 8 * t; f32: two at columns 4 * t and 4 * (t + gt)); else the
// strided columns t, t + gt, ..., t + 7 * gt.  Columns >= d read as 0.
template <typename T, bool VEC>
struct Cols {
  static constexpr int ELT = 16 / static_cast<int>(sizeof(T));
  __device__ static int col(int j, int t, int gt) {
    if constexpr (VEC) return ((j / ELT) * gt + t) * ELT + j % ELT;
    else return j * gt + t;
  }
  __device__ static void load(const T* __restrict__ rowp, int t, int gt,
                              int d, uint4 (&raw)[kCols / ELT]) {
    if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < kCols / ELT; ++k) {
        const int c = (k * gt + t) * ELT;
        raw[k] = c < d ? __ldcs(reinterpret_cast<const uint4*>(rowp + c))
                       : make_uint4(0, 0, 0, 0);
      }
    } else {
      T v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = j * gt + t;
        v[j] = c < d ? rowp[c] : repro::from_float<T>(0.f);
      }
      memcpy(&raw, v, sizeof(v));
    }
  }
  __device__ static void to_float(const uint4 (&raw)[kCols / ELT],
                                  float (&f)[kCols]) {
    T v[kCols];
    memcpy(v, &raw, sizeof(v));
#pragma unroll
    for (int j = 0; j < kCols; ++j) f[j] = repro::to_float(v[j]);
  }
  __device__ static void store(T* __restrict__ rowp, int t, int gt, int d,
                               const float (&f)[kCols]) {
    T v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = repro::from_float<T>(f[j]);
    if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < kCols / ELT; ++k) {
        const int c = (k * gt + t) * ELT;
        if (c < d) {
          uint4 w;
          memcpy(&w, v + k * ELT, sizeof(w));
          *reinterpret_cast<uint4*>(rowp + c) = w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = j * gt + t;
        if (c < d) rowp[c] = v[j];
      }
    }
  }
};

// The forward: a group of warps_per_row warps owns one row, a thread
// kFwdVecs words of it (bf16 16 columns, f32 8), all loaded before any is
// used; rows_per_block groups a block of at most 16 warps, a row a group.
constexpr int kFwdThreads = 512;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdVecs = 2;

// A thread's columns of a row, kFwdVecs words of ELT values: with VEC,
// word k holds columns (k gt + t) ELT .. + ELT (one 16-byte load, kept as
// loaded and converted where used); else value e of word k is column
// (k ELT + e) gt + t (scalar loads, kept as f32).  Columns >= d read as 0.
// Four 512-thread blocks an SM (32 registers) with 16-byte words; the
// scalar path's strided columns need more, so two.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kFwdThreads, VEC ? 4 : 2)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int64_t rows, int d,
                   int warps_per_row, float eps) {
  constexpr int ELT = 16 / static_cast<int>(sizeof(T));
  __shared__ float sums[kFwdWarps];
  const int gt = warps_per_row * 32;
  const int group = threadIdx.x / gt;
  const int t = threadIdx.x % gt;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / gt) + group;
  if (row >= rows) return;  // a whole group: no barrier of it is pending
  const T* xr = x + row * d;
  T* orow = out + row * d;
  auto col = [&](int k, int e) {
    return VEC ? (k * gt + t) * ELT + e : (k * ELT + e) * gt + t;
  };
  uint4 raw[kFwdVecs];               // VEC
  float xs[kFwdVecs * ELT];          // scalar loads
  float ss = 0.f;
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < kFwdVecs; ++k) {
      const int c = col(k, 0);
      raw[k] = c < d ? __ldg(reinterpret_cast<const uint4*>(xr + c))
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kFwdVecs; ++k) {
      const T* v = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
      for (int e = 0; e < ELT; ++e) {
        const float f = repro::to_float(v[e]);
        ss += f * f;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kFwdVecs; ++k)
#pragma unroll
      for (int e = 0; e < ELT; ++e) {
        const int c = col(k, e);
        xs[k * ELT + e] = c < d ? repro::to_float(xr[c]) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kFwdVecs * ELT; ++j) ss += xs[j] * xs[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (warps_per_row > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) sums[warp] = ss;
    group_barrier(1 + group, gt);
    ss = 0.f;
    for (int k = 0; k < warps_per_row; ++k)
      ss += sums[group * warps_per_row + k];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < kFwdVecs; ++k) {
    if constexpr (VEC) {
      const int c = col(k, 0);
      if (c >= d) continue;
      const T* v = reinterpret_cast<const T*>(&raw[k]);
      // the word's ELT scales, 4 to a 16-byte load
      T y[ELT];
#pragma unroll
      for (int e = 0; e < ELT; e += 4) {
        const float4 s4 =
            __ldg(reinterpret_cast<const float4*>(scale + c + e));
        const float w[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          y[e + u] = repro::from_float<T>(repro::to_float(v[e + u]) * r *
                                          (1.f + w[u]));
      }
      uint4 wv;
      memcpy(&wv, y, sizeof(wv));
      *reinterpret_cast<uint4*>(orow + c) = wv;
    } else {
#pragma unroll
      for (int e = 0; e < ELT; ++e) {
        const int c = col(k, e);
        if (c < d)
          orow[c] =
              repro::from_float<T>(xs[k * ELT + e] * r * (1.f + scale[c]));
      }
    }
  }
}

// rows wider than kRowCols: a block a row, x read twice
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_wide_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale, T* __restrict__ out,
                        int64_t rows, int d, float eps) {
  __shared__ float sums[2][kBwdWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int parity = 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const T* xr = x + row * d;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += kBwdThreads) {
      const float v = repro::to_float(xr[i]);
      ss += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) sums[parity][warp] = ss;
    __syncthreads();
    ss = 0.f;
    for (int k = 0; k < kBwdWarps; ++k) ss += sums[parity][k];
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    T* orow = out + row * d;
    for (int i = threadIdx.x; i < d; i += kBwdThreads)
      orow[i] = repro::from_float<T>(repro::to_float(xr[i]) * r *
                                     (1.f + scale[i]));
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int64_t rows, int d,
                       int warps_per_row, float eps) {
  using C = Cols<T, VEC>;
  constexpr int NV = kCols / C::ELT;
  __shared__ float2 sums[2][kBwdWarps];  // [row parity][warp]: (ss, dot)
  __shared__ float red[kRowCols];        // the block's groups' dscale
  const int gt = warps_per_row * 32;
  const int groups = blockDim.x / gt;
  const int group = threadIdx.x / gt;
  const int t = threadIdx.x % gt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float w[kCols], dsc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = C::col(j, t, gt);
    w[j] = c < d ? 1.f + scale[c] : 0.f;
    dsc[j] = 0.f;
  }

  const int64_t stride = static_cast<int64_t>(gridDim.x) * groups;
  int64_t row = static_cast<int64_t>(blockIdx.x) * groups + group;
  uint4 cx[NV], cdy[NV];
  if (row < rows) {
    C::load(x + row * d, t, gt, d, cx);
    C::load(dy + row * d, t, gt, d, cdy);
  }
  for (int parity = 0; row < rows; row += stride, parity ^= 1) {
    uint4 nx[NV], ndy[NV];
    const int64_t next = row + stride;
    if (next < rows) {
      C::load(x + next * d, t, gt, d, nx);
      C::load(dy + next * d, t, gt, d, ndy);
    }
    float xv[kCols], dyv[kCols];
    C::to_float(cx, xv);
    C::to_float(cdy, dyv);
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      ss += xv[j] * xv[j];
      dot += xv[j] * (w[j] * dyv[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (warps_per_row > 1) {
      if (lane == 0) sums[parity][warp] = make_float2(ss, dot);
      group_barrier(1 + group, gt);
      ss = dot = 0.f;
      for (int k = 0; k < warps_per_row; ++k) {
        const float2 p = sums[parity][group * warps_per_row + k];
        ss += p.x;
        dot += p.y;
      }
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float mdot = dot / static_cast<float>(d);
    float dxv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dxv[j] = r * (w[j] * dyv[j] - xv[j] * (r * r) * mdot);
      dsc[j] += dyv[j] * xv[j] * r;
    }
    C::store(dx + row * d, t, gt, d, dxv);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      cx[k] = nx[k];
      cdy[k] = ndy[k];
    }
  }

  // the groups' column sums, added in group order -> partial[blockIdx.x]
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  if (groups > 1) {
    if (group > 0) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        red[(group * gt + t) * kCols + j] = dsc[j];
    }
    __syncthreads();
    if (group > 0) return;
    for (int k = 1; k < groups; ++k) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) dsc[j] += red[(k * gt + t) * kCols + j];
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = C::col(j, t, gt);
    if (c < d) prow[c] = dsc[j];
  }
}

// rows wider than kRowCols: a block a row; x and dy read twice; the
// block's dscale row accumulates in `partial` (its own columns a thread)
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_wide_kernel(const T* __restrict__ x,
                            const float* __restrict__ scale,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, int64_t rows, int d,
                            float eps) {
  __shared__ float2 sums[2][kBwdWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kBwdThreads) prow[i] = 0.f;
  int parity = 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    float ss = 0.f, dot = 0.f;
    for (int i = threadIdx.x; i < d; i += kBwdThreads) {
      const float xv = repro::to_float(xr[i]);
      ss += xv * xv;
      dot += xv * ((1.f + scale[i]) * repro::to_float(dyr[i]));
    }
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (lane == 0) sums[parity][warp] = make_float2(ss, dot);
    __syncthreads();
    ss = dot = 0.f;
    for (int k = 0; k < kBwdWarps; ++k) {
      ss += sums[parity][k].x;
      dot += sums[parity][k].y;
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float mdot = dot / static_cast<float>(d);
    T* dxr = dx + row * d;
    for (int i = threadIdx.x; i < d; i += kBwdThreads) {
      const float xv = repro::to_float(xr[i]);
      const float dyv = repro::to_float(dyr[i]);
      dxr[i] = repro::from_float<T>(
          r * ((1.f + scale[i]) * dyv - xv * (r * r) * mdot));
      prow[i] += dyv * xv * r;
    }
  }
}

// dscale[c] = sum over blocks of partial[block, c], in block order: 32
// columns a block, 8 lanes of blocks each (blocks k, k + 8, ...), the
// lanes added in order
__global__ void __launch_bounds__(256)
    rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial,
                              float* __restrict__ dscale, int nblocks, int d) {
  __shared__ float lanes[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < d)
    for (int b = threadIdx.y; b < nblocks; b += 8)
      acc += partial[static_cast<int64_t>(b) * d + c];
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || c >= d) return;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum += lanes[k][threadIdx.x];
  dscale[c] = sum;
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, void* partial, long long rows, int d, int wpr,
               int rpb, int nblocks, float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const float* sp = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(partial);
  constexpr int ELT = 16 / static_cast<int>(sizeof(T));
  const auto bits = reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(dy) |
                    reinterpret_cast<uintptr_t>(dx) |
                    reinterpret_cast<uintptr_t>(scale);
  if (d > kRowCols)
    rmsnorm_bwd_wide_kernel<T><<<nblocks, kBwdThreads, 0, s>>>(
        xp, sp, dyp, dxp, pp, rows, d, eps);
  else if (d % ELT == 0 && (bits & 15) == 0)
    rmsnorm_bwd_kernel<T, true><<<nblocks, wpr * rpb * 32, 0, s>>>(
        xp, sp, dyp, dxp, pp, rows, d, wpr, eps);
  else
    rmsnorm_bwd_kernel<T, false><<<nblocks, wpr * rpb * 32, 0, s>>>(
        xp, sp, dyp, dxp, pp, rows, d, wpr, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_reduce_kernel<<<(d + 31) / 32, dim3(32, 8), 0, s>>>(
      pp, static_cast<float*>(dscale), nblocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, const void* scale, void* out, long long rows,
               int d, int wpr, int rpb, int nblocks, float eps,
               cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const float* sp = static_cast<const float*>(scale);
  constexpr int ELT = 16 / static_cast<int>(sizeof(T));
  const auto bits = reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out) |
                    reinterpret_cast<uintptr_t>(scale);
  if (d > kRowCols)
    rmsnorm_wide_kernel<T><<<nblocks, kBwdThreads, 0, s>>>(xp, sp, op, rows,
                                                           d, eps);
  else if (d % ELT == 0 && (bits & 15) == 0)
    rmsnorm_kernel<T, true><<<nblocks, wpr * rpb * 32, 0, s>>>(
        xp, sp, op, rows, d, wpr, eps);
  else
    rmsnorm_kernel<T, false><<<nblocks, wpr * rpb * 32, 0, s>>>(
        xp, sp, op, rows, d, wpr, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows, d] contiguous, dtype code `dtype`; scale: [d] f32.  Rows
// go to groups of warps_per_row warps, rows_per_block groups a block, a
// row a group (kernels/rmsnorm.py `fwd_geometry`): warps_per_row * 32
// threads hold kFwdVecs words of d, at most 16 warps a block, nblocks =
// ceil(rows / rows_per_block); or, for d > 4096, 16 warps, rows_per_block
// 1.  Returns a cudaError_t code (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             long long rows, int d, int warps_per_row,
                             int rows_per_block, int nblocks, float eps,
                             int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (dtype != repro::kF32 && dtype != repro::kBF16)
    return cudaErrorInvalidValue;
  // columns a thread holds
  const int cols = kFwdVecs * (dtype == repro::kF32 ? 4 : 8);
  const bool wide = d > kRowCols;
  if (d <= 0 || warps_per_row <= 0 || rows_per_block <= 0 ||
      (wide ? warps_per_row != kBwdWarps || rows_per_block != 1 ||
                  nblocks > 65535
            : warps_per_row * rows_per_block > kFwdWarps ||
                  warps_per_row * 32 * cols < d ||
                  nblocks != (rows + rows_per_block - 1) / rows_per_block) ||
      nblocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch_fwd<float>(x, scale, out, rows, d, warps_per_row,
                             rows_per_block, nblocks, eps, s);
  if (dtype == repro::kBF16)
    return launch_fwd<__nv_bfloat16>(x, scale, out, rows, d, warps_per_row,
                                     rows_per_block, nblocks, eps, s);
  return cudaErrorInvalidValue;
}

// Backward of repro_rmsnorm.  x, dy, dx: [rows, d] of dtype code `dtype`;
// scale, dscale: [d] f32; partial: [nblocks, d] f32 scratch.  Rows go to
// groups of warps_per_row warps, rows_per_block groups a block
// (kernels/rmsnorm.py `bwd_geometry`): warps_per_row * 256 >= d, or 16
// with rows_per_block 1 for d > 4096; nblocks <= ceil(rows /
// rows_per_block).  Returns a cudaError_t code (0 on success).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* dy, void* dx, void* dscale,
                                 void* partial, long long rows, int d,
                                 int warps_per_row, int rows_per_block,
                                 int nblocks, float eps, int dtype,
                                 void* stream) {
  const bool wide = d > kRowCols;
  if (d <= 0 || rows <= 0 || warps_per_row <= 0 || rows_per_block <= 0 ||
      warps_per_row * rows_per_block > kBwdWarps ||
      (wide ? warps_per_row != kBwdWarps
            : warps_per_row * 32 * kCols < d) ||
      nblocks <= 0 || nblocks > 65535 ||
      nblocks > (rows + rows_per_block - 1) / rows_per_block)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch_bwd<float>(x, scale, dy, dx, dscale, partial, rows, d,
                             warps_per_row, rows_per_block, nblocks, eps, s);
  if (dtype == repro::kBF16)
    return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows,
                                     d, warps_per_row, rows_per_block,
                                     nblocks, eps, s);
  return cudaErrorInvalidValue;
}
