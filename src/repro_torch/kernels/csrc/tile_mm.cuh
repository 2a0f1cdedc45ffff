// One block's tile of a matrix product on the CUDA cores (f32) or on
// warp-level mma.sync (bf16), shared by the standalone tile matmul
// (tile_matmul.cu), the fused matmul -> reduce-scatter ring
// (ring_matmul_rs.cu) and the grouped matmul (moe_gmm.cu), as
// `_mm_tile_kernel` is shared by the Pallas ring kernels in
// src/repro/kernels/collective_matmul.py.  bf16 operands that TMA can
// describe run gemm_tc.cuh's tile on wgmma instead; this bf16 tile is
// kept for the rest (kernels/autotune.py gemm_path: a base not 16-byte
// aligned, or a contiguous extent not a multiple of 8).
//
// `TileMM<T, BM, BN, BK>::run` computes the BM x BN tile (tm, tn) of
// x [m, k] @ w [k, n] (both row-major, contiguous) into f32 accumulators
// held in registers, walking k in steps of BK through shared memory.
// Rows, columns and k beyond the matrix are masked (zero-filled on load)
// rather than padded.  256 threads (8 warps).
//
// bf16: warp-level tensor-core products, mma.sync.m16n8k16 with f32
// accumulation, one shared-memory stage, plain loads.  The 8 warps
// are 2 (rows) x 4 (columns); a warp owns (BM/2) x (BN/4) outputs as
// (BM/32) x (BN/32) m16n8 fragments.  Tiles sit in shared memory as
// x[BM][BK+8] and w transposed, w[BN][BK+8]: each fragment register is one
// 32-bit load, and the 8-element row padding spreads a warp's loads over
// all 32 banks.
//
// f32: FMAs on the CUDA cores, so that no TF32 enters and f32 results keep
// full precision (TF32 keeps ~3 decimal digits).  256 threads as 16 x 16;
// a thread owns rows ty + 16 i and columns tx + 16 j (BM/16 x BN/16
// outputs).  Tiles sit in shared memory as x transposed, x[BK][BM+4], and
// w[BK][BN+4].
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr int kTileThreads = 256;

// Tiles are loaded 16 bytes at a time (8 bf16 or 4 f32 values) where the
// run lies inside the matrix and rows start 16-byte aligned; value by
// value, zero-filled, otherwise.
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int BM, int BN, int BK>
struct TileMM;

// ---------------------------------------------------------------- bf16
template <int BM, int BN, int BK>
struct TileMM<__nv_bfloat16, BM, BN, BK> {
  using T = __nv_bfloat16;
  static constexpr int kLD = BK + 8;          // smem row stride (elements)
  static constexpr int kMT = BM / 32;         // m16 fragments per warp
  static constexpr int kNT = BN / 32;         // n8 fragments per warp
  static constexpr size_t kSmem = sizeof(T) * (BM + BN) * kLD;
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BK % 16 == 0, "tile");

  float acc[kMT][kNT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // f(row, col, value&) over this thread's outputs, tile-local coordinates
  template <typename F>
  __device__ __forceinline__ void for_each(F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * (BM / 2) + i * 16 + g + ((e >> 1) << 3);
          const int c = wn * (BN / 4) + j * 8 + 2 * t + (e & 1);
          f(r, c, acc[i][j][e]);
        }
  }

  __device__ __forceinline__ void run(const T* __restrict__ x,
                                      const T* __restrict__ w, int m, int k,
                                      int n, int tm, int tn, char* smem) {
    T* xs = reinterpret_cast<T*>(smem);          // [BM][kLD]
    T* ws = xs + BM * kLD;                       // [BN][kLD] (w transposed)
    const int row0 = tm * BM, col0 = tn * BN;
    const bool vec_ok = (k % 8 == 0) && (n % 8 == 0) &&
                        aligned16(x) && aligned16(w);
    zero();
    for (int k0 = 0; k0 < k; k0 += BK) {
      // x tile: BM rows of BK values, 8 at a time along k
      for (int idx = threadIdx.x; idx < BM * (BK / 8); idx += kTileThreads) {
        const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
        const int gr = row0 + r, gc = k0 + c;
        T* dst = xs + r * kLD + c;
        if (vec_ok && gr < m && gc + 8 <= k) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(x + int64_t(gr) * k + gc);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            dst[q] = (gr < m && gc + q < k) ? x[int64_t(gr) * k + gc + q]
                                            : __float2bfloat16(0.f);
        }
      }
      // w tile: BK rows of BN values, read 8 at a time along n, stored
      // transposed
      for (int idx = threadIdx.x; idx < BK * (BN / 8); idx += kTileThreads) {
        const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
        const int gr = k0 + r, gc = col0 + c;
        alignas(16) T vals[8];
        if (vec_ok && gr < k && gc + 8 <= n) {
          *reinterpret_cast<uint4*>(vals) =
              *reinterpret_cast<const uint4*>(w + int64_t(gr) * n + gc);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            vals[q] = (gr < k && gc + q < n) ? w[int64_t(gr) * n + gc + q]
                                             : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) ws[(c + q) * kLD + r] = vals[q];
      }
      __syncthreads();
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int wm = warp >> 2, wn = warp & 3;
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const T* base = xs + (wm * (BM / 2) + i * 16 + g) * kLD + kk + 2 * t;
          a[i][0] = *reinterpret_cast<const uint32_t*>(base);
          a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLD);
          a[i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLD + 8);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const T* base = ws + (wn * (BN / 4) + j * 8 + g) * kLD + kk + 2 * t;
          b[j][0] = *reinterpret_cast<const uint32_t*>(base);
          b[j][1] = *reinterpret_cast<const uint32_t*>(base + 8);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                "{%0,%1,%2,%3};\n"
                : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]),
                  "+f"(acc[i][j][2]), "+f"(acc[i][j][3])
                : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]),
                  "r"(b[j][0]), "r"(b[j][1]));
      }
      __syncthreads();
    }
  }
};

// ----------------------------------------------------------------- f32
template <int BM, int BN, int BK>
struct TileMM<float, BM, BN, BK> {
  using T = float;
  static constexpr int kRM = BM / 16, kRN = BN / 16;
  static constexpr int kLDX = BM + 4, kLDW = BN + 4;
  static constexpr size_t kSmem = sizeof(float) * BK * (kLDX + kLDW);
  static_assert(BM % 16 == 0 && BN % 16 == 0 && BK % 4 == 0, "tile");

  float acc[kRM][kRN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;
  }

  template <typename F>
  __device__ __forceinline__ void for_each(F f) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) f(ty + 16 * i, tx + 16 * j, acc[i][j]);
  }

  __device__ __forceinline__ void run(const float* __restrict__ x,
                                      const float* __restrict__ w, int m,
                                      int k, int n, int tm, int tn,
                                      char* smem) {
    float* xs = reinterpret_cast<float*>(smem);  // [BK][kLDX] (x transposed)
    float* ws = xs + BK * kLDX;                  // [BK][kLDW]
    const int row0 = tm * BM, col0 = tn * BN;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const bool vec_ok = (k % 4 == 0) && (n % 4 == 0) &&
                        aligned16(x) && aligned16(w);
    zero();
    for (int k0 = 0; k0 < k; k0 += BK) {
      for (int idx = threadIdx.x; idx < BM * (BK / 4); idx += kTileThreads) {
        const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
        const int gr = row0 + r, gc = k0 + c;
        alignas(16) float vals[4];
        if (vec_ok && gr < m && gc + 4 <= k) {
          *reinterpret_cast<float4*>(vals) =
              *reinterpret_cast<const float4*>(x + int64_t(gr) * k + gc);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            vals[q] = (gr < m && gc + q < k) ? x[int64_t(gr) * k + gc + q]
                                             : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) xs[(c + q) * kLDX + r] = vals[q];
      }
      for (int idx = threadIdx.x; idx < BK * (BN / 4); idx += kTileThreads) {
        const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
        const int gr = k0 + r, gc = col0 + c;
        float* dst = ws + r * kLDW + c;
        if (vec_ok && gr < k && gc + 4 <= n) {
          const float4 v =
              *reinterpret_cast<const float4*>(w + int64_t(gr) * n + gc);
          dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dst[q] = (gr < k && gc + q < n) ? w[int64_t(gr) * n + gc + q]
                                            : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[kRM], b[kRN];
#pragma unroll
        for (int i = 0; i < kRM; ++i) a[i] = xs[kk * kLDX + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kRN; ++j) b[j] = ws[kk * kLDW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int j = 0; j < kRN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

// Calls f.template run<BM, BN, BK>() for the instantiated block sizes
// (kernels/autotune.py CAND_M x CAND_N x CAND_K; gemm_tc.cuh's
// dispatch_tc instantiates TC_BLOCKS) and returns its result;
// cudaErrorInvalidValue for any other combination.
template <typename F>
__host__ int dispatch_blocks(int bm, int bn, int bk, F& f) {
#define REPRO_TILE_CASE(M, N, K) \
  if (bm == M && bn == N && bk == K) return f.template run<M, N, K>();
  REPRO_TILE_CASE(64, 64, 32)
  REPRO_TILE_CASE(64, 64, 64)
  REPRO_TILE_CASE(64, 128, 32)
  REPRO_TILE_CASE(64, 128, 64)
  REPRO_TILE_CASE(128, 64, 32)
  REPRO_TILE_CASE(128, 64, 64)
  REPRO_TILE_CASE(128, 128, 32)
  REPRO_TILE_CASE(128, 128, 64)
#undef REPRO_TILE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace repro
