// The chunk tile of the Mamba2 SSD kernels (ssd.cu), shared by the
// forward and the backward: a block of 8 warps multiplies two f32 tiles
// held in shared memory, C[M x N] += A[M x K] B[K x N], into f32
// accumulators in registers.  Every product of the chunked SSD is one of
// these, at q = n = 128 (padded) and p = 64 (padded): C B^T, the masked
// product with x, C S^T, the chunk state x^T B, and in the backward
// dy x^T, M^T dy, B G^T, dy S, x G and the heads' dCB with B and C.
//
// bf16 (T = __nv_bfloat16): warp-level tensor-core products,
// mma.sync.m16n8k16 with f32 accumulation.  x, dy, B and C arrive in
// bf16, so an operand that is one of them is exact in bf16; an operand
// that carries f32 factors (decays, dt, chunk states, their gradients)
// is split as it is read into a bf16 high part and a bf16 low part,
// hi = bf16(v), lo = bf16(v - hi), and the product is taken twice
// (hi and lo against the exact side), as the flash forward splits P
// (flash_fwd_tc.cuh).  What the split leaves is below 2^-17 of each
// value.  Fragments are built in registers from the f32 tiles, so the
// split costs no shared memory; that is why these products run on
// mma.sync rather than on wgmma, which reads B (and here also A's
// halves) from swizzled bf16 tiles in shared memory.
//
// f32 (T = float): FMAs on the CUDA cores, so no TF32 enters (TF32 keeps
// ~3 decimal digits; the f32 gates need 1e-5).  Each thread owns the same
// outputs as in the bf16 layout: a register tile of 2 x 2 rows by NT x 2
// columns, one k at a time.
//
// Accumulator layout (both types): element e of fragment (mt, nt) holds
// row 16 tile_row(wm, mt) + lane / 4 + 8 (e >> 1) and column
// 8 (wn NT + nt) + 2 (lane % 4) + (e & 1), with warp w = wm WN + wn.
// With two fragment rows a warp takes the 16-row tiles wm and 2 WM - 1 -
// wm, so a causal product (k <= row, or k >= row) gives every warp the
// same number of k steps.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace ssd {

constexpr int kThreads = 256;   // 8 warps
constexpr int kQ = 128;         // chunk rows, padded
constexpr int kN = 128;         // state columns, padded
constexpr int kP = 64;          // head dim, padded
constexpr int kLdQ = kQ + 4;    // f32 row stride of a [.][128] tile
constexpr int kLdP = kP + 4;    // f32 row stride of a [.][64] tile

// which (row, k) pairs, or output tiles, a product needs
enum Tri : int {
  kFull = 0,    // all
  kKLeRow = 1,  // k <= row (the masked product: rows i, k = j <= i)
  kKGeRow = 2,  // k >= row (its transpose: rows j, k = i >= j)
  kLower = 3,   // outputs with column <= row (C B^T, dy x^T)
};

// element (r, c) of an f32 tile at p[r * RS + c * CS]: (RS, CS) = (ld, 1)
// row-major, (1, ld) the transpose of a row-major tile.  The strides are
// constants, so the unrolled loads of a product address off one register.
template <int RS, int CS>
struct View {
  const float* p;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[r * RS + c * CS];
  }
};
template <int LD>
using Rows = View<LD, 1>;  // a row-major tile
template <int LD>
using Cols = View<1, LD>;  // the transpose of a row-major tile

template <int WM, int MT>
__device__ __forceinline__ int tile_row(int wm, int mt) {
  static_assert(MT == 1 || MT == 2, "one or two fragment rows a warp");
  return MT == 1 ? wm : (mt == 0 ? wm : 2 * WM - 1 - wm);
}

// the thread's place in a WM x WN grid of warps, each MT x NT fragments
template <int WM, int WN, int MT, int NT>
struct Geo {
  static_assert(WM * WN == kThreads / 32, "8 warps");
  int wm, wn, g, t;
  __device__ __forceinline__ Geo() {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    wm = w / WN;
    wn = w % WN;
    g = l >> 2;
    t = l & 3;
  }
  __device__ __forceinline__ int row0(int mt) const {
    return tile_row<WM, MT>(wm, mt) * 16;
  }
  __device__ __forceinline__ int col0(int nt) const {
    return (wn * NT + nt) * 8;
  }
  // row and column of accumulator element e of fragment (mt, nt)
  __device__ __forceinline__ int row(int mt, int e) const {
    return row0(mt) + g + ((e >> 1) << 3);
  }
  __device__ __forceinline__ int col(int nt, int e) const {
    return col0(nt) + 2 * t + (e & 1);
  }
};

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&d)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16 of (a, b); lo = bf16 of what hi leaves
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B over k in [0, K) (K a multiple of 16), rows of A offset by
// r_off and columns of B by c_off within the chunk for TRI's tests.
// SA / SB: that operand carries f32 factors and is split (bf16 only;
// ignored in f32).
template <typename T, int WM, int WN, int MT, int NT, int TRI, bool SA,
          bool SB, typename VA, typename VB>
__device__ __forceinline__ void block_mm(float (&d)[MT][NT][4], VA A, VB B,
                                         int K, int r_off, int c_off = 0) {
  static_assert(!(SA && SB), "at most one operand carries f32 factors");
  const Geo<WM, WN, MT, NT> geo;
  int klo[MT], khi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = r_off + geo.row0(mt);
    klo[mt] = TRI == kKGeRow ? r : 0;
    khi[mt] = TRI == kKLeRow ? (r + 16 < K ? r + 16 : K) : K;
  }
  auto live = [&](int mt, int nt) {
    return TRI != kLower ||
           c_off + geo.col0(nt) <= r_off + geo.row0(mt) + 15;
  };
  for (int k0 = 0; k0 < K; k0 += 16) {
    bool act[MT];
    bool any = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      act[mt] = k0 >= klo[mt] && k0 < khi[mt];
      any |= act[mt];
    }
    if (!any) continue;
    if constexpr (sizeof(T) == 2) {
      // A's fragments of the active rows, then B's one column tile at a
      // time (so a split B costs 4 registers, not 4 NT)
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (!act[mt]) continue;
        const int r = geo.row0(mt) + geo.g;
        const int k = k0 + 2 * geo.t;
        const float a[8] = {A(r, k),     A(r, k + 1),     A(r + 8, k),
                            A(r + 8, k + 1), A(r, k + 8), A(r, k + 9),
                            A(r + 8, k + 8), A(r + 8, k + 9)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (SA)
            split_bf16(a[2 * i], a[2 * i + 1], ah[mt][i], al[mt][i]);
          else
            ah[mt][i] = pack_bf16(a[2 * i], a[2 * i + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bool need = false;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) need |= act[mt] && live(mt, nt);
        if (!need) continue;
        const int c = geo.col0(nt) + geo.g;
        const int k = k0 + 2 * geo.t;
        const float b0 = B(k, c), b1 = B(k + 1, c);
        const float b2 = B(k + 8, c), b3 = B(k + 9, c);
        uint32_t bh[2], bl[2];
        if constexpr (SB) {
          split_bf16(b0, b1, bh[0], bl[0]);
          split_bf16(b2, b3, bh[1], bl[1]);
        } else {
          bh[0] = pack_bf16(b0, b1);
          bh[1] = pack_bf16(b2, b3);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!act[mt] || !live(mt, nt)) continue;
          mma16816(d[mt][nt], ah[mt], bh);
          if constexpr (SA) mma16816(d[mt][nt], al[mt], bh);
          if constexpr (SB) mma16816(d[mt][nt], ah[mt], bl);
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < 16; ++kk) {
        const int k = k0 + kk;
        float bv[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = geo.col0(nt) + 2 * geo.t;
          bv[nt][0] = B(k, c);
          bv[nt][1] = B(k, c + 1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!act[mt]) continue;
          const int r = geo.row0(mt) + geo.g;
          const float a0 = A(r, k), a1 = A(r + 8, k);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (!live(mt, nt)) continue;
            d[mt][nt][0] = fmaf(a0, bv[nt][0], d[mt][nt][0]);
            d[mt][nt][1] = fmaf(a0, bv[nt][1], d[mt][nt][1]);
            d[mt][nt][2] = fmaf(a1, bv[nt][0], d[mt][nt][2]);
            d[mt][nt][3] = fmaf(a1, bv[nt][1], d[mt][nt][3]);
          }
        }
      }
    }
  }
}

// Row sums of an accumulator's (masked) values: v(mt, nt, e) summed over
// a row's columns within the thread, then over the 4 lanes of a row, then
// (by the caller, after a barrier) over the WN warps of a row in order:
// red[wn][row] receives this warp's part.
template <int WM, int WN, int MT, int NT, typename F>
__device__ __forceinline__ void row_parts(const Geo<WM, WN, MT, NT>& geo,
                                          float* red, F v) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s += v(mt, nt, 2 * hf) + v(mt, nt, 2 * hf + 1);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (geo.t == 0) red[geo.wn * kQ + geo.row(mt, 2 * hf)] = s;
    }
}

// Column sums likewise: over a column's rows within the thread, the 8
// lanes of a column, then (by the caller) the WM warps: red[wm][col].
template <int WM, int WN, int MT, int NT, typename F>
__device__ __forceinline__ void col_parts(const Geo<WM, WN, MT, NT>& geo,
                                          float* red, F v) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) s += v(mt, nt, e) + v(mt, nt, e + 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (geo.g == 0) red[geo.wm * kQ + geo.col(nt, e)] = s;
    }
}

// The inclusive prefix sum of v[0..kQ) in place, by warp 0 (4 values a
// lane, then a shuffle scan of the lane totals); the block's threads
// meet at barriers before and after.
__device__ __forceinline__ void chunk_cumsum(float* v) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float w[4];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run += v[lane * 4 + k];
      w[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[lane * 4 + k] = excl + w[k];
  }
  __syncthreads();
}

// A [ROWS][COLS] tile of a row-major matrix (row stride ld elements) into
// f32 shared memory with row stride lds (a multiple of 4, 16-byte aligned
// rows); rows >= nrows and columns >= ncols read as zeros.  `scale(r)`
// multiplies row r.  Where the tile spans whole rows of a 16-byte-aligned
// matrix, each thread issues its 16-byte loads in batches of 8 before it
// stores any, so a block keeps 2,048 loads in flight; otherwise value by
// value, 8 at a time.
template <int ROWS, int COLS, typename T, typename F>
__device__ __forceinline__ void load_tile(float* dst, int lds,
                                          const T* __restrict__ src,
                                          int64_t ld, int nrows, int ncols,
                                          F scale) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kRowVecs = COLS / kVec;
  constexpr int kPer = ROWS * kRowVecs / kThreads;  // vectors a thread
  constexpr int kBatch = kPer < 8 ? kPer : 8;
  static_assert(COLS % kVec == 0 && (ROWS * kRowVecs) % kThreads == 0 &&
                    kPer % kBatch == 0,
                "tile shape");
  const int tid = threadIdx.x;
  const bool vec = ncols == COLS && ld % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
#pragma unroll 1
    for (int b0 = 0; b0 < kPer; b0 += kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = (b0 + u) * kThreads + tid;
        const int r = v / kRowVecs, c = (v % kRowVecs) * kVec;
        raw[u] = r < nrows
                     ? __ldg(reinterpret_cast<const uint4*>(src + r * ld + c))
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = (b0 + u) * kThreads + tid;
        const int r = v / kRowVecs, c = (v % kRowVecs) * kVec;
        const T* e = reinterpret_cast<const T*>(&raw[u]);
        const float sc = r < nrows ? scale(r) : 0.f;
        float* out = dst + r * lds + c;
#pragma unroll
        for (int k = 0; k < kVec; k += 4)
          *reinterpret_cast<float4*>(out + k) =
              make_float4(to_float(e[k]) * sc, to_float(e[k + 1]) * sc,
                          to_float(e[k + 2]) * sc, to_float(e[k + 3]) * sc);
      }
    }
    return;
  }
#pragma unroll 1
  for (int i0 = 0; i0 < ROWS * COLS; i0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = i0 + u * kThreads + tid;
      const int r = idx / COLS, c = idx % COLS;
      v[u] = (idx < ROWS * COLS && r < nrows && c < ncols)
                 ? to_float(src[r * ld + c])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = i0 + u * kThreads + tid;
      const int r = idx / COLS, c = idx % COLS;
      if (idx < ROWS * COLS)
        dst[r * lds + c] = r < nrows ? v[u] * scale(r) : 0.f;
    }
  }
}

struct One {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// Sum of v over the block's threads in a fixed order (warp shuffles, then
// the 8 warp totals in order); every thread gets it.  `red` holds 8
// floats; the block meets at two barriers.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

}  // namespace ssd
}  // namespace repro
