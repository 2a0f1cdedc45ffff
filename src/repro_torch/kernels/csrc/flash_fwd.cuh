// The flash-attention forward's f32 tile loop, shared by the training
// kernel (flash_attention.cu) and the ring-attention kernel
// (ring_attention.cu), as both TPU kernels fold key blocks into the same
// online-softmax carry; and the masks both tiles share.  bf16 inputs take
// the tensor-core tile of flash_fwd_tc.cuh instead; f32 stays here on the
// CUDA cores, because a tensor-core product of f32 inputs is TF32 (~1e-3
// off), where the f32 gates (card vs CPU, 1e-5) need full f32 sums.
//
// One block owns one (batch, q head, 64-row q tile).  256 threads as
// 16 x 16, each owning a 4 x 4 block of the 64 x 64 score tile (rows
// ty*4+i, columns tx+16*j) and 4 rows x hd/16 columns of the output tile;
// row reductions are shuffles within a half-warp.  Tiles are staged in
// shared memory as f32 (q pre-scaled, as the TPU kernels scale q in f32),
// rows padded by one word against bank conflicts.  The products run on
// the CUDA cores (f32 FMAs).
//
// Positions are absolute: query row i of the block's tensor sits at
// q_off + i, key row j of the key tensor at k_off + j (flash attention:
// both offsets 0; the ring: the shards' offsets in the whole sequence).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace flash {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPLD = kTile + 4; // row stride of the score tiles in smem
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

// Which (query, key) pairs attend: sq query rows at positions q_off + i,
// sk key rows at k_off + j; causal; window 0 = none; softcap 0 = none.
struct Mask {
  int q_off, sq, k_off, sk;
  int causal, window;
  float softcap;
};

// key row kj visible from query row qi (indices into their tensors)
__device__ __forceinline__ bool visible(int qi, int kj, const Mask& m) {
  if (qi >= m.sq || kj >= m.sk) return false;
  const int qp = m.q_off + qi, kp = m.k_off + kj;
  if (m.causal && kp > qp) return false;
  if (m.window > 0 && kp <= qp - m.window) return false;
  return true;
}

// some key of tile [k0, k0 + kt) is visible from some query of
// [q0, q0 + 64) (the TPU kernels' `run` predicate)
__device__ __forceinline__ bool tile_runs(int q0, int k0, const Mask& m,
                                          int kt = kTile) {
  const int qp = m.q_off + q0, kp = m.k_off + k0;
  if (m.causal && kp > qp + kTile - 1) return false;
  if (m.window > 0 && kp + kt - 1 <= qp - m.window) return false;
  return true;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + ROWS) of head `hh` of a [b, s, nh, HD] tensor -> smem
// f32 [ROWS][HD + 1], times `mul`; rows >= s are zero
template <typename T, int HD, int ROWS = kTile>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int bi, int r0, int hh, int nh,
                                          int s, float mul) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = r0 + r;
    float v = 0.f;
    if (row < s)
      v = repro::to_float(
              src[((static_cast<int64_t>(bi) * s + row) * nh + hh) * HD + d]) *
          mul;
    dst[r * LD + d] = v;
  }
}

template <int HD>
constexpr size_t fwd_smem() {
  return (3 * kTile * (HD + 1) + kTile * kPLD) * sizeof(float);
}

// The online-softmax carry of one thread: rows ty*4+i of the q tile.
template <int HD>
struct Carry {
  static constexpr int NC = HD / 16;  // output columns per thread: tx + 16 c
  float m[4], l[4], acc[4][NC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }
  }
};

// Fold every key tile of one key tensor k, v [b, sk, kvh, HD] (kv head
// `kh` of batch `bi`) into the carry of the q tile at row q0, whose
// scaled rows are already in `qs`.  Tiles the mask hides entirely are
// never loaded (causal: the loop stops after the diagonal tile).  `ks`,
// `vs` [64][HD + 1] and `ps` [64][kPLD] are scratch in shared memory.
template <int HD>
__device__ __forceinline__ void fold_keys(const float* qs, float* ks, float* vs,
                                          float* ps,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v, int bi,
                                          int kh, int kvh, int q0,
                                          const Mask& mk, Carry<HD>& c) {
  constexpr int LD = HD + 1;
  constexpr int NC = Carry<HD>::NC;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nk = (mk.sk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (mk.causal && mk.k_off + k0 > mk.q_off + q0 + kTile - 1) break;
    if (!tile_runs(q0, k0, mk)) continue;
    __syncthreads();  // the previous tile's ks/vs/ps are consumed
    load_tile<float, HD>(ks, k, bi, k0, kh, kvh, mk.sk, 1.f);
    load_tile<float, HD>(vs, v, bi, k0, kh, kvh, mk.sk, 1.f);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool ok[4];
      float mx = c.m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j];
        if (mk.softcap != 0.f) x = mk.softcap * tanhf(x / mk.softcap);
        ok[j] = visible(qi, k0 + tx + 16 * j, mk);
        sc[i][j] = x;
        if (ok[j]) mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float corr = expf(c.m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = ok[j] ? expf(sc[i][j] - mx) : 0.f;
        ps[(ty * 4 + i) * kPLD + tx + 16 * j] = pv;
        rs += pv;
      }
      rs = half_warp_sum(rs);
      c.l[i] = c.l[i] * corr + rs;
      c.m[i] = mx;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) c.acc[i][cc] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pr[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty * 4 + i) * kPLD + kk];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) vv[cc] = vs[kk * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          c.acc[i][cc] = fmaf(pr[i], vv[cc], c.acc[i][cc]);
    }
  }
}

// out [b, s, h, HD] in T and lse [b, h, s] f32 (= m + log(l), l floored
// at 1e-30) of the q tile at row q0 of head hi.
template <int HD>
__device__ __forceinline__ void store_rows(const Carry<HD>& c,
                                           float* __restrict__ out,
                                           float* __restrict__ lse, int bi,
                                           int hi, int h, int s, int q0) {
  constexpr int NC = Carry<HD>::NC;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= s) continue;
    const float lf = fmaxf(c.l[i], 1e-30f);
    const int64_t o = ((static_cast<int64_t>(bi) * s + qi) * h + hi) * HD;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      out[o + tx + 16 * cc] = c.acc[i][cc] / lf;
    if (tx == 0)
      lse[(static_cast<int64_t>(bi) * h + hi) * s + qi] = c.m[i] + logf(lf);
  }
}

}  // namespace flash
}  // namespace repro
