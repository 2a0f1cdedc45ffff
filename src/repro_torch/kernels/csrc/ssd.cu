// Mamba2 chunked SSD (state-space duality) for Hopper, forward and
// backward: y [b, s, h, p] from x [b, s, h, p] (x's dtype), dt [b, s, h]
// f32 (the post-softplus step), A_log [h] f32, B, C [b, s, n] (x's
// dtype, one group shared by every head) and D [h] f32; f32 math, y in
// x's dtype; p <= 64, n <= 128, chunk q <= 128.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py `_kernel` (reached
// through `ssd`), whose grid is (batch, head, chunk) with the chunk axis
// sequential and the inter-chunk state S [p, n] carried in VMEM scratch.
// Carried over, that grid gives b * h blocks (24 at mamba2-130m's b 1) for
// 132 SMs, so the chunk-parallel form of models/ssd.py `ssd_chunked`
// runs instead.  With la_i the inclusive cumulative sum of a dt over the
// chunk (a = -exp(A_log)), L its last row and S_prev the state before
// the chunk, the forward is four launches:
//
//   1. ssd_cb_kernel, block (32-row tile, chunk, batch): C B^T of the
//      chunk, once for all heads (B and C are shared), causal, into f32
//      scratch cb [b, nc, 128, 128];
//   2. ssd_state_kernel, block (chunk, head, batch): the chunk's own state
//      S_c = sum_j (exp(la_L - la_j) dt_j x_j)^T B_j [p, n] and its decay
//      exp(la_L), into f32 scratch;
//   3. ssd_scan_kernel, a thread per (batch, head, state element): the
//      scan over the nc chunk states in place, leaving in slot c the state
//      before chunk c;
//   4. ssd_out_kernel, block (chunk, head, batch):
//      y = diag(exp(la)) C S_prev^T + W x + D x, with
//      W_ij = cb_ij exp(la_i - la_j) dt_j over the causal pairs only.
//
// The backward (the TPU kernel has none; JAX lets XLA differentiate
// `ssd_chunked`; kernels/ref.py `ssd_bwd_ref` is its plain version and
// states the algorithm) recomputes what it needs of the forward rather
// than keep it: launches 1-3 again (the 25 MB of f32 states at the slice
// shape would be kept per layer between the passes, against ~0.03 ms to
// recompute them), then
//
//   5. ssd_state_kernel in its backward form: G_loc = sum_i
//      (exp(la_i) dy_i)^T C_i [p, n] per chunk and head;
//   6. ssd_scan_kernel in reverse: slot c receives G_{c+1}, the gradient
//      of the state after chunk c (G_c = G_loc + exp(la_L) G_{c+1});
//   7. ssd_bwd_chunk_kernel, block (chunk, head, batch): dP = dy x^T (dt_j
//      on column j) over the causal pairs; d(dt x) = M^T dy + diag(exp(
//      la_L - la)) B G^T; dx and the x part of d(dt); d la from the rows
//      and columns of dP * M, from exp(la_i) C_i . (dy S_prev)_i, from
//      u_j = (dt x)_j . d(dt x)_j of the state and, on the last row, from
//      the chunk's decay; its reverse cumulative sum gives d(dt) and
//      dA_log's part.  The head's parts of dC and dB (dP * seg, exp(la)
//      dy S_prev, exp(la_L - la_j) dt_j x G) go to f32 scratch;
//   8. ssd_bwd_reduce_kernel, block (32-row tile, chunk, batch): the
//      heads' sum of dP * seg, then dC = dCB B + sum_h, dB = dCB^T C +
//      sum_h;
//   9. ssd_bwd_head_kernel: dA_log and dD, each head's parts in order.
//
// Every sum (over heads, chunks, tokens, a row's lanes) runs in a fixed
// order with no atomics, so two runs give the same bits.
//
// Bound on the H100, at mamba2-130m's slice (b 1, s 4096, h 24, p 64,
// n 128, q 128): the forward moves 27.7 MB (kernels/bounds.py
// `ssd_work`), 0.0083 ms; its least arithmetic is 4.1 GFLOP, 0.0612 ms on
// the f32 CUDA cores or 0.0041 ms on the bf16 tensor cores.  The
// backward (`ssd_bwd_work`) moves 42.7 MB (0.0128 ms) and does 9.9 GFLOP
// (0.1475 ms in f32, 0.0100 ms on the tensor cores).
// Design: every product is ssd_tile.cuh's chunk tile (mma.sync with the
// f32 operand split into two bf16 halves in bf16, CUDA-core FMAs in f32),
// C B^T is formed once per chunk rather than per head, and the masked
// products visit only the causal half.  A block holds one chunk's tiles
// (100-212 KB of shared memory, one block an SM), so it fills them with
// 16-byte loads issued 8 deep before any is stored, and the scans load 8
// chunks' states ahead of their stores: with one load in flight a thread
// the forward took 0.42 ms in bf16, with the loads batched 0.18 (my chip
// calls 4 and 6, PR 21).  The f32 scratch (chunk states written, scanned
// and read: ~100 MB at the slice; the backward's head parts ~150 MB) is
// what the tensor cores leave to the memory.
#include <cstdint>

#include "common.cuh"
#include "ssd_tile.cuh"

namespace {

using namespace repro::ssd;
using repro::to_float;

constexpr int kRowTile = 32;  // rows of C B^T (and of dC, dB) a block

// la[0..kQ): the inclusive cumulative sum of a * dt over the chunk's q
// rows (rows >= q add 0); dts[0..kQ) the step (0 past q).  Ends with a
// barrier.
__device__ __forceinline__ void load_la(float* la, float* dts,
                                        const float* __restrict__ dt,
                                        int64_t row0, int h, int hh, float a,
                                        int q) {
  for (int i = threadIdx.x; i < kQ; i += kThreads) {
    const float v = i < q ? dt[(row0 + i) * h + hh] : 0.f;
    dts[i] = v;
    la[i] = v * a;
  }
  chunk_cumsum(la);
}

// M [kQ][kLdQ] in shared memory: M_ij = cb_ij exp(la_i - la_j) (times
// dt_j with DT) for j <= i < q, else 0; cb is the chunk's [kQ][kQ] f32
// C B^T, read 4 values a load, 8 loads in flight a thread.
template <bool DT>
__device__ __forceinline__ void build_m(float* m, const float* __restrict__ cb,
                                        const float* la, const float* dts,
                                        int q) {
  constexpr int kPer = kQ * kQ / 4 / kThreads;  // 16 float4 a thread
#pragma unroll 1
  for (int b0 = 0; b0 < kPer; b0 += 8) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = __ldg(reinterpret_cast<const float4*>(cb) +
                   (b0 + u) * kThreads + threadIdx.x);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = ((b0 + u) * kThreads + threadIdx.x) * 4;
      const int i = idx / kQ, j0 = idx % kQ;
      const float w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        o[k] = (j <= i && i < q)
                   ? w[k] * expf(la[i] - la[j]) * (DT ? dts[j] : 1.f)
                   : 0.f;
      }
      *reinterpret_cast<float4*>(m + i * kLdQ + j0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// ---------------------------------------------------------------- 1
// Shared: cs [32][kLdQ] (rows of C), bs [kQ][kLdQ] (B, read transposed).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_cb_kernel(const T* __restrict__ B, const T* __restrict__ C,
                  float* __restrict__ cb, int s, int n, int q) {
  extern __shared__ __align__(16) float sm[];
  const int rt = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.y;
  float* cs = sm;
  float* bs = cs + kRowTile * kLdQ;
  const int64_t row0 = int64_t(bb) * s + int64_t(c) * q;
  const int r0 = rt * kRowTile;
  load_tile<kRowTile, kN>(cs, kLdQ, C + (row0 + r0) * n, n, q - r0, n,
                          One());
  load_tile<kQ, kN>(bs, kLdQ, B + row0 * n, n, q, n, One());
  __syncthreads();
  float d[1][4][4];
  zero(d);
  block_mm<T, 2, 4, 1, 4, kLower, false, false>(
      d, Rows<kLdQ>{cs}, Cols<kLdQ>{bs}, kN, r0);
  const Geo<2, 4, 1, 4> geo;
  float* out = cb + (int64_t(bb) * nc + c) * kQ * kQ;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + geo.row(0, e), j = geo.col(nt, e);
      out[i * kQ + j] = (j <= i && i < q) ? d[0][nt][e] : 0.f;
    }
}

// ---------------------------------------------------------------- 2, 5
// Forward (BWD false): v = x, weight exp(la_L - la_j) dt_j, m = B, out the
// chunk states (and their decays).  Backward: v = dy, weight exp(la_i),
// m = C, out G_loc.  Shared: la, dts [kQ], vs [kQ][kLdP] (the weighted
// rows of v), ms [kQ][kLdQ].
template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_state_kernel(const T* __restrict__ v, const float* __restrict__ dt,
                     const float* __restrict__ A_log,
                     const T* __restrict__ m, float* __restrict__ out,
                     float* __restrict__ decay, int s, int h, int p, int n,
                     int q) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x;
  float* la = sm;
  float* dts = la + kQ;
  float* vs = dts + kQ;
  float* ms = vs + kQ * kLdP;
  const int64_t row0 = int64_t(bb) * s + int64_t(c) * q;
  const float a = -expf(A_log[hh]);
  load_la(la, dts, dt, row0, h, hh, a, q);
  const float last = la[q - 1];
  load_tile<kQ, kP>(vs, kLdP, v + (row0 * h + hh) * p, int64_t(h) * p, q, p,
                    [&](int j) {
                      return BWD ? expf(la[j]) : expf(last - la[j]) * dts[j];
                    });
  load_tile<kQ, kN>(ms, kLdQ, m + row0 * n, n, q, n, One());
  __syncthreads();
  float d[2][4][4];
  zero(d);
  block_mm<T, 2, 4, 2, 4, kFull, true, false>(
      d, Cols<kLdP>{vs}, Rows<kLdQ>{ms}, kQ, 0);
  const Geo<2, 4, 2, 4> geo;
  float* o = out + ((int64_t(bb) * h + hh) * nc + c) * int64_t(p) * n;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = geo.row(mt, e), col = geo.col(nt, e);
        if (r < p && col < n) o[int64_t(r) * n + col] = d[mt][nt][e];
      }
  if (!BWD && threadIdx.x == 0)
    decay[(int64_t(bb) * h + hh) * nc + c] = expf(last);
}

// ---------------------------------------------------------------- 3, 6
// states [b*h][nc][p*n]: forward, S_c in and the state before chunk c
// out, and (if `final`) the state after the last chunk into final
// [b*h][p*n] (the prefill's decode state); REV, G_loc in and G_{c+1} out
// (the scan from the last chunk).
template <bool REV>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(float* __restrict__ states,
                    const float* __restrict__ decay, int nc, int pn,
                    float* __restrict__ final) {
  const int64_t bh = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  float* st = states + bh * nc * int64_t(pn) + e;
  const float* dc = decay + bh * nc;
  float carry = 0.f;
  // 8 chunks' states loaded before any is rewritten: the loads do not
  // wait on the stores
  for (int k0 = 0; k0 < nc; k0 += 8) {
    float sv[8], dv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = REV ? nc - 1 - (k0 + u) : k0 + u;
      const bool in = k0 + u < nc;
      sv[u] = in ? st[int64_t(c) * pn] : 0.f;
      dv[u] = in ? dc[c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (k0 + u >= nc) break;
      const int c = REV ? nc - 1 - (k0 + u) : k0 + u;
      st[int64_t(c) * pn] = carry;
      carry = carry * dv[u] + sv[u];
    }
  }
  if (final != nullptr) final[bh * pn + e] = carry;
}

// ---------------------------------------------------------------- 4
// Shared: la, dts [kQ], xs [kQ][kLdP], cw [kQ][kLdQ] (C, then W),
// ss [kP][kLdQ] (S_prev).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A_log, const T* __restrict__ C,
                   const float* __restrict__ D,
                   const float* __restrict__ cb,
                   const float* __restrict__ states, T* __restrict__ y,
                   int s, int h, int p, int n, int q) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x;
  float* la = sm;
  float* dts = la + kQ;
  float* xs = dts + kQ;
  float* cw = xs + kQ * kLdP;
  float* ss = cw + kQ * kLdQ;
  const int64_t row0 = int64_t(bb) * s + int64_t(c) * q;
  const float a = -expf(A_log[hh]);
  load_la(la, dts, dt, row0, h, hh, a, q);
  load_tile<kQ, kP>(xs, kLdP, x + (row0 * h + hh) * p, int64_t(h) * p, q, p,
                    One());
  load_tile<kQ, kN>(cw, kLdQ, C + row0 * n, n, q, n, One());
  load_tile<kP, kN>(ss, kLdQ,
                    states + ((int64_t(bb) * h + hh) * nc + c) * int64_t(p) *
                                 n,
                    n, p, n, One());
  __syncthreads();
  const Geo<4, 2, 2, 4> geo;
  float d[2][4][4];
  zero(d);
  // inter-chunk: C S_prev^T, each row times exp(la_i)
  block_mm<T, 4, 2, 2, 4, kFull, false, true>(
      d, Rows<kLdQ>{cw}, Cols<kLdQ>{ss}, kN, 0);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float el = expf(la[geo.row(mt, e)]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) d[mt][nt][e] *= el;
    }
  __syncthreads();  // C read by every warp; cw becomes W
  build_m<true>(cw, cb + (int64_t(bb) * nc + c) * kQ * kQ, la, dts, q);
  __syncthreads();
  // intra-chunk: W x over the causal pairs
  block_mm<T, 4, 2, 2, 4, kKLeRow, true, false>(
      d, Rows<kLdQ>{cw}, Rows<kLdP>{xs}, kQ, 0);
  const float dh = D[hh];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = geo.row(mt, e), pp = geo.col(nt, e);
        if (i < q && pp < p)
          y[((row0 + i) * h + hh) * p + pp] = repro::from_float<T>(
              d[mt][nt][e] + dh * xs[i * kLdP + pp]);
      }
}

// ---------------------------------------------------------------- 7
// Shared: la, dts [kQ]; xs, dys [kQ][kLdP]; r1 [kQ][kLdQ] (B, then M);
// r2 [kP][kLdQ] (S_prev); r3 [kP][kLdQ] (G_{c+1}); rows [4][4][kQ] (four
// kinds of row sums: dP * M, u, x . d(dt x), C . (exp(la) dy S), each in
// four parts: two 64-column halves by the two warps of a row); cols
// [4][kQ] (column sums of dP * M, by warp row); dla [kQ]; red [8].  The
// [q, 128] products run as two halves of 64 columns, so that no thread
// holds more than 32 accumulators.
constexpr int kRowSlots = 4;
constexpr int kRowParts = 4 * kRowSlots * kQ;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk_kernel(const T* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A_log,
                         const T* __restrict__ B, const T* __restrict__ C,
                         const float* __restrict__ D,
                         const T* __restrict__ dy,
                         const float* __restrict__ cb,
                         const float* __restrict__ states,
                         const float* __restrict__ gstates,
                         T* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ dcb_part,
                         float* __restrict__ dc_part,
                         float* __restrict__ db_part,
                         float* __restrict__ head_part, int s, int h, int p,
                         int n, int q) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  float* la = sm;
  float* dts = la + kQ;
  float* xs = dts + kQ;
  float* dys = xs + kQ * kLdP;
  float* r1 = dys + kQ * kLdP;
  float* r2 = r1 + kQ * kLdQ;
  float* r3 = r2 + kP * kLdQ;
  float* rows = r3 + kP * kLdQ;
  float* cols = rows + kRowParts;
  float* dla = cols + 4 * kQ;
  float* red = dla + kQ;
  // the parts of row-sum kind k from the half `half` of the columns
  auto slot = [&](int k, int half) {
    return rows + (k * kRowSlots + 2 * half) * kQ;
  };
  auto row_sum = [&](int k, int i) {
    const float* r = rows + k * kRowSlots * kQ + i;
    return ((r[0] + r[kQ]) + r[2 * kQ]) + r[3 * kQ];
  };
  const int64_t row0 = int64_t(bb) * s + int64_t(c) * q;
  const int64_t bc = int64_t(bb) * nc + c;
  const int64_t sbase = ((int64_t(bb) * h + hh) * nc + c) * int64_t(p) * n;
  const float a = -expf(A_log[hh]);
  load_la(la, dts, dt, row0, h, hh, a, q);
  const float last = la[q - 1];
  for (int i = tid; i < kRowParts; i += kThreads) rows[i] = 0.f;
  load_tile<kQ, kP>(xs, kLdP, x + (row0 * h + hh) * p, int64_t(h) * p, q, p,
                    One());
  load_tile<kQ, kP>(dys, kLdP, dy + (row0 * h + hh) * p, int64_t(h) * p, q,
                    p, One());
  load_tile<kQ, kN>(r1, kLdQ, B + row0 * n, n, q, n, One());
  load_tile<kP, kN>(r2, kLdQ, states + sbase, n, p, n, One());
  load_tile<kP, kN>(r3, kLdQ, gstates + sbase, n, p, n, One());
  __syncthreads();
  const float* cbc = cb + bc * kQ * kQ;
  const Geo<4, 2, 2, 4> geo;
  constexpr int kHalf = kQ / 2;  // columns a pass of a [q, 128] product

  // dP = dt_j (dy_i . x_j) over the causal pairs -> dP * seg (the head's
  // part of dCB) and the rows and columns of dP * M
  for (int half = 0; half < 2; ++half) {
    const int c0 = half * kHalf;
    float d[2][4][4];
    zero(d);
    block_mm<T, 4, 2, 2, 4, kLower, false, false>(
        d, Rows<kLdP>{dys}, Cols<kLdP>{xs + c0 * kLdP}, kP, 0, c0);
    float* part = dcb_part + (bc * h + hh) * int64_t(q) * q;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = geo.row(mt, e), j = c0 + geo.col(nt, e);
          float dseg = 0.f, em = 0.f;
          if (j <= i && i < q) {
            dseg = dts[j] * d[mt][nt][e] * expf(la[i] - la[j]);
            em = dseg * cbc[i * kQ + j];
          }
          if (i < q && j < q) part[i * q + j] = dseg;
          d[mt][nt][e] = em;
        }
    row_parts(geo, slot(0, half),
              [&](int mt, int nt, int e) { return d[mt][nt][e]; });
    col_parts(geo, cols + c0,
              [&](int mt, int nt, int e) { return d[mt][nt][e]; });
  }

  // d(dt x) = diag(exp(la_L - la_j)) B G^T + M^T dy -> dx, u, x . d(dt x)
  {
    float d[2][4][4];
    zero(d);
    block_mm<T, 4, 2, 2, 4, kFull, false, true>(
        d, Rows<kLdQ>{r1}, Cols<kLdQ>{r3}, kN, 0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float w = expf(last - la[geo.row(mt, e)]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) d[mt][nt][e] *= w;
      }
    row_parts(geo, slot(1, 0), [&](int mt, int nt, int e) {
      const int j = geo.row(mt, e), pp = geo.col(nt, e);
      return d[mt][nt][e] * dts[j] * xs[j * kLdP + pp];
    });
    __syncthreads();  // B read by every warp; r1 becomes M
    build_m<false>(r1, cbc, la, dts, q);
    __syncthreads();
    block_mm<T, 4, 2, 2, 4, kKGeRow, true, false>(
        d, Cols<kLdQ>{r1}, Rows<kLdP>{dys}, kQ, 0);
    const float dh = D[hh];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = geo.row(mt, e), pp = geo.col(nt, e);
          if (j < q && pp < p)
            dx[((row0 + j) * h + hh) * p + pp] = repro::from_float<T>(
                dts[j] * d[mt][nt][e] + dh * dys[j * kLdP + pp]);
        }
    row_parts(geo, slot(2, 0), [&](int mt, int nt, int e) {
      return d[mt][nt][e] * xs[geo.row(mt, e) * kLdP + geo.col(nt, e)];
    });
  }

  // v = dy S_prev -> the head's part of dC, exp(la_i) C_i . v_i
  for (int half = 0; half < 2; ++half) {
    const int c0 = half * kHalf;
    float d[2][4][4];
    zero(d);
    block_mm<T, 4, 2, 2, 4, kFull, false, true>(
        d, Rows<kLdP>{dys}, Rows<kLdQ>{r2 + c0}, kP, 0);
    float* part = dc_part + (bc * h + hh) * int64_t(q) * n;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = geo.row(mt, e);
        const float el = expf(la[i]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = c0 + geo.col(nt, e);
          d[mt][nt][e] *= el;
          if (i < q && col < n) {
            part[int64_t(i) * n + col] = d[mt][nt][e];
            d[mt][nt][e] *= to_float(C[(row0 + i) * n + col]);
          } else {
            d[mt][nt][e] = 0.f;
          }
        }
      }
    row_parts(geo, slot(3, half),
              [&](int mt, int nt, int e) { return d[mt][nt][e]; });
  }

  // x G_{c+1} -> the head's part of dB
  for (int half = 0; half < 2; ++half) {
    const int c0 = half * kHalf;
    float d[2][4][4];
    zero(d);
    block_mm<T, 4, 2, 2, 4, kFull, false, true>(
        d, Rows<kLdP>{xs}, Rows<kLdQ>{r3 + c0}, kP, 0);
    float* part = db_part + (bc * h + hh) * int64_t(q) * n;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = geo.row(mt, e);
        const float w = expf(last - la[j]) * dts[j];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = c0 + geo.col(nt, e);
          if (j < q && col < n) part[int64_t(j) * n + col] = w * d[mt][nt][e];
        }
      }
  }

  // <S_prev, G_{c+1}> and dD's part, each in a fixed order
  float fr = 0.f, xd = 0.f;
  for (int idx = tid; idx < kP * kN; idx += kThreads) {
    const int r = idx / kN, col = idx % kN;
    fr += r2[r * kLdQ + col] * r3[r * kLdQ + col];
  }
  for (int idx = tid; idx < kQ * kP; idx += kThreads) {
    const int r = idx / kP, col = idx % kP;
    xd += dys[r * kLdP + col] * xs[r * kLdP + col];
  }
  fr = block_sum(fr, red);
  xd = block_sum(xd, red);
  // d la_i: rows minus columns of dP * M, minus u_i, plus C . (exp(la) v)
  float ui = 0.f;
  if (tid < kQ) {
    ui = row_sum(1, tid);
    const float dl =
        row_sum(0, tid) -
        (((cols[tid] + cols[kQ + tid]) + cols[2 * kQ + tid]) +
         cols[3 * kQ + tid]) -
        ui + row_sum(3, tid);
    dla[tid] = tid < q ? dl : 0.f;
  }
  const float u_sum = block_sum(tid < q ? ui : 0.f, red);
  if (tid == 0) dla[q - 1] += u_sum + expf(last) * fr;
  __syncthreads();
  // d(a dt)_k = sum_{i >= k} dla_i: the prefix sum of the chunk reversed
  if (tid < kQ) cols[tid] = tid < q ? dla[q - 1 - tid] : 0.f;
  chunk_cumsum(cols);
  float da = 0.f;
  if (tid < q) {
    const float ddta = cols[q - 1 - tid];
    ddt[(row0 + tid) * h + hh] = row_sum(2, tid) + a * ddta;
    da = dts[tid] * ddta;
  }
  da = block_sum(da, red);
  if (tid == 0) {
    head_part[(bc * h + hh) * 2] = da;
    head_part[(bc * h + hh) * 2 + 1] = xd;
  }
}

// ---------------------------------------------------------------- 8
// Shared: sr [32][kLdQ] (the heads' dP * seg, rows r0..), sc [kQ][36]
// (the same, columns r0..), bs, cs [kQ][kLdQ].
constexpr int kLdT = kRowTile + 4;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_reduce_kernel(const T* __restrict__ B, const T* __restrict__ C,
                          const float* __restrict__ dcb_part,
                          const float* __restrict__ dc_part,
                          const float* __restrict__ db_part,
                          T* __restrict__ dB, T* __restrict__ dC, int s,
                          int h, int n, int q) {
  extern __shared__ __align__(16) float sm[];
  const int rt = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.y;
  float* sr = sm;
  float* sc = sr + kRowTile * kLdQ;
  float* bs = sc + kQ * kLdT;
  float* cs = bs + kQ * kLdQ;
  const int64_t row0 = int64_t(bb) * s + int64_t(c) * q;
  const int64_t bc = int64_t(bb) * nc + c;
  const int r0 = rt * kRowTile;
  const float* dcb = dcb_part + bc * h * int64_t(q) * q;
  for (int idx = threadIdx.x; idx < kRowTile * kQ; idx += kThreads) {
    const int ii = idx / kQ, j = idx % kQ, i = r0 + ii;
    float v = 0.f;
    if (i < q && j < q)
      for (int hh = 0; hh < h; ++hh) v += dcb[(hh * int64_t(q) + i) * q + j];
    sr[ii * kLdQ + j] = v;
  }
  for (int idx = threadIdx.x; idx < kQ * kRowTile; idx += kThreads) {
    const int i = idx / kRowTile, jj = idx % kRowTile, j = r0 + jj;
    float v = 0.f;
    if (i < q && j < q)
      for (int hh = 0; hh < h; ++hh) v += dcb[(hh * int64_t(q) + i) * q + j];
    sc[i * kLdT + jj] = v;
  }
  load_tile<kQ, kN>(bs, kLdQ, B + row0 * n, n, q, n, One());
  load_tile<kQ, kN>(cs, kLdQ, C + row0 * n, n, q, n, One());
  __syncthreads();
  const Geo<2, 4, 1, 4> geo;
  const int64_t hs = int64_t(q) * n;  // one head's part
  for (int which = 0; which < 2; ++which) {
    float d[1][4][4];
    zero(d);
    if (which == 0)   // dC rows i: sum_{j <= i} dCB_ij B_j
      block_mm<T, 2, 4, 1, 4, kKLeRow, true, false>(
          d, Rows<kLdQ>{sr}, Rows<kLdQ>{bs}, kQ, r0);
    else              // dB rows j: sum_{i >= j} dCB_ij C_i
      block_mm<T, 2, 4, 1, 4, kKGeRow, true, false>(
          d, Cols<kLdT>{sc}, Rows<kLdQ>{cs}, kQ, r0);
    const float* part = (which == 0 ? dc_part : db_part) + bc * h * hs;
    T* out = which == 0 ? dC : dB;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + geo.row(0, e), col = geo.col(nt, e);
        if (i >= q || col >= n) continue;
        float v = d[0][nt][e];
        for (int hh = 0; hh < h; ++hh)
          v += part[hh * hs + int64_t(i) * n + col];
        out[(row0 + i) * n + col] = repro::from_float<T>(v);
      }
  }
}

// ---------------------------------------------------------------- 9
// head_part [b * nc][h][2]: (d(sum a dt)/da, dD) parts, summed in order
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_head_kernel(const float* __restrict__ head_part,
                        const float* __restrict__ A_log,
                        float* __restrict__ dA_log, float* __restrict__ dD,
                        int bnc, int h) {
  const int hh = blockIdx.x * kThreads + threadIdx.x;
  if (hh >= h) return;
  float da = 0.f, dd = 0.f;
  for (int k = 0; k < bnc; ++k) {
    da += head_part[(int64_t(k) * h + hh) * 2];
    dd += head_part[(int64_t(k) * h + hh) * 2 + 1];
  }
  dA_log[hh] = -expf(A_log[hh]) * da;
  dD[hh] = dd;
}

// ---------------------------------------------------------------- host
constexpr size_t kCbSmem = sizeof(float) * (kRowTile + kQ) * kLdQ;
constexpr size_t kStateSmem = sizeof(float) * (2 * kQ + kQ * kLdP + kQ * kLdQ);
constexpr size_t kOutSmem =
    sizeof(float) * (2 * kQ + kQ * kLdP + kQ * kLdQ + kP * kLdQ);
constexpr size_t kChunkSmem =
    sizeof(float) * (2 * kQ + 2 * kQ * kLdP + kQ * kLdQ + 2 * kP * kLdQ +
                     kRowParts + 4 * kQ + kQ + 8);
constexpr size_t kReduceSmem =
    sizeof(float) * (kRowTile * kLdQ + kQ * kLdT + 2 * kQ * kLdQ);
static_assert(kChunkSmem <= 232448, "ssd_bwd_chunk_kernel's shared memory");

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

#define REPRO_TRY(expr)                  \
  do {                                   \
    const int rc_ = (expr);              \
    if (rc_ != 0) return rc_;            \
  } while (0)

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// launches 1-3: cb, the chunk states (scanned: the state before each
// chunk), their decays and, if `final` is not null, the final state
template <typename T>
int states_and_cb(const T* x, const float* dt, const float* A_log,
                  const T* B, const T* C, float* cb, float* states,
                  float* decay, float* final, int b, int s, int h, int p,
                  int n, int q, cudaStream_t st) {
  const int nc = s / q;
  REPRO_TRY(allow_smem(ssd_cb_kernel<T>, kCbSmem));
  REPRO_TRY(allow_smem(ssd_state_kernel<T, false>, kStateSmem));
  ssd_cb_kernel<T><<<dim3((q + kRowTile - 1) / kRowTile, nc, b), kThreads,
                     kCbSmem, st>>>(B, C, cb, s, n, q);
  REPRO_TRY(last_error());
  ssd_state_kernel<T, false><<<dim3(nc, h, b), kThreads, kStateSmem, st>>>(
      x, dt, A_log, B, states, decay, s, h, p, n, q);
  REPRO_TRY(last_error());
  const int pn = p * n;
  ssd_scan_kernel<false><<<dim3((pn + kThreads - 1) / kThreads, b * h),
                           kThreads, 0, st>>>(states, decay, nc, pn, final);
  return last_error();
}

template <typename T>
int forward(const void* x, const float* dt, const float* A_log,
            const void* B, const void* C, const float* D, void* y, float* cb,
            float* states, float* decay, float* final, int b, int s, int h,
            int p, int n, int q, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  REPRO_TRY(states_and_cb<T>(xt, dt, A_log, Bt, Ct, cb, states, decay, final,
                             b, s, h, p, n, q, st));
  REPRO_TRY(allow_smem(ssd_out_kernel<T>, kOutSmem));
  ssd_out_kernel<T><<<dim3(s / q, h, b), kThreads, kOutSmem, st>>>(
      xt, dt, A_log, Ct, D, cb, states, static_cast<T*>(y), s, h, p, n, q);
  return last_error();
}

struct BwdArgs {
  const void *x, *dt, *A_log, *B, *C, *D, *dy;
  void *dx, *ddt, *dA_log, *dB, *dC, *dD;
  void *cb, *states, *decay, *gstates, *dcb_part, *dc_part, *db_part,
      *head_part;
};

template <typename T>
int backward(const BwdArgs& g, int b, int s, int h, int p, int n, int q,
             cudaStream_t st) {
  const int nc = s / q;
  const T* x = static_cast<const T*>(g.x);
  const T* B = static_cast<const T*>(g.B);
  const T* C = static_cast<const T*>(g.C);
  const T* dy = static_cast<const T*>(g.dy);
  const auto* dt = static_cast<const float*>(g.dt);
  const auto* A_log = static_cast<const float*>(g.A_log);
  auto* cb = static_cast<float*>(g.cb);
  auto* states = static_cast<float*>(g.states);
  auto* decay = static_cast<float*>(g.decay);
  auto* gstates = static_cast<float*>(g.gstates);
  auto* dcb_part = static_cast<float*>(g.dcb_part);
  auto* dc_part = static_cast<float*>(g.dc_part);
  auto* db_part = static_cast<float*>(g.db_part);
  auto* head_part = static_cast<float*>(g.head_part);
  REPRO_TRY(states_and_cb<T>(x, dt, A_log, B, C, cb, states, decay, nullptr,
                             b, s, h, p, n, q, st));
  REPRO_TRY(allow_smem(ssd_state_kernel<T, true>, kStateSmem));
  ssd_state_kernel<T, true><<<dim3(nc, h, b), kThreads, kStateSmem, st>>>(
      dy, dt, A_log, C, gstates, nullptr, s, h, p, n, q);
  REPRO_TRY(last_error());
  const int pn = p * n;
  ssd_scan_kernel<true><<<dim3((pn + kThreads - 1) / kThreads, b * h),
                          kThreads, 0, st>>>(gstates, decay, nc, pn,
                                             nullptr);
  REPRO_TRY(last_error());
  REPRO_TRY(allow_smem(ssd_bwd_chunk_kernel<T>, kChunkSmem));
  ssd_bwd_chunk_kernel<T><<<dim3(nc, h, b), kThreads, kChunkSmem, st>>>(
      x, dt, A_log, B, C, static_cast<const float*>(g.D), dy, cb, states,
      gstates, static_cast<T*>(g.dx), static_cast<float*>(g.ddt), dcb_part,
      dc_part, db_part, head_part, s, h, p, n, q);
  REPRO_TRY(last_error());
  REPRO_TRY(allow_smem(ssd_bwd_reduce_kernel<T>, kReduceSmem));
  ssd_bwd_reduce_kernel<T><<<dim3((q + kRowTile - 1) / kRowTile, nc, b),
                             kThreads, kReduceSmem, st>>>(
      B, C, dcb_part, dc_part, db_part, static_cast<T*>(g.dB),
      static_cast<T*>(g.dC), s, h, n, q);
  REPRO_TRY(last_error());
  ssd_bwd_head_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      head_part, A_log, static_cast<float*>(g.dA_log),
      static_cast<float*>(g.dD), b * nc, h);
  return last_error();
}

bool bad_shape(int b, int s, int h, int p, int n, int q) {
  return b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || q <= 0 ||
         q > kQ || p > kP || n > kN || s % q || h > 65535 || b > 65535 ||
         s / q > 65535 || int64_t(b) * h > 65535;
}

}  // namespace

// x [b, s, h, p], B, C [b, s, n] (dtype code `dtype`), dt [b, s, h],
// A_log, D [h] f32 -> y [b, s, h, p] (x's dtype) and, if `final` is not
// null, the f32 state after the last step into final [b, h, p, n].
// Scratch, f32: cb [b, s / q, 128, 128], states [b, h, s / q, p, n],
// decay [b, h, s / q].  All contiguous; chunk q in [1, 128] dividing s,
// p in [1, 64], n in [1, 128].  Returns a cudaError_t code (0 on
// success).
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A_log,
                             const void* B, const void* C, const void* D,
                             void* y, void* cb, void* states, void* decay,
                             void* final, int b, int s, int h, int p, int n,
                             int q, int dtype, void* stream) {
  if (bad_shape(b, s, h, p, n, q)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A_log);
  const auto* df = static_cast<const float*>(D);
  auto* cbf = static_cast<float*>(cb);
  auto* sf = static_cast<float*>(states);
  auto* cf = static_cast<float*>(decay);
  auto* ff = static_cast<float*>(final);
  if (dtype == repro::kF32)
    return forward<float>(x, dtf, af, B, C, df, y, cbf, sf, cf, ff, b, s, h,
                          p, n, q, st);
  if (dtype == repro::kBF16)
    return forward<__nv_bfloat16>(x, dtf, af, B, C, df, y, cbf, sf, cf, ff, b,
                                  s, h, p, n, q, st);
  return cudaErrorInvalidValue;
}

// Backward of repro_ssd_fwd for the cotangent dy (x's shape and dtype):
// dx (x's dtype), ddt [b, s, h] f32, dA_log [h] f32, dB, dC [b, s, n]
// (B's dtype, summed over the heads), dD [h] f32.  Scratch, f32: cb,
// states, decay as the forward's; gstates like states; dcb_part
// [b, s / q, h, q, q]; dc_part, db_part [b, s / q, h, q, n]; head_part
// [b, s / q, h, 2].  Same limits as the forward.  Returns a cudaError_t
// code (0 on success).
extern "C" int repro_ssd_bwd(const void* x, const void* dt, const void* A_log,
                             const void* B, const void* C, const void* D,
                             const void* dy, void* dx, void* ddt,
                             void* dA_log, void* dB, void* dC, void* dD,
                             void* cb, void* states, void* decay,
                             void* gstates, void* dcb_part, void* dc_part,
                             void* db_part, void* head_part, int b, int s,
                             int h, int p, int n, int q, int dtype,
                             void* stream) {
  if (bad_shape(b, s, h, p, n, q)) return cudaErrorInvalidValue;
  const BwdArgs g{x,  dt,     A_log,   B,        C,       D,       dy,
                  dx, ddt,    dA_log,  dB,       dC,      dD,      cb,
                  states, decay, gstates, dcb_part, dc_part, db_part,
                  head_part};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return backward<float>(g, b, s, h, p, n, q, st);
  if (dtype == repro::kBF16)
    return backward<__nv_bfloat16>(g, b, s, h, p, n, q, st);
  return cudaErrorInvalidValue;
}
