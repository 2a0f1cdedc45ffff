// Flash attention forward and backward for Hopper (training path).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py `_kernel`
// (reached through `flash_attention`).  On the TPU the grid is
// (batch, q head, q block, kv block) with the kv-block axis sequential
// ("arbitrary"): the online-softmax state m/l/acc lives in VMEM scratch
// from one grid step to the next, and `pl.when` skips kv blocks that the
// causal/window mask hides entirely.  Hopper blocks run in no order, so
// here one block owns one (batch, q head, 64-row q tile) and walks the key
// tiles itself, keeping m/l/acc in registers; key tiles the mask hides
// entirely are never loaded (causal: the loop stops after the diagonal
// tile).  The JAX wrapper pads q/k/v to the block size; this kernel masks
// the ragged edges itself (query rows >= sq, keys >= sk).  Queries sit at
// positions arange(sq) and keys at arange(sk), as the TPU kernel's q_pos
// and k_pos: sk != sq is cross attention (whisper's 448 against 1,500,
// llama-3.2-vision's 2,048 against 6,404), causal 0 attends every key
// (cross attention, whisper's encoder); the grids cover sq (forward, dQ)
// and sk (dK/dV), and the tensor maps of K and V span sk rows.
//
// The TPU kernel has no backward: JAX lets XLA differentiate
// `chunked_attention`.  The port needs one, so the backward here is the
// FlashAttention-2 algorithm: a pre-pass computes delta = rowsum(dO * O);
// a dK/dV kernel runs one block per (batch, kv head, 64-key tile) and
// loops over the g query heads of that kv head and the q tiles that see
// the key tile, recomputing P = exp(s - lse) and dS = P * (dP - delta)
// (times 1 - tanh^2 under a softcap), and writes dK/dV once; a dQ kernel
// runs one block per (batch, q head, q tile) and loops over key tiles.
// No atomics: every output element is summed by one thread in a fixed
// order, so the result is deterministic.
//
// Both passes run two tiles, as the forward does.  bf16 inputs take the
// tensor-core tiles: the forward's of flash_fwd_tc.cuh (wgmma fed by TMA:
// a producer warp keeps K and V in a two-stage ring, one consumer
// warpgroup folds each 64-key tile into the block's 64 q rows; P enters
// the P V product as two bf16 halves, 1.5x the tensor-core flops, so that
// out stays within one bf16 ulp of the f32 reference; 20-160 KB of shared
// memory from hd 32 to 256) and the backward's of flash_bwd_tc.cuh (its
// dK/dV block: two consumer warpgroups, one for S^T -> P^T -> dV and one
// for dP^T -> dS^T -> dK, P^T passed between them in shared memory; its
// dQ block on the forward's layout; P and dS as two bf16 halves each;
// 2.5-4x the counted tensor-core flops; 40-208 KB of shared memory).  The
// tiles' roundings are pinned on the CPU by tests/test_torch_flash_tiles.py
// and tests/test_torch_flash_bwd_tiles.py, the kernels checked on the card
// by chip_smoke.py phases 5, 14, 17 and 24.  f32 inputs keep the CUDA-core
// tiles (flash_fwd.cuh and the two backward kernels below): a tensor-core
// product of f32 inputs is TF32, ~1e-3 off, where the f32 gates (card vs
// CPU, 1e-5) need full f32 sums.
//
// Bound on the H100: causal, the forward does about s/2 flops per element
// it moves (256 a byte in bf16 at s 1024), just below the tensor cores'
// ~295 flop-per-byte balance, so the card's bound is the bytes, by a
// little; at hd 256 with 16 q heads to one kv head it is the operations;
// the backward is alike.  The bf16 tiles' own limits are the exponentials
// (one a visible pair in each pass), the serial product, softmax, product
// order within a warpgroup, and the split's extra products.  The f32
// CUDA-core kernels run 256 threads as 16 x 16, each owning a 4 x 4 block
// of the 64 x 64 score tile and 4 rows x hd/16 columns of its output
// tile, f32 tiles in shared memory (q pre-scaled, as the TPU kernel scales
// q in f32), rows padded by one word against bank conflicts (f32 FMAs, one
// shared-memory load per two).  At head dim 256 four 64-row f32 tiles no
// longer fit a block's 227 KB, so both f32 backward kernels take 32-row
// key tiles there (KT): the dK/dV kernel holds 32 keys and the 64 queries
// of a q tile (215,296 B), the dQ kernel 64 queries and 32 keys
// (207,104 B); the f32 forward's three 64-row tiles take 214,784 B.  A
// launch whose shared memory the card refuses returns the error to the
// caller.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "flash_fwd.cuh"
#include "flash_bwd_tc.cuh"
#include "flash_fwd_tc.cuh"

namespace {

using namespace repro::flash;

struct Params {
  int b, sq, sk, h, kvh, g;
  int causal, window;  // window 0: none
  float scale, softcap;

  // queries at positions arange(sq), keys at arange(sk) (the TPU
  // kernel's q_pos and k_pos): sk != sq for cross attention
  __device__ __forceinline__ Mask mask() const {
    return Mask{0, sq, 0, sk, causal, window, softcap};
  }
};

__device__ __forceinline__ bool visible(int qi, int kj, const Params& p) {
  return repro::flash::visible(qi, kj, p.mask());
}

__device__ __forceinline__ bool tile_runs(int q0, int k0, const Params& p,
                                          int kt = kTile) {
  return repro::flash::tile_runs(q0, k0, p.mask(), kt);
}

// key rows of the backward's tiles at head dim HD: four f32 tiles of 64
// rows exceed the shared memory above hd 128
template <int HD>
constexpr int key_tile() { return HD > 128 ? 32 : kTile; }

// rows [r0, r0 + 64) of a [b, h, s] f32 row statistic (s = sq) -> smem;
// 0 past s
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int bi, int hi, int h, int r0, int s) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = r0 + r;
    dst[r] = row < s ? src[(static_cast<int64_t>(bi) * h + hi) * s + row] : 0.f;
  }
}

template <int HD, int KT>
constexpr size_t dkdv_smem() {
  return (2 * KT * (HD + 1) + 2 * kTile * (HD + 1) + 2 * KT * kPLD + 2 * kTile) *
         sizeof(float);
}

template <int HD, int KT>
constexpr size_t dq_smem() {
  return (2 * kTile * (HD + 1) + 2 * KT * (HD + 1) + kTile * (KT + 4) + 2 * kTile) *
         sizeof(float);
}

// f32: the CUDA-core tile of flash_fwd.cuh
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Params p) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                // [64][LD]  q * scale
  float* ks = qs + kTile * LD;     // [64][LD]
  float* vs = ks + kTile * LD;     // [64][LD]
  float* ps = vs + kTile * LD;     // [64][kPLD]  P of the current key tile

  const int q0 = blockIdx.x * kTile;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;

  load_tile<float, HD>(qs, q, bi, q0, hi, p.h, p.sq, p.scale);
  Carry<HD> c;
  c.init();
  fold_keys<HD>(qs, ks, vs, ps, k, v, bi, hi / p.g, p.kvh, q0, p.mask(), c);
  store_rows<HD>(c, out, lse, bi, hi, p.h, p.sq, q0);
}

// the maps of q, k and v for the tensor-core forward
struct FwdMaps {
  CUtensorMap q, k, v;
};

// bf16: one block per (batch, q head, 64-row q tile), the longest
// (latest) q tiles first
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ FwdMaps maps,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, Params p) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int hi = blockIdx.y;
  tc_block<HD>(&maps.q, OwnShard{&maps.k, &maps.v, p.mask()}, blockIdx.z, hi,
               hi / p.g, q0, p.scale, out, lse, p.h, p.sq);
}

// delta[b, h, s] = rowsum(dout * out) in f32; one warp per (b, s, h) row
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                           float* __restrict__ delta, int64_t rows, int s, int h) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const int64_t base = row * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32)
    acc += repro::to_float(dout[base + d]) * repro::to_float(out[base + d]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const int hi = static_cast<int>(row % h);
    const int64_t bs = row / h;
    const int si = static_cast<int>(bs % s);
    const int64_t bi = bs / s;
    delta[(bi * h + hi) * s + si] = acc;
  }
}

// bf16 backward: one dK/dV block per (batch, kv head and column part,
// 64-key tile), the first (longest under the causal mask) key tiles first
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, HD <= 64 ? 2 : 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ BwdMaps maps,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, Params p) {
  constexpr int parts = bwd_kv_parts<HD>();
  bwd_kv_block<HD>(maps, p.mask(), p.g, p.h, p.kvh, blockIdx.z,
                   blockIdx.y / parts, blockIdx.x * kTile, blockIdx.y % parts,
                   p.scale, lse, delta, dk, dv);
}

// bf16 backward: one dQ block per (batch, q head, 64-row q tile), the
// longest (latest) q tiles first
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ BwdMaps maps,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, Params p) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int hi = blockIdx.y;
  bwd_q_block<HD>(maps, p.mask(), blockIdx.z, hi, hi / p.g, q0, p.scale, lse,
                  delta, dq, p.h);
}

// probability and its score gradient for one (query, key) cell
__device__ __forceinline__ void p_ds(float raw, float dp, float lse_q,
                                     float delta_q, bool ok, const Params& p,
                                     float& pv, float& ds) {
  float x = raw, t = 0.f;
  if (p.softcap != 0.f) {
    t = tanhf(raw / p.softcap);
    x = p.softcap * t;
  }
  pv = ok ? expf(x - lse_q) : 0.f;
  ds = pv * (dp - delta_q);
  if (p.softcap != 0.f) ds *= 1.f - t * t;
}

// f32 backward: the CUDA-core dK/dV and dQ kernels
template <int HD, int KT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, Params p) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;
  constexpr int RK = KT / 16;        // key rows per thread
  extern __shared__ float smem[];
  float* ks = smem;                  // [KT][LD]  this block's keys
  float* vs = ks + KT * LD;          // [KT][LD]
  float* qs = vs + KT * LD;          // [64][LD]  q * scale of the q tile
  float* dos = qs + kTile * LD;      // [64][LD]
  float* ps = dos + kTile * LD;      // [KT keys][kPLD]  P^T
  float* dss = ps + KT * kPLD;       // [KT keys][kPLD]  dS^T
  float* lse_s = dss + KT * kPLD;    // [64]
  float* delta_s = lse_s + kTile;    // [64]

  const int k0 = blockIdx.x * KT;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x & 15;   // q columns tx + 16 * j
  const int ty = threadIdx.x >> 4;   // key rows ty * RK + i

  load_tile<float, HD, KT>(ks, k, bi, k0, kh, p.kvh, p.sk, 1.f);
  load_tile<float, HD, KT>(vs, v, bi, k0, kh, p.kvh, p.sk, 1.f);

  float adk[RK][NC], adv[RK][NC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int nq = (p.sq + kTile - 1) / kTile;
  for (int gi = 0; gi < p.g; ++gi) {
    const int hi = kh * p.g + gi;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_runs(q0, k0, p, KT)) continue;
      __syncthreads();  // the previous q tile is consumed (first: ks/vs ready)
      load_tile<float, HD>(qs, q, bi, q0, hi, p.h, p.sq, p.scale);
      load_tile<float, HD>(dos, dout, bi, q0, hi, p.h, p.sq, 1.f);
      load_rows(lse_s, lse, bi, hi, p.h, q0, p.sq);
      load_rows(delta_s, delta, bi, hi, p.h, q0, p.sq);
      __syncthreads();

      float st[RK][4], dpt[RK][4];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kr[RK], vr[RK], qc[4], dc[4];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kr[i] = ks[(ty * RK + i) * LD + d];
          vr[i] = vs[(ty * RK + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qc[j] = qs[(tx + 16 * j) * LD + d];
          dc[j] = dos[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kr[i], qc[j], st[i][j]);
            dpt[i][j] = fmaf(vr[i], dc[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          float pv, ds;
          p_ds(st[i][j], dpt[i][j], lse_s[qr], delta_s[qr],
               visible(q0 + qr, k0 + ty * RK + i, p), p, pv, ds);
          ps[(ty * RK + i) * kPLD + qr] = pv;
          dss[(ty * RK + i) * kPLD + qr] = ds;
        }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float pr[RK], dr[RK], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = ps[(ty * RK + i) * kPLD + qq];
          dr[i] = dss[(ty * RK + i) * kPLD + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dos[qq * LD + tx + 16 * c];
          qv[c] = qs[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            adv[i][c] = fmaf(pr[i], dov[c], adv[i][c]);
            adk[i][c] = fmaf(dr[i], qv[c], adk[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kj = k0 + ty * RK + i;
    if (kj >= p.sk) continue;
    const int64_t o = ((static_cast<int64_t>(bi) * p.sk + kj) * p.kvh + kh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[o + tx + 16 * c] = adk[i][c];
      dv[o + tx + 16 * c] = adv[i][c];
    }
  }
}

template <int HD, int KT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, Params p) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;
  constexpr int KC = KT / 16;        // key columns per thread
  constexpr int SLD = KT + 4;        // row stride of dS
  extern __shared__ float smem[];
  float* qs = smem;                  // [64][LD]  q * scale
  float* dos = qs + kTile * LD;      // [64][LD]
  float* ks = dos + kTile * LD;      // [KT][LD]
  float* vs = ks + KT * LD;          // [KT][LD]
  float* dss = vs + KT * LD;         // [64 queries][SLD]
  float* lse_s = dss + kTile * SLD;  // [64]
  float* delta_s = lse_s + kTile;    // [64]

  const int q0 = blockIdx.x * kTile;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = hi / p.g;
  const int tx = threadIdx.x & 15;   // key columns tx + 16 * j
  const int ty = threadIdx.x >> 4;   // query rows ty * 4 + i

  load_tile<float, HD>(qs, q, bi, q0, hi, p.h, p.sq, p.scale);
  load_tile<float, HD>(dos, dout, bi, q0, hi, p.h, p.sq, 1.f);
  load_rows(lse_s, lse, bi, hi, p.h, q0, p.sq);
  load_rows(delta_s, delta, bi, hi, p.h, q0, p.sq);

  float adq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adq[i][c] = 0.f;

  const int nk = (p.sk + KT - 1) / KT;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * KT;
    if (p.causal && k0 > q0 + kTile - 1) break;
    if (!tile_runs(q0, k0, p, KT)) continue;
    __syncthreads();  // the previous key tile is consumed (first: q side ready)
    load_tile<float, HD, KT>(ks, k, bi, k0, kh, p.kvh, p.sk, 1.f);
    load_tile<float, HD, KT>(vs, v, bi, k0, kh, p.kvh, p.sk, 1.f);
    __syncthreads();

    float sc[4][KC], dp[4][KC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], da[4], kb[KC], vb[KC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty * 4 + i) * LD + d];
        da[i] = dos[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        kb[j] = ks[(tx + 16 * j) * LD + d];
        vb[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float pv, ds;
        p_ds(sc[i][j], dp[i][j], lse_s[qr], delta_s[qr],
             visible(q0 + qr, k0 + tx + 16 * j, p), p, pv, ds);
        dss[qr * SLD + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float dr[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(ty * 4 + i) * SLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) adq[i][c] = fmaf(dr[i], kv[c], adq[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.sq) continue;
    const int64_t o = ((static_cast<int64_t>(bi) * p.sq + qi) * p.h + hi) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[o + tx + 16 * c] = adq[i][c] * p.scale;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD>
int fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse,
           const Params& p, cudaStream_t st) {
  FwdMaps maps;
  int e = encode_rows(&maps.q, q, p.b, p.sq, p.h, HD);
  if (e == 0) e = encode_rows(&maps.k, k, p.b, p.sk, p.kvh, HD);
  if (e == 0) e = encode_rows(&maps.v, v, p.b, p.sk, p.kvh, HD);
  if (e != 0) return e;
  const size_t smem = TcGeo<HD>::kSmem;
  cudaError_t ce = allow_smem(flash_fwd_tc_kernel<HD>, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
  flash_fwd_tc_kernel<HD><<<grid, kTcThreads, smem, st>>>(
      maps, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        const Params& p, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return fwd_tc<HD>(q, k, v, out, lse, p, st);
  } else {
    const size_t smem = fwd_smem<HD>();
    cudaError_t e = allow_smem(flash_fwd_kernel<HD>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
    flash_fwd_kernel<HD><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int HD>
int bwd_delta(const void* out, const void* dout, void* delta, const Params& p,
              cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(p.b) * p.sq * p.h;
  const int64_t warps_per_block = kThreads / 32;
  const dim3 dgrid(static_cast<unsigned>((rows + warps_per_block - 1) /
                                         warps_per_block));
  flash_bwd_delta_kernel<T, HD><<<dgrid, kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, p.sq, p.h);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd_tc(const void* q, const void* k, const void* v, const void* out,
           const void* lse, const void* dout, void* delta, void* dq, void* dk,
           void* dv, const Params& p, cudaStream_t st) {
  BwdMaps maps;
  int e = encode_rows(&maps.q, q, p.b, p.sq, p.h, HD);
  if (e == 0) e = encode_rows(&maps.k, k, p.b, p.sk, p.kvh, HD);
  if (e == 0) e = encode_rows(&maps.v, v, p.b, p.sk, p.kvh, HD);
  if (e == 0) e = encode_rows(&maps.dout, dout, p.b, p.sq, p.h, HD);
  if (e == 0) e = bwd_delta<__nv_bfloat16, HD>(out, dout, delta, p, st);
  if (e != 0) return e;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const unsigned q_tiles = (p.sq + kTile - 1) / kTile;
  const unsigned k_tiles = (p.sk + kTile - 1) / kTile;

  const size_t kv_smem = bwd_kv_smem<HD>();
  cudaError_t ce = allow_smem(flash_bwd_dkdv_tc_kernel<HD>, kv_smem);
  // all of the SM's 228 KB as shared memory: two blocks an SM at hd <= 64
  if (ce == cudaSuccess)
    ce = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<HD>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  flash_bwd_dkdv_tc_kernel<HD><<<dim3(k_tiles, p.kvh * bwd_kv_parts<HD>(), p.b),
                                 kBwdThreads, kv_smem, st>>>(
      maps, lse_f, delta_f, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), p);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return static_cast<int>(ce);

  const size_t q_smem = bwd_q_smem<HD>();
  ce = allow_smem(flash_bwd_dq_tc_kernel<HD>, q_smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  flash_bwd_dq_tc_kernel<HD><<<dim3(q_tiles, p.h, p.b), kTcThreads, q_smem,
                               st>>>(maps, lse_f, delta_f,
                                     static_cast<__nv_bfloat16*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

// f32: the CUDA-core kernels
template <int HD>
int bwd_f32(const void* q, const void* k, const void* v, const void* out,
            const void* lse, const void* dout, void* delta, void* dq,
            void* dk, void* dv, const Params& p, cudaStream_t st) {
  cudaError_t e =
      static_cast<cudaError_t>(bwd_delta<float, HD>(out, dout, delta, p, st));
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr int KT = key_tile<HD>();
  const size_t smem = dkdv_smem<HD, KT>();
  e = allow_smem(flash_bwd_dkdv_kernel<HD, KT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 kgrid((p.sk + KT - 1) / KT, p.kvh, p.b);
  flash_bwd_dkdv_kernel<HD, KT><<<kgrid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t qsmem = dq_smem<HD, KT>();
  e = allow_smem(flash_bwd_dq_kernel<HD, KT>, qsmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 qgrid((p.sq + kTile - 1) / kTile, p.h, p.b);
  flash_bwd_dq_kernel<HD, KT><<<qgrid, kThreads, qsmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

bool make_params(int b, int sq, int sk, int h, int kvh, int causal,
                 int window, float scale, float softcap, Params* p) {
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || kvh <= 0 || h % kvh ||
      h > 65535 || b > 65535 || window < 0)
    return false;
  *p = Params{b, sq, sk, h, kvh, h / kvh, causal, window, scale, softcap};
  return true;
}

}  // namespace

// q, out: [b, sq, h, hd]; k, v: [b, sk, kvh, hd], all of dtype code
// `dtype` and contiguous; lse: [b, h, sq] f32.  Queries sit at positions
// arange(sq), keys at arange(sk); causal 0 attends every key, window 0
// means no window.  Returns a cudaError_t code (0 on success).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int b, int sq, int sk,
                               int h, int kvh, int hd, int causal,
                               int window, float scale, float softcap,
                               int dtype, void* stream) {
  Params p;
  if (!make_params(b, sq, sk, h, kvh, causal, window, scale, softcap, &p))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    switch (hd) {
      case 32: return fwd<float, 32>(q, k, v, out, lse, p, st);
      case 64: return fwd<float, 64>(q, k, v, out, lse, p, st);
      case 128: return fwd<float, 128>(q, k, v, out, lse, p, st);
      case 256: return fwd<float, 256>(q, k, v, out, lse, p, st);
    }
  } else if (dtype == repro::kBF16) {
    switch (hd) {
      case 32: return fwd<__nv_bfloat16, 32>(q, k, v, out, lse, p, st);
      case 64: return fwd<__nv_bfloat16, 64>(q, k, v, out, lse, p, st);
      case 128: return fwd<__nv_bfloat16, 128>(q, k, v, out, lse, p, st);
      case 256: return fwd<__nv_bfloat16, 256>(q, k, v, out, lse, p, st);
    }
  }
  return cudaErrorInvalidValue;
}

// Backward of repro_flash_fwd: dq [b, sq, h, hd]; dk, dv [b, sk, kvh, hd]
// in the inputs' dtype; delta: [b, h, sq] f32 scratch.  Three launches
// (delta, dK/dV, dQ) on `stream`.  Returns a cudaError_t code (0 on
// success).
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* out, const void* lse,
                               const void* dout, void* delta, void* dq,
                               void* dk, void* dv, int b, int sq, int sk,
                               int h, int kvh, int hd, int causal,
                               int window, float scale, float softcap,
                               int dtype, void* stream) {
  Params p;
  if (!make_params(b, sq, sk, h, kvh, causal, window, scale, softcap, &p))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    switch (hd) {
      case 32: return bwd_f32<32>(q, k, v, out, lse, dout, delta, dq, dk, dv, p, st);
      case 64: return bwd_f32<64>(q, k, v, out, lse, dout, delta, dq, dk, dv, p, st);
      case 128: return bwd_f32<128>(q, k, v, out, lse, dout, delta, dq, dk, dv, p, st);
      case 256: return bwd_f32<256>(q, k, v, out, lse, dout, delta, dq, dk, dv, p, st);
    }
  } else if (dtype == repro::kBF16) {
    switch (hd) {
      case 32: return bwd_tc<32>(q, k, v, out, lse, dout, delta, dq, dk, dv, p, st);
      case 64: return bwd_tc<64>(q, k, v, out, lse, dout, delta, dq, dk, dv, p, st);
      case 128: return bwd_tc<128>(q, k, v, out, lse, dout, delta, dq, dk, dv, p, st);
      case 256: return bwd_tc<256>(q, k, v, out, lse, dout, delta, dq, dk, dv, p, st);
    }
  }
  return cudaErrorInvalidValue;
}
