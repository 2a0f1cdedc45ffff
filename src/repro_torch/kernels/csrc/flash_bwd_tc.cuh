// The bf16 flash-attention backward on Hopper's tensor cores (wgmma fed
// by TMA): the dK/dV block and the dQ block of flash_attention.cu's bf16
// backward, after its delta pre-pass (delta = rowsum(dO * O), f32).  The
// TPU kernel it stands beside, src/repro/kernels/flash_attention.py
// `_kernel`, has no backward: JAX lets XLA differentiate
// `chunked_attention`, whose gradient this computes.  f32
// inputs keep flash_attention.cu's CUDA-core kernels: a tensor-core
// product of f32 inputs would be TF32, ~1e-3 off where the f32 gates
// (card vs CPU, 1e-5) need full f32 sums.
//
// Both blocks recompute S = scale Q K^T (capped, masked) and
// P = exp(S - lse) from the forward's lse, and dP = dO V^T; then
// dS = P (dP - delta), times 1 - tanh^2 under a softcap.  Every product
// takes bf16 tiles that TMA brings into shared memory, swizzled as wgmma's
// descriptors read them (tc_ptx.cuh), and sums in f32 registers; the scale
// multiplies the f32 sums, never the bf16 inputs.
//
// dK/dV block, one per (batch, kv head, 64-key tile, box of 64 columns of
// dK and dV: hd 128 and 256 take two and four blocks a key tile, see
// bwd_kv_parts): two consumer warpgroups and one producer warp (288
// threads).  The producer loads K and V once, then streams Q and dO of
// every (q head of the kv head's group, 64-row q tile that sees the keys)
// through a two-stage ring, and its warp copies the q tile's lse and
// delta beside them.  Per q tile:
//
//   warpgroup 0   S^T = K Q^T      -> P^T, handed to warpgroup 1 through
//                                     an f32 tile in shared memory (times
//                                     1 - tanh^2 if capped)
//                 dV += P^T dO     (P^T from registers, dO MN-major)
//   warpgroup 1   dP^T = V dO^T    -> dS^T = P^T (dP^T - delta)
//                 dK += dS^T Q     (dS^T from registers, Q MN-major)
//
// Computing S^T rather than S puts P^T and dS^T in the accumulator layout
// that wgmma's register A operand takes (split_frags), as the forward
// feeds P; each warpgroup holds the f32 sum of its tensor's box of 64
// columns (32 a thread; in shared memory at hd 64, bwd_sums_in_smem), the
// tensor-core accumulator of one q tile's product that is added to it,
// and one 64 x 64 product.  dK is scaled once at the end.  Shared memory:
// K, V, 2 stages of Q and dO, 16 KB of P^T (and 32 KB of sums at hd 64):
// 40 KB at hd 32, 96 at 64 (two blocks an SM at both), 112 at 128, 208 at
// 256 (+ 1 KB of alignment slack).
//
// dQ block, one per (batch, q head, 64-row q tile): the forward's layout
// (one consumer warpgroup, one producer thread, tc_produce with dO loaded
// beside Q, K and V through the ring).  Per key tile S = Q K^T and
// dP = dO V^T, dS in registers, dQ += dS K (K MN-major); dQ scaled once.
// 24 KB of shared memory at hd 32 to 192 KB at 256 (+ 1 KB).
//
// No atomics: every dK, dV and dQ element is summed by one thread in a
// fixed order (q heads, then q tiles; key tiles), so two runs give the
// same bits.
//
// Rounding: P, P^T and dS^T enter their products as two bf16 halves,
// hi = bf16(x) and lo = bf16(x - hi), each its own product into the same
// f32 sum.  Rounded once, 3-9% of dQ, dK or dV elements fall beyond the
// card's bf16 gate against the f32 plain version (one bf16 ulp, atol
// 1e-4); with the split none does (tests/test_torch_flash_bwd_tiles.py
// emulates both on the CPU).  The split costs a product each: S, dP,
// 2 x dV, 2 x dK in the dK/dV block and S, dP, 2 x dQ in the dQ block,
// 10 products of 2 hd flops a visible pair against the 4 that the work
// count (kernels/bounds.flash_work: 8 hd flops a pair) holds: 2.5x,
// recomputing S and dP in both blocks included (3x at hd 128 and 4x at
// hd 256, where every box's block computes S^T and dP^T).
//
// Bound on the H100: the larger of the bytes (q, k, v, out, dout read
// once, dq, dk, dv written once, lse) over 3.35 TB/s and 8 hd flops a
// visible pair over 989 TFLOP/s: the bytes at hd 64, s 1024 by a little,
// the operations at hd 256 with 16 q heads to a kv head.  This design is
// bound in practice by its 2.5x flops, by the exponentials (one a pair in
// each block), by the serial product, softmax, product order within a
// warpgroup, and, with one kv head, by the blocks of the first key
// tiles, which walk the most q tiles (hd 256, b 2, s 4096: 512 blocks).
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_fwd.cuh"
#include "flash_fwd_tc.cuh"
#include "tc_ptx.cuh"

namespace repro {
namespace flash {

constexpr int kBwdConsumers = 256;               // two warpgroups
constexpr int kBwdThreads = kBwdConsumers + 32;  // + the producer warp
constexpr int kBwdStages = 2;                    // Q/dO ring depth
constexpr int kPFloats = kTile * kTile;          // the P^T tile, f32

// dK/dV blocks a key tile, each summing one box (64 columns; 32 at hd 32)
// of dK and dV: ptxas gives a 288-thread block 168 registers a thread,
// which hold a box's f32 sum and the tensor-core accumulator of one q
// tile (2 x 32 a thread), a 64 x 64 product and its bf16 halves, but not
// two boxes' (see bwd_kv_consume); so at hd 128 and 256 two and four
// blocks share a key tile, each computing S^T and dP^T
template <int HD>
__host__ __device__ constexpr int bwd_kv_parts() {
  return HD >= 128 ? HD / 64 : 1;
}

// Where a dK/dV block keeps its f32 sums: in registers, or at hd 64 in
// shared memory (word i of consumer thread t at i * 256 + t), so that the
// block fits the 96 registers a thread of two blocks an SM (launch bounds
// (288, 2) at hd 32 and 64): a sum, an accumulator and a product of 32
// each do not.
template <int HD>
__host__ __device__ constexpr bool bwd_sums_in_smem() {
  return HD == 64;
}

// the maps of q, k, v and dout for the tensor-core backward
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// dynamic shared memory of the dK/dV block (K, V, then Q and dO of each
// stage, then P^T of each stage) and of the dQ block (Q, dO, then K and V
// of each stage), each with the slack that aligns the base
template <int HD>
constexpr size_t bwd_kv_smem() {
  return (2 + 2 * kBwdStages) * TileGeo<HD>::kTileBytes +
         kPFloats * sizeof(float) +
         (bwd_sums_in_smem<HD>() ? kBwdConsumers * TileGeo<HD>::kAcc : 0) *
             sizeof(float) +
         1024;
}
template <int HD>
constexpr size_t bwd_q_smem() {
  return (2 + 2 * kTcStages) * TileGeo<HD>::kTileBytes + 1024;
}

// barriers of the dK/dV block: K and V; full and empty of each of the
// `stages` Q/dO stages; full and empty of the P^T tile
struct KvBars {
  uint64_t* kv;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* p_full;
  uint64_t* p_empty;
  __device__ __forceinline__ KvBars(uint64_t* b, int stages)
      : kv(b),
        full(b + 1),
        empty(b + 1 + stages),
        p_full(b + 1 + 2 * stages),
        p_empty(b + 2 + 2 * stages) {}
};

// the first q tile that may see key tile k0: both sides of the dK/dV
// block walk the q tiles from it, skipping those tile_runs rejects
__device__ __forceinline__ int first_q_tile(int k0, const Mask& m) {
  return m.causal ? k0 / kTile : 0;
}

// The producer warp of the dK/dV block: K and V once, then for each q
// head of kv head kh's group and each q tile that sees the keys, Q and dO
// (lane 0, by TMA) and lse and delta (every lane, into `stats`: [stage]
// [lse 64 | delta 64] f32, 0 past s) behind the stage's full barrier,
// which lane 0 arrives at twice: when it starts the loads, and when the
// warp has written the stats.
template <int HD>
__device__ __forceinline__ void bwd_kv_produce(
    uint8_t* ks, uint8_t* vs, uint8_t* qs, uint8_t* dos, float* stats,
    const KvBars& bar, const BwdMaps& maps, const Mask& m, int g, int h,
    int bi, int kh, int k0, const float* __restrict__ lse,
    const float* __restrict__ delta) {
  using G = TileGeo<HD>;
  constexpr int S = kBwdStages;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    bar_expect(bar.kv, 2 * G::kTileBytes);
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c) {
      tma_load(ks + c * G::kChunkBytes, &maps.k, bar.kv, c * G::kChunk, kh,
               k0, bi);
      tma_load(vs + c * G::kChunkBytes, &maps.v, bar.kv, c * G::kChunk, kh,
               k0, bi);
    }
  }
  const int s = m.sq;
  const int nq = (s + kTile - 1) / kTile;
  int it = 0;
  for (int gi = 0; gi < g; ++gi) {
    const int hi = kh * g + gi;
    const int64_t row = (static_cast<int64_t>(bi) * h + hi) * s;
    for (int qt = first_q_tile(k0, m); qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_runs(q0, k0, m)) continue;
      const int st = it % S;
      if (it >= S) bar_wait(bar.empty + st, (it / S - 1) & 1);
      if (lane == 0) {
        uint8_t* qd = qs + st * G::kTileBytes;
        uint8_t* dd = dos + st * G::kTileBytes;
        bar_expect(bar.full + st, 2 * G::kTileBytes);
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load(qd + c * G::kChunkBytes, &maps.q, bar.full + st,
                   c * G::kChunk, hi, q0, bi);
          tma_load(dd + c * G::kChunkBytes, &maps.dout, bar.full + st,
                   c * G::kChunk, hi, q0, bi);
        }
      }
      float* ls = stats + st * 2 * kTile;
#pragma unroll
      for (int r = lane; r < kTile; r += 32) {
        const bool in = q0 + r < s;
        ls[r] = in ? lse[row + q0 + r] : 0.f;
        ls[kTile + r] = in ? delta[row + q0 + r] : 0.f;
      }
      __syncwarp();  // the lanes' stats before lane 0's release
      if (lane == 0) bar_arrive(bar.full + st);
      ++it;
    }
  }
}

// The consumer warpgroups of the dK/dV block: warpgroup 0 sums dV,
// warpgroup 1 dK, of keys [k0, k0 + 64) of kv head kh, columns of part
// `part` of bwd_kv_parts; stored in bf16.
template <int HD>
__device__ __forceinline__ void bwd_kv_consume(
    const uint8_t* ks, const uint8_t* vs, const uint8_t* qs,
    const uint8_t* dos, const float* stats, float* pbuf, float* sbuf,
    const KvBars& bar, const Mask& m, int g, int kvh, int bi, int kh, int k0,
    int part, float scale, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv) {
  using G = TileGeo<HD>;
  constexpr int S = kBwdStages;
  constexpr bool kSmemSums = bwd_sums_in_smem<HD>();
  constexpr int NA = G::kAcc;
  constexpr int NC = G::kChunks / bwd_kv_parts<HD>();  // boxes of the part
  const uint32_t part_off = part * NC * G::kChunkBytes;
  const int wg = threadIdx.x >> 7;  // 0: P^T and dV; 1: dS^T and dK
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  // this thread's key rows r0, r0 + 8 and its q columns 8 j + 2t (+ 1)
  const int r0 = 16 * warp + (lane >> 2);

  // Each q tile's product goes into a fresh tensor-core accumulator `acc`,
  // which one f32 add an element folds into the block's sum `sum`: summed
  // in the tensor cores over every q tile and head, the f32 accumulator
  // drifts from IEEE-rounded sums by more than the gate allows (dK at hd
  // 256, 16 heads of 32-64 q tiles: 8 steps a tile, 2 bf16 ulps off on the
  // card, where the CPU's f32 emulation of the same tiles stays in one).
  // `sum` lives in registers, or in this thread's words of sbuf.
  float sum[NC][NA], acc[NC][NA];
  float* ssum = sbuf + threadIdx.x;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if constexpr (kSmemSums) ssum[(c * NA + i) * kBwdConsumers] = 0.f;
      else sum[c][i] = 0.f;
    }

  // warpgroup 0: S^T = K Q^T, then dV += P^T dO; warpgroup 1: dP^T =
  // V dO^T, then dK += dS^T Q
  const uint32_t a_addr = smem_addr(wg == 0 ? ks : vs);
  const int s = m.sq;
  const int nq = (s + kTile - 1) / kTile;
  bar_wait(bar.kv, 0);
  int it = 0;
  for (int gi = 0; gi < g; ++gi) {
    for (int qt = first_q_tile(k0, m); qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_runs(q0, k0, m)) continue;
      const int st = it % S;
      const uint32_t par = (it / S) & 1;
      const uint32_t q_addr = smem_addr(qs + st * G::kTileBytes);
      const uint32_t do_addr = smem_addr(dos + st * G::kTileBytes);
      // lse (warpgroup 0) or delta (warpgroup 1) of the q tile's rows
      const float* rs = stats + st * 2 * kTile + wg * kTile;

      float x[32];
      bar_wait(bar.full + st, par);
      wg_fence();
      mma_abt<HD>(x, a_addr, wg == 0 ? q_addr : do_addr);
      wg_commit();
      wg_wait_all();
      fence_regs(x);

      if (wg == 0) {
        // P^T: scale, cap, mask, exp(. - lse); warpgroup 1 takes P^T times
        // 1 - tanh^2 (the cap's derivative) through pbuf, each thread its
        // own elements, word i of thread tid at i * 128 + tid; the whole
        // tile is visible only if it holds no q row past s either
        const bool full = q0 + kTile <= s && tile_full(q0, k0, m);
        if (it > 0) bar_wait(bar.p_empty, (it - 1) & 1);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
          float sx = x[i] * scale, dt = 1.f;
          if (m.softcap != 0.f) {
            const float th = tanhf(sx / m.softcap);
            sx = m.softcap * th;
            dt = 1.f - th * th;
          }
          const float p =
              full || visible(q0 + qc, k0 + r0 + 8 * ((i >> 1) & 1), m)
                  ? expf(sx - rs[qc])
                  : 0.f;
          x[i] = p;
          pbuf[i * 128 + tid] = p * dt;
        }
        bar_arrive(bar.p_full);
      } else {
        // dS^T = P^T (dP^T - delta)
        bar_wait(bar.p_full, it & 1);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          x[i] = pbuf[i * 128 + tid] *
                 (x[i] - rs[8 * (i >> 2) + 2 * t + (i & 1)]);
        bar_arrive(bar.p_empty);
      }

      uint32_t xhi[4][4], xlo[4][4];
      split_frags(x, xhi, xlo);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[c][i] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      wg_fence();
      mma_split<HD, NC>(acc, xhi, xlo,
                        (wg == 0 ? do_addr : q_addr) + part_off);
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      bar_arrive(bar.empty + st);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          if constexpr (kSmemSums)
            ssum[(c * NA + i) * kBwdConsumers] += acc[c][i];
          else sum[c][i] += acc[c][i];
        }
      ++it;
    }
  }

  // dv (warpgroup 0) or dk = scale * sum (warpgroup 1), [b, sk, kvh, HD]
  __nv_bfloat16* dst = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + r0 + 8 * r;
    if (kj >= m.sk) continue;
    __nv_bfloat16* drow =
        dst + ((static_cast<int64_t>(bi) * m.sk + kj) * kvh + kh) * HD +
        part * NC * G::kChunk;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int i = 4 * j + 2 * r;
        float a = sum[c][i], b = sum[c][i + 1];
        if constexpr (kSmemSums) {
          a = ssum[(c * NA + i) * kBwdConsumers];
          b = ssum[(c * NA + i + 1) * kBwdConsumers];
        }
        *reinterpret_cast<__nv_bfloat162*>(drow + c * G::kChunk + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(a * mul, b * mul);
      }
  }
}

// The whole dK/dV block for keys [k0, k0 + 64) of kv head kh of batch bi,
// the columns of part `part`.
template <int HD>
__device__ __forceinline__ void bwd_kv_block(
    const BwdMaps& maps, const Mask& m, int g, int h, int kvh, int bi,
    int kh, int k0, int part, float scale, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv) {
  using G = TileGeo<HD>;
  constexpr int S = kBwdStages;
  extern __shared__ uint8_t bwd_smem[];
  __shared__ uint64_t bars[3 + 2 * S];
  __shared__ float stats[S * 2 * kTile];
  // swizzle atoms must sit on 1024-byte boundaries
  const uint32_t raw = smem_addr(bwd_smem);
  uint8_t* ks = bwd_smem + (((raw + 1023) & ~1023u) - raw);
  uint8_t* vs = ks + G::kTileBytes;
  uint8_t* qs = vs + G::kTileBytes;
  uint8_t* dos = qs + S * G::kTileBytes;
  float* pbuf = reinterpret_cast<float*>(dos + S * G::kTileBytes);
  float* sbuf = pbuf + kPFloats;  // bwd_sums_in_smem
  const KvBars bar(bars, S);
  if (threadIdx.x == 0) {
    bar_init(bar.kv, 1);
    for (int s = 0; s < S; ++s) {
      bar_init(bar.full + s, 2);
      bar_init(bar.empty + s, kBwdConsumers);
    }
    bar_init(bar.p_full, 128);
    bar_init(bar.p_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kBwdConsumers) {
    bwd_kv_produce<HD>(ks, vs, qs, dos, stats, bar, maps, m, g, h, bi, kh,
                       k0, lse, delta);
    return;
  }
  bwd_kv_consume<HD>(ks, vs, qs, dos, stats, pbuf, sbuf, bar, m, g, kvh, bi,
                     kh, k0, part, scale, dk, dv);
}

// The consumer warpgroup of the dQ block: rows [q0, q0 + 64) of q head hi.
template <int HD>
__device__ __forceinline__ void bwd_q_consume(
    const uint8_t* qs, const uint8_t* dos, const uint8_t* ks,
    const uint8_t* vs, uint64_t* bars, const Mask& m, int q0, float scale,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int bi, int hi, int h) {
  using G = TileGeo<HD>;
  constexpr int NA = G::kAcc;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kTcStages;
  uint64_t* empty = v_full + kTcStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // this thread's q rows r0, r0 + 8 and its key columns 8 j + 2t (+ 1)
  const int r0 = 16 * warp + (lane >> 2);
  const int s = m.sq;

  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    const int64_t idx = (static_cast<int64_t>(bi) * h + hi) * s + qi;
    lq[r] = qi < s ? lse[idx] : 0.f;
    dl[r] = qi < s ? delta[idx] : 0.f;
  }
  float acc[G::kChunks][NA];
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[c][i] = 0.f;

  const uint32_t q_addr = smem_addr(qs);
  const uint32_t do_addr = smem_addr(dos);
  bar_wait(q_full, 0);
  const int nk = (m.sk + kTile - 1) / kTile;
  int it = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (m.causal && k0 > q0 + kTile - 1) break;
    if (!tile_runs(q0, k0, m)) continue;
    const int st = it % kTcStages;
    const uint32_t par = (it / kTcStages) & 1;
    const uint32_t k_addr = smem_addr(ks + st * G::kTileBytes);
    const uint32_t v_addr = smem_addr(vs + st * G::kTileBytes);

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
    bar_wait(k_full + st, par);
    bar_wait(v_full + st, par);
    wg_fence();
    mma_abt<HD>(sc, q_addr, k_addr);
    mma_abt<HD>(dp, do_addr, v_addr);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta) (1 - tanh^2), P = exp(capped scaled S - lse)
    const bool full = tile_full(q0, k0, m);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi8 = (i >> 1) & 1;
      float sx = sc[i] * scale, dt = 1.f;
      if (m.softcap != 0.f) {
        const float th = tanhf(sx / m.softcap);
        sx = m.softcap * th;
        dt = 1.f - th * th;
      }
      const float p =
          full || visible(q0 + r0 + 8 * hi8,
                          k0 + 8 * (i >> 2) + 2 * t + (i & 1), m)
              ? expf(sx - lq[hi8])
              : 0.f;
      dp[i] = p * dt * (dp[i] - dl[hi8]);
    }

    // dQ += dS K
    uint32_t dhi[4][4], dlo[4][4];
    split_frags(dp, dhi, dlo);
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c) fence_regs(acc[c]);
    wg_fence();
    mma_split<HD>(acc, dhi, dlo, k_addr);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c) fence_regs(acc[c]);
    bar_arrive(empty + st);
    ++it;
  }

  // dq [b, s, h, HD] = scale * sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= s) continue;
    __nv_bfloat16* drow =
        dq + ((static_cast<int64_t>(bi) * s + qi) * h + hi) * HD;
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(drow + c * G::kChunk + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(acc[c][i] * scale, acc[c][i + 1] * scale);
      }
  }
}

// The whole dQ block for rows [q0, q0 + 64) of q head hi (kv head kh) of
// batch bi: the forward's barriers and producer (tc_produce, dO beside Q).
template <int HD>
__device__ __forceinline__ void bwd_q_block(
    const BwdMaps& maps, const Mask& m, int bi, int hi, int kh, int q0,
    float scale, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int h) {
  using G = TileGeo<HD>;
  extern __shared__ uint8_t bwd_smem[];
  __shared__ uint64_t bars[1 + 3 * kTcStages];
  const uint32_t raw = smem_addr(bwd_smem);
  uint8_t* qs = bwd_smem + (((raw + 1023) & ~1023u) - raw);
  uint8_t* dos = qs + G::kTileBytes;
  uint8_t* ks = dos + G::kTileBytes;
  uint8_t* vs = ks + kTcStages * G::kTileBytes;
  if (threadIdx.x == 0) {
    bar_init(bars, 1);
    for (int s = 0; s < kTcStages; ++s) {
      bar_init(bars + 1 + s, 1);
      bar_init(bars + 1 + kTcStages + s, 1);
      bar_init(bars + 1 + 2 * kTcStages + s, kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kTcConsumers) {
    if (threadIdx.x == kTcConsumers)
      tc_produce<HD>(qs, ks, vs, bars, &maps.q, OwnShard{&maps.k, &maps.v, m},
                     bi, hi, kh, q0, &maps.dout, dos);
    return;
  }
  bwd_q_consume<HD>(qs, dos, ks, vs, bars, m, q0, scale, lse, delta, dq, bi,
                    hi, h);
}

}  // namespace flash
}  // namespace repro
