// The bf16 flash-attention forward tile on Hopper's tensor cores (wgmma
// fed by TMA), shared by the training kernel (flash_attention.cu) and the
// ring-attention kernel (ring_attention.cu): the online-softmax fold of
// every visible key tile into one 64-row q tile's carry, with the masks
// of flash_fwd.cuh (absolute positions, causal, window, softcap, the
// ragged edge).  The PTX, tile geometry and products live in tc_ptx.cuh;
// the backward's dQ block (flash_bwd_tc.cuh) reuses this file's producer.  f32 inputs keep flash_fwd.cuh's CUDA-core loop: a
// tensor-core product of f32 inputs would be TF32, ~1e-3 off where the
// f32 gates (card vs CPU, 1e-5) need full f32 sums.
//
// A block is one (batch, q head, 64-row q tile): one consumer warpgroup
// (threads 0-127, wgmma's 64 rows) and one producer warp (128-159) of
// which one thread starts every load.  Shared memory, each tile a
// [64 rows][hd] bf16 block cut into boxes of 64 columns (32 at hd 32) and
// swizzled by TMA in the pattern wgmma's descriptors read (128-byte rows;
// 64-byte at hd 32):
//
//   Q            hd x 128 B        loaded once
//   K, V ring    2 stages x 2 x hd x 128 B, each stage behind a "full"
//                mbarrier per tensor (TMA completes its bytes) and an
//                "empty" one (the consumers release it)
//
// 20 KB at hd 32, 40 KB at 64, 80 KB at 128 (two blocks an SM) and 160 KB
// at 256 (one), plus 1 KB to align the base to the swizzle atom.
//
// Per key tile the consumers run S = Q K^T (wgmma, A and B from shared
// memory, both K-major, f32 accumulators in registers: 32 a thread), scale
// S, cap it, mask it, update the running max and sum with row reductions
// over the four threads that share a row, rescale O, and run O += P V
// (wgmma, P from registers as A, V from shared memory as B with the
// transpose bit: V's tile is [keys][hd], MN-major for this product).
// P goes in as two bf16 halves, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// each its own product into the same O: with P rounded once ~10% of
// `out` falls outside one bf16 ulp of the f32 reference at hd 64-256,
// with the split none does.  The split costs a third product: 1.5x the
// tensor-core flops of Q K^T + P V, which the work count
// (kernels/bounds.flash_work: 4 hd flops a visible pair) leaves out as the
// design's cost.  tests/test_torch_flash_tiles.py emulates these
// roundings in plain torch on the CPU and pins them against the plain
// version and the JAX kernel; it runs none of this file.  What checks the
// kernel itself is chip_smoke.py (phases 5, 11 and 17: every case against
// the plain version on the card, ragged s and ring shards included).
//
// Key tiles the mask hides from the whole q tile are never loaded (the
// causal loop stops after the diagonal tile; windowed-out tiles are
// skipped by tile_runs); inside a tile the per-element mask runs only
// where some pair is hidden.
//
// Bound on the H100: the larger of the bytes (q, k, v read once, out and
// lse written once) over 3.35 TB/s and 4 hd flops a visible pair over
// 989 TFLOP/s (kernels/bounds.flash_work): the bytes at hd 64, s 1024 by
// a little, the operations at hd 256 with 16 q heads to a kv head.  This
// design is bound in practice by the exponentials (one a visible pair),
// by the serial S, softmax, P V order within its one warpgroup, and by
// loading one tile ahead.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_fwd.cuh"
#include "tc_ptx.cuh"

namespace repro {
namespace flash {

using namespace repro::tc;
static_assert(kRows == kTile, "the tensor-core tile is the flash tile");

constexpr int kTcConsumers = 128;              // one warpgroup
constexpr int kTcThreads = kTcConsumers + 32;  // + the producer warp
constexpr int kTcStages = 2;                   // K/V ring depth

// the forward's shared memory: Q, then K and V of each stage, then the
// slack that aligns the base
template <int HD>
struct TcGeo : TileGeo<HD> {
  static constexpr size_t kSmem =
      (1 + 2 * kTcStages) * TileGeo<HD>::kTileBytes + 1024;
};

// every pair of key tile [k0, k0 + 64) and q tile [q0, q0 + 64) attends
// (rows past sq included: they are never stored)
__device__ __forceinline__ bool tile_full(int q0, int k0, const Mask& m) {
  if (k0 + kTile > m.sk) return false;
  const int qp = m.q_off + q0, kp = m.k_off + k0;
  if (m.causal && kp + kTile - 1 > qp) return false;
  if (m.window > 0 && kp <= qp + kTile - 1 - m.window) return false;
  return true;
}

// ---------------------------------------------------------------------------
// The block: one q tile folded over the key tiles of every shard of
// `Shards` (flash attention: one; ring attention: the ranks' shards).
// `Shards` gives count(), get(i, q0, mask, kmap, vmap) -> false for a
// shard this q tile skips, and ready(i), which the producer runs before
// its first load of shard i.
// ---------------------------------------------------------------------------
// The producer thread: Q (and, for the backward's dQ block, dO into `dos`
// through `dmap`) once behind bars[0], then K and V of each key tile the
// q tile sees through the ring.
template <int HD, typename Shards>
__device__ __forceinline__ void tc_produce(uint8_t* qs, uint8_t* ks,
                                           uint8_t* vs, uint64_t* bars,
                                           const CUtensorMap* qmap,
                                           const Shards& sh, int bi, int hi,
                                           int kh, int q0,
                                           const CUtensorMap* dmap = nullptr,
                                           uint8_t* dos = nullptr) {
  using G = TcGeo<HD>;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kTcStages;
  uint64_t* empty = v_full + kTcStages;
  bar_expect(q_full, (dmap != nullptr ? 2 : 1) * G::kTileBytes);
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
    tma_load(qs + c * G::kChunkBytes, qmap, q_full, c * G::kChunk, hi, q0,
             bi);
  if (dmap != nullptr)
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c)
      tma_load(dos + c * G::kChunkBytes, dmap, q_full, c * G::kChunk, hi, q0,
               bi);
  int it = 0;
  for (int s = 0; s < sh.count(); ++s) {
    Mask m;
    const CUtensorMap *km, *vm;
    if (!sh.get(s, q0, m, km, vm)) continue;
    sh.ready(s);
    const int nk = (m.sk + kTile - 1) / kTile;
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kTile;
      if (m.causal && m.k_off + k0 > m.q_off + q0 + kTile - 1) break;
      if (!tile_runs(q0, k0, m)) continue;
      const int st = it % kTcStages;
      if (it >= kTcStages) bar_wait(empty + st, (it / kTcStages - 1) & 1);
      uint8_t* kd = ks + st * G::kTileBytes;
      uint8_t* vd = vs + st * G::kTileBytes;
      bar_expect(k_full + st, G::kTileBytes);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
        tma_load(kd + c * G::kChunkBytes, km, k_full + st, c * G::kChunk, kh,
                 k0, bi);
      bar_expect(v_full + st, G::kTileBytes);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
        tma_load(vd + c * G::kChunkBytes, vm, v_full + st, c * G::kChunk, kh,
                 k0, bi);
      ++it;
    }
  }
}

template <int HD, typename Shards>
__device__ __forceinline__ void tc_consume(const uint8_t* qs,
                                           const uint8_t* ks,
                                           const uint8_t* vs, uint64_t* bars,
                                           const Shards& sh, int q0,
                                           float scale,
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ lse, int bi,
                                           int hi, int h, int sq) {
  using G = TcGeo<HD>;
  constexpr int NA = G::kAcc;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kTcStages;
  uint64_t* empty = v_full + kTcStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // this thread's rows of the q tile: r0 (accumulator elements with bit 1
  // of their index clear) and r0 + 8; its columns of each 8-column group:
  // 2t and 2t + 1
  const int r0 = 16 * warp + (lane >> 2);

  float o[G::kChunks][NA];
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < NA; ++i) o[c][i] = 0.f;
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_addr(qs);
  bar_wait(q_full, 0);
  int it = 0;
  for (int s = 0; s < sh.count(); ++s) {
    Mask m;
    const CUtensorMap *km, *vm;
    if (!sh.get(s, q0, m, km, vm)) continue;
    const int nk = (m.sk + kTile - 1) / kTile;
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kTile;
      if (m.causal && m.k_off + k0 > m.q_off + q0 + kTile - 1) break;
      if (!tile_runs(q0, k0, m)) continue;
      const int st = it % kTcStages;
      const uint32_t par = (it / kTcStages) & 1;
      const uint32_t k_addr = smem_addr(ks + st * G::kTileBytes);
      const uint32_t v_addr = smem_addr(vs + st * G::kTileBytes);

      // S = Q K^T over hd in steps of 16
      float sc[32];
      bar_wait(k_full + st, par);
      wg_fence();
      mma_abt<HD>(sc, q_addr, k_addr);
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      // scale, cap, mask; the running max and sum of rows r0, r0 + 8
      const bool full = tile_full(q0, k0, m);
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hi8 = (i >> 1) & 1;
        float x = sc[i] * scale;
        if (m.softcap != 0.f) x = m.softcap * tanhf(x / m.softcap);
        if (!full && !visible(q0 + r0 + 8 * hi8,
                              k0 + 8 * (i >> 2) + 2 * t + (i & 1), m))
          x = -INFINITY;
        sc[i] = x;
        mx[hi8] = fmaxf(mx[hi8], x);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = expf(mrow[r] - mx[r]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hi8 = (i >> 1) & 1;
        const float p = expf(sc[i] - mx[hi8]);
        sc[i] = p;
        sum[hi8] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lrow[r] = lrow[r] * corr[r] + quad_sum(sum[r]);
        mrow[r] = mx[r];
      }
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < NA; ++i) o[c][i] *= corr[(i >> 1) & 1];

      // P as wgmma's A fragments, in two bf16 halves
      uint32_t phi[4][4], plo[4][4];
      split_frags(sc, phi, plo);

      // O += P_hi V + P_lo V over the tile's keys in steps of 16, one
      // 64-column box of V (and O) at a time
      bar_wait(v_full + st, par);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c) fence_regs(o[c]);
      wg_fence();
      mma_split<HD>(o, phi, plo, v_addr);
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c) fence_regs(o[c]);
      bar_arrive(empty + st);
      ++it;
    }
  }

  // out [b, sq, h, HD] bf16 = O / l, lse [b, h, sq] f32 = m + log(l), l
  // floored at 1e-30
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= sq) continue;
    const float lf = fmaxf(lrow[r], 1e-30f);
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(bi) * sq + qi) * h + hi) * HD;
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * G::kChunk + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(o[c][i] / lf, o[c][i + 1] / lf);
      }
    if (t == 0)
      lse[(static_cast<int64_t>(bi) * h + hi) * sq + qi] = mrow[r] + logf(lf);
  }
}

// flash attention (and its backward's dQ block) folds one shard: the
// block's own k and v
struct OwnShard {
  const CUtensorMap* k;
  const CUtensorMap* v;
  Mask mk;
  __device__ __forceinline__ int count() const { return 1; }
  __device__ __forceinline__ bool get(int, int, Mask& m, const CUtensorMap*& km,
                                      const CUtensorMap*& vm) const {
    m = mk;
    km = k;
    vm = v;
    return true;
  }
  __device__ __forceinline__ void ready(int) const {}
};

// The whole block: barriers, the producer thread's loads, the consumer
// warpgroup's fold and store.  The block's q tile is rows [q0, q0 + 64)
// of head hi (kv head kh) of batch bi.
template <int HD, typename Shards>
__device__ __forceinline__ void tc_block(const CUtensorMap* qmap,
                                         const Shards& sh, int bi, int hi,
                                         int kh, int q0, float scale,
                                         __nv_bfloat16* __restrict__ out,
                                         float* __restrict__ lse, int h,
                                         int sq) {
  using G = TcGeo<HD>;
  extern __shared__ uint8_t tc_smem[];
  __shared__ uint64_t bars[1 + 3 * kTcStages];
  // swizzle atoms must sit on 1024-byte boundaries
  const uint32_t raw = smem_addr(tc_smem);
  uint8_t* qs = tc_smem + (((raw + 1023) & ~1023u) - raw);
  uint8_t* ks = qs + G::kTileBytes;
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
      tc_produce<HD>(qs, ks, vs, bars, qmap, sh, bi, hi, kh, q0);
    return;
  }
  tc_consume<HD>(qs, ks, vs, bars, sh, q0, scale, out, lse, bi, hi, h, sq);
}

}  // namespace flash
}  // namespace repro
