// The bf16 flash-attention forward tile on Hopper's tensor cores (wgmma
// fed by TMA), shared by the training kernel (flash_attention.cu) and the
// ring-attention kernel (ring_attention.cu): the online-softmax fold of
// every visible key tile into one 64-row q tile's carry, with the masks
// of flash_fwd.cuh (absolute positions, causal, window, softcap, the
// ragged edge).  f32 inputs keep flash_fwd.cuh's CUDA-core loop: a
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

namespace repro {
namespace flash {

constexpr int kTcConsumers = 128;              // one warpgroup
constexpr int kTcThreads = kTcConsumers + 32;  // + the producer warp
constexpr int kTcStages = 2;                   // K/V ring depth

template <int HD>
struct TcGeo {
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256, "head dim");
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;     // bytes a box row
  static constexpr int kChunk = kSwizzle / 2;              // bf16 columns a box
  static constexpr int kChunks = HD / kChunk;              // boxes a tile
  static constexpr int kChunkBytes = kTile * kSwizzle;     // one box: 64 rows
  static constexpr int kTileBytes = kChunks * kChunkBytes; // [64][HD] bf16
  static constexpr int kAcc = kChunk / 2;                  // O floats a box
  // wgmma descriptor: layout 1 = 128-byte swizzle, 2 = 64-byte; 8-row
  // groups kSwizzle * 8 bytes apart
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
  static constexpr uint32_t kGroupBytes = 8 * kSwizzle;
  // Q, then K and V of each stage, then the slack that aligns the base
  static constexpr size_t kSmem = (1 + 2 * kTcStages) * kTileBytes + 1024;
};

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// this thread's arrival, announcing `bytes` that TMA will complete
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Until the phase of parity `parity` has completed.  A wait that outlasts
// kBarTimeoutNs traps (the launch then fails and the wrapper raises)
// rather than hang the card on a load that never completes; it exceeds
// the ring's 30 s wait for a peer's flag, which its producer may spend
// while the consumers wait here.
constexpr long long kBarTimeoutNs = 40LL * 1000 * 1000 * 1000;

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!bar_try(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > kBarTimeoutNs) __trap();
  }
}

// one box of a 4-D tensor map at coordinates (c0 innermost) into `dst`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads of wgmma's registers across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptor of the swizzled tile at `addr`; both
// byte offsets are the 8-row group stride (the only one a 64-row K-major
// operand or a one-box-wide MN-major operand reads)
template <int HD>
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr) {
  using G = TcGeo<HD>;
  constexpr uint64_t off = G::kGroupBytes >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (off << 16) |
         (off << 32) | (G::kLayout << 62);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory,
// both K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared
// memory MN-major (transpose bit)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], as mma_rs_n64 (head dim 32)
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N], const uint32_t (&a)[4],
                                       uint64_t db) {
  if constexpr (N == 32) mma_rs_n64(d, a, db);
  else mma_rs_n32(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

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
template <int HD, typename Shards>
__device__ __forceinline__ void tc_produce(uint8_t* qs, uint8_t* ks,
                                           uint8_t* vs, uint64_t* bars,
                                           const CUtensorMap* qmap,
                                           const Shards& sh, int bi, int hi,
                                           int kh, int q0) {
  using G = TcGeo<HD>;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kTcStages;
  uint64_t* empty = v_full + kTcStages;
  bar_expect(q_full, G::kTileBytes);
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
    tma_load(qs + c * G::kChunkBytes, qmap, q_full, c * G::kChunk, hi, q0,
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
#pragma unroll
      for (int ks16 = 0; ks16 < HD / 16; ++ks16) {
        const uint32_t off = (ks16 * 16) / G::kChunk * G::kChunkBytes +
                             (ks16 * 16) % G::kChunk * 2;
        mma_ss_n64(sc, mat_desc<HD>(q_addr + off), mat_desc<HD>(k_addr + off),
                   ks16 > 0);
      }
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

      // P as wgmma's A fragments, in two bf16 halves: the accumulator of
      // key columns [16 kk, 16 kk + 16) is the A fragment of k-step kk
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sc[8 * kk + 2 * r], b = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
          const float2 hf = __bfloat1622float2(h2);
          phi[kk][r] = bf16x2_bits(h2);
          plo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
        }

      // O += P_hi V + P_lo V over the tile's keys in steps of 16, one
      // 64-column box of V (and O) at a time
      bar_wait(v_full + st, par);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c) fence_regs(o[c]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c) {
          const uint64_t db = mat_desc<HD>(v_addr + c * G::kChunkBytes +
                                           kk * 16 * G::kSwizzle);
          mma_rs(o[c], phi[kk], db);
          mma_rs(o[c], plo[kk], db);
        }
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

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found once through the runtime's
// entry-point lookup (the library links no -lcuda); null if not found
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous bf16 [b, s, nh, hd] tensor at `base` whose box is
// one TcGeo<hd> box: 64 rows of one head, hd 32 or 64 columns, swizzled
// as the wgmma descriptors read it; rows past s read as zeros.  Returns a
// cudaError_t code.
inline int encode_rows(CUtensorMap* map, const void* base, int b, int s,
                       int nh, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(base) % 16 ||
      (hd != 32 && hd != 64 && hd != 128 && hd != 256))
    return cudaErrorInvalidValue;
  const cuuint32_t chunk = hd >= 64 ? 64 : 32;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(nh),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {row, row * nh, row * nh * s};
  const cuuint32_t box[4] = {chunk, 1, static_cast<cuuint32_t>(kTile), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        hd >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace repro
