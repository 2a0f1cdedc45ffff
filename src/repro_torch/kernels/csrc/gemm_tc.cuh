// The bf16 GEMM tile on Hopper's tensor cores (wgmma fed by TMA), shared
// by the grouped matmul (moe_gmm.cu), the tile matmul (tile_matmul.cu)
// and the ring's per-step product (ring_matmul_rs.cu).  f32 and bf16
// operands that TMA cannot describe keep tile_mm.cuh's loops (the rule is
// gemm_path in kernels/autotune.py).
//
// `TcTile<BN, TA, TB>::run` computes the 128 x BN tile at (m0, n0) of
// op(A) [m, k] @ op(B) [k, n] into f32 accumulators held in registers.
// A is read from a tensor map over [za][m][k] (K-major), or with TA over
// [za][k][m] (MN-major: dw's x^T, read where x lies); B over [zb][k][n]
// (MN-major), or with TB over [zb][n][k] (K-major: dx's w^T).  The third
// map dimension is the expert (or the ring's chunk), so TMA zero-fills
// rows and k past the ends of one expert instead of reading the next
// one's; rows and columns past m and n are also masked on store.
//
// A block is two consumer warpgroups (threads 0-255, 64 rows of the tile
// each) and one producer warp (256-287) of which one thread starts every
// load.  k is walked in steps of 64 through a ring of kStages shared-
// memory stages, each holding A's [128][64] and B's [64][BN] boxes as TMA
// swizzles them (128 bytes a row) behind a "full" mbarrier (TMA
// completes its bytes) and an "empty" one (the 256 consumers release
// it), so the loads of the next stages are in flight while one
// multiplies.  Each k16 step is one m64nBNk16 wgmma a warpgroup (N 128 or
// 256, the whole tile's width); one group stays in flight while the next
// stage is awaited.  No atomics and no split of k: two runs give the same
// bits.  Every barrier wait traps after tc_ptx.cuh's 40 s.
//
// What was hard, and what the design does about it:
// - Multi-box MN-major descriptors.  An MN-major operand wider than one
//   64-column box reads its boxes `lead` bytes apart (the descriptor's
//   leading byte offset: one box of 64 k rows, 8 KB) and its 8-row groups
//   of k `stride` bytes apart (1 KB); a K-major operand reads only the
//   8-row group stride, and steps 32 bytes along k inside the swizzled
//   row.  The wrappers for n128 and n256 are tc_ptx.cuh's.
// - Ragged edges inside an expert: 3-D maps (above).
// - Shapes TMA cannot describe (a base not 16-byte aligned, a contiguous
//   extent not a multiple of 8 bf16): the wrappers choose tile_mm.cuh's
//   mma.sync tile for those before the launch; a refused map here is an
//   error, never a fallback.
// - Divergence.  ptxas serializes wgmma that it finds on a divergent
//   path (C7518, "compiler-inserted WG.DP in divergent path") and then
//   copies the accumulators; so, as in flash_fwd_tc.cuh, the producer
//   warp leaves the kernel after its loads and the consumers' code runs
//   outside any branch on the thread index.  A kernel that needs a
//   barrier after that (the ring) syncs the 256 consumers alone
//   (consumer_sync, named barrier 1).
// - The ring's persistent block produces and consumes once per ring
//   step: the stage counter `it` carries across steps in the producer
//   and the consumers alike, so the barriers' phases carry too, and the
//   producer loads the next step's first stages while the consumers run
//   the epilogue.  A 288-thread block gets at most 168 registers a thread
//   (registers go to warps in fours), and the ring's epilogue (add the
//   left partial, send, store) over 64 accumulators in registers needed
//   ~185 (the mma.sync ring's count), so with Staged the consumers write
//   the f32 tile once per step into a padded shared buffer and for_each
//   walks it row by row: coalesced, and light on registers.  The other
//   kernels store straight from the accumulators (store).
// - Accumulation: k <= 4096 at the port's shapes (256 k16 steps a
//   tile), one tensor-core accumulator; the drift that made
//   flash_bwd_tc.cuh fold its dK/dV sums in IEEE f32 appeared at ~8,000.
//
// Bound: operations at the main shapes (granite's expert products ~340
// flops a byte, the ring's [2048, 4096] @ [4096, 2048] ~1,000, above
// bf16's ~295 balance).
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_ptx.cuh"

namespace repro {
namespace gemm {

using namespace repro::tc;

constexpr int kBM = 128;                      // rows a tile: two warpgroups
constexpr int kBK = 64;                       // k a stage: one 128-byte row
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kBoxBytes = 64 * 128;           // [64][64] bf16, swizzled

// the maps of one product: A and B as above
struct Maps {
  CUtensorMap a, b;
};

// the 256 consumer threads alone (the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

template <int BN, bool TA, bool TB, bool Staged = false>
struct TcTile {
  static_assert(BN == 128 || BN == 256, "tile width");
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // Staged: the f32 tile, rows padded by 8 so that a warp's stores of
  // eight rows fall in distinct banks
  static constexpr int kLd = BN + 8;
  static constexpr size_t kEpiBytes = Staged ? sizeof(float) * kBM * kLd : 0;
  // the stages, the staged tile, the barriers, and the slack that aligns
  // the base to the 1024-byte swizzle atom
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes + kEpiBytes +
                                  2 * kStages * sizeof(uint64_t);
  static constexpr int kAcc = BN / 2;         // f32 a consumer thread

  float acc[kAcc];
  uint8_t* tiles;
  float* epi;
  uint64_t* full;
  uint64_t* empty;
  uint32_t it;                                // stages used so far
  bool staged;                                // acc is in epi

  // every thread of the block, before it produces or consumes
  __device__ __forceinline__ void init(uint8_t* smem) {
    const uint32_t raw = smem_addr(smem);
    tiles = smem + (((raw + 1023) & ~1023u) - raw);
    epi = reinterpret_cast<float*>(tiles + kStages * kStageBytes);
    full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes +
                                       kEpiBytes);
    empty = full + kStages;
    it = 0;
    staged = false;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        bar_init(full + s, 1);
        bar_init(empty + s, kConsumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  // the producer thread: the loads of the tile at (m0, n0) of the
  // product over k, A's slice za and B's slice zb
  __device__ __forceinline__ void produce(const CUtensorMap* amap,
                                          const CUtensorMap* bmap, int za,
                                          int zb, int m0, int n0, int k) {
    const int nk = (k + kBK - 1) / kBK;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % kStages;
      if (it >= kStages) bar_wait(empty + s, (it / kStages - 1) & 1);
      uint8_t* as = tiles + s * kStageBytes;
      uint8_t* bs = as + kABytes;
      const int k0 = kb * kBK;
      bar_expect(full + s, kStageBytes);
      if (TA) {
        tma_load3(as, amap, full + s, m0, k0, za);
        tma_load3(as + kBoxBytes, amap, full + s, m0 + 64, k0, za);
      } else {
        tma_load3(as, amap, full + s, k0, m0, za);
      }
      if (TB) {
        tma_load3(bs, bmap, full + s, k0, n0, zb);
      } else {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load3(bs + j * kBoxBytes, bmap, full + s, n0 + 64 * j, k0, zb);
      }
    }
  }

  __device__ __forceinline__ void mma(uint64_t da, uint64_t db, int acc_on) {
    if constexpr (BN == 128) mma_ss_n128<TA, !TB>(acc, da, db, acc_on);
    else mma_ss_n256<TA, !TB>(acc, da, db, acc_on);
  }

  // the 256 consumer threads: the sums of that tile (k > 0) into acc
  __device__ __forceinline__ void consume(int k) {
    const int nk = (k + kBK - 1) / kBK;
    const int wg = threadIdx.x >> 7;
    int prev = 0;
    staged = false;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % kStages;
      bar_wait(full + s, (it / kStages) & 1);
      const uint32_t a_addr =
          smem_addr(tiles + s * kStageBytes) + wg * kBoxBytes;
      const uint32_t b_addr = smem_addr(tiles + s * kStageBytes) + kABytes;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // K-major: 32 bytes along the swizzled row; MN-major: 16 rows
        const uint64_t da =
            TA ? make_desc(a_addr + kk * 2048, kBoxBytes, 1024, 1)
               : make_desc(a_addr + kk * 32, 16, 1024, 1);
        const uint64_t db =
            TB ? make_desc(b_addr + kk * 32, 16, 1024, 1)
               : make_desc(b_addr + kk * 2048, kBoxBytes, 1024, 1);
        mma(da, db, kb > 0 || kk > 0);
      }
      wg_commit();
      if (kb > 0) {
        wg_wait<1>();
        fence_regs(acc);
        bar_arrive(empty + prev);
      }
      prev = s;
    }
    wg_wait<0>();
    fence_regs(acc);
    bar_arrive(empty + prev);
  }

  // every consumer thread (Staged): f(row, col, value&) over the tile,
  // tile-local coordinates, thread t taking elements t, t + 256, ... of
  // the row-major order; the first call after consume writes acc to epi
  // (wgmma's layout: element i of warp w of warpgroup g holds row 64 g +
  // 16 w + lane / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane & 3) +
  // (i & 1)), and values f writes persist until the next consume
  template <typename F>
  __device__ __forceinline__ void for_each(F f) {
    static_assert(Staged, "for_each walks the staged tile");
    if (!staged) {
      const int lane = threadIdx.x & 31;
      const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
      const int c0 = 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < kAcc; i += 2)
        *reinterpret_cast<float2*>(
            epi + (r0 + 8 * ((i >> 1) & 1)) * kLd + c0 + 8 * (i >> 2)) =
            make_float2(acc[i], acc[i + 1]);
      consumer_sync();
      staged = true;
    }
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kBM * BN; idx += kConsumers)
      f(idx / BN, idx % BN, epi[(idx / BN) * kLd + idx % BN]);
  }

  // a consumer thread: its outputs cast to bf16 into out [rows][ld] at
  // (m0, n0), masked to rows x cols; column pairs as one 4-byte store
  // where ld is even
  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ out,
                                        int64_t ld, int rows, int cols,
                                        int m0, int n0) {
    const int lane = threadIdx.x & 31;
    const int r0 = m0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
    const int c0 = n0 + 2 * (lane & 3);
    const bool pairs = (ld % 2) == 0;
#pragma unroll
    for (int i = 0; i < kAcc; i += 2) {
      const int r = r0 + 8 * ((i >> 1) & 1);
      const int c = c0 + 8 * (i >> 2);
      if (r >= rows) continue;
      __nv_bfloat16* o = out + r * ld + c;
      if (pairs && c + 1 < cols) {
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      } else {
        if (c < cols) o[0] = __float2bfloat16(acc[i]);
        if (c + 1 < cols) o[1] = __float2bfloat16(acc[i + 1]);
      }
    }
  }
};

// The maps of op(A) [m, k] @ op(B) [k, n] for TcTile<BN, TA, TB>: A over
// za slices of [m][k] (or [k][m] with TA), B over zb slices of [k][n] (or
// [n][k] with TB), each contiguous at a 16-byte-aligned base.  Returns a
// cudaError_t code.
template <int BN, bool TA, bool TB>
inline int encode_maps(Maps* maps, const void* a, const void* b, int za,
                       int zb, int m, int k, int n) {
  int e = TA ? encode_3d(&maps->a, a, m, k, za, 64)
             : encode_3d(&maps->a, a, k, m, za, kBM);
  if (e == 0)
    e = TB ? encode_3d(&maps->b, b, k, n, zb, BN)
           : encode_3d(&maps->b, b, n, k, zb, 64);
  return e;
}

// Calls f.template run<BN>() for the instantiated tile widths
// (kernels/autotune.py TC_BLOCKS: 128 x 128 and 128 x 256, k 64);
// cudaErrorInvalidValue for any other block sizes.
template <typename F>
__host__ int dispatch_tc(int bm, int bn, int bk, F& f) {
  if (bm != kBM || bk != kBK) return cudaErrorInvalidValue;
  if (bn == 128) return f.template run<128>();
  if (bn == 256) return f.template run<256>();
  return cudaErrorInvalidValue;
}

}  // namespace gemm
}  // namespace repro
