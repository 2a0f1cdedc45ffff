// Hopper's tensor-core plumbing, shared by the bf16 attention tiles on
// wgmma and TMA (flash_fwd_tc.cuh, forward; flash_bwd_tc.cuh, backward)
// and the bf16 GEMM tile (gemm_tc.cuh): the geometry of a swizzled
// [64 rows][hd] bf16 tile in shared memory, the PTX of mbarriers, TMA
// loads and wgmma, and the host's tensor maps.
//
// A tile is cut into boxes of 64 columns (32 at hd 32), each box 64 rows
// of 128 bytes (64 at hd 32) that TMA swizzles in the pattern wgmma's
// descriptors read.  The same tile serves as a K-major operand (rows are
// M or N, hd is the reduction: Q K^T) and, with the transpose bit, as an
// MN-major B operand (rows are the reduction, hd is N: P V).
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace tc {

constexpr int kRows = 64;   // rows of a tile: wgmma's M, TMA's box

template <int HD>
struct TileGeo {
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256, "head dim");
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;     // bytes a box row
  static constexpr int kChunk = kSwizzle / 2;              // bf16 columns a box
  static constexpr int kChunks = HD / kChunk;              // boxes a tile
  static constexpr int kChunkBytes = kRows * kSwizzle;     // one box: 64 rows
  static constexpr int kTileBytes = kChunks * kChunkBytes; // [64][HD] bf16
  static constexpr int kAcc = kChunk / 2;                  // f32 a thread a box
  // wgmma descriptor: layout 1 = 128-byte swizzle, 2 = 64-byte; 8-row
  // groups kSwizzle * 8 bytes apart
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
  static constexpr uint32_t kGroupBytes = 8 * kSwizzle;
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

// one box of a 3-D tensor map at coordinates (c0 innermost) into `dst`
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
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
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of wgmma's registers across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptor of a swizzled operand at `addr`
// (layout 1: 128-byte swizzle, 2: 64-byte).  `lead` is the byte distance
// between the operand's 64-column boxes along M or N, read only for an
// MN-major operand wider than one box; `stride` the distance between its
// 8-row groups (8 rows of M or N K-major, 8 rows of K MN-major).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) |
         (layout << 62);
}

// the descriptor of the swizzled tile at `addr`; both byte offsets are
// the 8-row group stride (the only one a 64-row K-major operand or a
// one-box-wide MN-major operand reads)
template <int HD>
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr) {
  using G = TileGeo<HD>;
  return make_desc(addr, G::kGroupBytes, G::kGroupBytes, G::kLayout);
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

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory; TA:
// A MN-major, TB: B MN-major (wgmma's transpose bits)
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], A and B from shared memory; TA:
// A MN-major, TB: B MN-major (wgmma's transpose bits)
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n256(float (&d)[128], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
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

// ---------------------------------------------------------------------------
// The tiles' two products, issued by one warpgroup (the caller fences,
// commits and waits).  Accumulator element i of a thread holds row
// 16 w + lane / 4 + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 (lane & 3)
// + (i & 1) of its 64 x 64 block (w: the thread's warp in the group).
// ---------------------------------------------------------------------------
// d[64 x 64] = A B^T over HD: A and B [64][HD] tiles, both K-major
template <int HD>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a_addr,
                                        uint32_t b_addr) {
  using G = TileGeo<HD>;
#pragma unroll
  for (int ks16 = 0; ks16 < HD / 16; ++ks16) {
    const uint32_t off = (ks16 * 16) / G::kChunk * G::kChunkBytes +
                         (ks16 * 16) % G::kChunk * 2;
    mma_ss_n64(d, mat_desc<HD>(a_addr + off), mat_desc<HD>(b_addr + off),
               ks16 > 0);
  }
}

// A 64 x 64 f32 accumulator as wgmma's A fragments of its four k-steps of
// 16 columns, in two bf16 halves, hi = bf16(x) and lo = bf16(x - hi): the
// accumulator of columns [16 kk, 16 kk + 16) is the A fragment of k-step
// kk, so no value changes thread.
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h2);
      hi[kk][r] = bf16x2_bits(h2);
      lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }
}

// acc[64 x N] += (A_hi + A_lo)[64 x 64] B[64 x N], two products a k-step
// and box: A as split_frags' fragments, B the NC boxes of a [64][HD] tile
// from b_addr on (N = NC boxes of 64 columns, 32 at hd 32), read MN-major
// (its rows are the reduction), one box at a time
template <int HD, int NC = TileGeo<HD>::kChunks>
__device__ __forceinline__ void mma_split(float (&acc)[NC][TileGeo<HD>::kAcc],
                                          const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4],
                                          uint32_t b_addr) {
  using G = TileGeo<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t db = mat_desc<HD>(b_addr + c * G::kChunkBytes +
                                       kk * 16 * G::kSwizzle);
      mma_rs(acc[c], hi[kk], db);
      mma_rs(acc[c], lo[kk], db);
    }
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
// one TileGeo<hd> box: 64 rows of one head, hd 32 or 64 columns, swizzled
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
  const cuuint32_t box[4] = {chunk, 1, static_cast<cuuint32_t>(kRows), 1};
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

// The map of a contiguous bf16 [d2][d1][d0] tensor (d0 innermost) whose
// box is `box1` rows of 64 columns of one d2 slice, swizzled 128 bytes as
// the wgmma descriptors read it; reads past d0, or past d1 within a
// slice, are zeros.  TMA needs a 16-byte-aligned base and row stride: d0
// a multiple of 8.  Returns a cudaError_t code.
inline int encode_3d(CUtensorMap* map, const void* base, int d0, int d1,
                     int d2, int box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(base) % 16 || d0 <= 0 || d0 % 8 ||
      d1 <= 0 || d2 <= 0 || box1 <= 0 || box1 > 256)
    return cudaErrorInvalidValue;
  const cuuint64_t row = static_cast<cuuint64_t>(d0) * 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {row, row * static_cast<cuuint64_t>(d1)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace repro
