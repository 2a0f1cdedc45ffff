// Fused matmul -> reduce-scatter ring for Hopper: one rank's kernel.
//
// Replaces the TPU kernel src/repro/kernels/collective_matmul.py
// `_rs_ring_kernel` (reached through `pallas_matmul_reducescatter`, and
// through `fused_matmul_allreduce` for every row-parallel exit under the
// `fused` schedule).  Rank i of n holds x [n * chunk, k_local] and
// w [k_local, d]; the group's result is sum over ranks of (x @ w), and rank
// i keeps its chunk i [chunk, d].  At step s = 0 .. n-1 rank i computes
// the product of x's chunk c = (i - 1 - s) mod n, adds the f32 partial
// that its left neighbour sent at step s - 1, and (s < n - 1) stores the
// sum into its right neighbour's landing slot; after n steps it holds
// chunk i summed over all ranks and casts it once.
//
// What differs from the TPU kernel: its grid is (n,) sequential, one
// whole-chunk matmul per step, with the chunks pre-rolled on the host so
// step s reads a static block, and DMA semaphores between neighbours.  Here
// one block owns one output tile (bm x bn of the chunk) through all n
// steps, computing the chunk index itself, and the neighbours' flags are
// per tile: tiles pipeline independently, and no block ever waits for
// another block of its own launch, only for the same tile of its
// neighbours' launches.  The TPU kernel's flow control carries over: the
// partials and the landing slots are f32 with two slots, and the receiver
// acknowledges each slot it consumed before the sender may fill that slot
// again two steps later.  Flags are tagged with a counter the host grows
// by n - 1 every call (the send of step s carries tag base + s + 1, in
// slot tag % 2), so back-to-back calls need no reset or drain; at its
// first use of each slot in a call a sender waits until its right
// neighbour has started this call (so has ended the previous one and
// consumed everything sent then).  Sends are plain stores into the peer's
// memory through the peer pointer, a system-scope fence, and a release
// store of the tag; waits are acquire loads with __nanosleep and a timeout
// (peer.cuh).
//
// Bound on the H100: operations, those of the product (2 * rows * k_local
// * d), plus the (n - 1) chunk-sized f32 partials each rank writes to and
// reads from its neighbours.  The per-step product: bf16 operands that
// TMA can describe (kernels/autotune.py gemm_path) on the tensor-core tile
// (gemm_tc.cuh: wgmma fed by TMA; x read through a 3-D map over [n][chunk]
// [k], so a chunk's ragged last tile reads zeros, not the next chunk's
// rows; the producer warp loads every step's tiles and leaves, and the
// 256 consumers run the steps and the flags, syncing on their own named
// barrier; the stage ring's phases carry from one step's product to the
// next; 128 x 128 tiles with the epilogue staged through shared memory,
// which keeps the block within its 168 registers a thread); other bf16
// on tile_mm.cuh's mma.sync tile, f32 on its FMAs.  Both share
// ring_steps, the flag protocol above.
#include <cstdint>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "peer.cuh"
#include "tile_mm.cuh"

namespace {

using namespace repro::peer;
namespace gm = repro::gemm;

// the chunk whose product rank `rank` of n adds at ring step s
__device__ __forceinline__ int step_chunk(int rank, int s, int n) {
  return ((rank - 1 - s) % n + 2 * n) % n;
}

// The block's output tile (tm, tn) through the n ring steps;
// product(c) leaves chunk c's product of the tile in mm's accumulators and
// sync() is a barrier of every thread that runs this.
template <typename T, int BM, int BN, typename MM, typename Product,
          typename Sync>
__device__ __forceinline__ void ring_steps(MM& mm, const Product& product,
                                           const Sync& sync,
                                           char* const* __restrict__ ws,
                                           int rank, int n, size_t slot,
                                           T* __restrict__ out, int chunk,
                                           int d, int tm, int tn,
                                           uint32_t base, int* err) {
  const int tiles_n = (d + BN - 1) / BN;
  const int tile = tm * tiles_n + tn;
  const int row0 = tm * BM, col0 = tn * BN;
  const int left = (rank + n - 1) % n, right = (rank + 1) % n;
  uint32_t* own = flags(ws[rank]);
  uint32_t* rflags = flags(ws[right]);
  uint32_t* lflags = flags(ws[left]);
  if (threadIdx.x == 0) st_release(lflags + kRingStarted, base + 1);

  for (int s = 0; s < n; ++s) {
    product(step_chunk(rank, s, n));
    if (s > 0) {
      // the partial the left neighbour sent at step s - 1
      const uint32_t tag = base + s;
      const int j = tag & 1;
      if (threadIdx.x == 0)
        wait_geq(own + kRingReady + j * kMaxRingTiles + tile, tag, err,
                 kErrRingTimeout);
      sync();
      const float* land =
          reinterpret_cast<const float*>(ring_slot(ws[rank], slot, j));
      mm.for_each([&](int r, int cc, float& v) {
        const int gr = row0 + r, gc = col0 + cc;
        if (gr < chunk && gc < d) v += land[int64_t(gr) * d + gc];
      });
      sync();
      if (threadIdx.x == 0)
        st_release(lflags + kRingAck + j * kMaxRingTiles + tile, tag);
    }
    if (s < n - 1) {
      const uint32_t tag = base + s + 1;
      const int j = tag & 1;
      if (threadIdx.x == 0) {
        if (s < 2)
          wait_geq(own + kRingStarted, base + 1, err, kErrRingTimeout);
        else
          wait_geq(own + kRingAck + j * kMaxRingTiles + tile, tag - 2, err,
                   kErrRingTimeout);
      }
      sync();
      float* land = reinterpret_cast<float*>(ring_slot(ws[right], slot, j));
      mm.for_each([&](int r, int cc, float& v) {
        const int gr = row0 + r, gc = col0 + cc;
        if (gr < chunk && gc < d) land[int64_t(gr) * d + gc] = v;
      });
      __threadfence_system();
      sync();
      if (threadIdx.x == 0)
        st_release(rflags + kRingReady + j * kMaxRingTiles + tile, tag);
    } else {
      mm.for_each([&](int r, int cc, float& v) {
        const int gr = row0 + r, gc = col0 + cc;
        if (gr < chunk && gc < d)
          out[int64_t(gr) * d + gc] = repro::from_float<T>(v);
      });
    }
  }
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(repro::kTileThreads)
    ring_mm_rs_kernel(char* const* __restrict__ ws, int rank, int n,
                      size_t slot, const T* __restrict__ x,
                      const T* __restrict__ w, T* __restrict__ out, int chunk,
                      int k, int d, uint32_t base, int* err) {
  extern __shared__ __align__(16) char smem[];
  repro::TileMM<T, BM, BN, BK> mm;
  const int tiles_n = (d + BN - 1) / BN;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x % tiles_n;
  ring_steps<T, BM, BN>(
      mm,
      [&](int c) {
        mm.run(x + int64_t(c) * chunk * k, w, chunk, k, d, tm, tn, smem);
      },
      [] { __syncthreads(); }, ws, rank, n, slot, out, chunk, d, tm, tn,
      base, err);
}

template <int BN>
__global__ void __launch_bounds__(gm::kThreads, 1)
    ring_mm_rs_tc_kernel(const __grid_constant__ gm::Maps maps,
                         char* const* __restrict__ ws, int rank, int n,
                         size_t slot, __nv_bfloat16* __restrict__ out,
                         int chunk, int k, int d, uint32_t base, int* err) {
  extern __shared__ __align__(16) uint8_t gemm_smem[];
  gm::TcTile<BN, false, false, true> mm;
  mm.init(gemm_smem);
  const int tiles_n = (d + BN - 1) / BN;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x % tiles_n;
  if (threadIdx.x >= gm::kConsumers) {
    if (threadIdx.x == gm::kConsumers)
      for (int s = 0; s < n; ++s)
        mm.produce(&maps.a, &maps.b, step_chunk(rank, s, n), 0,
                   tm * gm::kBM, tn * BN, k);
    return;
  }
  ring_steps<__nv_bfloat16, gm::kBM, BN>(
      mm, [&](int) { mm.consume(k); }, [] { gm::consumer_sync(); }, ws, rank,
      n, slot, out, chunk, d, tm, tn, base, err);
}

template <typename T>
struct Launch {
  char* const* ws;
  int rank, n;
  size_t slot;
  const void* x;
  const void* w;
  void* out;
  int chunk, k, d;
  uint32_t base;
  int* err;
  cudaStream_t stream;

  template <int BM, int BN, int BK>
  int run() {
    using MM = repro::TileMM<T, BM, BN, BK>;
    const long long tiles =
        static_cast<long long>((chunk + BM - 1) / BM) * ((d + BN - 1) / BN);
    if (tiles > kMaxRingTiles) return cudaErrorInvalidValue;
    auto kern = ring_mm_rs_kernel<T, BM, BN, BK>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MM::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<static_cast<unsigned>(tiles), repro::kTileThreads, MM::kSmem,
           stream>>>(ws, rank, n, slot, static_cast<const T*>(x),
                     static_cast<const T*>(w), static_cast<T*>(out), chunk, k,
                     d, base, err);
    return static_cast<int>(cudaGetLastError());
  }
};

struct LaunchTc {
  char* const* ws;
  int rank, n;
  size_t slot;
  const void* x;
  const void* w;
  void* out;
  int chunk, k, d;
  uint32_t base;
  int* err;
  cudaStream_t stream;

  template <int BN>
  int run() {
    using MM = gm::TcTile<BN, false, false, true>;
    const long long tiles = static_cast<long long>(
        (chunk + gm::kBM - 1) / gm::kBM) * ((d + BN - 1) / BN);
    if (tiles > kMaxRingTiles) return cudaErrorInvalidValue;
    gm::Maps maps;
    int rc = gm::encode_maps<BN, false, false>(&maps, x, w, n, 1, chunk, k,
                                               d);
    if (rc != 0) return rc;
    auto kern = ring_mm_rs_tc_kernel<BN>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MM::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<static_cast<unsigned>(tiles), gm::kThreads, MM::kSmem, stream>>>(
        maps, ws, rank, n, slot, static_cast<__nv_bfloat16*>(out), chunk, k,
        d, base, err);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// ws: device array of the n ranks' workspace pointers (peer.cuh); x
// [n * chunk, k], w [k, d], out [chunk, d] contiguous of dtype code
// `dtype`; chunk * d * 4 <= slot.  tc = 1: the tensor-core tile (bf16;
// block sizes one of gemm_tc.cuh's); tc = 0: tile_mm.cuh's.  `base` is
// the tag counter before this call (the caller adds n - 1 after it).
// Returns a cudaError_t code.
extern "C" int repro_ring_matmul_rs(const void* ws, int rank, int n,
                                    long long slot, const void* x,
                                    const void* w, void* out, int chunk,
                                    int k, int d, int bm, int bn, int bk,
                                    unsigned base, int dtype, int tc,
                                    void* err, void* stream) {
  if (n < 2 || n > kMaxRanks || rank < 0 || rank >= n || chunk <= 0 ||
      k <= 0 || d <= 0 ||
      static_cast<long long>(chunk) * d * 4 > slot)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto wsp = static_cast<char* const*>(ws);
  if (tc) {
    if (dtype != repro::kBF16) return cudaErrorInvalidValue;
    // 128 x 128 only: 128 x 256 and its staged tile exceed shared memory
    if (bm != gm::kBM || bn != 128 || bk != gm::kBK)
      return cudaErrorInvalidValue;
    LaunchTc l{wsp, rank, n, static_cast<size_t>(slot), x, w, out, chunk, k,
               d, base, static_cast<int*>(err), s};
    return l.run<128>();
  }
  if (dtype == repro::kF32) {
    Launch<float> l{wsp, rank, n, static_cast<size_t>(slot), x, w, out,
                    chunk, k, d, base, static_cast<int*>(err), s};
    return repro::dispatch_blocks(bm, bn, bk, l);
  }
  if (dtype == repro::kBF16) {
    Launch<__nv_bfloat16> l{wsp, rank, n, static_cast<size_t>(slot), x, w,
                            out, chunk, k, d, base, static_cast<int*>(err), s};
    return repro::dispatch_blocks(bm, bn, bk, l);
  }
  return cudaErrorInvalidValue;
}
