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
// reads from its neighbours.  The per-step product is tile_mm.cuh's
// (mma.sync for bf16, FMAs for f32).
#include <cstdint>

#include "common.cuh"
#include "peer.cuh"
#include "tile_mm.cuh"

namespace {

using namespace repro::peer;

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(repro::kTileThreads)
    ring_mm_rs_kernel(char* const* __restrict__ ws, int rank, int n,
                      size_t slot, const T* __restrict__ x,
                      const T* __restrict__ w, T* __restrict__ out, int chunk,
                      int k, int d, uint32_t base, int* err) {
  extern __shared__ __align__(16) char smem[];
  const int tiles_n = (d + BN - 1) / BN;
  const int tile = blockIdx.x;
  const int tm = tile / tiles_n, tn = tile % tiles_n;
  const int row0 = tm * BM, col0 = tn * BN;
  const int left = (rank + n - 1) % n, right = (rank + 1) % n;
  uint32_t* own = flags(ws[rank]);
  uint32_t* rflags = flags(ws[right]);
  uint32_t* lflags = flags(ws[left]);
  if (threadIdx.x == 0) st_release(lflags + kRingStarted, base + 1);

  repro::TileMM<T, BM, BN, BK> mm;
  for (int s = 0; s < n; ++s) {
    const int c = ((rank - 1 - s) % n + 2 * n) % n;
    mm.run(x + int64_t(c) * chunk * k, w, chunk, k, d, tm, tn, smem);
    if (s > 0) {
      // the partial the left neighbour sent at step s - 1
      const uint32_t tag = base + s;
      const int j = tag & 1;
      if (threadIdx.x == 0)
        wait_geq(own + kRingReady + j * kMaxRingTiles + tile, tag, err,
                 kErrRingTimeout);
      __syncthreads();
      const float* land =
          reinterpret_cast<const float*>(ring_slot(ws[rank], slot, j));
      mm.for_each([&](int r, int cc, float& v) {
        const int gr = row0 + r, gc = col0 + cc;
        if (gr < chunk && gc < d) v += land[int64_t(gr) * d + gc];
      });
      __syncthreads();
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
      __syncthreads();
      float* land = reinterpret_cast<float*>(ring_slot(ws[right], slot, j));
      mm.for_each([&](int r, int cc, float& v) {
        const int gr = row0 + r, gc = col0 + cc;
        if (gr < chunk && gc < d) land[int64_t(gr) * d + gc] = v;
      });
      __threadfence_system();
      __syncthreads();
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

}  // namespace

// ws: device array of the n ranks' workspace pointers (peer.cuh); x
// [n * chunk, k], w [k, d], out [chunk, d] contiguous of dtype code
// `dtype`; chunk * d * 4 <= slot.  `base` is the tag counter before this
// call (the caller adds n - 1 after it).  Returns a cudaError_t code.
extern "C" int repro_ring_matmul_rs(const void* ws, int rank, int n,
                                    long long slot, const void* x,
                                    const void* w, void* out, int chunk,
                                    int k, int d, int bm, int bn, int bk,
                                    unsigned base, int dtype, void* err,
                                    void* stream) {
  if (n < 2 || n > kMaxRanks || rank < 0 || rank >= n || chunk <= 0 ||
      k <= 0 || d <= 0 ||
      static_cast<long long>(chunk) * d * 4 > slot)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto wsp = static_cast<char* const*>(ws);
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
