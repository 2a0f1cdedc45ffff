// Tiled matrix product for Hopper: out [m, n] = x [m, k] @ w [k, n], f32
// accumulation, output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/collective_matmul.py
// `_mm_tile_kernel` (reached through `pallas_tile_matmul`), whose grid is
// (m/bm, n/bn, k/bk) with the k axis sequential and an f32 VMEM
// accumulator carried across k steps, on inputs padded to the blocks.
// Here one block owns one (bm, bn) output tile and walks k itself in
// steps of bk (gemm_tc.cuh, tile_mm.cuh), keeping the f32 sums in
// registers; the ragged edge is masked (or zero-filled by TMA) instead of
// padded.  The block sizes come from kernels/autotune.py.
//
// Bound on the H100: operations at the training shapes (a [2048, 1024] @
// [1024, 2048] product does 2 * 2048 flops per element it moves, far above
// the ~295 flop-per-byte balance of bf16); bytes only for skinny products.
// Design: bf16 operands that TMA can describe (kernels/autotune.py
// gemm_path) on the tensor-core tile (gemm_tc.cuh: wgmma fed by TMA, a
// 4-stage ring, 128 x 128 or 128 x 256); other bf16 operands on
// tile_mm.cuh's mma.sync tile; f32 on CUDA-core FMAs so TF32 stays off and
// the f32 results match the JAX package's full-f32 products.
#include "gemm_tc.cuh"
#include "tile_mm.cuh"

namespace {

namespace gm = repro::gemm;

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(repro::kTileThreads)
    tile_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ out, int m, int k, int n) {
  extern __shared__ __align__(16) char smem[];
  repro::TileMM<T, BM, BN, BK> mm;
  const int tm = blockIdx.y, tn = blockIdx.x;
  mm.run(x, w, m, k, n, tm, tn, smem);
  const int row0 = tm * BM, col0 = tn * BN;
  mm.for_each([&](int r, int c, float& v) {
    const int gr = row0 + r, gc = col0 + c;
    if (gr < m && gc < n) out[int64_t(gr) * n + gc] = repro::from_float<T>(v);
  });
}

template <int BN>
__global__ void __launch_bounds__(gm::kThreads, 1)
    tile_matmul_tc_kernel(const __grid_constant__ gm::Maps maps,
                          __nv_bfloat16* __restrict__ out, int m, int k,
                          int n) {
  extern __shared__ __align__(16) uint8_t gemm_smem[];
  gm::TcTile<BN, false, false> mm;
  mm.init(gemm_smem);
  const int m0 = blockIdx.y * gm::kBM, n0 = blockIdx.x * BN;
  if (threadIdx.x >= gm::kConsumers) {
    if (threadIdx.x == gm::kConsumers)
      mm.produce(&maps.a, &maps.b, 0, 0, m0, n0, k);
    return;
  }
  mm.consume(k);
  mm.store(out, n, m, n, m0, n0);
}

template <typename T>
struct Launch {
  const void* x;
  const void* w;
  void* out;
  int m, k, n;
  cudaStream_t stream;

  template <int BM, int BN, int BK>
  int run() {
    using MM = repro::TileMM<T, BM, BN, BK>;
    auto kern = tile_matmul_kernel<T, BM, BN, BK>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MM::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    kern<<<grid, repro::kTileThreads, MM::kSmem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), m, k, n);
    return static_cast<int>(cudaGetLastError());
  }
};

struct LaunchTc {
  const void* x;
  const void* w;
  void* out;
  int m, k, n;
  cudaStream_t stream;

  template <int BN>
  int run() {
    using MM = gm::TcTile<BN, false, false>;
    gm::Maps maps;
    int rc = gm::encode_maps<BN, false, false>(&maps, x, w, 1, 1, m, k, n);
    if (rc != 0) return rc;
    auto kern = tile_matmul_tc_kernel<BN>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MM::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((n + BN - 1) / BN, (m + gm::kBM - 1) / gm::kBM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    kern<<<grid, gm::kThreads, MM::kSmem, stream>>>(
        maps, static_cast<__nv_bfloat16*>(out), m, k, n);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// x [m, k], w [k, n], out [m, n]: contiguous, dtype code `dtype`.  tc = 1:
// the tensor-core tile (bf16; block sizes one of gemm_tc.cuh's); tc = 0:
// tile_mm.cuh's tile (block sizes one of its instantiated set).  Returns a
// cudaError_t code (0 on success).
extern "C" int repro_tile_matmul(const void* x, const void* w, void* out,
                                 int m, int k, int n, int bm, int bn, int bk,
                                 int dtype, int tc, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype != repro::kBF16) return cudaErrorInvalidValue;
    LaunchTc l{x, w, out, m, k, n, s};
    return gm::dispatch_tc(bm, bn, bk, l);
  }
  if (dtype == repro::kF32) {
    Launch<float> l{x, w, out, m, k, n, s};
    return repro::dispatch_blocks(bm, bn, bk, l);
  }
  if (dtype == repro::kBF16) {
    Launch<__nv_bfloat16> l{x, w, out, m, k, n, s};
    return repro::dispatch_blocks(bm, bn, bk, l);
  }
  return cudaErrorInvalidValue;
}
