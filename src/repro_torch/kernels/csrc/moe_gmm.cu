// Grouped (per-expert) matrix product for Hopper: out [E, C, F] =
// x [E, C, D] @ w [E, D, F] for every expert e, f32 accumulation, output
// in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py `_kernel` (reached
// through `moe_gmm`), whose grid is (expert, row block, column block, k
// block) with the k axis sequential and an f32 VMEM accumulator, on a
// capacity C and widths that the blocks divide.  Here one block owns one
// (bm, bn) output tile of one expert (grid z is the expert) and walks k
// itself through the port's shared tile loop (tile_mm.cuh: bf16 on
// mma.sync tensor-core instructions, f32 on CUDA-core FMAs so that no
// TF32 enters), keeping the f32 sums in registers; rows, columns and k
// beyond the matrices are masked, so any capacity C works
// (`capacity()` = max(8, ceil(t k / E * 1.25)) is rarely a tile multiple).
//
// Bound on the H100: bytes at granite-moe-3b-a800m's shapes (4096 tokens,
// C 1024: 2 C flops per weight byte and 2 F per activation byte, ~340
// flops a byte, near bf16's ~295 balance, so the two bounds are close);
// the weights of all 40 experts are read once.  Design: the plain tile
// loop, one launch for all experts; the backward products (dx = dy w^T,
// dw = x^T dy) are the same kernel on transposed copies.  wgmma/TMA tiles
// are later work.
#include "tile_mm.cuh"

namespace {

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(repro::kTileThreads)
    moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int c, int d, int f) {
  extern __shared__ __align__(16) char smem[];
  const int64_t e = blockIdx.z;
  const T* xe = x + e * c * d;
  const T* we = w + e * d * f;
  T* oe = out + e * c * f;
  repro::TileMM<T, BM, BN, BK> mm;
  const int tm = blockIdx.y, tn = blockIdx.x;
  mm.run(xe, we, c, d, f, tm, tn, smem);
  const int row0 = tm * BM, col0 = tn * BN;
  mm.for_each([&](int r, int cc, float& v) {
    const int gr = row0 + r, gc = col0 + cc;
    if (gr < c && gc < f) oe[int64_t(gr) * f + gc] = repro::from_float<T>(v);
  });
}

template <typename T>
struct Launch {
  const void* x;
  const void* w;
  void* out;
  int e, c, d, f;
  cudaStream_t stream;

  template <int BM, int BN, int BK>
  int run() {
    using MM = repro::TileMM<T, BM, BN, BK>;
    auto kern = moe_gmm_kernel<T, BM, BN, BK>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MM::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((f + BN - 1) / BN, (c + BM - 1) / BM, e);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    kern<<<grid, repro::kTileThreads, MM::kSmem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), c, d, f);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// x [e, c, d], w [e, d, f], out [e, c, f]: contiguous, dtype code `dtype`;
// block sizes (bm, bn, bk) one of the instantiated set (tile_mm.cuh).
// Returns a cudaError_t code (0 on success).
extern "C" int repro_moe_gmm(const void* x, const void* w, void* out, int e,
                             int c, int d, int f, int bm, int bn, int bk,
                             int dtype, void* stream) {
  if (e <= 0 || c <= 0 || d <= 0 || f <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    Launch<float> l{x, w, out, e, c, d, f, s};
    return repro::dispatch_blocks(bm, bn, bk, l);
  }
  if (dtype == repro::kBF16) {
    Launch<__nv_bfloat16> l{x, w, out, e, c, d, f, s};
    return repro::dispatch_blocks(bm, bn, bk, l);
  }
  return cudaErrorInvalidValue;
}
