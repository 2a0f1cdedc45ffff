// Grouped (per-expert) matrix product for Hopper: out [E, M, N] =
// op(A) [E, M, K] @ op(B) [E, K, N] for every expert e, f32 accumulation,
// output in A's dtype.  The forward is x [E, C, D] @ w [E, D, F]; the
// backward's dx = dy w^T and dw = x^T dy read w and x where they lie.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py `_kernel` (reached
// through `moe_gmm`), whose grid is (expert, row block, column block, k
// block) with the k axis sequential and an f32 VMEM accumulator, on a
// capacity C and widths that the blocks divide.  Here one block owns one
// output tile of one expert (grid z is the expert) and walks k itself,
// keeping the f32 sums in registers; any capacity C works
// (`capacity()` = max(8, ceil(t k / E * 1.25)) is rarely a tile multiple).
//
// bf16 operands that TMA can describe (kernels/autotune.py gemm_path:
// 16-byte-aligned bases, contiguous extents a multiple of 8) run the
// tensor-core tile (gemm_tc.cuh: wgmma fed by TMA, 128 x 128 or 128 x 256,
// 3-D tensor maps whose third dimension is the expert, so a ragged C
// reads zeros, not the next expert's rows).  A is K-major ([M][K]) or,
// with `ta`, MN-major ([K][M]: dw's x^T read from x [C, D]); B MN-major
// ([K][N]) or, with `tb`, K-major ([N][K]: dx's w^T read from w [D, F]);
// so the backward copies nothing.  Other bf16 operands run tile_mm.cuh's
// mma.sync tile and f32 its CUDA-core FMAs (no TF32 enters), both on A
// [M][K] and B [K][N] only: the wrapper makes the transposed copies for
// those.
//
// Bound on the H100: operations at granite-moe-3b-a800m's shapes (4096
// tokens, C 1024: 2 C flops per weight byte and 2 F per activation byte,
// ~340 flops a byte, near bf16's ~295 balance, so the two bounds are
// close); the weights of all 40 experts are read once.
#include "gemm_tc.cuh"
#include "tile_mm.cuh"

namespace {

namespace gm = repro::gemm;

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

template <int BN, bool TA, bool TB>
__global__ void __launch_bounds__(gm::kThreads, 1)
    moe_gmm_tc_kernel(const __grid_constant__ gm::Maps maps,
                      __nv_bfloat16* __restrict__ out, int m, int k, int n) {
  extern __shared__ __align__(16) uint8_t gemm_smem[];
  gm::TcTile<BN, TA, TB> mm;
  mm.init(gemm_smem);
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * gm::kBM, n0 = blockIdx.x * BN;
  if (threadIdx.x >= gm::kConsumers) {
    if (threadIdx.x == gm::kConsumers)
      mm.produce(&maps.a, &maps.b, e, e, m0, n0, k);
    return;
  }
  mm.consume(k);
  mm.store(out + static_cast<int64_t>(e) * m * n, n, m, n, m0, n0);
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

template <bool TA, bool TB>
struct LaunchTc {
  const void* a;
  const void* b;
  void* out;
  int e, m, k, n;
  cudaStream_t stream;

  template <int BN>
  int run() {
    using MM = gm::TcTile<BN, TA, TB>;
    gm::Maps maps;
    int rc = gm::encode_maps<BN, TA, TB>(&maps, a, b, e, e, m, k, n);
    if (rc != 0) return rc;
    auto kern = moe_gmm_tc_kernel<BN, TA, TB>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MM::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + BN - 1) / BN, (m + gm::kBM - 1) / gm::kBM, e);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    kern<<<grid, gm::kThreads, MM::kSmem, stream>>>(
        maps, static_cast<__nv_bfloat16*>(out), m, k, n);
    return static_cast<int>(cudaGetLastError());
  }
};

template <bool TA, bool TB>
int launch_tc(const void* a, const void* b, void* out, int e, int m, int k,
              int n, int bm, int bn, int bk, cudaStream_t s) {
  LaunchTc<TA, TB> l{a, b, out, e, m, k, n, s};
  return gm::dispatch_tc(bm, bn, bk, l);
}

}  // namespace

// out [e, m, n] = op(a) @ op(b) per expert: a [e, m, k] (or [e, k, m]
// with ta), b [e, k, n] (or [e, n, k] with tb), out contiguous of dtype
// code `dtype`.  tc = 1: the tensor-core tile (bf16 only; block sizes one
// of gemm_tc.cuh's; any ta, tb but both); tc = 0: tile_mm.cuh's tile
// (block sizes one of its instantiated set; ta = tb = 0).  Returns a
// cudaError_t code (0 on success).
extern "C" int repro_moe_gmm(const void* a, const void* b, void* out, int e,
                             int m, int k, int n, int ta, int tb, int bm,
                             int bn, int bk, int dtype, int tc,
                             void* stream) {
  if (e <= 0 || m <= 0 || k <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype != repro::kBF16) return cudaErrorInvalidValue;
    if (!ta && !tb) return launch_tc<false, false>(a, b, out, e, m, k, n, bm,
                                                   bn, bk, s);
    if (!ta && tb) return launch_tc<false, true>(a, b, out, e, m, k, n, bm,
                                                 bn, bk, s);
    if (ta && !tb) return launch_tc<true, false>(a, b, out, e, m, k, n, bm,
                                                 bn, bk, s);
    return cudaErrorInvalidValue;
  }
  if (ta || tb) return cudaErrorInvalidValue;
  if (dtype == repro::kF32) {
    Launch<float> l{a, b, out, e, m, k, n, s};
    return repro::dispatch_blocks(bm, bn, bk, l);
  }
  if (dtype == repro::kBF16) {
    Launch<__nv_bfloat16> l{a, b, out, e, m, k, n, s};
    return repro::dispatch_blocks(bm, bn, bk, l);
  }
  return cudaErrorInvalidValue;
}
