// Mamba2 chunked SSD (state-space duality) forward for Hopper:
// y [b, s, h, p] from x [b, s, h, p] (x's dtype), dt [b, s, h] f32 (the
// post-softplus step), A_log [h] f32, B, C [b, s, n] (x's dtype, one group
// shared by every head) and D [h] f32; f32 math, y in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py `_kernel` (reached
// through `ssd`), whose grid is (batch, head, chunk) with the chunk axis
// sequential and the inter-chunk state S [p, n] carried in VMEM scratch.
// Carried over, that grid gives b * h blocks (24 at mamba2-130m's b 1) for
// 132 SMs.  Here the chunk-parallel form of models/ssd.py `ssd_chunked`
// runs as three launches:
//
//   1. ssd_state_kernel, block (chunk, head, batch): the chunk's own state
//      S_c = sum_j exp(la_last - la_j) dt_j x_j B_j^T  [p, n], and its
//      total decay exp(la_last), into f32 scratch;
//   2. ssd_scan_kernel, one thread per (batch, head, state element): the
//      short scan over the nc chunk states, in place, leaving in slot c
//      the state BEFORE chunk c;
//   3. ssd_out_kernel, block (chunk, head, batch):
//      y_i = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) dt_j x_j
//            + exp(la_i) C_i . S_prev + D x_i.
//
// la is the inclusive cumulative sum of dt * a (a = -exp(A_log)) inside
// the chunk.  At mamba2-130m's shape (b 1, s 4096, h 24, p 64, n 128,
// chunk 128) launches 1 and 3 have 768 blocks each.
//
// Bound on the H100: operations, f32.  The least work at mamba2-130m's
// shape is 4.1 GFLOP against 28 MB moved (kernels/bounds.py `ssd_work`:
// C B^T once per chunk over the causal pairs, then per head the masked
// product, C S^T and the state).  This design does 8.1 GFLOP: per chunk
// and head 2 q^2 n for C B^T (recomputed per head although B and C are
// shared by the heads), 2 q^2 p for the masked product over all q^2
// pairs, and 2 q n p each for C S^T and the state.  CUDA-core FMAs in f32
// on tiles held in shared memory (a 16 x 16 thread grid, each thread a
// register tile of outputs); the products on tensor cores (TF32 or bf16
// with f32 accumulation) are later work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kQ = 128;         // largest chunk
constexpr int kBN = 128;        // state columns per strip (launch 1)
constexpr int kNC = 32;         // n per step of the C B^T and C S^T products

// la[0..q) holds dt * a on entry; warp 0 turns it into its inclusive
// prefix sum in place (4 values a lane, then a shuffle scan of the lane
// totals).  Ends with __syncthreads().
__device__ __forceinline__ void chunk_cumsum(float* la, int q) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane * 4 + k;
      run += (i < q) ? la[i] : 0.f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane * 4 + k;
      if (i < q) la[i] = excl + v[k];
    }
  }
  __syncthreads();
}

// la of the chunk starting at token row0 (of b * s) for head hh
__device__ __forceinline__ void load_la(float* la, const float* __restrict__ dt,
                                        int64_t row0, int h, int hh, float a,
                                        int q) {
  for (int i = threadIdx.x; i < q; i += kThreads)
    la[i] = dt[(row0 + i) * h + hh] * a;
  chunk_cumsum(la, q);
}

// Launch 1.  Shared: la [kQ], xw [kQ][p+1] (exp(la_last - la_j) dt_j x_j),
// bs [kQ][kBN+1] (a strip of B).  Thread (ty, tx) owns state rows
// ty + 16 i (i < PT) and strip columns tx + 16 k (k < 8).
template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
    ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A_log,
                     const T* __restrict__ B, float* __restrict__ states,
                     float* __restrict__ decay, int s, int h, int p, int n,
                     int q) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ldx = p + 1;
  float* la = sm;
  float* xw = la + kQ;
  float* bs = xw + kQ * ldx;
  const int64_t row0 = int64_t(bb) * s + int64_t(c) * q;
  const float a = -expf(A_log[hh]);
  load_la(la, dt, row0, h, hh, a, q);
  const float last = la[q - 1];
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int j = idx / p, pp = idx - j * p;
    const int64_t r = row0 + j;
    const float xdt = repro::to_float(x[(r * h + hh) * p + pp]) *
                      dt[r * h + hh];
    xw[j * ldx + pp] = expf(last - la[j]) * xdt;
  }
  const int64_t sbase = ((int64_t(bb) * h + hh) * nc + c) * int64_t(p) * n;
  for (int n0 = 0; n0 < n; n0 += kBN) {
    __syncthreads();  // xw written; the previous strip consumed
    for (int idx = tid; idx < q * kBN; idx += kThreads) {
      const int j = idx / kBN, k = idx - j * kBN;
      bs[j * (kBN + 1) + k] =
          (n0 + k < n) ? repro::to_float(B[(row0 + j) * n + n0 + k]) : 0.f;
    }
    __syncthreads();
    float acc[PT][8];
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
    for (int j = 0; j < q; ++j) {
      float av[PT], bv[8];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int pp = ty + 16 * i;
        av[i] = pp < p ? xw[j * ldx + pp] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) bv[k] = bs[j * (kBN + 1) + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
    }
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int pp = ty + 16 * i;
      if (pp >= p) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = n0 + tx + 16 * k;
        if (col < n) states[sbase + int64_t(pp) * n + col] = acc[i][k];
      }
    }
  }
  if (tid == 0) decay[(int64_t(bb) * h + hh) * nc + c] = expf(last);
}

// Launch 2.  states [b*h][nc][p*n]: S_c in, the state before chunk c out.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(float* __restrict__ states,
                    const float* __restrict__ decay, int nc, int pn) {
  const int64_t bh = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  float* st = states + bh * nc * int64_t(pn) + e;
  const float* dc = decay + bh * nc;
  float carry = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float sc = st[int64_t(c) * pn];
    st[int64_t(c) * pn] = carry;
    carry = carry * dc[c] + sc;
  }
}

// Launch 3.  Shared: la [kQ], xdt [kQ][p+1] (dt_j x_j), cb [kQ][kQ+1]
// (masked, decayed C B^T), cs and bs [kQ][kNC+1] (n-steps of C and B; bs
// later holds an n-step of S_prev as [kNC][p+1]).  Thread (ty, tx) owns
// rows ty + 16 i (i < 8) and, of C B^T, columns tx + 16 k (k < 8), of y,
// columns tx + 16 k (k < PT).
template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
    ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A_log, const T* __restrict__ B,
                   const T* __restrict__ C, const float* __restrict__ D,
                   const float* __restrict__ states, T* __restrict__ y,
                   int s, int h, int p, int n, int q) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ldx = p + 1;
  constexpr int kLC = kNC + 1, kLB = kQ + 1;
  float* la = sm;
  float* xdt = la + kQ;
  float* cb = xdt + kQ * ldx;
  float* cs = cb + kQ * kLB;
  float* bs = cs + kQ * kLC;
  const int64_t row0 = int64_t(bb) * s + int64_t(c) * q;
  const float a = -expf(A_log[hh]);
  load_la(la, dt, row0, h, hh, a, q);
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int j = idx / p, pp = idx - j * p;
    const int64_t r = row0 + j;
    xdt[j * ldx + pp] =
        repro::to_float(x[(r * h + hh) * p + pp]) * dt[r * h + hh];
  }

  // C B^T over n, kNC at a time
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
  for (int n0 = 0; n0 < n; n0 += kNC) {
    __syncthreads();
    for (int idx = tid; idx < kQ * kNC; idx += kThreads) {
      const int i = idx / kNC, k = idx - i * kNC;
      const bool in = i < q && n0 + k < n;
      cs[i * kLC + k] = in ? repro::to_float(C[(row0 + i) * n + n0 + k]) : 0.f;
      bs[i * kLC + k] = in ? repro::to_float(B[(row0 + i) * n + n0 + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kNC; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = cs[(ty + 16 * i) * kLC + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[(tx + 16 * j) * kLC + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      cb[r * kLB + col] =
          (col <= r && r < q) ? acc[i][j] * expf(la[r] - la[col]) : 0.f;
    }
  }
  __syncthreads();

  // intra-chunk: sum_j cb[i][j] xdt[j][:]
  float ya[8][PT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < PT; ++k) ya[i][k] = 0.f;
  for (int j = 0; j < q; ++j) {
    float av[8], bv[PT];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = cb[(ty + 16 * i) * kLB + j];
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int pp = tx + 16 * k;
      bv[k] = pp < p ? xdt[j * ldx + pp] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < PT; ++k) ya[i][k] = fmaf(av[i], bv[k], ya[i][k]);
  }

  // inter-chunk: C_i . S_prev[pp][:], kNC at a time
  float yb[8][PT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < PT; ++k) yb[i][k] = 0.f;
  const float* sp = states + ((int64_t(bb) * h + hh) * nc + c) * int64_t(p) * n;
  float* ss = bs;  // [kNC][p+1]
  for (int n0 = 0; n0 < n; n0 += kNC) {
    __syncthreads();
    for (int idx = tid; idx < kQ * kNC; idx += kThreads) {
      const int i = idx / kNC, k = idx - i * kNC;
      cs[i * kLC + k] = (i < q && n0 + k < n)
                            ? repro::to_float(C[(row0 + i) * n + n0 + k])
                            : 0.f;
    }
    for (int idx = tid; idx < p * kNC; idx += kThreads) {
      const int pp = idx / kNC, k = idx - pp * kNC;
      ss[k * ldx + pp] = (n0 + k < n) ? sp[int64_t(pp) * n + n0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kNC; ++k) {
      float av[8], bv[PT];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = cs[(ty + 16 * i) * kLC + k];
#pragma unroll
      for (int m = 0; m < PT; ++m) {
        const int pp = tx + 16 * m;
        bv[m] = pp < p ? ss[k * ldx + pp] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int m = 0; m < PT; ++m) yb[i][m] = fmaf(av[i], bv[m], yb[i][m]);
    }
  }

  const float dh = D[hh];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= q) continue;
    const float el = expf(la[r]);
    const int64_t base = ((row0 + r) * h + hh) * p;
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int pp = tx + 16 * k;
      if (pp >= p) continue;
      const float xv = repro::to_float(x[base + pp]);
      y[base + pp] = repro::from_float<T>(ya[i][k] + el * yb[i][k] + dh * xv);
    }
  }
}

size_t state_smem(int p) {
  return sizeof(float) * (kQ + kQ * (p + 1) + kQ * (kBN + 1));
}

size_t out_smem(int p) {
  return sizeof(float) *
         (kQ + kQ * (p + 1) + kQ * (kQ + 1) + 2 * kQ * (kNC + 1));
}

template <typename T, int PT>
int launch(const void* x, const float* dt, const float* A_log, const void* B,
           const void* C, const float* D, void* y, float* states,
           float* decay, int b, int s, int h, int p, int n, int q,
           cudaStream_t st) {
  const int nc = s / q;
  const size_t sm1 = state_smem(p), sm3 = out_smem(p);
  auto k1 = ssd_state_kernel<T, PT>;
  auto k3 = ssd_out_kernel<T, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sm1));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sm3));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nc, h, b);
  k1<<<grid, kThreads, sm1, st>>>(static_cast<const T*>(x), dt, A_log,
                                  static_cast<const T*>(B), states, decay, s,
                                  h, p, n, q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pn = p * n;
  ssd_scan_kernel<<<dim3((pn + kThreads - 1) / kThreads, b * h), kThreads, 0,
                    st>>>(states, decay, nc, pn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k3<<<grid, kThreads, sm3, st>>>(
      static_cast<const T*>(x), dt, A_log, static_cast<const T*>(B),
      static_cast<const T*>(C), D, states, static_cast<T*>(y), s, h, p, n, q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* A_log,
             const void* B, const void* C, const float* D, void* y,
             float* states, float* decay, int b, int s, int h, int p, int n,
             int q, cudaStream_t st) {
  if (p <= 32)
    return launch<T, 2>(x, dt, A_log, B, C, D, y, states, decay, b, s, h, p,
                        n, q, st);
  if (p <= 64)
    return launch<T, 4>(x, dt, A_log, B, C, D, y, states, decay, b, s, h, p,
                        n, q, st);
  return launch<T, 8>(x, dt, A_log, B, C, D, y, states, decay, b, s, h, p, n,
                      q, st);
}

}  // namespace

// x [b, s, h, p], B, C [b, s, n] (dtype code `dtype`), dt [b, s, h],
// A_log, D [h] f32 -> y [b, s, h, p] (x's dtype).  Scratch: states
// [b, h, s / q, p, n] and decay [b, h, s / q], f32.  All contiguous;
// chunk q in [1, 128] dividing s, p in [1, 128].  Returns a cudaError_t
// code (0 on success).
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A_log,
                             const void* B, const void* C, const void* D,
                             void* y, void* states, void* decay, int b, int s,
                             int h, int p, int n, int q, int dtype,
                             void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || q <= 0 || q > kQ ||
      p > 128 || s % q || h > 65535 || b > 65535 || int64_t(b) * h > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A_log);
  const auto* df = static_cast<const float*>(D);
  auto* sf = static_cast<float*>(states);
  auto* cf = static_cast<float*>(decay);
  if (dtype == repro::kF32)
    return launch_p<float>(x, dtf, af, B, C, df, y, sf, cf, b, s, h, p, n, q,
                           st);
  if (dtype == repro::kBF16)
    return launch_p<__nv_bfloat16>(x, dtf, af, B, C, df, y, sf, cf, b, s, h,
                                   p, n, q, st);
  return cudaErrorInvalidValue;
}
