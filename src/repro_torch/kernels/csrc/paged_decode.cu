// Paged single-token decode attention for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `_paged_kernel` (reached through `paged_flash_decode`).  On the TPU the
// grid is (slot, kv head, page) with the page axis sequential: the block
// table arrives by scalar prefetch, each grid step DMAs one page and the
// online-softmax state m/l/acc lives in VMEM scratch from step to step.
// Hopper blocks run in no order, so here one block owns one (slot, kv
// head) pair and walks that slot's pages itself, reading its own row of
// `tables` and its own `pos` (no scalar prefetch).  Positions past `pos`
// are never read: pages wholly beyond it are skipped and the last page is
// cut at `pos`, which is what the TPU kernel's `pi * page <= pos` skip and
// `k_pos <= pos` mask compute.  The null page 0 is read like any other
// page and is masked by position only, as there.
//
// Bound on the H100: bytes.  Each key and value row of a mapped position
// is read once (2 * kvh * hd values per position and slot) against about
// 4 * g * hd flops, far below the card's flop-per-byte balance.  Design:
// the block's 8 warps take positions round-robin; a warp reads one token's
// k and v rows (hd values, split over the 32 lanes, coalesced), reduces
// q.k for the g query heads of the kv head with warp shuffles and updates
// its own f32 m/l/acc in registers.  The 8 partial states are merged once
// through shared memory at the end.  Work is one block per (slot, kv
// head): 256 blocks at 8 slots x 32 kv heads on 132 SMs; splitting the
// sequence over more blocks is later work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,          // [b, kvh * G, HD]
    const T* __restrict__ k_pages,    // [P, page, kvh, HD]
    const T* __restrict__ v_pages,    // [P, page, kvh, HD]
    const int* __restrict__ tables,   // [b, nb]
    const int* __restrict__ pos,      // [b]
    T* __restrict__ out,              // [b, kvh * G, HD]
    int kvh, int page, int nb, float scale, float softcap) {
  constexpr int PER = HD / 32;  // values per lane: lane + 32 * e
  const int bi = blockIdx.x;
  const int kh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int last = min(pos[bi], nb * page - 1);

  const int64_t head0 = (static_cast<int64_t>(bi) * kvh + kh) * G * HD;
  float qv[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < PER; ++e)
      qv[g][e] = repro::to_float(q[head0 + g * HD + lane + 32 * e]) * scale;

  float m[G], l[G], acc[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
  }

  const int* row = tables + static_cast<int64_t>(bi) * nb;
  const int64_t tok_stride = static_cast<int64_t>(kvh) * HD;
  for (int t = warp; t <= last; t += kWarps) {
    const int pg = row[t / page];
    const int64_t base =
        (static_cast<int64_t>(pg) * page + t % page) * tok_stride +
        static_cast<int64_t>(kh) * HD;
    float kr[PER], vr[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      kr[e] = repro::to_float(k_pages[base + lane + 32 * e]);
      vr[e] = repro::to_float(v_pages[base + lane + 32 * e]);
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) dot += qv[g][e] * kr[e];
      s[g] = dot;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc = s[g];
      if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
      const float m_new = fmaxf(m[g], sc);
      const float corr = expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[g][e] = acc[g][e] * corr + p * vr[e];
      m[g] = m_new;
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) sm_acc[warp][g][lane + 32 * e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      o += sm_acc[w][g][d] * c;
    }
    out[head0 + idx] = repro::from_float<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int G>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* pos, void* out, int b, int kvh, int page, int nb,
           float scale, float softcap, cudaStream_t s) {
  const dim3 grid(b, kvh);
  paged_decode_kernel<T, HD, G><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<T*>(out), kvh, page, nb,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_g(int g, const void* q, const void* k, const void* v,
               const void* tables, const void* pos, void* out, int b, int kvh,
               int page, int nb, float scale, float softcap, cudaStream_t s) {
  switch (g) {
    case 1: return launch<T, HD, 1>(q, k, v, tables, pos, out, b, kvh, page, nb, scale, softcap, s);
    case 2: return launch<T, HD, 2>(q, k, v, tables, pos, out, b, kvh, page, nb, scale, softcap, s);
    case 4: return launch<T, HD, 4>(q, k, v, tables, pos, out, b, kvh, page, nb, scale, softcap, s);
    case 8: return launch<T, HD, 8>(q, k, v, tables, pos, out, b, kvh, page, nb, scale, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_hd(int hd, int g, const void* q, const void* k, const void* v,
                const void* tables, const void* pos, void* out, int b,
                int kvh, int page, int nb, float scale, float softcap,
                cudaStream_t s) {
  switch (hd) {
    case 32: return dispatch_g<T, 32>(g, q, k, v, tables, pos, out, b, kvh, page, nb, scale, softcap, s);
    case 64: return dispatch_g<T, 64>(g, q, k, v, tables, pos, out, b, kvh, page, nb, scale, softcap, s);
    case 128: return dispatch_g<T, 128>(g, q, k, v, tables, pos, out, b, kvh, page, nb, scale, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [b, 1, kvh * g, hd]; k_pages, v_pages: [P, page, kvh, hd], all of
// dtype code `dtype` and contiguous; tables: [b, nb] int32; pos: [b] int32.
// Returns a cudaError_t code (0 on success).
extern "C" int repro_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* tables,
                                  const void* pos, void* out, int b, int kvh,
                                  int g, int hd, int page, int nb,
                                  float scale, float softcap, int dtype,
                                  void* stream) {
  if (b <= 0) return 0;
  if (kvh <= 0 || kvh > 65535 || page <= 0 || nb <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_hd<float>(hd, g, q, k_pages, v_pages, tables, pos, out,
                              b, kvh, page, nb, scale, softcap, s);
  if (dtype == repro::kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, g, q, k_pages, v_pages, tables, pos,
                                      out, b, kvh, page, nb, scale, softcap,
                                      s);
  return cudaErrorInvalidValue;
}
