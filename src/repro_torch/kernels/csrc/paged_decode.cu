// Paged single-token decode attention for Hopper (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `_paged_kernel` (reached through `paged_flash_decode`).  On the TPU the
// grid is (slot, kv head, page) with the page axis sequential: the block
// table arrives by scalar prefetch, each grid step DMAs one page and the
// online-softmax state m/l/acc lives in VMEM scratch from step to step.
// Hopper blocks run in no order and in parallel, so the sequence of each
// slot is cut into splits of `pps` pages (kernels/flash_attention.py
// `paged_splits`, from the shapes alone, never from `pos`) and one block
// owns one (slot, kv head, split), reading its own row of `tables` and its
// own `pos` (no scalar prefetch).  Positions past `pos` are never read:
// a split that starts past it exits at once and the last split is cut at
// `pos`, which is what the TPU kernel's `pi * page <= pos` skip and
// `k_pos <= pos` mask compute.  The null page 0 is read like any other
// page and is masked by position only, as there.
//
// Bound on the H100: bytes.  Each key and value row of a mapped position
// is read once (2 * kvh * hd values per position and slot) against about
// 4 * g * hd flops: at g <= 8 that is <= 8 flop/B in bf16, below the f32
// FMA units' balance (~20 flop/B), so CUDA cores suffice.  The design
// moves the bytes at the card's rate:
//  - many blocks: at 8 slots x 32 kv heads x 16 splits of 128 positions
//    a long slot's work is spread over every SM, where one block per
//    (slot, kv head) walked 2,048 positions alone;
//  - 16-byte loads: a chunk of CHUNK tokens' K and V rows (8 KB each) is
//    copied with `cp.async` into a two-stage shared-memory ring, so the
//    next chunk's loads run under this chunk's arithmetic;
//  - one softmax step a chunk: the chunk's q.k scores for all g heads go
//    to shared memory (each row's DL lanes reduce the g partial dots by a
//    butterfly that halves the values at each shuffle), then one max and
//    one rescale of acc per chunk, not per token;
//  - p.v: a thread owns 16 bytes of d for one head and a strided subset
//    of the chunk's tokens; the token groups' acc and l are added in a
//    fixed order at the end of the split.
// The splits of a (slot, kv head) are merged in split order by the last
// of its blocks to finish (an atomic counter per pair in `counters`,
// which that block resets to 0), so a call is one launch and gives the
// same bits on every run; a pair with one active split writes its output
// directly.
//
// Groups and head dims: g in {1, 2, 3, 4, 8, 16} (granite-moe's 24/8
// heads give 3, recurrentgemma's 16/1 give 16) and hd in {32, 64, 128,
// 256} (gemma2, recurrentgemma).  A lane holds 16 bytes of a K/V row, or
// 32 where a row of 16-byte words would need more than a warp (f32 at
// hd 256).  A group that is not a power of two reduces each head's dot
// over the row's lanes whole (no halving butterfly), and the threads
// past g * (token groups) sit out p.v.  Where q would take more than 64
// registers a thread (g 16 at 8 values a lane), it stays in shared
// memory as f32 and every dot reads it there.  The K/V stages are
// dynamic shared memory (64 KB at f32 hd 256).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPps = 256;       // a split's row of the table, in smem
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

template <typename T, int HD>
struct Geo {
  static constexpr int E16 = 16 / static_cast<int>(sizeof(T));  // per 16 B
  // values a lane holds: one 16-byte word, or two where a row would
  // otherwise span more than a warp
  static constexpr int ELT = HD / 32 > E16 ? HD / 32 : E16;
  static constexpr int VEC = ELT / E16;      // 16-byte words a lane
  static constexpr int DL = HD / ELT;        // lanes per K/V row (4..32)
  static constexpr int ROWS = kThreads / DL;  // rows one pass covers
  static constexpr int C0 = 8192 / (HD * static_cast<int>(sizeof(T)));
  // tokens a stage holds: 8 KB of K (and of V), 16..64 rows
  static constexpr int CHUNK = C0 < 16 ? 16 : (C0 > 64 ? 64 : C0);
  static constexpr int SMEM = 4 * CHUNK * HD * static_cast<int>(sizeof(T));
  static_assert(32 % DL == 0 && CHUNK % ROWS == 0, "row geometry");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// s[0..N-1]: this lane's partial dots of N heads.  Each step with offset
// O halves the values a lane keeps (lanes with bit O keep the upper half
// and send the lower one); once one is left, the steps add it whole.
// After the steps down to offset 1 the lane holds the totals of
// max(1, N / (2 * O0)) heads (see head_base).
template <int G, int N, int O>
__device__ __forceinline__ void butterfly(float (&s)[G], int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? s[i] : s[i + N / 2];
        const float keep = up ? s[i + N / 2] : s[i];
        s[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      butterfly<G, N / 2, O / 2>(s, lane);
    } else {
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], O);
      butterfly<G, 1, O / 2>(s, lane);
    }
  }
}

// the first head whose total the lane holds after butterfly<G, G, DL/2>
template <int G, int DL>
__device__ __forceinline__ int head_base(int lane) {
  int base = 0, n = G;
#pragma unroll
  for (int o = DL / 2; o >= 1; o >>= 1) {
    if (n > 1) {
      n /= 2;
      if (lane & o) base += n;
    }
  }
  return base;
}

// every head's total over a row's DL lanes, in every lane (a group that
// is not a power of two cannot halve)
template <int G, int DL>
__device__ __forceinline__ void row_sums(float (&s)[G]) {
#pragma unroll
  for (int o = DL / 2; o >= 1; o >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
}

template <typename T>
__device__ __forceinline__ void to_floats(const uint4& raw, float* f);
template <>
__device__ __forceinline__ void to_floats<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void to_floats<__nv_bfloat16>(const uint4& raw,
                                                         float* f) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads, 1) paged_decode_kernel(
    const T* __restrict__ q,          // [b, kvh * G, HD]
    const T* __restrict__ k_pages,    // [P, page, kvh, HD]
    const T* __restrict__ v_pages,    // [P, page, kvh, HD]
    const int* __restrict__ tables,   // [b, nb]
    const int* __restrict__ pos,      // [b]
    T* __restrict__ out,              // [b, kvh * G, HD]
    float* __restrict__ partial,      // [b, kvh, nsplit, G, HD + 2]
    int* __restrict__ counters,       // [b * kvh], 0 between calls
    int kvh, int page, int page_shift, int nb, int pps, int nsplit,
    float scale, float softcap, bool vec) {
  using Gm = Geo<T, HD>;
  constexpr int ELT = Gm::ELT, DL = Gm::DL, ROWS = Gm::ROWS;
  constexpr int E16 = Gm::E16, VEC = Gm::VEC;
  constexpr int CHUNK = Gm::CHUNK;
  constexpr bool POW2 = (G & (G - 1)) == 0;
  constexpr int GPT = G > ROWS ? G / ROWS : 1;  // heads a thread adds p.v for
  constexpr int TG = G < ROWS ? ROWS / G : 1;   // token groups of p.v
  constexpr int NJ = (CHUNK + TG - 1) / TG;     // tokens a token group takes
  // totals a lane holds, and lanes holding the same
  constexpr int NH = !POW2 ? G : (G > DL ? G / DL : 1);
  constexpr int DUP = !POW2 ? DL : (DL > G ? DL / G : 1);
  constexpr bool QSMEM = G * ELT > 64;          // q in shared memory
  static_assert(G <= ROWS ? true : G % ROWS == 0, "heads over rows");
  static_assert(TG * G * HD * 4 <= 2 * CHUNK * HD * static_cast<int>(sizeof(T)),
                "the token groups' sums fit a K stage");

  const int split = blockIdx.x % nsplit;
  const int bi = blockIdx.x / nsplit;
  const int kh = blockIdx.y;
  const int last = min(pos[bi], nb * page - 1);
  const int span = pps * page;
  const int n_active = last < 0 ? 1 : last / span + 1;
  if (split >= n_active) return;
  const int t0 = split * span;
  const int n = max(0, min(t0 + span, last + 1) - t0);

  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);  // [2][CHUNK * HD]
  T* sv = sk + 2 * CHUNK * HD;         // [2][CHUNK * HD]
  __shared__ float ssc[CHUNK][G];
  __shared__ __align__(16) float sq[QSMEM ? G * HD : 1];
  __shared__ int tab[kMaxPps];  // the split's physical pages
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int dl = tid % DL;
  const int rest = tid / DL;

  const int64_t head0 = (static_cast<int64_t>(bi) * kvh + kh) * G * HD;
  float qv[QSMEM ? 1 : G][ELT];
  if constexpr (QSMEM) {
    for (int i = tid; i < G * HD; i += kThreads)
      sq[i] = repro::to_float(q[head0 + i]) * scale;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < ELT; ++e)
        qv[g][e] = repro::to_float(q[head0 + g * HD + dl * ELT + e]) * scale;
  }

  // p.v ownership: heads hg0 .. hg0 + GPT - 1, tokens tg, tg + TG, ...;
  // threads past G * TG (a group that does not divide ROWS) take none
  const int hg0 = GPT > 1 ? rest * GPT : rest % G;
  const int tg = GPT > 1 ? 0 : rest / G;
  const bool pv = GPT > 1 || rest < G * TG;
  float m[GPT], l[GPT], acc[GPT][ELT];
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < ELT; ++e) acc[i][e] = 0.f;
  }

  const int* row = tables + static_cast<int64_t>(bi) * nb + split * pps;
  for (int i = tid; i < min(pps, nb - split * pps); i += kThreads)
    tab[i] = row[i];
  __syncthreads();
  const int64_t tok_stride = static_cast<int64_t>(kvh) * HD;
  const int nchunks = (n + CHUNK - 1) / CHUNK;

  // chunk c's K and V rows into stage c & 1 (rows past n are not read)
  auto issue = [&](int c) {
    const int st = c & 1;
#pragma unroll
    for (int it = 0; it < CHUNK / ROWS; ++it) {
      const int r = it * ROWS + rest;
      const int t = c * CHUNK + r;  // position within the split
      if (t < n) {
        const int pi = page_shift >= 0 ? t >> page_shift : t / page;
        const int po = page_shift >= 0 ? t & (page - 1) : t % page;
        const int64_t off =
            (static_cast<int64_t>(tab[pi]) * page + po) * tok_stride +
            static_cast<int64_t>(kh) * HD + dl * ELT;
        T* dk = sk + st * CHUNK * HD + r * HD + dl * ELT;
        T* dv = sv + st * CHUNK * HD + r * HD + dl * ELT;
        if (vec) {
#pragma unroll
          for (int w = 0; w < VEC; ++w) {
            cp_async16(dk + w * E16, k_pages + off + w * E16);
            cp_async16(dv + w * E16, v_pages + off + w * E16);
          }
        } else {
#pragma unroll
          for (int e = 0; e < ELT; ++e) {
            dk[e] = k_pages[off + e];
            dv[e] = v_pages[off + e];
          }
        }
      }
    }
    cp_async_commit();
  };

  if (nchunks > 0) issue(0);
  for (int c = 0; c < nchunks; ++c) {
    const int st = c & 1;
    if (c + 1 < nchunks) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_in = min(CHUNK, n - c * CHUNK);

    // scores of the chunk's tokens for all G heads -> ssc
#pragma unroll
    for (int it = 0; it < CHUNK / ROWS; ++it) {
      const int r = it * ROWS + rest;
      float kf[ELT];
      const T* kr = sk + st * CHUNK * HD + r * HD + dl * ELT;
#pragma unroll
      for (int w = 0; w < VEC; ++w)
        to_floats<T>(*reinterpret_cast<const uint4*>(kr + w * E16),
                     kf + w * E16);
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
        if constexpr (QSMEM) {
          const float* qs = sq + g * HD + dl * ELT;
#pragma unroll
          for (int e = 0; e < ELT; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qs + e);
            dot += q4.x * kf[e];
            dot += q4.y * kf[e + 1];
            dot += q4.z * kf[e + 2];
            dot += q4.w * kf[e + 3];
          }
        } else {
#pragma unroll
          for (int e = 0; e < ELT; ++e) dot += qv[g][e] * kf[e];
        }
        s[g] = dot;
      }
      if constexpr (POW2)
        butterfly<G, G, DL / 2>(s, lane);
      else
        row_sums<G, DL>(s);
      if (dl % DUP == 0) {
        const int hb = POW2 ? head_base<G, DL>(lane) : 0;
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          float sc = s[i];
          if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
          ssc[r][hb + i] = r < n_in ? sc : kNegInf;  // rows past n: no part
        }
      }
    }
    __syncthreads();

    // one max and one rescale per head, then p.v over this thread's tokens
    // (loops of fixed length, so the shared-memory loads issue together)
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      if (!pv) break;
      const int g = hg0 + i;
      float mx = m[i];
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) mx = fmaxf(mx, ssc[t][g]);
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < ELT; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int t = tg + j * TG;
        if (t < n_in) {
          const float p = expf(ssc[t][g] - mx);
          l[i] += p;
          float vf[ELT];
          const T* vr = sv + st * CHUNK * HD + t * HD + dl * ELT;
#pragma unroll
          for (int w = 0; w < VEC; ++w)
            to_floats<T>(*reinterpret_cast<const uint4*>(vr + w * E16),
                         vf + w * E16);
#pragma unroll
          for (int e = 0; e < ELT; ++e) acc[i][e] += p * vf[e];
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next issue
  }

  // add the token groups in order (the stages are free now)
  float* red = reinterpret_cast<float*>(sk);   // [TG][G][HD]
  float* red_l = reinterpret_cast<float*>(sv);  // [TG][G]
  __shared__ float red_m[G];
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    if (!pv) break;
    const int g = hg0 + i;
#pragma unroll
    for (int e = 0; e < ELT; ++e)
      red[(tg * G + g) * HD + dl * ELT + e] = acc[i][e];
    if (dl == 0) {
      red_l[tg * G + g] = l[i];
      if (tg == 0) red_m[g] = m[i];
    }
  }
  __syncthreads();

  const int pair = bi * kvh + kh;
  float* part = partial + static_cast<int64_t>(pair) * nsplit * G * (HD + 2);
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      o += red[(j * G + g) * HD + idx % HD];
      lsum += red_l[j * G + g];
    }
    if (n_active == 1) {
      out[head0 + idx] = repro::from_float<T>(o / fmaxf(lsum, 1e-30f));
    } else {
      float* ps = part + (static_cast<int64_t>(split) * G + g) * (HD + 2);
      ps[idx % HD] = o;
      if (idx % HD == 0) {
        ps[HD] = red_m[g];
        ps[HD + 1] = lsum;
      }
    }
  }
  if (n_active == 1) return;

  // the last block of this pair to finish merges the splits in order:
  // each head's max over the splits (a warp's lanes, then a shuffle: a
  // max is exact in any order), then the splits' weights c[s][g] =
  // exp(m_s - max) a chunk of SC splits at a time in shared memory, and
  // every output (its running sum in shared memory, a thread's own) and
  // every l sum adds the splits in split order: the whole block streams
  // the partials, where one thread an output re-read every split's m
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[pair], 1) == n_active - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  constexpr int SC = 2 * CHUNK * HD * static_cast<int>(sizeof(T)) / (4 * G);
  float* acc_s = reinterpret_cast<float*>(sk);  // [G * HD], a thread's own
  float* cw = reinterpret_cast<float*>(sv);     // [SC][G]
  __shared__ float s_mx[G], s_l[G];
  for (int g = tid / 32; g < G; g += kThreads / 32) {
    float mx = kNegInf;
    for (int s = lane; s < n_active; s += 32)
      mx = fmaxf(mx, __ldcg(part + (static_cast<int64_t>(s) * G + g) *
                                       (HD + 2) + HD));
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) {
      s_mx[g] = mx;
      s_l[g] = 0.f;
    }
  }
  for (int idx = tid; idx < G * HD; idx += kThreads) acc_s[idx] = 0.f;
  __syncthreads();
  for (int s0 = 0; s0 < n_active; s0 += SC) {
    const int ns = min(SC, n_active - s0);
    for (int i = tid; i < ns * G; i += kThreads)
      cw[i] = expf(__ldcg(part + (static_cast<int64_t>(s0) * G + i) *
                                     (HD + 2) + HD) - s_mx[i % G]);
    __syncthreads();
    if (tid < G)
      for (int s = 0; s < ns; ++s)
        s_l[tid] += __ldcg(part + (static_cast<int64_t>(s0 + s) * G + tid) *
                                      (HD + 2) + HD + 1) * cw[s * G + tid];
    for (int idx = tid; idx < G * HD; idx += kThreads) {
      const int g = idx / HD;
      const float* ps = part + (static_cast<int64_t>(s0) * G + g) * (HD + 2) +
                        idx % HD;
      float o = acc_s[idx];
      for (int s = 0; s < ns; ++s)
        o += __ldcg(ps + static_cast<int64_t>(s) * G * (HD + 2)) *
             cw[s * G + g];
      acc_s[idx] = o;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < G * HD; idx += kThreads)
    out[head0 + idx] =
        repro::from_float<T>(acc_s[idx] / fmaxf(s_l[idx / HD], 1e-30f));
  if (tid == 0) counters[pair] = 0;
}

struct Args {
  const void *q, *k, *v, *tables, *pos;
  void* out;
  float* partial;
  int* counters;
  int b, kvh, page, page_shift, nb, pps, nsplit;
  float scale, softcap;
  bool vec;
};

template <typename T, int HD, int G>
int launch(const Args& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(a.b) * a.nsplit, a.kvh);
  constexpr int smem = Geo<T, HD>::SMEM;
  // the stages' dynamic shared memory beside the static arrays (once an
  // instance: a racing second call sets the same value)
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, HD, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  paged_decode_kernel<T, HD, G><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.pos), static_cast<T*>(a.out), a.partial,
      a.counters, a.kvh, a.page, a.page_shift, a.nb, a.pps, a.nsplit,
      a.scale, a.softcap, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_g(int g, const Args& a, cudaStream_t s) {
  switch (g) {
    case 1: return launch<T, HD, 1>(a, s);
    case 2: return launch<T, HD, 2>(a, s);
    case 3: return launch<T, HD, 3>(a, s);
    case 4: return launch<T, HD, 4>(a, s);
    case 8: return launch<T, HD, 8>(a, s);
    case 16: return launch<T, HD, 16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_hd(int hd, int g, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 32: return dispatch_g<T, 32>(g, a, s);
    case 64: return dispatch_g<T, 64>(g, a, s);
    case 128: return dispatch_g<T, 128>(g, a, s);
    case 256: return dispatch_g<T, 256>(g, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [b, 1, kvh * g, hd]; k_pages, v_pages: [P, page, kvh, hd], all of
// dtype code `dtype` and contiguous; tables: [b, nb] int32; pos: [b] int32.
// The sequence of a slot is cut into nsplit = ceil(nb / pps) splits of
// pps <= 256 pages; partial: f32 scratch of b * kvh * nsplit * g * (hd + 2) values;
// counters: int32 scratch of b * kvh values, all 0 (and 0 again after the
// call).  Returns a cudaError_t code (0 on success).
extern "C" int repro_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* tables,
                                  const void* pos, void* out, void* partial,
                                  void* counters, int b, int kvh, int g,
                                  int hd, int page, int nb, int pps,
                                  int nsplit, float scale, float softcap,
                                  int dtype, void* stream) {
  if (b <= 0) return 0;
  if (kvh <= 0 || kvh > 65535 || page <= 0 || nb <= 0 || pps <= 0 ||
      pps > kMaxPps || nsplit != (nb + pps - 1) / pps ||
      static_cast<long long>(b) * nsplit > 0x7fffffffLL ||
      static_cast<long long>(nb) * page > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto bits = reinterpret_cast<uintptr_t>(k_pages) |
                    reinterpret_cast<uintptr_t>(v_pages);
  int page_shift = -1;
  if ((page & (page - 1)) == 0)
    for (page_shift = 0; (1 << page_shift) < page; ++page_shift) {
    }
  const Args a{q, k_pages, v_pages, tables, pos, out,
               static_cast<float*>(partial), static_cast<int*>(counters),
               b, kvh, page, page_shift, nb, pps, nsplit, scale, softcap,
               (bits & 15) == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return dispatch_hd<float>(hd, g, a, s);
  if (dtype == repro::kBF16) return dispatch_hd<__nv_bfloat16>(hd, g, a, s);
  return cudaErrorInvalidValue;
}
