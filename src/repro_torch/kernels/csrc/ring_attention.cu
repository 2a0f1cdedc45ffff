// Ring attention forward for Hopper: one rank's call.
//
// Replaces the TPU kernel src/repro/kernels/ring_attention.py
// `_ring_attn_kernel` (reached through `pallas_ring_forward`, the forward
// of `ring_attention` when the sequence is sharded over the model group).
// Rank `rank` of n holds q [b, sq, h, hd] (positions rank * sq + arange)
// and its K/V shard [b, sk, kvh, hd] (positions rank * sk + arange); it
// computes causal (optionally windowed, softcapped) attention of its q
// over every rank's shard, folding shard (rank - s) mod n at step s into
// an online-softmax carry, and writes out [b, sq, h, hd] and lse
// [b, h, sq] f32.  Shards that lie entirely in the q tile's future are
// skipped, as the TPU kernel's `run` predicate skips them.
//
// What differs from the TPU kernel: there the grid is (n,) sequential and
// each step's KV block hops to the left neighbour by a double-buffered
// RDMA while the block is folded.  Here the shards do not travel: each
// rank publishes its K/V shard once into its peer workspace (peer.cuh),
// and every block reads the tiles of shard `src` straight through the
// peer pointer.  A block is one (batch, q head, 64-row q tile); the tile
// loop is the flash forward's (flash_fwd_tc.cuh for bf16, flash_fwd.cuh
// for f32).  Three launches on the communicator's stream:
//
//   1. publish: wait until every peer has finished reading this rank's
//      attention slot (call epoch) % 2 from call epoch - 2 (its done
//      flag), then copy K and V into that slot;
//   2. attention: every block first stores the ready tag (epoch) of this
//      rank's slot into every peer's flags (all blocks store the same
//      value, so no block depends on another block of its launch), then,
//      before reading a peer's shard, waits for that peer's ready tag;
//   3. done: store the done tag (epoch) into every peer's flags: this
//      rank has read their slots of this call.
//
// No block ever waits for a block of its own launch, only for peers'
// flags, so blocks that are not resident cannot deadlock the ones that
// are.  Flags only grow (epoch tagging, two slots by call parity), so
// back-to-back calls need no reset.  On one card the ranks are processes
// that the card time-slices: a flag wait can cost a time slice.
//
// bf16 shards fold through the tensor-core tile of flash_fwd_tc.cuh
// (wgmma fed by TMA; P as two bf16 halves, 1.5x the tensor-core flops;
// the intended roundings pinned on the CPU by
// tests/test_torch_flash_tiles.py, the kernel checked on the card by
// chip_smoke.py phase 11): the block's producer thread waits for a
// peer's ready tag itself, then starts the shard's tile loads; the
// consumer warpgroup never waits on a flag.  Own
// tiles come through tensor maps of this rank's k and v, a peer's
// through maps of its attention slot of this call's parity, which the
// host builds from the peers' mapped base addresses for every call: with
// the parity known at launch that is two maps a rank, 2n + 1 with q's,
// 2,176 bytes of kernel parameters at n = 8 (under the 4 KB limit that
// CUDA before 12.1 sets), so no map lives in device memory and none needs
// the tensormap proxy fence.  A peer's K/V were written by another
// process's publish launch: after the acquire load of its tag the
// producer runs the async-proxy fence before TMA reads them.  f32 shards
// keep flash_fwd.cuh's CUDA-core loop: a tensor-core product of f32
// inputs is TF32, ~1e-3 off the f32 reference.
//
// Bound on the H100: operations (q.k and p.v over the visible pairs, about
// 1.0e11 flops for one internlm2-1.8b rank at b 2, s 4096, tp 2, against
// ~67 MB moved); the bf16 tile's own limits are the exponentials and its
// one load ahead, and on one card the ranks' time slices.
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "flash_fwd.cuh"
#include "flash_fwd_tc.cuh"
#include "peer.cuh"

namespace {

using namespace repro::peer;
using namespace repro::flash;

constexpr int kCopyThreads = 256;
constexpr int kMaxCopyBlocks = 1024;

struct RingParams {
  int b, sq, sk, h, kvh, g;
  int causal, window;  // window 0: none
  float scale, softcap;
};

// K and V (`words` 16-byte words each) into this rank's attention slot
// epoch % 2, once every peer has read the slot's previous contents.
__global__ void __launch_bounds__(kCopyThreads)
    publish_kernel(char* const* __restrict__ ws, int rank, int n, size_t slot,
                   const uint4* __restrict__ k, const uint4* __restrict__ v,
                   int64_t words, size_t v_off, uint32_t epoch, int* err) {
  if (threadIdx.x == 0 && epoch > 2) {
    const uint32_t* own = flags(ws[rank]);
    for (int r = 0; r < n; ++r)
      if (r != rank)
        wait_geq(own + kAttnDone + r, epoch - 2, err, kErrAttnTimeout);
  }
  __syncthreads();
  char* dst = attn_slot(ws[rank], slot, epoch & 1);
  uint4* dk = reinterpret_cast<uint4*>(dst);
  uint4* dv = reinterpret_cast<uint4*>(dst + v_off);
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < words; i += step) {
    dk[i] = k[i];
    dv[i] = v[i];
  }
  __threadfence_system();
}

// shard `src`'s mask for the q tile at row q0, or false when the tile
// sees none of the shard (skipped before any wait for it)
__device__ __forceinline__ bool shard_mask(int src, int rank, int q0,
                                           const RingParams& p, Mask& m) {
  m = Mask{rank * p.sq, p.sq, src * p.sk, p.sk, p.causal, p.window,
           p.softcap};
  const int q_last = min(q0 + kTile, p.sq) - 1;
  if (p.causal && m.k_off > m.q_off + q_last) return false;
  if (p.window > 0 && m.k_off + p.sk - 1 <= m.q_off + q0 - p.window)
    return false;
  return true;
}

// f32: the CUDA-core tile of flash_fwd.cuh
template <int HD>
__global__ void __launch_bounds__(kThreads)
    ring_attn_kernel(char* const* __restrict__ ws, int rank, int n,
                     size_t slot, size_t v_off, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ out, float* __restrict__ lse,
                     RingParams p, uint32_t epoch, int* err) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                // [64][LD]  q * scale
  float* ks = qs + kTile * LD;     // [64][LD]
  float* vs = ks + kTile * LD;     // [64][LD]
  float* ps = vs + kTile * LD;     // [64][kPLD]

  const int q0 = blockIdx.x * kTile;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int par = epoch & 1;
  // the publish launch has ended: this rank's shard is in its slot
  if (threadIdx.x < n && threadIdx.x != rank) {
    __threadfence_system();
    st_release(flags(ws[threadIdx.x]) + kAttnReady + par * kMaxRanks + rank,
               epoch);
  }

  load_tile<float, HD>(qs, q, bi, q0, hi, p.h, p.sq, p.scale);
  Carry<HD> c;
  c.init();
  for (int s = 0; s < n; ++s) {
    const int src = (rank - s + n) % n;
    Mask mk;
    if (!shard_mask(src, rank, q0, p, mk)) continue;
    const float* kp = k;
    const float* vp = v;
    if (src != rank) {
      if (threadIdx.x == 0)
        wait_geq(flags(ws[rank]) + kAttnReady + par * kMaxRanks + src, epoch,
                 err, kErrAttnTimeout);
      __syncthreads();
      const char* base = attn_slot(ws[src], slot, par);
      kp = reinterpret_cast<const float*>(base);
      vp = reinterpret_cast<const float*>(base + v_off);
    }
    fold_keys<HD>(qs, ks, vs, ps, kp, vp, bi, hi / p.g, p.kvh, q0, mk, c);
  }
  store_rows<HD>(c, out, lse, bi, hi, p.h, p.sq, q0);
}

// the maps of the tensor-core kernel: q, and the K and V shard of every
// rank (this rank's own tensors; a peer's attention slot of this call)
struct RingMaps {
  CUtensorMap q;
  CUtensorMap k[kMaxRanks];
  CUtensorMap v[kMaxRanks];
};

// the ring's shards for one q tile: shard (rank - s) mod n at step s,
// skipped where the q tile sees none of it; a peer's only after its
// ready tag of this call
struct RingShards {
  const RingMaps* maps;
  char* const* ws;
  RingParams p;
  int rank, n, par;
  uint32_t epoch;
  int* err;

  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ bool get(int s, int q0, Mask& m,
                                      const CUtensorMap*& km,
                                      const CUtensorMap*& vm) const {
    const int src = (rank - s + n) % n;
    if (!shard_mask(src, rank, q0, p, m)) return false;
    km = &maps->k[src];
    vm = &maps->v[src];
    return true;
  }
  __device__ __forceinline__ void ready(int s) const {
    const int src = (rank - s + n) % n;
    if (src == rank) return;
    wait_geq(flags(ws[rank]) + kAttnReady + par * kMaxRanks + src, epoch, err,
             kErrAttnTimeout);
    asm volatile("fence.proxy.async.global;" ::: "memory");
  }
};

// bf16: one block per (batch, q head, 64-row q tile), the latest q tiles
// (the most keys) first
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    ring_attn_tc_kernel(char* const* __restrict__ ws, int rank, int n,
                        const __grid_constant__ RingMaps maps,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, RingParams p,
                        uint32_t epoch, int* err) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int hi = blockIdx.y;
  const int par = epoch & 1;
  // the publish launch has ended: this rank's shard is in its slot
  if (threadIdx.x < n && threadIdx.x != rank) {
    __threadfence_system();
    st_release(flags(ws[threadIdx.x]) + kAttnReady + par * kMaxRanks + rank,
               epoch);
  }
  tc_block<HD>(&maps.q, RingShards{&maps, ws, p, rank, n, par, epoch, err},
               blockIdx.z, hi, hi / p.g, q0, p.scale, out, lse, p.h, p.sq);
}

// this rank has read every peer's slot of call `epoch`
__global__ void done_kernel(char* const* __restrict__ ws, int rank, int n,
                            uint32_t epoch) {
  const int r = threadIdx.x;
  if (r < n && r != rank) st_release(flags(ws[r]) + kAttnDone + rank, epoch);
}

template <int HD>
int attend_tc(char* const* ws, const long long* host_ws, int rank, int n,
              size_t slot, size_t v_off, const void* q, const void* k,
              const void* v, void* out, void* lse, const RingParams& p,
              uint32_t epoch, int* err, cudaStream_t st) {
  RingMaps maps;
  memset(&maps, 0, sizeof(maps));
  int e = encode_rows(&maps.q, q, p.b, p.sq, p.h, HD);
  for (int r = 0; r < n && e == 0; ++r) {
    const char* kr = static_cast<const char*>(k);
    const char* vr = static_cast<const char*>(v);
    if (r != rank) {
      kr = attn_slot(reinterpret_cast<char*>(host_ws[r]), slot, epoch & 1);
      vr = kr + v_off;
    }
    e = encode_rows(&maps.k[r], kr, p.b, p.sk, p.kvh, HD);
    if (e == 0) e = encode_rows(&maps.v[r], vr, p.b, p.sk, p.kvh, HD);
  }
  if (e != 0) return e;
  const size_t smem = TcGeo<HD>::kSmem;
  auto kern = ring_attn_tc_kernel<HD>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
  kern<<<grid, kTcThreads, smem, st>>>(ws, rank, n, maps,
                                       static_cast<__nv_bfloat16*>(out),
                                       static_cast<float*>(lse), p, epoch,
                                       err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int attend(char* const* ws, const long long* host_ws, int rank, int n,
           size_t slot, size_t v_off, const void* q, const void* k,
           const void* v, void* out, void* lse, const RingParams& p,
           uint32_t epoch, int* err, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return attend_tc<HD>(ws, host_ws, rank, n, slot, v_off, q, k, v, out,
                         lse, p, epoch, err, st);
  } else {
    const size_t smem = fwd_smem<HD>();
    auto kern = ring_attn_kernel<HD>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
    kern<<<grid, kThreads, smem, st>>>(
        ws, rank, n, slot, v_off, static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), static_cast<float*>(lse), p, epoch, err);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int attend_hd(int hd, char* const* ws, const long long* host_ws, int rank,
              int n, size_t slot, size_t v_off, const void* q, const void* k,
              const void* v, void* out, void* lse, const RingParams& p,
              uint32_t epoch, int* err, cudaStream_t st) {
  switch (hd) {
    case 32:
      return attend<T, 32>(ws, host_ws, rank, n, slot, v_off, q, k, v, out,
                           lse, p, epoch, err, st);
    case 64:
      return attend<T, 64>(ws, host_ws, rank, n, slot, v_off, q, k, v, out,
                           lse, p, epoch, err, st);
    case 128:
      return attend<T, 128>(ws, host_ws, rank, n, slot, v_off, q, k, v, out,
                            lse, p, epoch, err, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// ws: device array of the n ranks' workspace pointers (peer.cuh), host_ws
// the same n pointers in host memory; q, out [b, sq, h, hd] and k, v
// [b, sk, kvh, hd] contiguous of dtype code `dtype`, q, k and v 16-byte
// aligned; lse [b, h, sq] f32; window 0 means none.  `epoch` counts this
// group's ring-attention calls from 1.  K and V, each rounded up to 256
// bytes, must fit one slot.  Returns a cudaError_t code (0 on success).
extern "C" int repro_ring_attention(const void* ws, const void* host_ws,
                                    int rank, int n, long long slot,
                                    const void* q,
                                    const void* k, const void* v, void* out,
                                    void* lse, int b, int sq, int sk, int h,
                                    int kvh, int hd, int causal, int window,
                                    float scale, float softcap,
                                    unsigned epoch, int dtype, void* err,
                                    void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || b <= 0 || sq <= 0 ||
      sk <= 0 || h <= 0 || kvh <= 0 || h % kvh || h > 65535 || b > 65535 ||
      window < 0 || epoch < 1 || (dtype != repro::kF32 && dtype != repro::kBF16))
    return cudaErrorInvalidValue;
  const size_t elt = dtype == repro::kF32 ? 4 : 2;
  const size_t kv_bytes = static_cast<size_t>(b) * sk * kvh * hd * elt;
  const size_t v_off = (kv_bytes + 255) / 256 * 256;
  if (kv_bytes % 16 || 2 * v_off > static_cast<size_t>(slot) ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wsp = static_cast<char* const*>(ws);
  auto host = static_cast<const long long*>(host_ws);
  int* errp = static_cast<int*>(err);
  if (n > 1) {
    const int64_t words = static_cast<int64_t>(kv_bytes / 16);
    const int64_t want = (words + kCopyThreads - 1) / kCopyThreads;
    const unsigned blocks =
        static_cast<unsigned>(want < kMaxCopyBlocks ? want : kMaxCopyBlocks);
    publish_kernel<<<blocks, kCopyThreads, 0, st>>>(
        wsp, rank, n, static_cast<size_t>(slot), static_cast<const uint4*>(k),
        static_cast<const uint4*>(v), words, v_off, epoch, errp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const RingParams p{b, sq, sk, h, kvh, h / kvh, causal, window, scale,
                     softcap};
  const int rc =
      dtype == repro::kF32
          ? attend_hd<float>(hd, wsp, host, rank, n,
                             static_cast<size_t>(slot), v_off, q, k, v, out,
                             lse, p, epoch, errp, st)
          : attend_hd<__nv_bfloat16>(hd, wsp, host, rank, n,
                                     static_cast<size_t>(slot), v_off, q, k,
                                     v, out, lse, p, epoch, errp, st);
  if (rc != 0 || n == 1) return rc;
  done_kernel<<<1, 32, 0, st>>>(wsp, rank, n, epoch);
  return static_cast<int>(cudaGetLastError());
}
