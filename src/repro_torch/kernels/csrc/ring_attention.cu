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
// loop is the flash forward's (flash_fwd.cuh).  Three launches on the
// communicator's stream:
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
// Bound on the H100: operations (q.k and p.v over the visible pairs, about
// 1.0e11 flops for one internlm2-1.8b rank at b 2, s 4096, tp 2, against
// ~67 MB moved).  This first kernel runs its products on the CUDA cores
// (f32 FMAs, the flash forward's loop), so the FMA and shared-memory
// rates bound it in practice; wgmma/TMA tiles are later work.
#include <cstdint>

#include "common.cuh"
#include "flash_fwd.cuh"
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    ring_attn_kernel(char* const* __restrict__ ws, int rank, int n,
                     size_t slot, size_t v_off, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse,
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

  load_tile<T, HD>(qs, q, bi, q0, hi, p.h, p.sq, p.scale);
  Carry<HD> c;
  c.init();
  const int q_last = min(q0 + kTile, p.sq) - 1;
  for (int s = 0; s < n; ++s) {
    const int src = (rank - s + n) % n;
    const Mask mk{rank * p.sq, p.sq, src * p.sk, p.sk, p.causal, p.window,
                  p.softcap};
    // a shard this q tile cannot see is skipped before any wait for it
    if (p.causal && mk.k_off > mk.q_off + q_last) continue;
    if (p.window > 0 && mk.k_off + p.sk - 1 <= mk.q_off + q0 - p.window)
      continue;
    const T* kp = k;
    const T* vp = v;
    if (src != rank) {
      if (threadIdx.x == 0)
        wait_geq(flags(ws[rank]) + kAttnReady + par * kMaxRanks + src, epoch,
                 err, kErrAttnTimeout);
      __syncthreads();
      const char* base = attn_slot(ws[src], slot, par);
      kp = reinterpret_cast<const T*>(base);
      vp = reinterpret_cast<const T*>(base + v_off);
    }
    fold_keys<T, HD>(qs, ks, vs, ps, kp, vp, bi, hi / p.g, p.kvh, q0, mk, c);
  }
  store_rows<T, HD>(c, out, lse, bi, hi, p.h, p.sq, q0);
}

// this rank has read every peer's slot of call `epoch`
__global__ void done_kernel(char* const* __restrict__ ws, int rank, int n,
                            uint32_t epoch) {
  const int r = threadIdx.x;
  if (r < n && r != rank) st_release(flags(ws[r]) + kAttnDone + rank, epoch);
}

template <typename T, int HD>
int attend(char* const* ws, int rank, int n, size_t slot, size_t v_off,
           const void* q, const void* k, const void* v, void* out, void* lse,
           const RingParams& p, uint32_t epoch, int* err, cudaStream_t st) {
  const size_t smem = fwd_smem<HD>();
  auto kern = ring_attn_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
  kern<<<grid, kThreads, smem, st>>>(
      ws, rank, n, slot, v_off, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), p, epoch, err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attend_hd(int hd, char* const* ws, int rank, int n, size_t slot,
              size_t v_off, const void* q, const void* k, const void* v,
              void* out, void* lse, const RingParams& p, uint32_t epoch,
              int* err, cudaStream_t st) {
  switch (hd) {
    case 32:
      return attend<T, 32>(ws, rank, n, slot, v_off, q, k, v, out, lse, p,
                           epoch, err, st);
    case 64:
      return attend<T, 64>(ws, rank, n, slot, v_off, q, k, v, out, lse, p,
                           epoch, err, st);
    case 128:
      return attend<T, 128>(ws, rank, n, slot, v_off, q, k, v, out, lse, p,
                            epoch, err, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// ws: device array of the n ranks' workspace pointers (peer.cuh); q, out
// [b, sq, h, hd] and k, v [b, sk, kvh, hd] contiguous of dtype code
// `dtype`, k and v 16-byte aligned; lse [b, h, sq] f32; window 0 means
// none.  `epoch` counts this group's ring-attention calls from 1.  K and
// V, each rounded up to 256 bytes, must fit one slot.  Returns a
// cudaError_t code (0 on success).
extern "C" int repro_ring_attention(const void* ws, int rank, int n,
                                    long long slot, const void* q,
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
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wsp = static_cast<char* const*>(ws);
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
          ? attend_hd<float>(hd, wsp, rank, n, static_cast<size_t>(slot),
                             v_off, q, k, v, out, lse, p, epoch, errp, st)
          : attend_hd<__nv_bfloat16>(hd, wsp, rank, n,
                                     static_cast<size_t>(slot), v_off, q, k,
                                     v, out, lse, p, epoch, errp, st);
  if (rc != 0 || n == 1) return rc;
  done_kernel<<<1, 32, 0, st>>>(wsp, rank, n, epoch);
  return static_cast<int>(cudaGetLastError());
}
