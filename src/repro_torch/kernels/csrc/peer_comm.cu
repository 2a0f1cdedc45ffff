// Transport of the port's PeerComm: the workspace each rank shares with
// its peers through CUDA IPC, and the collective kernels over it.
//
// No TPU kernel is replaced here: on the TPU, XLA's psum / all_gather do
// this work.  On Hopper the port could hand it to NCCL, but NCCL refuses
// two ranks on one device, and the one card this is verified on runs the
// ranks as processes sharing cuda:0.  So the collectives are written
// against a table of peer workspace pointers, which is symmetric memory on
// a box with several cards and n buffers on one card.
//
// Collective kernel (all-reduce sum or max, all-gather, reduce-scatter):
// the input is cut
// into tiles of kCollTile elements, one block per tile.  A block copies
// its tile of x into its own workspace's collective slot (epoch % 2),
// fences, and publishes the epoch into every peer's flag for (slot, its
// rank, tile); it then waits for every rank's flag of that tile in its
// own workspace, and reads the tile from every rank's slot.  The sum is
// taken in f32 in rank order 0, 1, ..., n-1 on every rank and cast once,
// so all ranks get bitwise identical results (the norm inputs of the
// replicas must not drift).  The reduce-scatter (scatter mode) publishes
// the whole input the same way, but each rank then reads and sums only the
// elements of its own chunk and writes only that chunk: the input seen as
// [outer, n, inner], rank r's chunk is [:, r, :] (the input cut into n
// equal parts along one dim).  Its sum is the all-reduce's, element by
// element, so it equals the all-reduce followed by the slice bit for bit.  Slot epoch % 2 is rewritten two calls later;
// by then every peer has published a tile of the call in between, which
// it does only after its previous kernel (the reader of this slot) has
// ended, on the one stream all its collectives run on.
//
// Bound on the H100: bytes.  Each rank writes its input once into its
// slot, reads n slots and writes the output: (n + 2) x bytes a rank on
// one card, where the n ranks share the card's 3.35 TB/s; the scatter
// mode reads n chunks and writes one: (2 + 2 / n) x bytes a rank.
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "peer.cuh"

namespace {

using namespace repro::peer;

constexpr int kThreads = 256;

enum Mode { kSum = 0, kMax = 1, kGather = 2, kScatter = 3 };

template <typename T>
__global__ void __launch_bounds__(kThreads)
    collective_kernel(char* const* __restrict__ ws, int rank, int n,
                      size_t slot, const T* __restrict__ x,
                      T* __restrict__ out, int64_t count, int64_t inner,
                      int64_t offset, int mode, uint32_t epoch, int* err) {
  const int tile = blockIdx.x;
  const int p = epoch & 1;
  const int64_t lo = int64_t(tile) * kCollTile;
  const int64_t hi = lo + kCollTile < count ? lo + kCollTile : count;
  T* mine = reinterpret_cast<T*>(coll_slot(ws[rank], slot, p));
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) mine[i] = x[i];
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x < n) {
    uint32_t* f = flags(ws[threadIdx.x]) + kCollFlags +
                  (p * kMaxRanks + rank) * kMaxCollTiles + tile;
    st_release(f, epoch);
  }
  if (threadIdx.x == 0) {
    const uint32_t* own = flags(ws[rank]) + kCollFlags;
    for (int r = 0; r < n; ++r)
      wait_geq(own + (p * kMaxRanks + r) * kMaxCollTiles + tile, epoch, err,
               kErrCollTimeout);
  }
  __syncthreads();
  if (mode == kGather) {
    for (int r = 0; r < n; ++r) {
      const T* src = reinterpret_cast<const T*>(coll_slot(ws[r], slot, p));
      for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
        out[r * count + i] = src[i];
    }
    return;
  }
  if (mode == kScatter) {
    // element offset + i of the whole input sits in chunk (blk % n) of
    // row blk / n; this rank keeps its chunk only
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      const int64_t gi = offset + i;
      const int64_t blk = gi / inner;
      if (blk % n != rank) continue;
      float acc = repro::to_float(
          reinterpret_cast<const T*>(coll_slot(ws[0], slot, p))[i]);
      for (int r = 1; r < n; ++r)
        acc += repro::to_float(
            reinterpret_cast<const T*>(coll_slot(ws[r], slot, p))[i]);
      out[(blk / n) * inner + gi % inner] = repro::from_float<T>(acc);
    }
    return;
  }
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    float acc = repro::to_float(
        reinterpret_cast<const T*>(coll_slot(ws[0], slot, p))[i]);
    for (int r = 1; r < n; ++r) {
      const float v = repro::to_float(
          reinterpret_cast<const T*>(coll_slot(ws[r], slot, p))[i]);
      acc = mode == kMax ? fmaxf(acc, v) : acc + v;
    }
    out[i] = repro::from_float<T>(acc);
  }
}

}  // namespace

// One workspace of workspace_bytes(slot) bytes, zeroed; *ptr receives the
// device pointer.
extern "C" int repro_peer_alloc(long long slot, void** ptr) {
  const size_t bytes = workspace_bytes(static_cast<size_t>(slot));
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemset(*ptr, 0, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int repro_peer_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// The IPC handle of a workspace, as CUDA_IPC_HANDLE_SIZE (64) bytes.
extern "C" int repro_peer_export(void* ptr, void* handle64) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::memcpy(handle64, &h, sizeof(h));
  return 0;
}

// Map a peer's workspace into this process.
extern "C" int repro_peer_open(const void* handle64, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle64, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int repro_peer_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// A host-mapped error word (zeroed) that kernels write on a flag timeout:
// *host and *dev receive its host and device addresses.
extern "C" int repro_peer_error_word(void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, sizeof(int), cudaHostAllocMapped);
  if (e != cudaSuccess) return static_cast<int>(e);
  *static_cast<int*>(*host) = 0;
  return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

extern "C" int repro_peer_error_word_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

// ws: device array of n workspace pointers (this rank's included); x
// [count], out [count] (sum, max) or [n, count] (gather), dtype code
// `dtype`; count * element size <= slot and count <= kMaxCollTiles *
// kCollTile.  Scatter mode: x is elements [offset, offset + count) of a
// whole input seen as [outer, n, inner], and out is this rank's whole
// chunk [outer, inner] (its elements among x's are written).  `epoch`
// counts this group's collective calls from 1.
extern "C" int repro_peer_collective(const void* ws, int rank, int n,
                                     long long slot, const void* x, void* out,
                                     long long count, long long inner,
                                     long long offset, int dtype, int mode,
                                     unsigned epoch, void* err,
                                     void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || count <= 0 ||
      mode < kSum || mode > kScatter || inner <= 0 || offset < 0)
    return cudaErrorInvalidValue;
  const size_t elt = dtype == repro::kF32 ? 4 : 2;
  const long long tiles = (count + kCollTile - 1) / kCollTile;
  if (tiles > kMaxCollTiles || count * elt > static_cast<size_t>(slot))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto wsp = static_cast<char* const*>(ws);
  if (dtype == repro::kF32) {
    collective_kernel<float><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
        wsp, rank, n, slot, static_cast<const float*>(x),
        static_cast<float*>(out), count, inner, offset, mode, epoch,
        static_cast<int*>(err));
  } else if (dtype == repro::kBF16) {
    collective_kernel<__nv_bfloat16><<<static_cast<unsigned>(tiles), kThreads, 0,
                                         s>>>(
        wsp, rank, n, slot, static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), count, inner, offset, mode, epoch,
        static_cast<int*>(err));
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
