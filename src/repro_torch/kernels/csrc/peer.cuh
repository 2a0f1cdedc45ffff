// Peer workspaces: the memory that the ranks of one tensor-parallel group
// share, and the flag protocol the port's collective kernels use on it.
//
// Each rank cudaMallocs one workspace (peer_comm.cu), exports it with
// cudaIpcGetMemHandle, and opens every peer's; kernels receive the table
// of all ranks' workspace base pointers (their own included).  On a box
// with several cards these are the peers' memories over NVLink; on one
// card, n processes sharing the device.
//
// Layout of a workspace (byte offsets; `slot` = slot_bytes, a multiple of
// 256):
//   [0, kFlagBytes)         flag words (uint32), see the offsets below
//   ring landing slot 0/1   2 x slot bytes, f32 partial sums of the ring
//   collective slot 0/1     2 x slot bytes, each rank's published input
//   attention slot 0/1      2 x slot bytes, each rank's published K/V shard
//                           (ring_attention.cu)
//
// Flags only ever grow: each is compared against a tag that the host
// counts up call by call (epoch tagging), so back-to-back calls need no
// reset.  Writers publish with a system-scope release store after a
// system-scope fence; readers spin on an acquire load with __nanosleep
// and give up after kTimeoutNs, recording the failure in a host-mapped
// error word and trapping (the launch then fails and the wrapper raises).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {
namespace peer {

constexpr int kMaxRanks = 8;
constexpr int kMaxRingTiles = 4096;    // output tiles of one ring call
constexpr int kMaxCollTiles = 4096;    // element tiles of one collective
constexpr int kCollTile = 8192;        // elements per collective tile

// flag word offsets (in uint32 words)
constexpr int kRingReady = 0;                                  // [2][T]
constexpr int kRingAck = kRingReady + 2 * kMaxRingTiles;       // [2][T]
constexpr int kRingStarted = kRingAck + 2 * kMaxRingTiles;     // [1]
constexpr int kCollFlags = kRingStarted + 64;                  // [2][R][T]
// ring attention: kAttnReady[slot][src] = the call whose K/V rank src has
// published in its attention slot; kAttnDone[r] = the last call for which
// rank r has finished reading every peer's attention slot.  Each is
// written by the rank it names into every peer's workspace.
constexpr int kAttnReady = kCollFlags + 2 * kMaxRanks * kMaxCollTiles;
constexpr int kAttnDone = kAttnReady + 2 * kMaxRanks;          // [R]
constexpr int kFlagWords = kAttnDone + kMaxRanks;
constexpr size_t kFlagBytes = ((kFlagWords * 4 + 4095) / 4096) * 4096;

constexpr long long kTimeoutNs = 30LL * 1000 * 1000 * 1000;   // 30 s

// error codes written to the host-mapped error word
constexpr int kErrRingTimeout = 1;
constexpr int kErrCollTimeout = 2;
constexpr int kErrAttnTimeout = 3;

__host__ __device__ inline size_t workspace_bytes(size_t slot) {
  return kFlagBytes + 6 * slot;
}
__host__ __device__ inline char* ring_slot(char* ws, size_t slot, int j) {
  return ws + kFlagBytes + static_cast<size_t>(j) * slot;
}
__host__ __device__ inline char* coll_slot(char* ws, size_t slot, int j) {
  return ws + kFlagBytes + (2 + static_cast<size_t>(j)) * slot;
}
__host__ __device__ inline char* attn_slot(char* ws, size_t slot, int j) {
  return ws + kFlagBytes + (4 + static_cast<size_t>(j)) * slot;
}
__host__ __device__ inline uint32_t* flags(char* ws) {
  return reinterpret_cast<uint32_t*>(ws);
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= want (wrap-free: tags stay far below 2^31).  Called by
// one thread of a block; the block synchronises after it.
__device__ __forceinline__ void wait_geq(const uint32_t* p, uint32_t want,
                                         int* err, int code) {
  if (ld_acquire(p) >= want) return;
  const long long t0 = now_ns();
  unsigned sleep = 32;
  while (ld_acquire(p) < want) {
    __nanosleep(sleep);
    if (sleep < 4096) sleep <<= 1;
    if (now_ns() - t0 > kTimeoutNs) {
      atomicExch_system(err, code);
      __threadfence_system();
      __trap();
    }
  }
}

}  // namespace peer
}  // namespace repro
