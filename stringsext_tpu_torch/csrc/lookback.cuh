// The single-pass scan's frame, shared by report_clamp.cu (a running max)
// and last_set_scan.cu (the last value set): the tile shape, the tile's
// ticket, the warp scan and the decoupled look-back across tiles (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA, 2016), each over int32 values under an associative `op`, called
// as op(earlier, later).
//
// A thread owns kItems consecutive positions, a thread block of kWarps
// warps a tile of kTile. Tiles are numbered in the order thread blocks
// start (take_ticket: an atomic ticket), so a tile waits only on tiles
// whose blocks already run. Each tile publishes one 64-bit status word a
// scanned lane, a flag in the high half and a value in the low: AGG with
// its aggregate at once, INCL with the value through it once its prefix is
// known. Flag and value share one aligned word that carries nothing else,
// so the words are read and written relaxed at device scope. The launcher
// zeroes ticket and words on the stream before each launch.

#pragma once

#include <stdint.h>

namespace {

constexpr int kItems = 16;                 // positions a thread
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kThreads * kItems;   // 4096 positions a thread block
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kFlagAgg = 1, kFlagIncl = 2;

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t status_word(uint32_t flag, int32_t value) {
  return ((uint64_t)flag << 32) | (uint32_t)value;
}

// The 16 int32 at p, in four 16-byte loads where `vec` says p allows them.
__device__ __forceinline__ void load_ints(const int32_t* __restrict__ p, bool vec, int32_t* v) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(p) + k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) v[k] = __ldg(p + k);
  }
}

// The block's tile: thread 0 takes the next ticket, every thread reads it.
__device__ __forceinline__ int64_t take_ticket(uint32_t* ticket) {
  __shared__ uint32_t tile_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
  __syncthreads();
  return tile_s;
}

// Inclusive scan of v under `op` over the first `width` lanes of the warp
// (every lane takes part).
template <int width, class Op>
__device__ __forceinline__ int32_t warp_scan(int32_t v, int lane, Op op) {
#pragma unroll
  for (int d = 1; d < width; d <<= 1) {
    const int32_t o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = op(o, v);
  }
  return v;
}

// One warp for one scanned lane of tile `tile`: publish the tile's
// aggregate, compose every tile before it under `op` (tile 0's prefix is
// `origin`), publish the value through the tile. `own`: op(x, agg) == agg
// for every x, so the tile publishes INCL at once and reads back no
// further than it must. Warp lane 0 reads the nearest predecessor, 32 at a
// time, and waits until those up to the nearest INCL are published.
// Returns the tile's exclusive prefix to every lane.
template <class Op>
__device__ int32_t look_back(uint64_t* status, int64_t tile, int32_t agg, int32_t origin,
                             int32_t identity, bool own, int lane, Op op) {
  if (tile == 0) {
    if (lane == 0) st_relaxed(status, status_word(kFlagIncl, op(origin, agg)));
    return origin;
  }
  if (lane == 0) st_relaxed(status + tile, status_word(own ? kFlagIncl : kFlagAgg, agg));
  int32_t prefix = identity;
  for (int64_t pred = tile - 1;;) {
    const int64_t idx = pred - lane;  // lane 0 is the nearest predecessor
    // before tile 0, which is INCL once published: origin, never reached
    const uint64_t word = idx >= 0 ? ld_relaxed(status + idx) : status_word(kFlagIncl, origin);
    const uint32_t flag = (uint32_t)(word >> 32);
    const uint32_t ready = __ballot_sync(kFull, flag != 0);
    const uint32_t stops = __ballot_sync(kFull, flag == kFlagIncl);
    const int first = stops ? __ffs(stops) - 1 : 31;
    const uint32_t need = first == 31 ? kFull : (2u << first) - 1;
    if ((ready & need) != need) {
      __nanosleep(32);
      continue;
    }
    // the window's values up to the stop, composed oldest (lane `first`)
    // to newest (lane 0): lane i takes in lane i + d's span
    int32_t v = lane <= first ? (int32_t)(uint32_t)word : identity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_down_sync(kFull, v, d);
      if (lane + d < 32) v = op(o, v);
    }
    prefix = op(__shfl_sync(kFull, v, 0), prefix);
    if (stops) break;
    pred -= 32;
  }
  if (!own && lane == 0) st_relaxed(status + tile, status_word(kFlagIncl, op(prefix, agg)));
  return prefix;
}

}  // namespace
