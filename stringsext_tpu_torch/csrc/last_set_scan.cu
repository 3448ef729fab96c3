// The last-set scans of ISO-2022-JP's lanes, on Hopper.
//
// Replaces code that the JAX package leaves to XLA: stringsext_tpu/ops/
// classify_iso2022.py::_scan_last_set :71 (a jax.lax.associative_scan of the
// transfers {identity = -1, set = v >= 0}), which iso_pre_lanes :141 runs
// twice over a chunk, for the mode and for the redundant-escape flag. One
// launch scans both lanes, and meets the contract bit for bit:
//   in   int32 t[n] for each of the 2 lanes, 0 < n < 2^31
//   out  int32 out[n] for each: the last t[j] >= 0 with j <= i, else -1.
// The port's plain version composes it with an int64 torch.cummax over the
// positions that hold a value and a gather; on a 1-D tensor cummax scans the
// one row with one thread block, about 24 ms a lane for an 8 MiB piece.
//
// Bound: each lane read once and written once, 8 bytes a position a lane:
// both lanes of an 8 MiB piece 134.2 MB, 0.0401 ms at 3.35 TB/s; of a 64 MiB
// piece 1.074 GB, 0.320 ms.
//
// Design: one pass, as report_clamp.cu's. A thread owns 16 consecutive
// positions, a thread block of 8 warps a tile of 4096.
//   1. Loads: four 16-byte loads a lane where the lane is 16-byte aligned,
//      position by position otherwise and in the tile's last, partial chunk.
//   2. The thread's running last value of each lane over its 16 positions,
//      in registers, in place of the loaded values.
//   3. Inside the tile: the threads' last values scanned by shuffles in each
//      warp, then warp l scans the 8 warp totals of lane l: the tile's
//      aggregate and each warp's exclusive prefix.
//   4. Across tiles: the decoupled look-back of lookback.cuh, warp l for
//      lane l, one 64-bit status word a tile a lane (a flag in the high
//      half, a value in the low). A tile that holds a set value is its own
//      inclusive value and publishes INCL at once; a tile without one
//      publishes AGG (-1, the identity) and waits for the nearest INCL
//      before it. Tile 0's prefix is -1.
//   5. Each thread takes its prefix where its running value is -1 and stores
//      its 16 values a lane in four 16-byte stores where the output allows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kLanes = 2;                  // the mode's and the flag's
constexpr int32_t kUnset = -1;             // the identity transfer

// The composition of two transfers, a then b.
__device__ __forceinline__ int32_t then(int32_t a, int32_t b) { return b >= 0 ? b : a; }

struct Then {
  __device__ int32_t operator()(int32_t a, int32_t b) const { return then(a, b); }
};

// The 16 int32 of v to p, in four 16-byte stores where `vec` says p allows
// them.
__device__ __forceinline__ void store16(int32_t* __restrict__ p, bool vec, const int32_t* v) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      reinterpret_cast<int4*>(p)[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) p[k] = v[k];
  }
}

// aligned: bit l for input lane l, bit 2 + l for output lane l, set where
// the array is 16-byte aligned.
__global__ void __launch_bounds__(kThreads, 4)
last_set_kernel(const int32_t* __restrict__ t0, const int32_t* __restrict__ t1, int32_t n,
                int64_t tiles, uint32_t* __restrict__ ticket, uint64_t* __restrict__ status,
                int32_t* __restrict__ o0, int32_t* __restrict__ o1, int aligned) {
  __shared__ int32_t warp_total[kLanes][kWarps];
  __shared__ int32_t warp_prefix[kLanes][kWarps];
  const int64_t tile = take_ticket(ticket);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base64 = tile * kTile + (int64_t)threadIdx.x * kItems;
  const int32_t base = (int32_t)min(base64, (int64_t)n);  // past n: no position
  const bool whole = base64 + kItems <= n;
  const int32_t* const in[kLanes] = {t0, t1};
  int32_t* const out[kLanes] = {o0, o1};

  // 1-3. the running values, the threads' exclusive prefixes in the warp
  int32_t run[kLanes][kItems], excl[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (whole) {
      load_ints(in[l] + base, (aligned >> l) & 1, run[l]);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) run[l][k] = base64 + k < n ? in[l][base + k] : kUnset;
    }
    int32_t m = kUnset;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      m = then(m, run[l][k]);
      run[l][k] = m;
    }
    const int32_t incl = warp_scan<32>(m, lane, Then());
    excl[l] = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl[l] = kUnset;
    if (lane == 31) warp_total[l][warp] = incl;
  }
  __syncthreads();

  // 4. across tiles, warp l for lane l
  if (warp < kLanes) {
    const int32_t w =
        warp_scan<kWarps>(lane < kWarps ? warp_total[warp][lane] : kUnset, lane, Then());
    const int32_t agg = __shfl_sync(kFull, w, kWarps - 1);
    int32_t wex = __shfl_up_sync(kFull, w, 1);
    if (lane == 0) wex = kUnset;
    const int32_t prefix = look_back(status + warp * tiles, tile, agg, kUnset, kUnset,
                                     agg >= 0, lane, Then());
    if (lane < kWarps) warp_prefix[warp][lane] = then(prefix, wex);
  }
  __syncthreads();

  // 5. the prefix where the thread's own value is unset, the stores
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int32_t pre = then(warp_prefix[l][warp], excl[l]);
#pragma unroll
    for (int k = 0; k < kItems; ++k) run[l][k] = then(pre, run[l][k]);
    if (whole) {
      store16(out[l] + base, (aligned >> (2 + l)) & 1, run[l]);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (base64 + k < n) out[l][base + k] = run[l][k];
    }
  }
}

int aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Enqueue the kernel on `stream`. scratch: uint64[1 + 2 * ceil(n / 4096)]
// (the tile ticket, then one status word a tile a lane), zeroed here on the
// stream; o0, o1: int32[n]. Requires 0 < n < 2^31.
extern "C" int last_set_scan_launch(const void* t0, const void* t1, int64_t n, void* scratch,
                                    void* o0, void* o1, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0 || n > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(scratch, 0, (size_t)(1 + kLanes * tiles) * sizeof(uint64_t), s);
  if (e != cudaSuccess) return (int)e;
  const int aligned =
      aligned16(t0) | aligned16(t1) << 1 | aligned16(o0) << 2 | aligned16(o1) << 3;
  last_set_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const int32_t*>(t0), static_cast<const int32_t*>(t1), (int32_t)n, tiles,
      static_cast<uint32_t*>(scratch), static_cast<uint64_t*>(scratch) + 1,
      static_cast<int32_t*>(o0), static_cast<int32_t*>(o1), aligned);
  return (int)cudaGetLastError();
}
