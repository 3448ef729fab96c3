// Report clamp of the run-table feed, on Hopper.
//
// Replaces the report clamp of stringsext_tpu/ops/device_events.py::
// runtable_feed :344, code that the JAX package leaves to XLA (a
// jax.lax.cummax of the event reports, a clamp and a compare), and meets
// its contract bit for bit:
//   in   bool start[n], pending[n], acc[n]; int32 report_off[n], length[n];
//        lo (-1 <= lo < 2^31), 0 < n < 2^31
//   out  bool feedable[n]: acc[i] && M[i] == i + length[i] - 1, where
//        M[i] = max(lo, max over j <= i with start[j] && !pending[j] of
//        j + report_off[j]) (int32 sums that wrap, as torch's);
//        int32 last: M[n - 1], the running max the next piece starts from.
// On a 1-D tensor torch.cummax scans the one row with one thread block: 22
// ms for an 8 MiB piece, 0.2% of the card's bandwidth.
//
// Bound: each input read once and the mask written once, 12 bytes a
// position (3 bool and 2 int32 in, 1 bool out): 100.7 MB, 0.030 ms at 3.35
// TB/s for an 8 MiB piece; 805 MB, 0.240 ms for 64 MiB.
//
// Design: one pass. A thread owns 16 consecutive positions, a thread block
// of 8 warps a tile of 4096.
//   1. Loads. Each bool lane in one 16-byte load (4-byte loads where the
//      slice starts 4 bytes into its allocation, as the feed's pieces with
//      their 4 bytes of context do; byte loads past that), each int32 lane
//      in four. The tile's last, partial chunk loads position by position.
//   2. The thread's running max of its 16 event reports (an empty position
//      contributes INT32_MIN, max's identity) and the targets i + length - 1,
//      in registers; the accept bits in one word.
//   3. Inside the tile: an inclusive max scan of the threads' maxima by
//      shuffles, then warp 0 scans the 8 warp maxima: the tile's aggregate
//      and each warp's exclusive prefix.
//   4. Across tiles: the decoupled look-back of lookback.cuh under max,
//      one 64-bit status word a tile (a flag in the high half, a max in
//      the low). Tile 0's prefix is lo.
//   5. Each thread takes M = max(prefix, its running max) at each position,
//      compares, and stores its 16 mask bytes in one 16-byte store; the
//      thread that holds position n - 1 writes `last`.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int32_t kNone = INT32_MIN;       // the identity of max

struct Max {
  __device__ int32_t operator()(int32_t a, int32_t b) const { return max(a, b); }
};

// Alignment of the launch's arrays, two bits each: 2 for 16 bytes, 1 for
// 4 bytes, 0 for 1 byte.
enum { kStart, kPending, kAcc, kReport, kLength, kOut };
__device__ __forceinline__ int align_of(int aligned, int array) {
  return (aligned >> (2 * array)) & 3;
}

// The 16 bytes at p (16 positions of a bool lane) as four words, by the
// widest load the lane's alignment allows.
__device__ __forceinline__ uint4 load_bools(const uint8_t* __restrict__ p, int align) {
  if (align == 2) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
  if (align == 1) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __ldg(q + k);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)__ldg(p + 4 * k) | ((uint32_t)__ldg(p + 4 * k + 1) << 8) |
             ((uint32_t)__ldg(p + 4 * k + 2) << 16) | ((uint32_t)__ldg(p + 4 * k + 3) << 24);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool byte_of(const uint4& w, int k) {
  const uint32_t word = k < 4 ? w.x : k < 8 ? w.y : k < 12 ? w.z : w.w;
  return ((word >> (8 * (k & 3))) & 0xFF) != 0;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__global__ void __launch_bounds__(kThreads, 4)
report_clamp_kernel(const uint8_t* __restrict__ start, const uint8_t* __restrict__ pending,
                    const uint8_t* __restrict__ acc, const int32_t* __restrict__ report_off,
                    const int32_t* __restrict__ length, int32_t n, int32_t lo,
                    uint32_t* __restrict__ ticket, uint64_t* __restrict__ status,
                    uint8_t* __restrict__ out, int32_t* __restrict__ last, int aligned) {
  __shared__ int32_t warp_total[kWarps];
  __shared__ int32_t warp_prefix[kWarps];
  const int64_t tile = take_ticket(ticket);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base64 = tile * kTile + (int64_t)threadIdx.x * kItems;
  const int32_t base = (int32_t)min(base64, (int64_t)n);  // past n: no position

  // 1-2. the running max of the thread's reports, the targets, the accept bits
  int32_t run[kItems], target[kItems];
  uint32_t acc_bits = 0;
  int32_t m = kNone;
  if (base64 + kItems <= n) {
    const uint4 s = load_bools(start + base, align_of(aligned, kStart));
    const uint4 p = load_bools(pending + base, align_of(aligned, kPending));
    const uint4 a = load_bools(acc + base, align_of(aligned, kAcc));
    int32_t ro[kItems], len[kItems];
    load_ints(report_off + base, align_of(aligned, kReport) == 2, ro);
    load_ints(length + base, align_of(aligned, kLength) == 2, len);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int32_t i = base + k;
      if (byte_of(s, k) && !byte_of(p, k)) m = max(m, wrap_add(i, ro[k]));
      run[k] = m;
      target[k] = wrap_add(i, len[k] - 1);
      acc_bits |= (uint32_t)byte_of(a, k) << k;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int32_t i = base + k;
      const bool in = base64 + k < n;
      if (in && start[i] && !pending[i]) m = max(m, wrap_add(i, report_off[i]));
      run[k] = m;
      target[k] = in ? wrap_add(i, length[i] - 1) : 0;
      acc_bits |= (uint32_t)(in && acc[i]) << k;
    }
  }

  // 3. the threads' exclusive prefixes in the warp, the warps' in the tile
  const int32_t incl = warp_scan<32>(m, lane, Max());
  int32_t excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = kNone;
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();

  // 4. across tiles
  if (warp == 0) {
    const int32_t w =
        warp_scan<kWarps>(lane < kWarps ? warp_total[lane] : kNone, lane, Max());
    const int32_t agg = __shfl_sync(kFull, w, kWarps - 1);
    int32_t wex = __shfl_up_sync(kFull, w, 1);
    if (lane == 0) wex = kNone;
    const int32_t prefix = look_back(status, tile, agg, lo, kNone, false, lane, Max());
    if (lane < kWarps) warp_prefix[lane] = max(prefix, wex);
  }
  __syncthreads();

  // 5. the clamp, the compare, the stores
  const int32_t pre = max(warp_prefix[warp], excl);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int32_t M = max(pre, run[k]);
    const bool f = ((acc_bits >> k) & 1) && M == target[k];
    w[k >> 2] |= (uint32_t)f << (8 * (k & 3));
    if (base64 + k == (int64_t)n - 1) *last = M;
  }
  if (base64 + kItems <= n && align_of(aligned, kOut) == 2) {
    *reinterpret_cast<uint4*>(out + base) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (base64 + k < n) out[base + k] = (uint8_t)((w[k >> 2] >> (8 * (k & 3))) & 1);
  }
}

int align_bits(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return a % 16 == 0 ? 2 : a % 4 == 0 ? 1 : 0;
}

}  // namespace

// Enqueue the kernel on `stream`. scratch: uint64[ceil(n / 4096) + 1] (the
// tile ticket, then one status word a tile), zeroed here on the stream;
// out: bool[n]; last: int32[1]. Requires 0 < n < 2^31 and -1 <= lo < 2^31.
extern "C" int report_clamp_launch(const void* start, const void* pending, const void* acc,
                                   const void* report_off, const void* length, int64_t n,
                                   int64_t lo, void* scratch, void* out, void* last, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0 || n > INT32_MAX || lo < -1 || lo > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * sizeof(uint64_t), s);
  if (e != cudaSuccess) return (int)e;
  const int aligned = align_bits(start) << (2 * kStart) | align_bits(pending) << (2 * kPending) |
                      align_bits(acc) << (2 * kAcc) | align_bits(report_off) << (2 * kReport) |
                      align_bits(length) << (2 * kLength) | align_bits(out) << (2 * kOut);
  report_clamp_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(start), static_cast<const uint8_t*>(pending),
      static_cast<const uint8_t*>(acc), static_cast<const int32_t*>(report_off),
      static_cast<const int32_t*>(length), (int32_t)n, (int32_t)lo,
      static_cast<uint32_t*>(scratch), static_cast<uint64_t*>(scratch) + 1,
      static_cast<uint8_t*>(out), static_cast<int32_t*>(last), aligned);
  return (int)cudaGetLastError();
}
