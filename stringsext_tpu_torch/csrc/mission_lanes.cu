// Per-byte mission fields of the UTF-8, UTF-16LE and UTF-16BE missions in
// one pass, on Hopper: the lanes kernel of the run-table step's fallback.
//
// Replaces stringsext_tpu/ops/pallas_scan.py::flagship_mission_lanes (:291,
// kernel _flagship_kernel :257; fields _utf8_field :71 and _utf16_field
// :188) and meets its contract bit for bit:
//   in   uint8 data[R][128] (R >= 32, R % 32 == 0), viewed as uint32 words;
//        params int32 (3, 8): per mission af0..af3, ubf0, ubf1, grep, pad;
//   out  int32 out[R][128]: mission 0's 7-bit field at bits 0-6, mission
//        1's (UTF-16LE) at 8-14, mission 2's (UTF-16BE) at 16-22.
// A field: accept b0, event length b1-3 (at event starts), grep b4, start
// b5, valid start b6. UTF-16 fields stand at even stream positions.
//
// Stream-edge context is the reference's, not zeros. Its halo blocks are
// clamped duplicates (pallas_scan.py:303-316): the 3 bytes "before" byte 0
// are stream bytes 4093-4095 (the end of row 31) and the 3 bytes "after"
// the last byte are the first bytes of row R-32. This kernel reads the same
// bytes, so a UTF-8 lead in the last byte can form a char with row R-32's
// first bytes, exactly as in the reference.
//
// What bounds it on this card. DRAM traffic is 1 byte read and 4 bytes
// written per input byte: 64 MiB in and 256 MiB out, ~100 us at 3.35 TB/s.
// A first version that derived every byte's field on its own (a 12-byte
// window for 4 own bytes, the UTF-8 claim test re-deriving the events 1-3
// bytes back, three code units rebuilt per position and byte order) took
// many times that: the kernel is bounded by 32-bit integer instruction
// throughput first, and by how its stores reach memory second. The design
// spends fewer operations on each byte and stores whole 512-byte runs.
//
// Design (mission_fields.cuh, byte_masks.cuh). One thread per 16 input
// bytes: one 16-byte load, the word before and the word after from the
// neighbouring lanes by shuffle (the warp's first and last lane load
// theirs, with the edge rule above: word 1023 before word 0, word
// (R-32)*32 after the last), a 24-byte window for 16 own bytes. The eight
// bit planes of the window are made by three 8 x 8 bit transposes; every
// predicate is then one uint32 over the window, so each position's event
// is computed once and `claimed` and the lookaheads are shifts. UTF-16
// units stand at the even bits of the same window: the LE and BE missions
// share the planes and the surrogate classes, which depend on a unit's
// high byte alone, and differ in which byte that is. The filters are
// 256-bit tables in shared memory, looked up a byte (UTF-8) or a decoded
// code point (UTF-16) at a time; no register array is indexed by data. The
// masks of the three missions are spread back to bytes by bit transposes,
// two for the 16 own bytes of a mission (the BE bits ride one position above
// the LE bits, which stand at even positions only, so they share theirs). A thread's 16 results are 64 contiguous bytes;
// written from the thread, a warp's store would touch 32 separate half
// sectors, so the warp stages its 2 KB through shared memory and stores
// four runs of 512 contiguous bytes (store_fields). The per-mission
// kernels of pallas_scan.py (utf8_mission_lanes :499, utf16_mission_lanes
// :367) are the same functions under the launchers of
// single_mission_lanes.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mission_fields.cuh"

namespace {

struct FlagshipParams {
  MissionParams m[3];
};

__global__ void __launch_bounds__(kLanesThreads)
flagship_mission_lanes_kernel(const uint32_t* __restrict__ data, int64_t nwords,
                              int64_t tail_word, int4* __restrict__ out,
                              FlagshipParams prm) {
  __shared__ uint32_t table[3][8];
  __shared__ int4 stage[kLanesThreads * 4];
  if (threadIdx.x == 0) {
    store_filter_table(table[0], prm.m[0]);
    store_filter_table(table[1], prm.m[1]);
    store_filter_table(table[2], prm.m[2]);
  }
  __syncthreads();
  // nwords is a multiple of 4 * kLanesThreads (R % 32 == 0): no thread is idle
  const int64_t i = (int64_t)blockIdx.x * kLanesThreads + threadIdx.x;
  uint32_t c[6], W[8];
  load_window(data, i, nwords, tail_word, c);
  window_planes(c, W);
  const FieldMasks f8 = utf8_field_masks(W, table_passes(c, table[0]), prm.m[0].grep);
  const FieldMasks le = utf16_field_masks(c, W, false, table[1], prm.m[1].grep);
  const FieldMasks be = utf16_field_masks(c, W, true, table[2], prm.m[2].grep);
  // LE fields stand at even positions, so the BE fields fit one above
  uint32_t m16[7];
#pragma unroll
  for (int b = 0; b < 7; ++b) m16[b] = le.m[b] | (be.m[b] << 1);
  uint32_t v8[4], v16[4];
  field_words(f8.m, v8);  // word q: the UTF-8 fields of the own bytes 4q..4q+3
  field_words(m16, v16);  // LE 4q, BE 4q, LE 4q+2, BE 4q+2
  int4 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t f = v8[q], g = v16[q];
    v[q] = make_int4((f & 0xFFu) | ((g & 0xFFFFu) << 8), (f >> 8) & 0xFFu,
                     ((f >> 16) & 0xFFu) | ((g >> 16) << 8), f >> 24);
  }
  store_fields(out, i, v, stage);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the caller raises when it is not cudaSuccess.
// `params` is host memory: the (3, 8) int32 table, passed by value.
extern "C" int flagship_mission_lanes_launch(const void* data, int64_t rows, void* out,
                                             const int32_t* params, int device,
                                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  FlagshipParams prm;
  for (int m = 0; m < 3; ++m) prm.m[m] = mission_params(params + 8 * m);
  const int64_t nwords = rows * 32;
  if (rows < 32 || rows % 32) return (int)cudaErrorInvalidValue;
  const int64_t blocks = nwords / (4 * kLanesThreads);
  flagship_mission_lanes_kernel<<<(unsigned)blocks, kLanesThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(data), nwords, (rows - 32) * 32,
      static_cast<int4*>(out), prm);
  return (int)cudaGetLastError();
}
