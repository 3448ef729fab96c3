// Per-byte fields of ONE mission, on Hopper: the per-mission lanes kernels.
//
// Replaces three kernels of stringsext_tpu/ops/pallas_scan.py and meets
// their contract bit for bit:
//   utf8_mission_lanes :499 (kernel _utf8_kernel :139 via _paneled_call
//     :442), utf16_mission_lanes :367 (_utf16_kernel_body(be) :237), with
//     in   uint8 data[R][128] (R >= 32, R % 32 == 0), viewed as uint32
//          words; params int32[8]: af0..af3, ubf0, ubf1, grep, pad;
//   single_byte_mission_lanes :387 (_single_byte_kernel :346), with
//     in   uint8 data[R][128] (the same rows rule, kept for one contract);
//          params int32[17]: accept table (8 words, 256 bits), valid table
//          (8 words), grep byte;
//   out  int32 out[R][128]: the mission's 7-bit field per byte (accept b0,
//        event length b1-3 at event starts, grep b4, start b5, valid
//        start b6; UTF-16 fields stand at even stream positions).
//
// UTF-8 and UTF-16: the design of mission_lanes.cu with one field instead
// of three. One thread per 16 input bytes loads them at once, takes the
// word before and the word after from its neighbours in the warp (with the
// reference's stream-edge context: mission_fields.cuh, load_window: word
// 1023 before word 0, word (R-32)*32 after the last), holds the field bits
// as masks over that 24-byte window, spreads them back to bytes and hands
// its 16 results to the warp's staged 512-byte stores. The mission and, for
// UTF-16, the byte order are template arguments of one kernel.
//
// Single-byte: no window and no context; every byte is a 1-byte event
// (START and length 1), VALID and ACCEPT come from the two 256-bit tables,
// and grep matches the byte itself (as the reference's kernel compares
// the byte, :355). A field depends on the byte value alone, so each block
// first writes the 256 fields into a shared-memory table, one per thread,
// and each thread then looks up its 4 bytes.
//
// What bounds them on this card. DRAM traffic is 1 byte read and 4 bytes
// written per input byte (64 MiB in, 256 MiB out: ~100 us at 3.35 TB/s).
// The UTF-8 and UTF-16 fields cost tens of integer operations per byte; on
// the shared mask-space field code, which computes each window position
// once and stores whole 512-byte runs, they come close to the memory
// bound. The single-byte kernel does one shared-memory lookup per byte and
// is bounded by memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mission_fields.cuh"

namespace {

constexpr int kThreads = 256;

enum Kind { kUtf8 = 0, kUtf16le = 1, kUtf16be = 2 };

template <int kKind>
__global__ void __launch_bounds__(kLanesThreads)
mission_lanes_kernel(const uint32_t* __restrict__ data, int64_t nwords, int64_t tail_word,
                     int4* __restrict__ out, MissionParams prm) {
  __shared__ uint32_t table[8];
  __shared__ int4 stage[kLanesThreads * 4];
  if (threadIdx.x == 0) store_filter_table(table, prm);
  __syncthreads();
  // nwords is a multiple of 4 * kLanesThreads (R % 32 == 0): no thread is idle
  const int64_t i = (int64_t)blockIdx.x * kLanesThreads + threadIdx.x;
  uint32_t c[6], W[8];
  load_window(data, i, nwords, tail_word, c);
  window_planes(c, W);
  const FieldMasks f = kKind == kUtf8 ? utf8_field_masks(W, table_passes(c, table), prm.grep)
                                      : utf16_field_masks(c, W, kKind == kUtf16be, table,
                                                          prm.grep);
  uint32_t w[4];
  field_words(f.m, w);  // UTF-16: zero at odd positions
  int4 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = make_int4(w[q] & 0xFFu, (w[q] >> 8) & 0xFFu, (w[q] >> 16) & 0xFFu, w[q] >> 24);
  store_fields(out, i, v, stage);
}

struct SingleByteParams {
  uint32_t accept[8];  // 256-bit table: the byte's char passes AF/UBF
  uint32_t valid[8];   // 256-bit table: the byte decodes to a char
  int32_t grep;        // grep byte, -1: none
};

__global__ void __launch_bounds__(kThreads)
single_byte_lanes_kernel(const uint32_t* __restrict__ data, int64_t nwords,
                         int4* __restrict__ out, SingleByteParams prm) {
  __shared__ int field[256];
  {
    const int v = threadIdx.x;  // kThreads == 256: one table entry each
    const bool accept = (prm.accept[v >> 5] >> (v & 31)) & 1u;
    const bool valid = (prm.valid[v >> 5] >> (v & 31)) & 1u;
    const bool grep = accept && v == prm.grep;
    field[v] = (int)accept | (1 << 1) | ((int)grep << 4) | (1 << 5) | ((int)valid << 6);
  }
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= nwords) return;
  const uint32_t w = __ldg(data + t);
  out[t] = make_int4(field[w & 0xFF], field[(w >> 8) & 0xFF], field[(w >> 16) & 0xFF],
                     field[w >> 24]);
}

static_assert(kThreads == 256, "single_byte_lanes_kernel fills its table one entry a thread");

template <int kKind>
int launch_mission(const void* data, int64_t rows, void* out, const int32_t* params,
                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t nwords = rows * 32;
  if (rows < 32 || rows % 32) return (int)cudaErrorInvalidValue;
  const int64_t blocks = nwords / (4 * kLanesThreads);
  mission_lanes_kernel<kKind><<<(unsigned)blocks, kLanesThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(data), nwords, (rows - 32) * 32, static_cast<int4*>(out),
      mission_params(params));
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher enqueues its kernel on `stream` (PyTorch's current stream)
// and returns cudaGetLastError(); the caller raises when it is not
// cudaSuccess. `params` is host memory, passed to the kernel by value.

extern "C" int utf8_mission_lanes_launch(const void* data, int64_t rows, void* out,
                                         const int32_t* params, int device, void* stream) {
  return launch_mission<kUtf8>(data, rows, out, params, device, stream);
}

extern "C" int utf16_mission_lanes_launch(const void* data, int64_t rows, void* out,
                                          const int32_t* params, int big_endian, int device,
                                          void* stream) {
  return big_endian ? launch_mission<kUtf16be>(data, rows, out, params, device, stream)
                    : launch_mission<kUtf16le>(data, rows, out, params, device, stream);
}

extern "C" int single_byte_mission_lanes_launch(const void* data, int64_t rows, void* out,
                                                const int32_t* params, int device,
                                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  SingleByteParams prm;
  for (int k = 0; k < 8; ++k) {
    prm.accept[k] = (uint32_t)params[k];
    prm.valid[k] = (uint32_t)params[8 + k];
  }
  prm.grep = params[16];
  const int64_t nwords = rows * 32;
  const int64_t blocks = (nwords + kThreads - 1) / kThreads;
  single_byte_lanes_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(data), nwords, static_cast<int4*>(out), prm);
  return (int)cudaGetLastError();
}
