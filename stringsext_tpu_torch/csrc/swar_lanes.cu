// Packed per-byte mission field words of the flagship trio (UTF-8, UTF-16LE,
// UTF-16BE) in one pass, on Hopper: the "lanes" of the SWAR kernels.
//
// Replaces stringsext_tpu/ops/pallas_swar.py::flagship_swar_lanes (:590,
// kernel _flagship_swar_kernel :572) and meets its contract bit for bit:
//   in   uint32 words[rows][128], little-endian, 4 stream bytes per word;
//   out  int32 out[3][rows][128]: mission s's field word for each word.
// A field is 7 bits per stream byte: accept b0, char length b1-3 (at char
// starts), grep b4, start b5, valid start b6 (swar_utf8_panel :334). UTF-16
// fields sit at each unit's first byte, so a word holds unit 2i at bits 0-7
// and unit 2i+1 at bits 16-23 and its odd bytes are zero (swar_utf16_panel
// :461). The stream behaves as if surrounded by zero bytes (the reference
// zeroes its edge halos, :546), unlike the lanes kernels of pallas_scan.py.
//
// The missions come as the packed int32 table of stringsext_tpu_torch/ops/
// swar.py::pack_specs, the one swar_counts.cu reads: three 88-int records
// (UTF-8, UTF-16LE, UTF-16BE, in this order: flagship_specs), copied to
// shared memory by each block. Of the UTF-8 record the kernel reads the grep
// byte and table A, the 256-bit table of the accepted bytes; of a UTF-16
// record the astral flag, the grep code point and interval list A.
//
// What bounds it on this card. DRAM traffic is 1 byte read and 3 bytes
// written per stream byte: 268.4 MB at 64 MiB, 0.080 ms at the data sheet's
// 3.35 TB/s and 0.090 ms at the 2.98 TB/s that a device-to-device copy_
// reaches. The arithmetic is 32-bit integer work on every byte. Counted in
// the compiled code (cuobjdump -sass), a thread executes about 700
// instructions for its 16 bytes under the default filters (two UTF-16
// intervals a mission, no grep char): about 500 go to the integer pipe
// (logic, shifts, permutes, compares), which an SM's 64 INT32 lanes take at
// one warp instruction every two cycles a scheduler, the rest are
// multiply-adds (shifts left and subtractions among them) and memory
// operations. 131072 warps x 500 x 2 cycles over 132 SMs x 4 schedulers at
// 1.98 GHz are 0.125 ms: the kernel is bounded by integer instruction issue
// at about one and a half times its byte bound (scripts/swar_lanes_bound.py
// times it without its stores and without its arithmetic), and the design
// is about spending fewer integer-pipe operations on each byte.
//
// Design (mission_fields.cuh, byte_masks.cuh). One thread per 16 stream
// bytes, one warp per 512-byte row: one 16-byte load, the word before and
// the word after from the neighbouring lanes by shuffle (the warp's first
// and last lane load theirs, zero outside the stream), a 24-byte window.
//  - The bit planes of the window are made once for all three missions, by
//    three 8 x 8 bit transposes; every predicate of a byte's value is then
//    one uint32 over the window, and lookbacks and lookaheads are shifts.
//  - The UTF-8 accept set is the record's 256-bit table, which each block
//    spreads out to 256 bytes of shared memory: a lookup is a byte
//    extraction and a load, instead of two interval lists walked a byte.
//  - UTF-16 units stand at the even bits of the same window: LE and BE share
//    the planes and the surrogate classes. Only the code-point intervals are
//    tested unit by unit, eight own units a thread, two intervals a turn
//    with each bound read once for the eight; a test is two subtractions
//    and one logic operation on their sign bits.
//  - The seven masks of a mission go back to bytes by two more transposes
//    for the 16 own bytes; the BE masks ride one bit above the LE masks,
//    which stand at even positions only, so one spread serves both orders.
//  - The grep compares are a template argument: without a grep char their
//    masks are zero when the kernel is compiled.
// A thread then holds four words a mission and stores them as one 16 bytes,
// and a warp writes 512 contiguous bytes of each output: nothing is staged
// through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mission_fields.cuh"

namespace {

// Table layout: keep in step with swar.py (_REC, _HDR, _MAX_IV, H_*, T_A).
constexpr int kRec = 88;
constexpr int kHdr = 8;  // interval list A starts here
constexpr int kMaxIv = 16;
constexpr int kTabA = kHdr + 4 * kMaxIv;  // 256-bit table of the UTF-8 lists
constexpr int hAstral = 2, hGrep = 4, hNa = 5;
constexpr int kMissions = 3;

// kGrep: a mission has a grep char. Without one the grep masks are zero when
// the kernel is compiled, and their compares and their share of the spread go.
template <bool kGrep>
__global__ void __launch_bounds__(kLanesThreads)
flagship_swar_lanes_kernel(const uint32_t* __restrict__ words, int64_t nwords,
                           int4* __restrict__ out, const int32_t* __restrict__ table) {
  __shared__ int32_t rec[kMissions * kRec];
  __shared__ uint8_t pass8[256];  // 1: the UTF-8 filter holds the byte value
  for (int k = threadIdx.x; k < kMissions * kRec; k += kLanesThreads) rec[k] = __ldg(table + k);
  for (int v = threadIdx.x; v < 256; v += kLanesThreads)
    pass8[v] = ((uint32_t)__ldg(table + kTabA + (v >> 5)) >> (v & 31)) & 1u;
  __syncthreads();
  // The thread's own words are 4i..4i+3. A warp is one row, so past the
  // last row whole warps leave.
  const int64_t i = (int64_t)blockIdx.x * kLanesThreads + threadIdx.x;
  if (4 * i >= nwords) return;
  uint32_t c[6], W[8];
  load_window<true>(words, i, nwords, 0, c);
  window_planes(c, W);
  const int32_t *r8 = rec, *rle = rec + kRec, *rbe = rec + 2 * kRec;
  const FieldMasks f8 = utf8_field_masks(W, byte_table_passes(c, pass8), kGrep ? r8[hGrep] : -1);
  const FieldMasks le = utf16_interval_field_masks(c, W, false, rle[hAstral] != 0, rle + kHdr,
                                                   rle[hNa], kGrep ? rle[hGrep] : -1);
  const FieldMasks be = utf16_interval_field_masks(c, W, true, rbe[hAstral] != 0, rbe + kHdr,
                                                   rbe[hNa], kGrep ? rbe[hGrep] : -1);
  // LE fields stand at even positions, so the BE fields fit one above
  uint32_t m16[7];
#pragma unroll
  for (int b = 0; b < 7; ++b) m16[b] = le.m[b] | (be.m[b] << 1);
  uint32_t v8[4], v16[4], vle[4], vbe[4];
  field_words(f8.m, v8);
  field_words(m16, v16);  // a word: LE 4q, BE 4q, LE 4q+2, BE 4q+2
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    vle[q] = v16[q] & 0x00FF00FFu;
    vbe[q] = (v16[q] >> 8) & 0x00FF00FFu;
  }
  const int64_t per_mission = nwords / 4;  // int4s
  out[i] = make_int4(v8[0], v8[1], v8[2], v8[3]);
  out[per_mission + i] = make_int4(vle[0], vle[1], vle[2], vle[3]);
  out[2 * per_mission + i] = make_int4(vbe[0], vbe[1], vbe[2], vbe[3]);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the caller raises when it is not cudaSuccess. `table`
// is device memory: the three records of the trio; `any_grep` says whether
// one of them holds a grep char; `words` and `out` are 16-byte aligned.
extern "C" int swar_lanes_launch(const void* words, int64_t rows, void* out,
                                 const void* table, int any_grep, int device,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  constexpr int kRowsPerBlock = kLanesThreads / 32;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (rows < 1 || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  auto kernel = any_grep ? flagship_swar_lanes_kernel<true> : flagship_swar_lanes_kernel<false>;
  kernel<<<(unsigned)blocks, kLanesThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), rows * 128, static_cast<int4*>(out),
      static_cast<const int32_t*>(table));
  return (int)cudaGetLastError();
}
