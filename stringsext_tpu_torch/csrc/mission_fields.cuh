// Per-byte mission fields shared by the lanes kernels (mission_lanes.cu,
// single_mission_lanes.cu, swar_lanes.cu): the device-side twins of
// stringsext_tpu/ops/pallas_scan.py's `_utf8_field` (:71) and
// `_utf16_field` (:188), and of stringsext_tpu/ops/pallas_swar.py's
// `swar_utf8_panel` (:334), which is the first under a byte table, and
// `swar_utf16_panel` (:461), under a list of code-point intervals.
//
// A field is 7 bits: accept b0, event length b1-3 (at event starts), grep
// b4, start b5, valid start b6. A thread owns 16 stream bytes and holds
// every bit of their fields as a uint32 mask over its 24-byte window (the
// word before its four, the four, the word after: bit i + 4 = window byte i,
// the own bytes at bits 8-23). A field depends on the bytes 3 back and 3
// ahead of its own, so the window holds them all, each window position's
// predicates are computed once for all its neighbours, and lookbacks and
// lookaheads are shifts (byte_masks.cuh). Only what is not a function of
// one byte's value is done byte by byte: the filter lookup, in a table in
// shared memory. At the end the seven masks of a mission are spread back
// into one byte a position, the sixteen own positions by two bit transposes.

#pragma once

#include <stdint.h>

#include "byte_masks.cuh"

namespace {

constexpr int kLanesThreads = 256;  // whole warps: the window comes by shuffle
constexpr unsigned kFullWarp = 0xFFFFFFFFu;
constexpr int kOwnBit = 8;  // window bit of the thread's own byte 0: a whole byte up

struct MissionParams {
  int32_t af[4];   // AF mask, 128 bits (ASCII codepoints)
  int32_t ubf[2];  // UBF mask, 64 bits (UTF-8 lead byte & 0x3F)
  int32_t grep;    // grep codepoint, -1: none
  int32_t pad;
};

// `q` holds af0..af3, ubf0, ubf1, grep, pad: one row of the host table.
inline MissionParams mission_params(const int32_t* q) {
  MissionParams p;
  for (int k = 0; k < 4; ++k) p.af[k] = q[k];
  p.ubf[0] = q[4];
  p.ubf[1] = q[5];
  p.grep = q[6];
  p.pad = q[7];
  return p;
}

// The filter as one 256-bit table `t` (8 words, shared memory): index v
// below 128 is AF bit v, index 128 + x is UBF bit x & 0x3F. A UTF-8 byte
// looks itself up (a byte from 0x80 on is tested as lead & 0x3F, and v &
// 0x3F picks the same word and bit as 128 + (v & 0x3F) does); a decoded
// code point looks up 128 + (the lead byte of its UTF-8 form & 0x3F).
__device__ __forceinline__ void store_filter_table(uint32_t* t, const MissionParams& p) {
  t[0] = p.af[0];
  t[1] = p.af[1];
  t[2] = p.af[2];
  t[3] = p.af[3];
  t[4] = t[6] = p.ubf[0];
  t[5] = t[7] = p.ubf[1];
}

// The thread's window of words: c[0] the word before its own four, c[1..4]
// the four (one 16-byte load), c[5] the word after. Neighbours within the
// warp hand each other their edge words; the warp's first and last lane
// load theirs. The stream's edge context is the reference's. For the lanes
// kernels of pallas_scan.py that is not zeros: their halo blocks are clamped
// duplicates (pallas_scan.py:303-316, :462-477), so word 1023 (stream bytes
// 4092-4095) stands before word 0 and word `tail_word` ((R-32)*32, the start
// of row R-32) after the last. With kZeroEdges the stream is surrounded by
// zero bytes instead, as pallas_swar.py's kernels have it (`_edge_halos`
// :546), and `tail_word` is not read. Every thread of the warp must call it
// (`i` is the thread's index, its own words are 4i..4i+3).
template <bool kZeroEdges = false>
__device__ __forceinline__ void load_window(const uint32_t* __restrict__ data, int64_t i,
                                            int64_t nwords, int64_t tail_word,
                                            uint32_t (&c)[6]) {
  const int lane = threadIdx.x & 31;
  const uint4 own = __ldg(reinterpret_cast<const uint4*>(data) + i);
  c[1] = own.x;
  c[2] = own.y;
  c[3] = own.z;
  c[4] = own.w;
  c[0] = __shfl_up_sync(kFullWarp, c[4], 1);
  c[5] = __shfl_down_sync(kFullWarp, c[1], 1);
  if (kZeroEdges) {
    if (lane == 0) c[0] = i == 0 ? 0u : __ldg(data + 4 * i - 1);
    if (lane == 31) c[5] = 4 * i + 4 == nwords ? 0u : __ldg(data + 4 * i + 4);
  } else {
    if (lane == 0) c[0] = __ldg(data + (i == 0 ? 1023 : 4 * i - 1));
    if (lane == 31) c[5] = __ldg(data + (4 * i + 4 == nwords ? tail_word : 4 * i + 4));
  }
}

// The bit planes of the 24 window bytes: three transposes of 8 bytes, then
// plane k's three bytes are picked into one word.
__device__ __forceinline__ void window_planes(const uint32_t (&c)[6], uint32_t (&W)[8]) {
  uint32_t lo[3], hi[3];  // planes 0-3 and 4-7 of window bytes 8g..8g+7
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    lo[g] = c[2 * g];
    hi[g] = c[2 * g + 1];
    transpose8(lo[g], hi[g]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t(&t)[3] = k < 4 ? lo : hi;
    const uint32_t sel = (k & 3) | ((4 + (k & 3)) << 4);  // byte k of t[0], of t[1]
    const uint32_t low16 = __byte_perm(t[0], t[1], sel);
    const uint32_t bytes = __byte_perm(low16, t[2], 0x0010u | ((4 + (k & 3)) << 8)) & 0x00FFFFFFu;
    W[k] = bytes << (kOwnBit - 4);  // window byte 4 is the own byte 0
  }
}

// One mission's field bits as window masks: m[b] holds bit b of the field
// of every window byte (right at the own bytes).
struct FieldMasks {
  uint32_t m[7];
};

// The thread's own bytes that a filter table holds, at their window bits.
// `table` is 256 bits in 8 words (shared memory): bit v & 31 of word v >> 5
// for byte value v.
__device__ __forceinline__ uint32_t table_passes(const uint32_t (&c)[6], const uint32_t* table) {
  uint32_t passes = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t v = (c[1 + (i >> 2)] >> (8 * (i & 3))) & 0xFFu;
    passes = __funnelshift_r(passes, table[v >> 5] >> (v & 31), 1);  // enters at bit 31
  }
  return passes >> (16 - kOwnBit);
}

// The same from the table spread out to 256 bytes of 0 or 1 (shared memory):
// a byte costs its extraction and one load, and the sum is a multiply-add.
__device__ __forceinline__ uint32_t byte_table_passes(const uint32_t (&c)[6],
                                                      const uint8_t* table) {
  uint32_t passes = 0;
#pragma unroll
  for (int i = 15; i >= 0; --i) {
    const uint32_t v = (c[1 + (i >> 2)] >> (8 * (i & 3))) & 0xFFu;
    passes = 2u * passes + table[v];
  }
  return passes << kOwnBit;
}

// pallas_scan.py::_utf8_field; `passes`: the bytes that the filter holds.
__device__ __forceinline__ FieldMasks utf8_field_masks(const uint32_t (&W)[8], uint32_t passes,
                                                       int grep) {
  const Utf8Masks u = utf8_structure(W);
  FieldMasks f;
  f.m[0] = u.is_start & u.ev_valid & passes;
  f.m[1] = u.s1 | u.s3;  // length bit 0
  f.m[2] = u.s2 | u.s3;  // length bit 1
  f.m[3] = u.s4;         // length bit 2
  f.m[4] = grep >= 0 ? f.m[0] & bytes_equal(W, grep) : 0u;
  f.m[5] = u.is_start;
  f.m[6] = u.is_start & u.ev_valid;
  return f;
}

// pallas_scan.py::_utf16_field; the masks have bits at even positions only
// (the first byte of a unit).
__device__ __forceinline__ FieldMasks utf16_field_masks(const uint32_t (&c)[6],
                                                        const uint32_t (&W)[8], bool be,
                                                        const uint32_t* table, int grep) {
  const Utf16Masks s = utf16_structure(W, be);
  // own unit j is half j of d[0..3], the unit after the own 8 is d[4]'s first
  uint32_t d[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) d[k] = be ? __byte_perm(c[1 + k], 0, 0x2301) : c[1 + k];
  uint32_t passes = 0, grep_hit = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bit = kOwnBit + 2 * j;
    const int u = (d[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
    const int un = (d[(j + 1) >> 1] >> (16 * ((j + 1) & 1))) & 0xFFFF;
    const int cp = ((s.pair >> bit) & 1u) ? 0x10000 + ((u & 0x3FF) << 10) + (un & 0x3FF) : u;
    // 128 + (lead byte of cp's UTF-8 form & 0x3F)
    const int idx = cp < 0x80      ? cp
                    : cp < 0x800   ? 128 + (cp >> 6)
                    : cp < 0x10000 ? 128 + (0x20 | (cp >> 12))
                                   : 128 + (0x30 | (cp >> 18));
    passes |= ((table[idx >> 5] >> (idx & 31)) & 1u) << bit;
    grep_hit |= (cp == grep ? 1u : 0u) << bit;
  }
  FieldMasks f;
  f.m[0] = s.valid & passes;
  f.m[1] = 0u;
  f.m[2] = s.start & ~s.pair;  // length 2
  f.m[3] = s.start & s.pair;   // length 4
  f.m[4] = f.m[0] & grep_hit;
  f.m[5] = s.start;
  f.m[6] = s.valid;
  return f;
}

// pallas_swar.py::swar_utf16_panel (:461): the same field under a filter
// that is a list of `niv` code-point intervals, iv[2k] to iv[2k + 1]
// inclusive (shared memory; code points and bounds are below 2^30). A
// surrogate pair is tested as its decoded code point only where `astral`
// says that an interval reaches the astral planes or the surrogates
// (:389-404); otherwise the raw unit is, which no interval then holds.
// A code point lies in [lo, hi] iff neither cp - lo nor hi - cp is negative,
// i.e. iff the sign bit of their OR is clear: two subtractions, which the
// multiply-add pipe takes, and one logic operation an interval, where a
// compare, a select and an OR would all go to the integer pipe. The interval
// loop runs outside the unit loop, two intervals a turn, so a bound is read
// once for the thread's eight units; miss[j] keeps its sign bit while no
// interval so far holds unit j.
__device__ __forceinline__ FieldMasks utf16_interval_field_masks(
    const uint32_t (&c)[6], const uint32_t (&W)[8], bool be, bool astral, const int32_t* iv,
    int niv, int grep) {
  const Utf16Masks s = utf16_structure(W, be);
  uint32_t d[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) d[k] = be ? __byte_perm(c[1 + k], 0, 0x2301) : c[1 + k];
  int cp[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cp[j] = (d[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
  if (astral) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // ascending: cp[j + 1] is still the raw unit
      const int un = j < 7 ? cp[j + 1] : (int)(d[4] & 0xFFFFu);
      if ((s.pair >> (kOwnBit + 2 * j)) & 1u)
        cp[j] = 0x10000 + ((cp[j] & 0x3FF) << 10) + (un & 0x3FF);
    }
  }
  int miss[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) miss[j] = -1;
#pragma unroll 1
  for (int k = 0; k < niv; k += 2) {
    const int lo0 = iv[2 * k], hi0 = iv[2 * k + 1];
    const bool two = k + 1 < niv;  // an odd list ends with the empty interval [1, 0]
    const int lo1 = two ? iv[2 * k + 2] : 1, hi1 = two ? iv[2 * k + 3] : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      miss[j] &= ((cp[j] - lo0) | (hi0 - cp[j])) & ((cp[j] - lo1) | (hi1 - cp[j]));
  }
  // Bits 30 and 31 of miss[j] are equal, so two bits a unit go in at the
  // bottom and unit j ends at bits 2j and 2j + 1: the even one is used.
  uint32_t missed = 0;
#pragma unroll
  for (int j = 7; j >= 0; --j) missed = __funnelshift_l((uint32_t)miss[j], missed, 2);
  uint32_t grep_hit = 0;
  if (grep >= 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) grep_hit |= cp[j] == grep ? (1u << (kOwnBit + 2 * j)) : 0u;
  }
  FieldMasks f;
  f.m[0] = s.valid & ~(missed << kOwnBit);
  f.m[1] = 0u;
  f.m[2] = s.start & ~s.pair;  // length 2
  f.m[3] = s.start & s.pair;   // length 4
  f.m[4] = f.m[0] & grep_hit;
  f.m[5] = s.start;
  f.m[6] = s.valid;
  return f;
}

// The fields of all 16 own bytes as four words, v[q] those of the own bytes
// 4q..4q+3: the masks' own bits are the rows of two 8 x 8 bit matrices (own
// bytes 0-7 and 8-15; row b is mask b, row 7 is empty), and a transpose
// turns a row a mask into a byte a position. The own bits fill bytes 1 and 2
// of a mask, so the rows are picked bytewise.
__device__ __forceinline__ void field_words(const uint32_t (&m)[7], uint32_t (&v)[4]) {
  static_assert(kOwnBit == 8, "the own bits must fill bytes 1 and 2 of a mask");
  // masks a and b -> a's byte 1, b's byte 1, a's byte 2, b's byte 2
  const uint32_t p01 = __byte_perm(m[0], m[1], 0x6251);
  const uint32_t p23 = __byte_perm(m[2], m[3], 0x6251);
  const uint32_t p45 = __byte_perm(m[4], m[5], 0x6251);
  const uint32_t p6 = __byte_perm(m[6], 0u, 0x6251);
  v[0] = __byte_perm(p01, p23, 0x5410);  // rows 0-3, own bytes 0-7
  v[1] = __byte_perm(p45, p6, 0x5410);   // rows 4-7
  v[2] = __byte_perm(p01, p23, 0x7632);  // rows 0-3, own bytes 8-15
  v[3] = __byte_perm(p45, p6, 0x7632);
  transpose8(v[0], v[1]);
  transpose8(v[2], v[3]);
}

// A warp's 128 results of 16 bytes, each thread holding numbers 4 lane ..
// 4 lane + 3, leave as four stores of 512 contiguous bytes each: staged
// through shared memory (`stage`: the block's kLanesThreads * 4 slots, 2 KB
// a warp) with an XOR swizzle of the slot number that keeps the 16-byte
// writes and the 16-byte reads free of bank conflicts. `i` is the thread's
// index, as in load_window.
__device__ __forceinline__ void store_fields(int4* __restrict__ out, int64_t i,
                                             const int4 (&v)[4], int4* stage) {
  const int lane = threadIdx.x & 31;
  int4* w = stage + (threadIdx.x >> 5) * 128;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = 4 * lane + q;
    w[n ^ ((n >> 3) & 7)] = v[q];
  }
  __syncwarp();
  int4* dst = out + 4 * (i - lane);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = 32 * r + lane;
    dst[n] = w[n ^ ((n >> 3) & 7)];
  }
}

}  // namespace
