// Byte predicates as bits of a uint32 over a window of stream bytes, shared
// by swar_counts.cu (a 32-byte window a lane) and the lanes kernels
// (mission_fields.cuh, a 24-byte window a thread).
//
// Bit i of every mask stands for window byte i, so a lookahead by k bytes
// is `>> k` and a lookback `<< k`: the SWAR algebra of
// stringsext_tpu/ops/pallas_swar.py (`_utf8_structure` :161, `_utf16_*`
// :370-461) on one register a predicate. The eight bit planes of the bytes
// (plane k: bit k of every byte) are gathered from the packed words, four
// bytes an operation (plane8) or all eight planes of eight bytes by a bit
// transpose (transpose8); every predicate that depends on one byte's value
// is then a few logic operations on the planes for the whole window at once.
// Bytes outside the window read as zero.

#pragma once

#include <stdint.h>

namespace {

// Bit k of each of the 8 bytes of (a, b), little-endian and a first, as
// bits 0-7. The masked bytes hold their bit at bit 0 (a) and bit 4 (b); the
// multiply adds the four bytes, each shifted to its own place, into bits
// 24-31, and no two terms meet in one bit, so nothing carries.
__device__ __forceinline__ uint32_t plane8(uint32_t a, uint32_t b, int k) {
  constexpr uint32_t kLsb = 0x01010101u, kGather = 0x01020408u;
  return ((((a >> k) & kLsb) | (((b >> k) & kLsb) << 4)) * kGather) >> 24;
}

// All eight planes of the 8 bytes of (a, b) at once: the bytes are the rows
// of an 8 x 8 bit matrix, and three rounds of swaps (of single bits, of 2 x 2
// and of 4 x 4 blocks across the diagonal) transpose it. Afterwards byte k of
// `a` is plane k, as plane8(a, b, k) gives it, and byte k of `b` plane 4 + k.
__device__ __forceinline__ void transpose8(uint32_t& a, uint32_t& b) {
  uint32_t t;
  t = (a ^ (a >> 7)) & 0x00AA00AAu;
  a ^= t ^ (t << 7);
  t = (b ^ (b >> 7)) & 0x00AA00AAu;
  b ^= t ^ (t << 7);
  t = (a ^ (a >> 14)) & 0x0000CCCCu;
  a ^= t ^ (t << 14);
  t = (b ^ (b >> 14)) & 0x0000CCCCu;
  b ^= t ^ (t << 14);
  t = (a & 0x0F0F0F0Fu) | ((b << 4) & 0xF0F0F0F0u);
  b = ((a >> 4) & 0x0F0F0F0Fu) | (b & 0xF0F0F0F0u);
  a = t;
}

// The filter-independent UTF-8 masks (pallas_swar.py::_utf8_structure):
// is_start, ev_valid and sL = starts an event (a char, or a malformed
// sequence's maximal subpart) of length L. A bit is right where the window
// holds the 3 bytes before it and the 3 after it.
struct Utf8Masks {
  uint32_t is_start, ev_valid, s1, s2, s3, s4;
};

__device__ __forceinline__ Utf8Masks utf8_structure(const uint32_t (&W)[8]) {
  const uint32_t top2 = W[7] & W[6];        // 0xC0-0xFF
  const uint32_t top4 = top2 & W[5] & W[4];  // 0xF0-0xFF
  const uint32_t low0 = ~(W[3] | W[2] | W[1] | W[0]);  // low nibble 0
  const uint32_t cont = W[7] & ~W[6];                  // 0x80-0xBF
  const uint32_t l1 = ~W[7];
  const uint32_t l2 = top2 & ~W[5] & (W[4] | W[3] | W[2] | W[1]);  // 0xC2-0xDF
  const uint32_t l3 = top2 & W[5] & ~W[4];                         // 0xE0-0xEF
  const uint32_t l4 = top4 & ~W[3] & ~(W[2] & (W[1] | W[0]));      // 0xF0-0xF4
  const uint32_t xe0 = l3 & low0;
  const uint32_t xed = l3 & W[3] & W[2] & ~W[1] & W[0];
  const uint32_t xf0 = top4 & low0;
  const uint32_t xf4 = top4 & ~W[3] & W[2] & ~W[1] & ~W[0];
  const uint32_t c1 = cont >> 1, c2 = cont >> 2, c3 = cont >> 3;
  // the next byte's bit 5, and its bits 5 or 4: a continuation byte is
  // >= 0xA0 iff bit 5 is set, and >= 0x90 iff bit 5 or bit 4 is
  const uint32_t m5 = W[5] >> 1, m45 = (W[5] | W[4]) >> 1;
  const uint32_t c1ok3 = c1 & ~((xe0 & ~m5) | (xed & m5));
  const uint32_t c1ok4 = c1 & ~((xf0 & ~m45) | (xf4 & m45));
  const uint32_t v2 = l2 & c1;
  const uint32_t v3 = l3 & c1ok3 & c2;
  const uint32_t v4 = l4 & c1ok4 & c2 & c3;
  const uint32_t bad2 = ((l3 & c1ok3) | (l4 & c1ok4)) & ~c2;
  const uint32_t bad3 = l4 & c1ok4 & c2 & ~c3;
  const uint32_t ge2 = v2 | v3 | v4 | bad2 | bad3;
  const uint32_t ge3 = v3 | v4 | bad3;
  // a continuation byte starts an event unless an event starting 1-3
  // bytes back, at a non-continuation byte, claims it
  const uint32_t claimed = ((~cont & ge2) << 1) | ((~cont & ge3) << 2) | ((~cont & v4) << 3);
  Utf8Masks m;
  m.is_start = ~(cont & claimed);
  m.ev_valid = l1 | v2 | v3 | v4;
  m.s2 = m.is_start & (v2 | bad2);
  m.s3 = m.is_start & (v3 | bad3);
  m.s4 = m.is_start & v4;
  m.s1 = m.is_start & ~(m.s2 | m.s3 | m.s4);
  return m;
}

// Window bytes equal to `v` (no bit where v is not a byte value).
__device__ __forceinline__ uint32_t bytes_equal(const uint32_t (&W)[8], int v) {
  if ((unsigned)v > 255u) return 0u;
  uint32_t e = 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < 8; ++k) e &= ((v >> k) & 1) ? W[k] : ~W[k];
  return e;
}

// UTF-16 code units stand at the even bits of a byte window that starts at
// an even stream position: unit j is bit 2j, so a unit ahead is `>> 2`.
constexpr uint32_t kEvenBits = 0x55555555u;

struct Utf16Masks {
  uint32_t start, valid, pair;  // pair: a high surrogate with its low one
};

// pallas_swar.py::_utf16_* / pallas_scan.py::_utf16_field: whether a unit
// is a surrogate depends on its high byte alone, the unit's second byte in
// UTF-16LE and its first in UTF-16BE. Every unit starts an event but the
// low half of a pair; a unit is valid unless it is a lone surrogate.
__device__ __forceinline__ Utf16Masks utf16_structure(const uint32_t (&W)[8], bool be) {
  const uint32_t sur = W[7] & W[6] & ~W[5] & W[4] & W[3];  // 0xD8-0xDF
  const uint32_t hi_b = sur & ~W[2], lo_b = sur & W[2];    // 0xD8-0xDB, 0xDC-0xDF
  const uint32_t hi = (be ? hi_b : hi_b >> 1) & kEvenBits;
  const uint32_t lo = (be ? lo_b : lo_b >> 1) & kEvenBits;
  Utf16Masks m;
  m.pair = hi & (lo >> 2);
  const uint32_t trail = m.pair << 2;
  m.start = ~trail & kEvenBits;
  m.valid = ((~hi & ~lo) | m.pair) & m.start;
  return m;
}

}  // namespace
