// Event-chain orbit of the CJK and ISO-2022-JP lanes, on Hopper.
//
// Replaces stringsext_tpu/ops/classify_cjk.py::_orbit_mask_blocked :91, code
// that the JAX package leaves to XLA (two 512-step lax.scans and one
// associative_scan over [nb, 5] transfer tables), and meets its contract bit
// for bit:
//   in   int32 step[cap]; n, start (int64, 0 <= start < 512 * ceil(cap / 512))
//   out  bool out[cap]: out[i] for i < n says the chain from `start` under
//        i -> i + max(step[i], 1) reaches i. As in the reference, a chain
//        that steps to n or past it ends there (the position it steps from
//        is marked), one that stands on a position at or past n ends
//        unmarked, and one that leaves a 512-byte block for an offset past 3
//        of the next block ends. Positions past cap step by 1. Blocks before
//        the start's block are never marked; the start's block is entered at
//        start % 512, which may exceed 3.
//
// Bound: the steps read once and the mask written once, 5 bytes a position
// (335.5 MB, 0.1002 ms at 3.35 TB/s for a 64 MiB piece). The design moves
// those bytes in one kernel: each step is loaded once, 16 bytes a lane with
// all of a warp's loads in flight, and each mask byte stored once, 16 bytes
// a store. (Only the rare blocks of the general path, item 3, read their
// steps a second time.)
//
// Design. A thread owns a segment of 32 positions in each of two rounds; a
// warp covers 1024 positions a round (two blocks of 512), a thread block of
// 8 warps a tile of 2 x 8192.
//   1. Codes. The warp stages its steps in shared memory (coalesced loads,
//      then each lane reads its own 128 bytes from a rotated layout without
//      bank conflicts) and keeps a 2-bit code per position
//      (min(max(step, 1), 4) - 1) and a bit mask "dead": the chain ends here,
//      i + max(step, 1) >= n (which holds for every i >= n as well). On the
//      fast path, every step 1..4 and the segment's end 4 or more before n,
//      no position is dead and the codes are the steps less 1, packed by
//      multiply-adds.
//   2. Segment maps. The state of a chain at a segment boundary is its entry
//      offset 0..3 into the next segment, or DEAD. A segment's map sends each
//      of the five states to the state at its end (five 3-bit fields; DEAD
//      always to DEAD), computed by one backward pass over the 32 positions
//      with the exits of the next four positions in a window (on the fast
//      path four bytes, one byte permute a position).
//      Why these maps are exact: let every position i of a block with
//      i + max(step[i], 1) < n have max(step[i], 1) <= 4. A chain that
//      enters a segment [b, b + 32) at b + e, e in 0..3, moves by steps of
//      at most 4 until it ends or first stands at or past b + 32, which is
//      then at most b + 35: entry 0..3 of the next segment. Its course
//      depends on e alone. A dead position ends it where the reference ends
//      it (i >= n: the reference's cursor freezes unmarked; i + s > n: it
//      goes FAR; i + s = n: it lands on n, which it never leaves and never
//      marks). Block boundaries are segment boundaries (512 = 16 x 32) and
//      every exit offset is at most 3, so the reference's block-end rule
//      never fires in such a block, and composing the segment maps gives
//      the reference's block tables.
//   3. The general path: a block that holds a position with i + step < n and
//      step > 4 (no lanes kind writes one; the contract allows it) is found
//      by a warp vote. Its 16 threads take the reference's walk over its
//      steps in device memory: lanes 0-3 of the half-warp walk from entries
//      0..3 (and lane 4 from the start, in the start's block) to the block's
//      exit, whose offset past 3 ends the chain; the block's map replaces
//      the first segment's, and the other 15 segments take the identity.
//      The block-end rule lives only here. After the look-back one thread
//      walks again from the block's entry and sets the mark bits in shared
//      memory.
//   4. The start as a map. The chain enters the stream DEAD. Segments before
//      the start's keep their maps (DEAD goes to DEAD); the start's segment
//      (or block, on the general path) maps every state to the exit of the
//      walk from start's own offset: a constant map. This equals the
//      reference's identity tables up to the start block plus its e0.
//   5. Composition inside a tile: an inclusive scan of the segment maps by
//      shuffles (5 rounds a warp and round), then warp 0 scans the 16 warp
//      maps (4 rounds): the tile's aggregate and every warp's exclusive
//      map. Each thread keeps its codes, dead bits and exclusive map of each
//      round in shared memory until the marks (in registers they spill).
//   6. Composition across tiles: a decoupled look-back (Merrill and
//      Garland, "Single-pass Parallel Prefix Scan with Decoupled
//      Look-back", NVIDIA, 2016). Tiles are numbered in the order thread
//      blocks start (an atomic ticket), so a tile waits only on tiles whose
//      blocks already run. Each tile publishes one 32-bit status word: flag
//      AGG with its aggregate map at once, flag INCL with the constant map
//      of the state after it once its entry is known (INCL at once when its
//      aggregate is constant). Warp 0 reads 32 predecessors at a time,
//      waits until those up to the nearest INCL are published, and composes
//      them by a shuffle tree (none when the nearest is INCL). Flag and map
//      share one aligned word that carries nothing else, so the words are
//      read and written relaxed at device scope: acquire and release
//      ordering would order no other data and cost 1-2% (scripts/
//      orbit_bound.py). The launcher zeroes ticket and words on the stream
//      before each launch. Every thread applies its exclusive map to the
//      tile's entry state, walks its segment forward once more in registers
//      (a 32-bit window of reached positions) and stores its 32 mask bytes.
//
// What bounds it on this card (scripts/orbit_bound.py times variants of
// this file): the loads and stores alone reach about 85% of the bound; the
// walks and scans, and the look-back's waits for predecessors that have not
// yet published, take the rest. Two rounds a tile halve the tiles to look
// back over (one round: 8192 tiles at 64 MiB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 512;                      // block of the resolve (the reference's _ORBIT_BLOCK)
constexpr int kSeg = 32;                     // positions a thread in a round
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpSpan = 32 * kSeg;         // 1024: two blocks a warp in a round
constexpr int kRound = kWarps * kWarpSpan;   // 8192 positions a round
constexpr int kRounds = 2;
constexpr int kTile = kRounds * kRound;      // 16384 positions a thread block
constexpr int kMaps = kRounds * kWarps;      // warp maps a tile: warp 0 scans them
constexpr int kHalf = kB / kSeg;             // 16 lanes a block
constexpr uint32_t kDead = 4;
// the identity map on {0..4}, five 3-bit fields
constexpr uint32_t kIdent = 0u | (1u << 3) | (2u << 6) | (3u << 9) | (4u << 12);
constexpr uint32_t kOnes = 0x1249;  // 1 in every field
constexpr uint32_t kExits = 0u | (1u << 3) | (2u << 6) | (3u << 9);  // positions 32..35
constexpr uint32_t kFlagAgg = 1u << 16, kFlagIncl = 2u << 16, kMapBits = 0x7FFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kMaps <= 32, "warp 0 scans the warp maps of a tile");

__device__ __forceinline__ uint32_t apply_map(uint32_t m, uint32_t x) { return (m >> (3 * x)) & 7; }

// `first`, then `then`
__device__ __forceinline__ uint32_t compose(uint32_t first, uint32_t then) {
  uint32_t r = 0;
#pragma unroll
  for (int x = 0; x < 5; ++x) r |= apply_map(then, apply_map(first, x)) << (3 * x);
  return r;
}

__device__ __forceinline__ uint32_t const_map(uint32_t x) { return x * kOnes; }
__device__ __forceinline__ bool is_const(uint32_t m) { return m == const_map(m & 7); }

// The int4 slot of a warp's 16-byte chunk q (0..255) of steps: lane q / 8's
// eight chunks form one row, rotated by the lane, so that eight lanes that
// read or write the same chunk of their rows touch eight bank groups.
__device__ __forceinline__ int slot(int q) {
  const int row = q >> 3;
  return (row << 3) | ((q & 7) ^ (row & 7));
}

// Status words: flag and map in one aligned 32-bit word, which carries
// nothing else, so relaxed accesses at device scope suffice (no fences).
__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The forward walk through a segment from the positions set in `a` (bit p:
// the chain stands at p), one of them at most. Returns the positions it
// reaches; `exit_state` gets its entry into the next segment or DEAD.
__device__ __forceinline__ uint32_t walk_segment(uint32_t a, uint64_t codes, uint32_t dead,
                                                 uint32_t* exit_state) {
  uint32_t reached = 0;
#pragma unroll
  for (int p = 0; p < kSeg; ++p) {
    const uint32_t live = a & ~(dead >> p) & 1;
    reached = __funnelshift_r(reached, a, 1);  // bit 0 of a in at the top
    a = (a >> 1) | (live << ((uint32_t)(codes >> (2 * p)) & 3));
  }
  *exit_state = a ? (uint32_t)(__ffs(a) - 1) : kDead;
  return reached;
}

// The reference's walk through the block at `bbase` from offset r, over
// the steps in device memory (the general path's blocks are rare). Sets
// bit r % 32 of mk[r / 32] for each position it reaches below n when mk is
// given; returns the exit state (an exit offset past 3 ends the chain).
__device__ uint32_t walk_block(const int32_t* __restrict__ step, int64_t cap, int64_t bbase,
                               int64_t r, int64_t n, uint32_t* mk) {
  while (r < kB) {
    const int64_t i = bbase + r;
    if (i >= n) return kDead;
    if (mk) mk[r >> 5] |= 1u << (r & 31);
    const int64_t sf = i < cap ? max(__ldg(step + i), 1) : 1;
    if (i + sf >= n) return kDead;
    r += sf;
  }
  return r - kB < 4 ? (uint32_t)(r - kB) : kDead;
}

// Warp 0 of tile `tile`: publish the aggregate, find the state in which the
// chain enters the tile, publish the state after it. Returns the entry state.
__device__ uint32_t look_back(uint32_t* status, int64_t tile, uint32_t agg, int lane) {
  if (lane == 0) st_relaxed(status + tile, (is_const(agg) ? kFlagIncl : kFlagAgg) | agg);
  uint32_t acc = kIdent;  // the maps of tiles pred + 1 .. tile - 1, in order
  for (int64_t pred = tile - 1;;) {
    const int64_t idx = pred - lane;  // lane 0 is the nearest predecessor
    const uint32_t word = idx >= 0 ? ld_relaxed(status + idx) : kFlagIncl | const_map(kDead);
    const uint32_t ready = __ballot_sync(kFull, word != 0);
    const uint32_t stops = __ballot_sync(kFull, (word & kFlagIncl) != 0);
    const int first = stops ? __ffs(stops) - 1 : 31;
    const uint32_t need = first == 31 ? kFull : (2u << first) - 1;
    if ((ready & need) != need) {
      __nanosleep(32);
      continue;
    }
    uint32_t v = lane <= first ? word & kMapBits : kIdent;
    if (first > 0) {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t o = __shfl_down_sync(kFull, v, d);
        if (lane + d < 32) v = compose(o, v);  // the higher lane holds the earlier tiles
      }
    }
    acc = compose(__shfl_sync(kFull, v, 0), acc);
    if (stops) break;  // acc is constant now
    pred -= 32;
  }
  const uint32_t entry = acc & 7;
  if (lane == 0 && !is_const(agg))
    st_relaxed(status + tile, kFlagIncl | const_map(apply_map(agg, entry)));
  return entry;
}

__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;  // bit b to byte b
}

// Positions at or past n are never marked: the segment's bits below n.
__device__ __forceinline__ uint32_t below_n(int nrem) {
  return nrem >= kSeg ? kFull : nrem <= 0 ? 0u : (1u << nrem) - 1;
}

__device__ __forceinline__ int rem_of(int64_t n, int64_t base) {
  return (int)max(min(n - base, (int64_t)1 << 30), (int64_t)-1);
}

__global__ void __launch_bounds__(kThreads, 4)
orbit_kernel(const int32_t* __restrict__ step, int64_t cap, int64_t n, int64_t start,
             uint32_t* __restrict__ ticket, uint32_t* __restrict__ status,
             uint8_t* __restrict__ out, int aligned) {
  __shared__ int4 stage[kWarps][kWarpSpan / 4];
  // a thread's segment in each round: codes, dead bits, exclusive map
  __shared__ uint4 kept[kRounds][kThreads];
  __shared__ uint32_t block_marks[kWarps][32];
  __shared__ uint32_t warp_map[kMaps];
  __shared__ uint32_t warp_entry[kMaps];
  __shared__ uint32_t tile_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t tile = tile_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, j = lane & (kHalf - 1);
  // round r of the tile starts at tbase + r * kRound for this warp
  const int64_t tbase = tile * kTile + (int64_t)warp * kWarpSpan;
  int4* st = stage[warp];
  uint32_t general = 0, any_general = 0;  // bit r: this lane's block / the warp, in round r

#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int64_t wbase = tbase + (int64_t)r * kRound;
    const int64_t base = wbase + (int64_t)lane * kSeg;
    // 1. stage the warp's steps (past cap: 1) and read this segment's codes
    if ((aligned & 1) && wbase + kWarpSpan <= cap) {
      const int4* src = reinterpret_cast<const int4*>(step + wbase);
      int4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldg(src + 32 * k + lane);
#pragma unroll
      for (int k = 0; k < 8; ++k) st[slot(32 * k + lane)] = v[k];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int64_t i = wbase + 4 * (32 * k + lane);
        int4 v;
        v.x = i < cap ? step[i] : 1;
        v.y = i + 1 < cap ? step[i + 1] : 1;
        v.z = i + 2 < cap ? step[i + 2] : 1;
        v.w = i + 3 < cap ? step[i + 3] : 1;
        st[slot(32 * k + lane)] = v;
      }
    }
    __syncwarp();
    const int nrem = rem_of(n, base);
    // The fast path: every step 1..4 and the segment's end 4 or more before
    // n, so no position is dead; the codes are the steps less 1, packed by
    // multiply-adds. Else each position's code and dead bit one by one.
    uint32_t lo = 0, hi = 0, bad = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int4 v = st[slot(lane * 8 + c)];
      const uint32_t a = v.x - 1, b = v.y - 1, e = v.z - 1, f = v.w - 1;
      bad |= a | b | e | f;
      const uint32_t byte = ((f * 4 + e) * 4 + b) * 4 + a;
      if (c < 4) lo |= byte << (8 * c);
      else hi |= byte << (8 * (c - 4));
    }
    uint64_t codes = lo | ((uint64_t)hi << 32);
    uint32_t dead = 0;
    bool big = false;
    const bool fast = bad < 4 && nrem >= kSeg + 4;
    if (!fast) {
      codes = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int4 v = st[slot(lane * 8 + c)];
        const int32_t s4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 4 * c + e;
          const int sf = max(s4[e], 1);
          const bool d = sf >= nrem - p;
          dead |= (uint32_t)d << p;
          big |= sf > 4 && !d;
          codes |= (uint64_t)(min(sf, 4) - 1) << (2 * p);
        }
      }
    }
    __syncwarp();  // the next round stages over these steps

    // 2. the segment's map, by the exits of the next four positions
    uint32_t map;
    if (fast) {
      // the four exits as bytes: each position takes byte `code` of the
      // window and shifts it in, one byte permute
      uint32_t w = 0x03020100u;
#pragma unroll
      for (int p = kSeg - 1; p >= 0; --p)
        w = __byte_perm(w, 0, ((uint32_t)(codes >> (2 * p)) & 3) | 0x2100);
      map = (w & 7) | ((w >> 5) & (7u << 3)) | ((w >> 10) & (7u << 6)) | ((w >> 15) & (7u << 9)) |
            (kDead << 12);
    } else {
      uint32_t w = kExits;
#pragma unroll
      for (int p = kSeg - 1; p >= 0; --p) {
        const uint32_t e =
            (dead >> p) & 1 ? kDead : (w >> (3 * ((uint32_t)(codes >> (2 * p)) & 3))) & 7;
        w = ((w << 3) | e) & 0xFFF;
      }
      map = w | (kDead << 12);
    }
    // 4. the start's segment: a constant map
    if (start >= base && start < base + kSeg) {
      uint32_t x;
      walk_segment(1u << (start - base), codes, dead, &x);
      map = const_map(x);
    }

    // 3. blocks with a step above 4 that does not end the chain
    const uint32_t bigmask = __ballot_sync(kFull, big);
    if (bigmask) {
      const bool gen = (bigmask >> (kHalf * half)) & 0xFFFF;
      const int64_t bbase = wbase + (int64_t)kB * half;
      const bool start_block = start >= bbase && start < bbase + kB;
      uint32_t x = kDead;
      if (gen && (j < 4 || (j == 4 && start_block)))
        x = walk_block(step, cap, bbase, j < 4 ? j : start - bbase, n, nullptr);
      const int lead = lane & kHalf;
      const uint32_t e0 = __shfl_sync(kFull, x, lead), e1 = __shfl_sync(kFull, x, lead + 1),
                     e2 = __shfl_sync(kFull, x, lead + 2), e3 = __shfl_sync(kFull, x, lead + 3),
                     es = __shfl_sync(kFull, x, lead + 4);
      if (gen)
        map = j ? kIdent
                : start_block ? const_map(es)
                              : e0 | (e1 << 3) | (e2 << 6) | (e3 << 9) | (kDead << 12);
      general |= (uint32_t)gen << r;
      any_general |= 1u << r;
    }

    // 5. composition inside the tile: the warp's segments in this round
    uint32_t inc = map;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc = compose(o, inc);
    }
    uint32_t excl = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) excl = kIdent;
    if (lane == 31) warp_map[r * kWarps + warp] = inc;
    kept[r][threadIdx.x] = make_uint4((uint32_t)codes, (uint32_t)(codes >> 32), dead, excl);
  }
  __syncthreads();

  // 6. composition across tiles
  if (warp == 0) {
    uint32_t wm = lane < kMaps ? warp_map[lane] : kIdent;
#pragma unroll
    for (int d = 1; d < kMaps; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, wm, d);
      if (lane >= d) wm = compose(o, wm);
    }
    const uint32_t agg = __shfl_sync(kFull, wm, kMaps - 1);
    uint32_t wex = __shfl_up_sync(kFull, wm, 1);
    if (lane == 0) wex = kIdent;
    const uint32_t entry = look_back(status, tile, agg, lane);
    if (lane < kMaps) warp_entry[lane] = apply_map(wex, entry);
  }
  __syncthreads();

#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int64_t wbase = tbase + (int64_t)r * kRound;
    const int64_t base = wbase + (int64_t)lane * kSeg;
    const uint4 k = kept[r][threadIdx.x];
    const uint32_t x = apply_map(k.w, warp_entry[r * kWarps + warp]);
    // the marks: a forward walk in registers, or the general path's walk
    uint32_t mk;
    if ((any_general >> r) & 1) {
      const int64_t bbase = wbase + (int64_t)kB * half;
      block_marks[warp][lane] = 0;
      __syncwarp();
      if (((general >> r) & 1) && j == 0) {
        const int64_t from = start >= bbase && start < bbase + kB ? start - bbase
                             : x < 4                             ? (int64_t)x
                                                                 : (int64_t)kB;
        walk_block(step, cap, bbase, from, n, block_marks[warp] + kHalf * half);
      }
      __syncwarp();
    }
    if ((general >> r) & 1) {
      mk = block_marks[warp][lane];
    } else {
      const bool has_start = start >= base && start < base + kSeg;
      uint32_t unused;
      mk = walk_segment(has_start ? 1u << (start - base) : x < 4 ? 1u << x : 0u,
                        k.x | ((uint64_t)k.y << 32), k.z, &unused);
    }
    mk &= below_n(rem_of(n, base));

    if ((aligned & 2) && base + kSeg <= cap) {
      uint4 lo, hi;
      lo.x = spread4(mk & 0xF);
      lo.y = spread4((mk >> 4) & 0xF);
      lo.z = spread4((mk >> 8) & 0xF);
      lo.w = spread4((mk >> 12) & 0xF);
      hi.x = spread4((mk >> 16) & 0xF);
      hi.y = spread4((mk >> 20) & 0xF);
      hi.z = spread4((mk >> 24) & 0xF);
      hi.w = spread4(mk >> 28);
      uint4* o = reinterpret_cast<uint4*>(out + base);
      o[0] = lo;
      o[1] = hi;
    } else {
      for (int p = 0; p < kSeg && base + p < cap; ++p) out[base + p] = (uint8_t)((mk >> p) & 1);
    }
  }
}

}  // namespace

// Enqueue the kernel on `stream`. scratch: uint32[ceil(cap / 16384) + 1]
// (the tile ticket, then one status word a tile), zeroed here on the
// stream; out: bool[cap]. Requires 0 <= start < 512 * ceil(cap / 512).
extern "C" int orbit_resolve_launch(const void* step, int64_t cap, int64_t n, int64_t start,
                                    void* scratch, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t nb = (cap + kB - 1) / kB;
  const int64_t tiles = (cap + kTile - 1) / kTile;
  if (cap <= 0 || start < 0 || start >= nb * kB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  uint32_t* ticket = static_cast<uint32_t*>(scratch);
  const int aligned = (reinterpret_cast<uintptr_t>(step) % 16 == 0 ? 1 : 0) |
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 2 : 0);
  orbit_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(static_cast<const int32_t*>(step), cap, n,
                                                    start, ticket, ticket + 1,
                                                    static_cast<uint8_t*>(out), aligned);
  return (int)cudaGetLastError();
}
