// The single-pass scan with decoupled look-back that K6 (compact.cu), K3
// (test_resolve.cu), K12 (pack.cu) and K2's scan (bin_and_table.cu) share.
//
// A block takes its tile from an atomic ticket, so tiles start in ticket
// order and a tile only ever waits for tiles that already run.  The block
// publishes its tile's total in a status word; warp 0 looks back over the
// earlier tiles' words (32 at a time) until it meets an inclusive prefix,
// and publishes its own inclusive prefix.
//
// A status word is (flag << 62) | value, value below 2^62: one 64-bit store
// publishes both; flag 0 (the cleared word) is "not ready".  A value is one
// count, or two counts below 2^31 packed as (a << 31) | b (pack2): sums of
// packed values are the packed sums, so one look-back scans both (K12's two
// directions).
//
// The scratch holds 1 + ntiles 64-bit words: scratch[0] the ticket (low
// half) and the count of blocks done with the status words (high half),
// scratch[1 + t] the status word of tile t.  It is all zero between calls,
// and the calls leave it so: the block that makes the count ntiles (every
// other block has by then read and written its last status word) clears
// the words, the ticket and the count.  Nothing about a call is passed in
// from the host, so a launch recorded in a CUDA graph replays correctly any
// number of times; a zero word reads as "not ready".  A scratch belongs to
// one stream.
#pragma once

#include "common.cuh"

namespace amc {

// Flags of a tile's status word.
constexpr unsigned kAggregate = 1u;  // value = the tile's own total
constexpr unsigned kInclusive = 2u;  // value = the total up to and with it
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long status_word(
    unsigned flag, unsigned long long value) {
  return (static_cast<unsigned long long>(flag) << 62) | value;
}

// Two counts, each below 2^31, as one look-back value, and back.
__device__ __forceinline__ unsigned long long pack2(int a, int b) {
  return (static_cast<unsigned long long>(a) << 31) |
         static_cast<unsigned long long>(b);
}
__device__ __forceinline__ int pack2_hi(unsigned long long v) {
  return static_cast<int>(v >> 31);
}
__device__ __forceinline__ int pack2_lo(unsigned long long v) {
  return static_cast<int>(v & 0x7fffffffull);
}

// The value of the tiles before `tile` (> 0).  All 32 lanes of warp 0
// call it.  Lane l reads the word of tile base - l and waits until it is
// published; the window moves back by 32 until it holds an inclusive
// prefix.
__device__ __forceinline__ unsigned long long look_back(
    const volatile unsigned long long* status, int tile) {
  const unsigned kFull = 0xffffffffu;
  int lane = threadIdx.x;
  unsigned long long prefix = 0;
  for (int base = tile - 1;; base -= 32) {
    int t = base - lane;
    // Before tile 0 there is nothing: an inclusive prefix of 0.
    unsigned flag = kInclusive;
    unsigned long long value = 0;
    if (t >= 0) {
      unsigned long long word;
      do {
        word = status[t];
      } while ((word >> 62) == 0);
      flag = static_cast<unsigned>(word >> 62);
      value = word & kValueMask;
    }
    unsigned inclusive = __ballot_sync(kFull, flag == kInclusive);
    int nearest = inclusive != 0 ? __ffs(inclusive) - 1 : 31;
    unsigned long long v = lane <= nearest ? value : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    prefix += v;
    if (inclusive != 0) return prefix;
  }
}

// The block's tile, in ticket order.  Every thread of the block calls it.
__device__ __forceinline__ int take_tile(unsigned long long* scratch) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(scratch),
                                        1u));
  }
  __syncthreads();
  return s_tile;
}

// The value of the tiles before `tile`, given the tile's own; publishes the
// tile's inclusive prefix.  Every thread of the block calls it, once, and
// gets the prefix.  *last is true in the one block that is done with the
// status words last: it must call release_tiles before it ends.
__device__ __forceinline__ unsigned long long tile_prefix_value(
    unsigned long long* scratch, int tile, unsigned long long tile_total,
    int ntiles, bool* last) {
  __shared__ unsigned long long s_prefix;
  __shared__ bool s_last;
  unsigned* finished = reinterpret_cast<unsigned*>(scratch) + 1;
  volatile unsigned long long* status = scratch + 1;
  if (threadIdx.x < 32) {
    unsigned long long prefix = 0;
    if (tile > 0) {
      if (threadIdx.x == 0) {
        status[tile] = status_word(kAggregate, tile_total);
      }
      prefix = look_back(status, tile);
    }
    if (threadIdx.x == 0) {
      status[tile] = status_word(kInclusive, prefix + tile_total);
      s_prefix = prefix;
      // This block touches no status word from here on.  The fence orders
      // its reads and its two stores before the count, so the block that
      // sees the count reach ntiles may clear every word.
      __threadfence();
      s_last = atomicAdd(finished, 1u) == static_cast<unsigned>(ntiles - 1);
    }
  }
  __syncthreads();
  *last = s_last;
  return s_prefix;
}

// tile_prefix_value for one count.
__device__ __forceinline__ int tile_prefix(unsigned long long* scratch,
                                           int tile, int tile_total,
                                           int ntiles, bool* last) {
  return static_cast<int>(tile_prefix_value(
      scratch, tile, static_cast<unsigned long long>(tile_total), ntiles,
      last));
}

// Leave the scratch as the call found it: all zero.  Called by every thread
// of the block that tile_prefix named the last.
__device__ __forceinline__ void release_tiles(unsigned long long* scratch,
                                              int ntiles) {
  __threadfence();
  volatile unsigned long long* status = scratch + 1;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) status[t] = 0ull;
  if (threadIdx.x == 0) scratch[0] = 0ull;
}

}  // namespace amc
