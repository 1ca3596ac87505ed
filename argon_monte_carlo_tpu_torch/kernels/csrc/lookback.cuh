// The single-pass scan with decoupled look-back that K6 (compact.cu), K3
// (test_resolve.cu), K7 (flush_hist.cu), K12 (pack.cu) and the scan of
// counts of K2 (bin_and_table.cu) and K11 (allpairs.cu) share.
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

// The scan of counts of the counting sorts of K2 (cell counts) and K11
// (slab counts): offsets[c] = the counts before c, offsets[m] = the total,
// and each count left zero once read, so the next call counts from zero
// with no memset.  kCountItems counts a thread (one 16-byte load where
// counts and offsets are aligned), kCountTile a block.
constexpr int kCountItems = 4;
constexpr int kCountTile = kThreads * kCountItems;

// The look-back words a scan of m counts needs (scratch[0] and a word a
// tile).
inline long long count_scan_words(int m) {
  return 1 + max(blocks_for(m, kCountTile), 1);
}

namespace {  // each source its own copy: the sources link into one library

template <bool kVector>
__launch_bounds__(kThreads) __global__ void count_scan_kernel(
    int* __restrict__ counts, int m, int ntiles,
    unsigned long long* __restrict__ scratch, int* __restrict__ offsets) {
  int tile = take_tile(scratch);
  long long first = static_cast<long long>(tile) * kCountTile +
                    threadIdx.x * kCountItems;
  int c[kCountItems] = {0, 0, 0, 0};
  bool vector = kVector && first + kCountItems <= m;
  if (vector) {
    int4 v = *reinterpret_cast<const int4*>(counts + first);
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
    *reinterpret_cast<int4*>(counts + first) = make_int4(0, 0, 0, 0);
  } else {
    for (int k = 0; k < kCountItems; ++k) {
      if (first + k < m) {
        c[k] = counts[first + k];
        counts[first + k] = 0;
      }
    }
  }
  int own = c[0] + c[1] + c[2] + c[3];
  int tile_total;
  int rank = block_exclusive_scan(own, &tile_total);
  bool last;
  int run = tile_prefix(scratch, tile, tile_total, ntiles, &last) + rank;
  int o[kCountItems];
  for (int k = 0; k < kCountItems; ++k) {
    o[k] = run;
    run += c[k];
  }
  if (vector) {
    *reinterpret_cast<int4*>(offsets + first) =
        make_int4(o[0], o[1], o[2], o[3]);
  } else {
    for (int k = 0; k < kCountItems; ++k) {
      if (first + k < m) offsets[first + k] = o[k];
    }
  }
  // The thread that holds count m - 1 knows the total.
  if (first <= m - 1 && m - 1 < first + kCountItems) offsets[m] = run;
  if (m == 0 && tile == 0 && threadIdx.x == 0) offsets[0] = 0;
  if (last) release_tiles(scratch, ntiles);
}

// One launch of the scan of m counts on the stream; scratch holds
// scratch_words zero words.  Launches nothing and returns
// cudaErrorInvalidValue when that is fewer than count_scan_words(m).
inline cudaError_t count_scan(int* counts, int m, int* offsets,
                              unsigned long long* scratch,
                              long long scratch_words, cudaStream_t stream) {
  if (scratch_words < count_scan_words(m)) return cudaErrorInvalidValue;
  int ntiles = max(blocks_for(m, kCountTile), 1);
  uintptr_t aligned = reinterpret_cast<uintptr_t>(counts) |
                      reinterpret_cast<uintptr_t>(offsets);
  if ((aligned & 15u) == 0) {
    count_scan_kernel<true><<<ntiles, kThreads, 0, stream>>>(
        counts, m, ntiles, scratch, offsets);
  } else {
    count_scan_kernel<false><<<ntiles, kThreads, 0, stream>>>(
        counts, m, ntiles, scratch, offsets);
  }
  return cudaSuccess;
}

}  // namespace

}  // namespace amc
