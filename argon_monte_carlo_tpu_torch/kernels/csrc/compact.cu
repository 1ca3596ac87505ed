// K6 compact and K5 emit_pairs: stream compactions.
//
// K6 replaces argon_monte_carlo_tpu/ops/compact.py compact_indices
// (:23-46), a sort-based lowering of jnp.nonzero(size=, fill_value=) on the
// TPU: the ascending indices of a mask's set entries, truncated to size,
// padded with fill.  The pairs engine compacts with it twice a step over
// all particles (engine.py:398-419), the z-slab engine once a slab a step
// (the free lanes of the merge); K3 (colliding entries) compacts on the way
// inside its own launches with compact_launch below.
//
// K5 replaces argon_monte_carlo_tpu/ops/pairs.py rebuild_finish (:208-277):
// the (N, top_k) rebuild candidates become the pair list (a, b), the
// cursor, the hot and one-shot re-search masks, and the overflow and spill
// counters.  The reference compacts in two stages (the particles with any
// candidate, then their entries); one count -> exclusive scan -> write pass
// gives the same list even when truncated, because the first m_cap entries
// come from at most m_cap particles.
//
// Bound: memory for the passes (the mask or the candidates read once); K6's
// mask of 1M bytes is 0.3 us of traffic, so K6 is bound by its launches.
//
// Design, K6: one launch, a single pass (a chained scan with decoupled
// look-back).  A block takes its tile from an atomic ticket, so tiles start
// in ticket order and a tile only ever waits for tiles that already run.
// Each thread loads 16 mask bytes at once, counts them, and the block scans
// the counts; the block publishes its tile's total in a status word, warp 0
// looks back over the earlier tiles' words (32 at a time) until it meets an
// inclusive prefix, publishes its own inclusive prefix, and every thread
// writes its indices at prefix + rank below size.  The block of the last
// tile knows the grand total: it pads [min(total, size), size) with fill, so
// there is no fill launch and no memset.
//
// The scratch (ticket, count of finished blocks, a status word a tile) is
// all zero between calls, and the kernel itself leaves it so: a block that
// is done with the status words adds one to the finished count, and the
// block that makes it ntiles -- every other block has by then read and
// written its last status word -- clears the words of this call, the ticket
// and the count.  Nothing about a call is passed in from the host (no
// generation number), so a launch recorded in a CUDA graph replays
// correctly any number of times; a zero word reads as "not ready".  The
// scratch belongs to one stream (ops/compact.py keeps one a stream).
// Integer only: the same output in every run.
//
// Design, the multi-pass form (K5; compact_launch for K3;
// mask_scan_launch for K12): per block, a count (__syncthreads_count for a
// mask, a block scan for K5's per-particle entry counts); one block scans
// the block totals (Hillis-Steele over 1024 threads, each owning a
// contiguous chunk, as K2 and K7 do) and totals up to three channels; per
// block, each element writes at its block's offset plus its rank inside the
// block.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kMaxChannels = 3;

// block_vals is (nblocks, channels) row-major.  Channel 0 is scanned
// (exclusive) into block_offsets; every channel is totalled into totals.
__global__ void scan_blocks_kernel(const int* __restrict__ block_vals,
                                   int nblocks, int channels,
                                   int* __restrict__ block_offsets,
                                   int* __restrict__ totals) {
  __shared__ int sums[kMaxChannels][kScanThreads];
  int t = threadIdx.x;
  int per = (nblocks + kScanThreads - 1) / kScanThreads;
  int lo = min(t * per, nblocks);
  int hi = min(lo + per, nblocks);
  int own[kMaxChannels] = {0, 0, 0};
  for (int b = lo; b < hi; ++b) {
    for (int c = 0; c < channels; ++c) own[c] += block_vals[b * channels + c];
  }
  for (int c = 0; c < kMaxChannels; ++c) sums[c][t] = own[c];
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    int v[kMaxChannels];
    for (int c = 0; c < kMaxChannels; ++c) v[c] = t >= d ? sums[c][t - d] : 0;
    __syncthreads();
    for (int c = 0; c < kMaxChannels; ++c) sums[c][t] += v[c];
    __syncthreads();
  }
  int run = sums[0][t] - own[0];
  for (int b = lo; b < hi; ++b) {
    block_offsets[b] = run;
    run += block_vals[b * channels];
  }
  if (t == 0) {
    for (int c = 0; c < channels; ++c) totals[c] = sums[c][kScanThreads - 1];
  }
}

__global__ void fill_kernel(int* __restrict__ out, int size, int value) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < size) out[k] = value;
}

__global__ void mask_count_kernel(const uint8_t* __restrict__ mask, int len,
                                  int* __restrict__ block_vals) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int count = __syncthreads_count(i < len && mask[i]);
  if (threadIdx.x == 0) block_vals[blockIdx.x] = count;
}

__global__ void mask_write_kernel(const uint8_t* __restrict__ mask, int len,
                                  const int* __restrict__ block_offsets,
                                  int size, int* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int total;
  int rank = amc::block_exclusive_scan(i < len && mask[i] ? 1 : 0, &total);
  if (i < len && mask[i]) {
    rank += block_offsets[blockIdx.x];
    if (rank < size) out[rank] = i;
  }
}

// K5, pass 1: the per-particle flags, and per block the entry count, the
// count of particles with any entry and the count of unswept particles.
__global__ void emit_count_kernel(const int* __restrict__ cands, int n,
                                  int top_k, const int* __restrict__ pslot0,
                                  int dummy_slot,
                                  const uint8_t* __restrict__ clipped,
                                  const uint8_t* __restrict__ unswept,
                                  uint8_t* __restrict__ hot,
                                  uint8_t* __restrict__ pending1,
                                  int* __restrict__ block_vals) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int count = 0;
  bool uns = false;
  if (i < n) {
    const int* row = cands + static_cast<long long>(i) * top_k;
    for (int k = 0; k < top_k; ++k) count += row[k] >= 0 ? 1 : 0;
    uns = unswept[i] != 0;
    bool dropped = pslot0[i] >= dummy_slot;
    hot[i] = clipped[i] || dropped || uns;
    pending1[i] = row[top_k - 1] >= 0;
  }
  int total;
  amc::block_exclusive_scan(count, &total);
  int has = __syncthreads_count(count > 0);
  int uns_count = __syncthreads_count(uns);
  if (threadIdx.x == 0) {
    block_vals[3 * blockIdx.x] = total;
    block_vals[3 * blockIdx.x + 1] = has;
    block_vals[3 * blockIdx.x + 2] = uns_count;
  }
}

// K5, pass 2: particle-major entries, ascending within a particle, the
// first m_cap of them kept.
__global__ void emit_write_kernel(const int* __restrict__ cands, int n,
                                  int top_k,
                                  const int* __restrict__ block_offsets,
                                  int m_cap, int* __restrict__ a,
                                  int* __restrict__ b) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int count = 0;
  const int* row = cands + static_cast<long long>(i) * top_k;
  if (i < n) {
    for (int k = 0; k < top_k; ++k) count += row[k] >= 0 ? 1 : 0;
  }
  int total;
  int off = amc::block_exclusive_scan(count, &total);
  if (i >= n || count == 0) return;
  off += block_offsets[blockIdx.x];
  for (int k = 0; k < top_k && off < m_cap; ++k) {
    int j = row[k];
    if (j < 0) continue;
    a[off] = i;
    b[off] = j;
    ++off;
  }
}

// K5, pass 3: cursor and counters (pairs.py:258-276).
__global__ void emit_finish_kernel(const int* __restrict__ totals, int m_cap,
                                   const int* __restrict__ cell_overflow,
                                   const int* __restrict__ old_overflow,
                                   const int* __restrict__ old_spill,
                                   int* __restrict__ cursor,
                                   int* __restrict__ overflow,
                                   int* __restrict__ spill) {
  int count = totals[0];
  int has = totals[1];
  *cursor = min(count, m_cap);
  *overflow = *old_overflow + max(count - m_cap, 0) + max(has - m_cap, 0);
  *spill = *old_spill + *cell_overflow + totals[2];
}


// ---------------------------------------------------------------------------
// K6: the single-pass compaction
// ---------------------------------------------------------------------------

constexpr int kTileBytes = 16;  // mask bytes a thread, one vector load
constexpr int kTile = amc::kThreads * kTileBytes;
// Flags of a tile's status word.  The word is (flag << 32) | value: one
// 64-bit store publishes both; flag 0 (the cleared word) is "not ready".
constexpr unsigned kAggregate = 1u;  // value = the tile's own total
constexpr unsigned kInclusive = 2u;  // value = the total up to and with it

__device__ __forceinline__ unsigned long long status_word(unsigned flag,
                                                          int value) {
  return (static_cast<unsigned long long>(flag) << 32) |
         static_cast<unsigned>(value);
}

// The number of set entries in the tiles before `tile` (> 0).  All 32 lanes
// of warp 0 call it.  Lane l reads the word of tile base - l and waits
// until it is published; the window moves back by 32 until it holds an
// inclusive prefix.
__device__ __forceinline__ int look_back(
    const volatile unsigned long long* status, int tile) {
  const unsigned kFull = 0xffffffffu;
  int lane = threadIdx.x;
  int prefix = 0;
  for (int base = tile - 1;; base -= 32) {
    int t = base - lane;
    // Before tile 0 there is nothing: an inclusive prefix of 0.
    unsigned flag = kInclusive;
    int value = 0;
    if (t >= 0) {
      unsigned long long word;
      do {
        word = status[t];
      } while ((word >> 32) == 0);
      flag = static_cast<unsigned>(word >> 32);
      value = static_cast<int>(static_cast<unsigned>(word));
    }
    unsigned inclusive = __ballot_sync(kFull, flag == kInclusive);
    int nearest = inclusive != 0 ? __ffs(inclusive) - 1 : 31;
    int v = lane <= nearest ? value : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    prefix += v;
    if (inclusive != 0) return prefix;
  }
}

// scratch[0] holds the ticket counter (low half) and the count of finished
// blocks (high half), scratch[1 + t] the status word of tile t; all zero
// between calls.  kVector: mask is 16-byte aligned.
template <bool kVector>
__launch_bounds__(amc::kThreads) __global__ void compact_single_pass_kernel(
    const uint8_t* __restrict__ mask, int len, int ntiles, int size, int fill,
    unsigned long long* __restrict__ scratch, int* __restrict__ out) {
  __shared__ int s_tile;
  __shared__ int s_prefix;
  __shared__ bool s_last;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned* finished = ticket + 1;
  volatile unsigned long long* status = scratch + 1;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  int tile = s_tile;
  long long first = static_cast<long long>(tile) * kTile +
                    threadIdx.x * kTileBytes;
  unsigned bits = 0;  // bit k: entry first + k is set
  if (kVector && first + kTileBytes <= len) {
    uint4 v = *reinterpret_cast<const uint4*>(mask + first);
    unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < kTileBytes; ++k) {
      if ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) bits |= 1u << k;
    }
  } else {
    for (int k = 0; k < kTileBytes; ++k) {
      if (first + k < len && mask[first + k]) bits |= 1u << k;
    }
  }
  int tile_total;
  int rank = amc::block_exclusive_scan(__popc(bits), &tile_total);
  if (threadIdx.x < 32) {
    int prefix = 0;
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
  int prefix = s_prefix;
  rank += prefix;
  while (bits != 0 && rank < size) {
    out[rank++] = static_cast<int>(first) + __ffs(bits) - 1;
    bits &= bits - 1;
  }
  if (tile == ntiles - 1) {
    // Every ticket is taken and every earlier tile is counted in prefix.
    for (int k = min(prefix + tile_total, size) + threadIdx.x; k < size;
         k += amc::kThreads) {
      out[k] = fill;
    }
  }
  if (s_last) {
    // Leave the scratch as this call found it: all zero.
    __threadfence();
    for (int t = threadIdx.x; t < ntiles; t += amc::kThreads) status[t] = 0ull;
    if (threadIdx.x == 0) scratch[0] = 0ull;
  }
}

}  // namespace

namespace amc {

void mask_scan_launch(const uint8_t* mask, int len, int* block_vals,
                      int* block_offsets, int* total, cudaStream_t stream) {
  int nblocks = blocks_for(len);
  if (nblocks > 0) {
    mask_count_kernel<<<nblocks, kThreads, 0, stream>>>(mask, len,
                                                         block_vals);
  }
  scan_blocks_kernel<<<1, kScanThreads, 0, stream>>>(
      block_vals, nblocks, 1, block_offsets, total);
}

void compact_launch(const uint8_t* mask, int len, int size, int fill,
                    int* out, int* total, int* block_vals,
                    int* block_offsets, cudaStream_t stream) {
  int nblocks = blocks_for(len);
  if (size > 0) {
    fill_kernel<<<blocks_for(size), kThreads, 0, stream>>>(out, size, fill);
  }
  mask_scan_launch(mask, len, block_vals, block_offsets, total, stream);
  if (nblocks > 0) {
    mask_write_kernel<<<nblocks, kThreads, 0, stream>>>(
        mask, len, block_offsets, size, out);
  }
}

}  // namespace amc

// K6.  scratch holds 1 + ceil(len / 4096) 64-bit words, belongs to this
// stream, was zero when it was allocated and is written by nothing else
// (the kernel zeroes what it wrote before it ends).  One launch, the same
// arguments whenever the same tensors are compacted: safe to record in a
// CUDA graph.
AMC_EXPORT int amc_compact(const uint8_t* mask, int len, int size, int fill,
                           int* out, unsigned long long* scratch,
                           cudaStream_t stream) {
  int ntiles = max(amc::blocks_for(len, kTile), 1);
  if ((reinterpret_cast<uintptr_t>(mask) & 15u) == 0) {
    compact_single_pass_kernel<true><<<ntiles, amc::kThreads, 0, stream>>>(
        mask, len, ntiles, size, fill, scratch, out);
  } else {
    compact_single_pass_kernel<false><<<ntiles, amc::kThreads, 0, stream>>>(
        mask, len, ntiles, size, fill, scratch, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scratch: block_vals (3 * blocks_for(n) ints), block_offsets
// (blocks_for(n)), totals (3).
AMC_EXPORT int amc_emit_pairs(
    const int* cands, int n, int top_k, const int* pslot0, int dummy_slot,
    const uint8_t* clipped, const uint8_t* unswept, const int* cell_overflow,
    const int* old_overflow, const int* old_spill, int m_cap, int* a, int* b,
    int* cursor, uint8_t* hot, uint8_t* pending1, int* overflow, int* spill,
    int* block_vals, int* block_offsets, int* totals, cudaStream_t stream) {
  int nblocks = amc::blocks_for(n);
  if (m_cap > 0) {
    fill_kernel<<<amc::blocks_for(m_cap), amc::kThreads, 0, stream>>>(
        a, m_cap, n);
    fill_kernel<<<amc::blocks_for(m_cap), amc::kThreads, 0, stream>>>(
        b, m_cap, n);
  }
  if (nblocks > 0) {
    emit_count_kernel<<<nblocks, amc::kThreads, 0, stream>>>(
        cands, n, top_k, pslot0, dummy_slot, clipped, unswept, hot, pending1,
        block_vals);
  }
  scan_blocks_kernel<<<1, kScanThreads, 0, stream>>>(
      block_vals, nblocks, 3, block_offsets, totals);
  if (nblocks > 0) {
    emit_write_kernel<<<nblocks, amc::kThreads, 0, stream>>>(
        cands, n, top_k, block_offsets, m_cap, a, b);
  }
  emit_finish_kernel<<<1, 1, 0, stream>>>(totals, m_cap, cell_overflow,
                                          old_overflow, old_spill, cursor,
                                          overflow, spill);
  return static_cast<int>(cudaGetLastError());
}
