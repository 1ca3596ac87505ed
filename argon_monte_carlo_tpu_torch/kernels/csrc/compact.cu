// K6 compact and K5 emit_pairs: stream compactions.
//
// K6 replaces argon_monte_carlo_tpu/ops/compact.py compact_indices
// (:23-46), a sort-based lowering of jnp.nonzero(size=, fill_value=) on the
// TPU: the ascending indices of a mask's set entries, truncated to size,
// padded with fill.  The pairs engine compacts with it twice a step over
// all particles (engine.py:398-419), the z-slab engine once a slab a step
// (the free lanes of the merge); K3 (colliding entries) compacts on the way
// inside its own first launch with the same single-pass scan
// (lookback.cuh).
//
// K5 replaces argon_monte_carlo_tpu/ops/pairs.py rebuild_finish (:208-277):
// the (N, top_k) rebuild candidates become the pair list (a, b), the
// cursor, the hot and one-shot re-search masks, and the overflow and spill
// counters.  The reference compacts in two stages (the particles with any
// candidate, then their entries); one scan over the entries gives the same
// list even when truncated, because the first m_cap entries come from at
// most m_cap particles.
//
// Bound: memory for both (the mask or the candidates read once, the
// outputs written once); K6's mask of 1M bytes is 0.3 us of traffic, so K6
// is bound by its launch.
//
// Design, K6: one launch, a single pass (a chained scan with decoupled
// look-back, lookback.cuh: tiles in ticket order, a status word a tile).
// Each thread loads 16 mask bytes at once, counts them, and the block scans
// the counts; warp 0 looks back for the tile's prefix, and every thread
// writes its indices at prefix + rank below size.  The block of the last
// tile knows the grand total: it pads [min(total, size), size) with fill, so
// there is no fill launch and no memset.  The scratch is the look-back's,
// all zero between calls, and the kernel itself leaves it so; nothing about
// a call is passed in from the host (no generation number), so a launch
// recorded in a CUDA graph replays correctly any number of times.  The
// scratch belongs to one stream (ops/compact.py keeps one a stream).
// Integer only: the same output in every run.
//
// Design, K5: one launch of the same single pass.  A block takes 4,096
// particles, a thread four groups of 4 (a group's candidate rows one
// 16-byte load a word where aligned), writes their hot and pending1 flags,
// and keeps a bit for each candidate entry; the block scans the threads'
// entry counts group by group, and the tile's entry count and its count of
// particles with any entry travel through the look-back as one packed
// value (pack2).  Each thread writes its entries at prefix + rank while
// below m_cap, particle-major and ascending within a particle.  The
// unswept count needs no prefix: a block adds it to one more scratch word.
// The pad of [min(total, m_cap), m_cap) with n, which K3 relies on, is
// spread over extra blocks of the same grid (4,096 ints of a and b each,
// 105 at the 1M pore's capacity): they take their tickets after every
// tile's block, wait for the last tile's inclusive prefix (whose block
// already runs), and pad their share with 16-byte stores.  The block that
// finishes last writes cursor, overflow and spill and leaves the scratch
// zero.  4,096 particles a tile keep the look-back short (245 tiles at the
// 1M pore).
#include "common.cuh"
#include "lookback.cuh"

namespace {

// ---------------------------------------------------------------------------
// K6: the single-pass compaction
// ---------------------------------------------------------------------------

constexpr int kTileBytes = 16;  // mask bytes a thread, one vector load
constexpr int kTile = amc::kThreads * kTileBytes;

// scratch is the look-back's (lookback.cuh), all zero between calls.
// kVector: mask is 16-byte aligned.
template <bool kVector>
__launch_bounds__(amc::kThreads) __global__ void compact_single_pass_kernel(
    const uint8_t* __restrict__ mask, int len, int ntiles, int size, int fill,
    unsigned long long* __restrict__ scratch, int* __restrict__ out) {
  int tile = amc::take_tile(scratch);
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
  bool last;
  int prefix = amc::tile_prefix(scratch, tile, tile_total, ntiles, &last);
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
  if (last) amc::release_tiles(scratch, ntiles);
}

// ---------------------------------------------------------------------------
// K5: the single-pass emission
// ---------------------------------------------------------------------------

constexpr int kEmitItems = 4;   // particles a group: one 16-byte load a row word
constexpr int kEmitGroups = 4;  // groups a thread, kEmitStride particles apart
constexpr int kEmitStride = amc::kThreads * kEmitItems;
constexpr int kEmitTile = kEmitStride * kEmitGroups;
constexpr int kMaxTopK = 16;   // kEmitItems * top_k bits in a 64-bit mask
constexpr int kPadInts = 4096;  // ints of a and b a pad block takes
constexpr int kMaxPadBlocks = 128;

// p[lo, hi) = value, shared among `workers` threads (this one `worker`):
// 16-byte stores between a scalar head and tail.
__device__ __forceinline__ void fill_ints(int* __restrict__ p, int lo, int hi,
                                          int value, int worker,
                                          int workers) {
  if (lo >= hi) return;
  int misaligned = static_cast<int>(
      (reinterpret_cast<uintptr_t>(p + lo) >> 2) & 3u);
  int body = min(hi, lo + ((4 - misaligned) & 3));
  for (int k = lo + worker; k < body; k += workers) p[k] = value;
  int vectors = (hi - body) / 4;
  int4* v = reinterpret_cast<int4*>(p + body);
  int4 fill = make_int4(value, value, value, value);
  for (int k = worker; k < vectors; k += workers) v[k] = fill;
  for (int k = body + 4 * vectors + worker; k < hi; k += workers) {
    p[k] = value;
  }
}

// The kEmitItems particles from `first`: writes their hot and pending1
// flags, adds the ones with any candidate to *has and the unswept ones to
// *uns, and returns their entries' bits (bit q * top_k + k: particle
// first + q has candidate k; the bits ascend in the list's order).
template <bool kVector>
__device__ __forceinline__ unsigned long long emit_group(
    const int* __restrict__ cands, long long first, int n, int top_k,
    const int* __restrict__ pslot0, int dummy_slot,
    const uint8_t* __restrict__ clipped, const uint8_t* __restrict__ unswept,
    uint8_t* __restrict__ hot, uint8_t* __restrict__ pending1, int* has,
    int* uns) {
  const int* rows = cands + first * top_k;
  unsigned long long bits = 0;
  int slot[kEmitItems];
  bool clip[kEmitItems], un[kEmitItems];
  bool vector = kVector && first + kEmitItems <= n;
  if (vector) {
    const int4* rows4 = reinterpret_cast<const int4*>(rows);
    for (int q = 0; q < top_k; ++q) {
      int4 v = rows4[q];
      int c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c[k] >= 0) bits |= 1ull << (4 * q + k);
      }
    }
    int4 s4 = *reinterpret_cast<const int4*>(pslot0 + first);
    uchar4 c4 = *reinterpret_cast<const uchar4*>(clipped + first);
    uchar4 u4 = *reinterpret_cast<const uchar4*>(unswept + first);
    slot[0] = s4.x; slot[1] = s4.y; slot[2] = s4.z; slot[3] = s4.w;
    clip[0] = c4.x; clip[1] = c4.y; clip[2] = c4.z; clip[3] = c4.w;
    un[0] = u4.x; un[1] = u4.y; un[2] = u4.z; un[3] = u4.w;
  } else {
    for (int q = 0; q < kEmitItems; ++q) {
      long long i = first + q;
      bool in = i < n;
      for (int k = 0; in && k < top_k; ++k) {
        if (rows[q * top_k + k] >= 0) bits |= 1ull << (q * top_k + k);
      }
      slot[q] = in ? pslot0[i] : 0;
      clip[q] = in && clipped[i];
      un[q] = in && unswept[i];
    }
  }
  unsigned long long row_mask = (1ull << top_k) - 1;  // top_k <= 16
  bool hot_q[kEmitItems], full_q[kEmitItems];
  for (int q = 0; q < kEmitItems; ++q) {
    unsigned long long row = (bits >> (q * top_k)) & row_mask;
    *has += row != 0;
    *uns += un[q];
    full_q[q] = (row >> (top_k - 1)) & 1ull;
    hot_q[q] = clip[q] || slot[q] >= dummy_slot || un[q];
  }
  if (vector) {
    *reinterpret_cast<uchar4*>(hot + first) =
        make_uchar4(hot_q[0], hot_q[1], hot_q[2], hot_q[3]);
    *reinterpret_cast<uchar4*>(pending1 + first) =
        make_uchar4(full_q[0], full_q[1], full_q[2], full_q[3]);
  } else {
    for (int q = 0; q < kEmitItems && first + q < n; ++q) {
      hot[first + q] = hot_q[q];
      pending1[first + q] = full_q[q];
    }
  }
  return bits;
}

// Blocks [0, ntiles) are the tiles of kEmitTile particles, in ticket order
// (a thread takes kEmitGroups groups of kEmitItems particles, kEmitStride
// apart, so that a warp's loads are contiguous); blocks [ntiles, nblocks)
// pad.  scratch: the look-back's 1 + ntiles words, then the unswept
// count's word, all zero between calls.  kVector: cands and pslot0 are
// 16-byte aligned, the four masks 4-byte aligned.
template <bool kVector>
__launch_bounds__(amc::kThreads) __global__ void emit_pairs_kernel(
    const int* __restrict__ cands, int n, int top_k,
    const int* __restrict__ pslot0, int dummy_slot,
    const uint8_t* __restrict__ clipped, const uint8_t* __restrict__ unswept,
    const int* __restrict__ cell_overflow,
    const int* __restrict__ old_overflow, const int* __restrict__ old_spill,
    int m_cap, int ntiles, int nblocks, int* __restrict__ a,
    int* __restrict__ b, int* __restrict__ cursor, uint8_t* __restrict__ hot,
    uint8_t* __restrict__ pending1, int* __restrict__ overflow,
    int* __restrict__ spill, unsigned long long* __restrict__ scratch) {
  __shared__ int s_total;
  __shared__ bool s_last;
  unsigned long long* uns_word = scratch + 1 + ntiles;
  volatile unsigned long long* status = scratch + 1;
  int ticket = amc::take_tile(scratch);
  bool last;
  if (ticket < ntiles) {
    long long first[kEmitGroups];
    unsigned long long bits[kEmitGroups];
    int has = 0, uns = 0;
#pragma unroll
    for (int g = 0; g < kEmitGroups; ++g) {
      first[g] = static_cast<long long>(ticket) * kEmitTile +
                 g * kEmitStride + threadIdx.x * kEmitItems;
      bits[g] = emit_group<kVector>(cands, first[g], n, top_k, pslot0,
                                    dummy_slot, clipped, unswept, hot,
                                    pending1, &has, &uns);
    }
    // The list's order is group-major in a tile: a scan a group.
    int rank[kEmitGroups];
    int entries = 0;
#pragma unroll
    for (int g = 0; g < kEmitGroups; ++g) {
      int group_total;
      rank[g] = entries + amc::block_exclusive_scan(__popcll(bits[g]),
                                                    &group_total);
      entries += group_total;
    }
    // Below 2^16 particles a tile each: one scan for both sums.
    int both;
    amc::block_exclusive_scan((has << 16) | uns, &both);
    // Before this block is counted finished (tile_prefix_value fences).
    if (threadIdx.x == 0 && (both & 0xffff) > 0) {
      atomicAdd(uns_word, static_cast<unsigned long long>(both & 0xffff));
    }
    unsigned long long prefix = amc::tile_prefix_value(
        scratch, ticket, amc::pack2(entries, both >> 16), nblocks, &last);
    int before = amc::pack2_hi(prefix);
#pragma unroll
    for (int g = 0; g < kEmitGroups; ++g) {
      int r = before + rank[g];
      const int* rows = cands + first[g] * top_k;
      for (unsigned long long v = bits[g]; v != 0 && r < m_cap;
           v &= v - 1) {
        int e = __ffsll(static_cast<long long>(v)) - 1;
        a[r] = static_cast<int>(first[g]) + e / top_k;
        b[r] = rows[e];
        ++r;
      }
    }
  } else {
    // A pad block: every tile's block took its ticket before this one, so
    // the last tile's block runs and will publish the grand total.
    if (threadIdx.x == 0) {
      unsigned long long word;
      do {
        word = status[ntiles - 1];
      } while ((word >> 62) != amc::kInclusive);
      s_total = amc::pack2_hi(word & amc::kValueMask);
    }
    __syncthreads();
    int lo = min(s_total, m_cap);
    int worker = (ticket - ntiles) * amc::kThreads + threadIdx.x;
    int workers = (nblocks - ntiles) * amc::kThreads;
    fill_ints(a, lo, m_cap, n, worker, workers);
    fill_ints(b, lo, m_cap, n, worker, workers);
    if (threadIdx.x == 0) {
      // Done with the status words (as in tile_prefix_value).
      __threadfence();
      s_last = atomicAdd(reinterpret_cast<unsigned*>(scratch) + 1, 1u) ==
               static_cast<unsigned>(nblocks - 1);
    }
    __syncthreads();
    last = s_last;
  }
  if (!last) return;
  // Every block has published its tile and added its unswept count.
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned long long total = status[ntiles - 1] & amc::kValueMask;
    int count = amc::pack2_hi(total);
    int with_any = amc::pack2_lo(total);
    int unswept_total = static_cast<int>(
        *reinterpret_cast<volatile unsigned long long*>(uns_word));
    *reinterpret_cast<volatile unsigned long long*>(uns_word) = 0ull;
    *cursor = min(count, m_cap);
    *overflow = *old_overflow + max(count - m_cap, 0) +
                max(with_any - m_cap, 0);
    *spill = *old_spill + *cell_overflow + unswept_total;
  }
  __syncthreads();
  amc::release_tiles(scratch, ntiles);
}

}  // namespace

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

// K5.  scratch holds scratch_words zero 64-bit words of this stream (at
// least 2 + ceil(n / 1024): the look-back's and the unswept count's) and is
// left zero; with fewer, nothing is launched and cudaErrorInvalidValue is
// returned.  top_k is 1 to 16.  One launch, the same arguments whenever
// the same tensors are emitted: safe to record in a CUDA graph.
AMC_EXPORT int amc_emit_pairs(
    const int* cands, int n, int top_k, const int* pslot0, int dummy_slot,
    const uint8_t* clipped, const uint8_t* unswept, const int* cell_overflow,
    const int* old_overflow, const int* old_spill, int m_cap, int* a, int* b,
    int* cursor, uint8_t* hot, uint8_t* pending1, int* overflow, int* spill,
    unsigned long long* scratch, int scratch_words, cudaStream_t stream) {
  int ntiles = max(amc::blocks_for(n, kEmitTile), 1);
  if (top_k < 1 || top_k > kMaxTopK || scratch_words < ntiles + 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int npad = m_cap > 0 ? min(amc::blocks_for(m_cap, kPadInts), kMaxPadBlocks)
                       : 0;
  int nblocks = ntiles + npad;
  uintptr_t wide = reinterpret_cast<uintptr_t>(cands) |
                   reinterpret_cast<uintptr_t>(pslot0);
  uintptr_t narrow = reinterpret_cast<uintptr_t>(clipped) |
                     reinterpret_cast<uintptr_t>(unswept) |
                     reinterpret_cast<uintptr_t>(hot) |
                     reinterpret_cast<uintptr_t>(pending1);
  auto kernel = (wide & 15u) == 0 && (narrow & 3u) == 0
                    ? emit_pairs_kernel<true>
                    : emit_pairs_kernel<false>;
  kernel<<<nblocks, amc::kThreads, 0, stream>>>(
      cands, n, top_k, pslot0, dummy_slot, clipped, unswept, cell_overflow,
      old_overflow, old_spill, m_cap, ntiles, nblocks, a, b, cursor, hot,
      pending1, overflow, spill, scratch);
  return static_cast<int>(cudaGetLastError());
}
