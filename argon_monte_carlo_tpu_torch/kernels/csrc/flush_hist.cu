// K7 flush_hist: fold the staged completed paths into the running sums and
// counts and the (4, num_bins+1) free-path histogram, then clear the staging.
//
// Replaces the deleted Pallas kernel _hist_kernel / histogram_804
// (argon_monte_carlo_tpu/ops/pallas_hist.py:39-85, pallas_call at :71,
// removed in e3a8dc0) and the XLA code that took over its job,
// argon_monte_carlo_tpu/ops/measure.py flush_pending (:131-197) with its
// compaction (ops/compact.py:23).
//
// Bound: memory, of the staged rows alone.  The mask is read once (N
// bytes) and each staged row read and cleared once (33 bytes an event);
// events are a few thousand a step at 1M particles, so the mask dominates.
//
// Both entries are one launch, in place, deterministic (no float atomics):
// hist, path_sum, path_count, hist_drop_count and the staging are updated
// where they stand.  A block takes a tile of 4096 particles; a thread reads
// 16 mask bytes at once and the 16-byte value row of each of its staged
// particles, sums them in index order, and the block tree-sums the
// threads' sums in a fixed order.  The block bins its events into
// shared-memory integer bins, adds them to integer bins kept between
// calls, adds its counts to path_count and hist_drop_count (integer
// atomics), and clears its staged rows and mask bytes; no block reads a
// row another block clears.  The last block to finish (a ticket it resets,
// as in K6) adds the block sums to path_sum in a fixed order, adds
// float(count) to every bin of hist -- bitwise hist + counts.to(float32)
// -- and clears the integer bins.
//
// amc_flush_hist, the dense entry (the sweep, the cube and a slab): with
// n <= capacity every staged event is binned.  With n > capacity only the
// events of rank < capacity are (the reference's compacted branch, its
// lowest-index events): each tile's event count goes through lookback.cuh's
// look-back, an event's rank is its tile's prefix plus its rank in the
// tile, and hist_drop_count grows by max(events - capacity, 0), a block's
// share each.
//
// amc_flush_hist_compacted is the pairs engine's entry, replacing
// ops/measure.py flush_pending_compacted (:88-128): the events to bin come
// from the engine's one shared per-step compaction (K6), event_idx,
// ascending and padded with n; two binary searches find the tile's range of
// it, the block bins the listed particles that are staged, and the staged
// events it does not list are added to hist_drop_count.
//
// Only the staged rows are cleared: the staging keeps a row whose mask is
// clear at zero (record_completed, K8, K10 and K3 write a row only where
// they set its mask, and every flush clears what was staged).  The scratch
// (the ticket, the integer bins, a block's sums, the look-back words)
// belongs to one stream; the kernels leave the ticket, the bins and the
// look-back words zero, and nothing about a call comes from the host, so a
// launch replays correctly in a CUDA graph.
#include "lookback.cuh"

namespace {

constexpr int kFlushBytes = 16;  // particles a thread, one 16-byte mask load
constexpr int kFlushTile = amc::kThreads * kFlushBytes;

// The first k in [0, e) with idx[k] >= value (e if none), idx ascending.
// All 32 lanes of a warp call it: 32 probes a round, about four rounds for
// the engine's 16,384 entries.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ idx,
                                                int e, int value) {
  int lane = threadIdx.x & 31;
  int lo = 0, hi = e;  // the answer lies in [lo, hi]
  while (lo < hi) {
    int step = (hi - lo + 31) / 32;
    int probe = lo + lane * step;
    bool below = probe < hi && idx[probe] < value;
    // The probes below value are a prefix, since idx ascends.
    int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) return lo;
    int next_hi = min(lo + c * step, hi);
    lo = lo + (c - 1) * step + 1;
    hi = next_hi;
  }
  return lo;
}

// Fixed-order tree sum of sh[k][0, kThreads) into sh[k][0]; every thread of
// the block calls it.
__device__ __forceinline__ void tree_sum4(float (*sh)[amc::kThreads]) {
  int t = threadIdx.x;
  __syncthreads();
  for (int s = amc::kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      for (int k = 0; k < 4; ++k) sh[k][t] = sh[k][t] + sh[k][t + s];
    }
    __syncthreads();
  }
}

// Bit k set: particle first + k is staged.  full: all 16 lie below n and
// the mask is 16-byte aligned (one load).
__device__ __forceinline__ unsigned staged_bits(const uint8_t* mask,
                                                int first, int n, bool full) {
  unsigned bits = 0;
  if (full) {
    uint4 v = *reinterpret_cast<const uint4*>(mask + first);
    unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < kFlushBytes; ++k) {
      if ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) bits |= 1u << k;
    }
  } else {
    for (int k = 0; k < kFlushBytes; ++k) {
      if (first + k < n && mask[first + k]) bits |= 1u << k;
    }
  }
  return bits;
}

template <bool kVector>
__device__ __forceinline__ float4 staged_row(const float* vals, int i) {
  return kVector ? reinterpret_cast<const float4*>(vals)[i]
                 : make_float4(vals[4 * i], vals[4 * i + 1], vals[4 * i + 2],
                               vals[4 * i + 3]);
}

// The thread's staged rows summed in index order into sh[k][threadIdx.x].
template <bool kVector>
__device__ __forceinline__ void sum_rows(const float* vals, int first,
                                         unsigned bits,
                                         float (*sh)[amc::kThreads]) {
  float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (unsigned rest = bits; rest != 0; rest &= rest - 1) {
    float4 v = staged_row<kVector>(vals, first + __ffs(rest) - 1);
    f[0] = f[0] + v.x;
    f[1] = f[1] + v.y;
    f[2] = f[2] + v.z;
    f[3] = f[3] + v.w;
  }
  for (int k = 0; k < 4; ++k) sh[k][threadIdx.x] = f[k];
}

// One event's four bins: floor(v / bin_width) clipped to [0, num_bins].
__device__ __forceinline__ void bin_event(const float v[4], int* sh_bins,
                                          int num_bins, float bin_width) {
  int row = num_bins + 1;
  for (int c = 0; c < 4; ++c) {
    int id = static_cast<int>(floorf(v[c] / bin_width));
    id = min(max(id, 0), num_bins);
    atomicAdd(&sh_bins[c * row + id], 1);
  }
}

// Clear the thread's staged rows and their mask bytes.
template <bool kVector>
__device__ __forceinline__ void clear_rows(float* vals, uint8_t* mask,
                                           int first, unsigned bits,
                                           bool full) {
  if (bits == 0) return;
  if (full) *reinterpret_cast<uint4*>(mask + first) = make_uint4(0, 0, 0, 0);
  for (unsigned rest = bits; rest != 0; rest &= rest - 1) {
    int i = first + __ffs(rest) - 1;
    if (kVector) {
      reinterpret_cast<float4*>(vals)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int c = 0; c < 4; ++c) vals[4 * i + c] = 0.0f;
    }
    if (!full) mask[i] = 0;
  }
}

// The block's end, after its rows are cleared: its shared bins into the
// kept ones, its sums into block_sums[tile] and its counts into path_count
// and hist_drop_count; the last block to take the ticket then folds every
// block's sums into path_sum in a fixed order and the kept bins into hist,
// and leaves the bins and the ticket zero.  Every thread calls it.
__device__ __forceinline__ void finish_block(
    int tile, int events, int drops, const int* sh_bins, int total_bins,
    float (*sh_sum)[amc::kThreads], float* __restrict__ hist,
    float* __restrict__ path_sum, int* __restrict__ path_count,
    int* __restrict__ hist_drop_count, int* ints, float* block_sums) {
  __shared__ bool s_last;
  int t = threadIdx.x;
  unsigned* ticket = reinterpret_cast<unsigned*>(ints);
  int* bins = ints + 1;
  for (int k = t; k < total_bins; k += amc::kThreads) {
    if (sh_bins[k] != 0) atomicAdd(&bins[k], sh_bins[k]);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    for (int k = 0; k < 4; ++k) block_sums[4 * tile + k] = sh_sum[k][0];
    if (events > 0) atomicAdd(path_count, events);
    if (drops > 0) atomicAdd(hist_drop_count, drops);
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // The last block: every other block's sums and bins are in.
  __threadfence();
  const volatile float* sums = block_sums;
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int blk = t; blk < gridDim.x; blk += amc::kThreads) {
    for (int k = 0; k < 4; ++k) g[k] = g[k] + sums[4 * blk + k];
  }
  for (int k = 0; k < 4; ++k) sh_sum[k][t] = g[k];
  tree_sum4(sh_sum);
  if (t < 4) path_sum[t] = path_sum[t] + sh_sum[t][0];
  volatile int* vbins = bins;
  for (int k = t; k < total_bins; k += amc::kThreads) {
    hist[k] = hist[k] + static_cast<float>(vbins[k]);
    vbins[k] = 0;
  }
  if (t == 0) *ticket = 0u;
}

// ints: the ticket, then the 4 * (num_bins + 1) integer bins, all zero
// between calls.  block_sums: 4 floats a tile.  scan: the look-back words
// (kCut only).  kVector: vals and mask are 16-byte aligned.  kCut: n >
// capacity, so only the events of rank < capacity are binned.
template <bool kVector, bool kCut>
__launch_bounds__(amc::kThreads) __global__ void flush_dense_kernel(
    float* __restrict__ vals, uint8_t* __restrict__ mask, int n,
    int capacity, int num_bins, float bin_width, float* __restrict__ hist,
    float* __restrict__ path_sum, int* __restrict__ path_count,
    int* __restrict__ hist_drop_count, int* ints, float* block_sums,
    unsigned long long* scan) {
  extern __shared__ int sh_bins[];
  __shared__ float sh_sum[4][amc::kThreads];
  int t = threadIdx.x;
  int total_bins = 4 * (num_bins + 1);
  // With the cut, tiles start in ticket order for the look-back.
  int tile = kCut ? amc::take_tile(scan) : static_cast<int>(blockIdx.x);
  for (int k = t; k < total_bins; k += amc::kThreads) sh_bins[k] = 0;

  int first = tile * kFlushTile + t * kFlushBytes;
  bool full = kVector && first + kFlushBytes <= n;
  unsigned bits = staged_bits(mask, first, n, full);
  sum_rows<kVector>(vals, first, bits, sh_sum);
  int events;  // the tile's
  int before = amc::block_exclusive_scan(__popc(bits), &events);

  // This thread bins its first `budget` events: those of rank < capacity.
  int budget = kFlushBytes;
  int drops = 0;
  if (kCut) {
    bool last;
    int prefix = amc::tile_prefix(scan, tile, events, gridDim.x, &last);
    if (last) amc::release_tiles(scan, gridDim.x);
    budget = capacity - prefix - before;
    drops = events - min(max(capacity - prefix, 0), events);
  }
  int k = 0;
  for (unsigned rest = bits; rest != 0 && k < budget; rest &= rest - 1) {
    float4 v = staged_row<kVector>(vals, first + __ffs(rest) - 1);
    const float c[4] = {v.x, v.y, v.z, v.w};
    bin_event(c, sh_bins, num_bins, bin_width);
    ++k;
  }
  tree_sum4(sh_sum);  // also orders the binning's reads before the clearing
  clear_rows<kVector>(vals, mask, first, bits, full);
  finish_block(tile, events, drops, sh_bins, total_bins, sh_sum, hist,
               path_sum, path_count, hist_drop_count, ints, block_sums);
}

// ints, block_sums: as flush_dense_kernel's.
template <bool kVector>
__launch_bounds__(amc::kThreads) __global__ void flush_compacted_kernel(
    float* __restrict__ vals, uint8_t* __restrict__ mask, int n,
    const int* __restrict__ event_idx, int e, int num_bins, float bin_width,
    float* __restrict__ hist, float* __restrict__ path_sum,
    int* __restrict__ path_count, int* __restrict__ hist_drop_count,
    int* ints, float* block_sums) {
  extern __shared__ int sh_bins[];
  __shared__ float sh_sum[4][amc::kThreads];
  __shared__ unsigned sh_bits[amc::kThreads];
  __shared__ int s_range[2];
  __shared__ int s_events, s_listed;
  int t = threadIdx.x;
  int total_bins = 4 * (num_bins + 1);
  int lo = blockIdx.x * kFlushTile;
  int hi = min(lo + kFlushTile, n);
  for (int k = t; k < total_bins; k += amc::kThreads) sh_bins[k] = 0;
  if (t < 64) {
    int bound = warp_lower_bound(event_idx, e, t < 32 ? lo : hi);
    if ((t & 31) == 0) s_range[t >> 5] = bound;
  }
  if (t == 0) s_events = s_listed = 0;

  // This thread's 16 particles: the staged ones, their sum in index order.
  int first = lo + t * kFlushBytes;
  bool full = kVector && first + kFlushBytes <= n;
  unsigned bits = staged_bits(mask, first, n, full);
  sh_bits[t] = bits;
  sum_rows<kVector>(vals, first, bits, sh_sum);
  __syncthreads();
  if (bits != 0) atomicAdd(&s_events, __popc(bits));

  // Bin the listed particles of this tile that are staged.
  int listed = 0;
  for (int k = s_range[0] + t; k < s_range[1]; k += amc::kThreads) {
    int i = event_idx[k];
    int local = i - lo;
    if (!((sh_bits[local / kFlushBytes] >> (local % kFlushBytes)) & 1u)) {
      continue;
    }
    const float c[4] = {vals[4 * i], vals[4 * i + 1], vals[4 * i + 2],
                        vals[4 * i + 3]};
    bin_event(c, sh_bins, num_bins, bin_width);
    ++listed;
  }
  if (listed > 0) atomicAdd(&s_listed, listed);
  tree_sum4(sh_sum);  // also orders the binning's reads before the clearing
  clear_rows<kVector>(vals, mask, first, bits, full);
  finish_block(blockIdx.x, s_events, s_events - s_listed, sh_bins,
               total_bins, sh_sum, hist, path_sum, path_count,
               hist_drop_count, ints, block_sums);
}

// The launch of a flush kernel: its integer bins in dynamic shared memory
// (beside ~5 KB of static shared memory, bins above 32 KB need the opt-in).
template <typename Kernel, typename... Args>
int launch_flush(Kernel kernel, int nblocks, int num_bins,
                 cudaStream_t stream, Args... args) {
  int bytes = static_cast<int>(sizeof(int)) * 4 * (num_bins + 1);
  if (bytes > 32 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  }
  kernel<<<nblocks, amc::kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const float* vals, const uint8_t* mask) {
  return ((reinterpret_cast<uintptr_t>(vals) |
           reinterpret_cast<uintptr_t>(mask)) & 15u) == 0;
}

}  // namespace

// In place: hist, path_sum, path_count, hist_drop_count, and the staged
// rows of vals and mask (cleared).  With n > capacity only the capacity
// lowest-index events are binned.  Scratch of this stream, kept by the
// kernel: ints (1 + 4 * (num_bins + 1), zero between calls), block_sums (4
// floats a tile of 4096 particles), scan (the look-back words, 1 + tiles,
// zero between calls; read only when n > capacity).
AMC_EXPORT int amc_flush_hist(float* vals, uint8_t* mask, int n,
                              int capacity, int num_bins, float bin_width,
                              float* hist, float* path_sum, int* path_count,
                              int* hist_drop_count, int* ints,
                              float* block_sums, unsigned long long* scan,
                              cudaStream_t stream) {
  int nblocks = max(amc::blocks_for(n, kFlushTile), 1);
  bool vec = aligned16(vals, mask);
  bool cut = n > capacity;
  auto kernel = vec ? (cut ? flush_dense_kernel<true, true>
                           : flush_dense_kernel<true, false>)
                    : (cut ? flush_dense_kernel<false, true>
                           : flush_dense_kernel<false, false>);
  return launch_flush(kernel, nblocks, num_bins, stream, vals, mask, n,
                      capacity, num_bins, bin_width, hist, path_sum,
                      path_count, hist_drop_count, ints, block_sums, scan);
}

// In place: hist, path_sum, path_count, hist_drop_count, and the staged
// rows of vals and mask (cleared).  event_idx (e,) lists particle indices,
// ascending, then the padding n.  Scratch of this stream, kept by the
// kernel: ints (1 + 4 * (num_bins + 1), zero between calls), block_sums
// (4 floats a block of 4096 particles).
AMC_EXPORT int amc_flush_hist_compacted(
    float* vals, uint8_t* mask, int n, const int* event_idx, int e,
    int num_bins, float bin_width, float* hist, float* path_sum,
    int* path_count, int* hist_drop_count, int* ints, float* block_sums,
    cudaStream_t stream) {
  int nblocks = max(amc::blocks_for(n, kFlushTile), 1);
  auto kernel = aligned16(vals, mask) ? flush_compacted_kernel<true>
                                      : flush_compacted_kernel<false>;
  return launch_flush(kernel, nblocks, num_bins, stream, vals, mask, n,
                      event_idx, e, num_bins, bin_width, hist, path_sum,
                      path_count, hist_drop_count, ints, block_sums);
}
