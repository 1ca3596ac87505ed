// K7 flush_hist: fold the staged completed paths into the running sums and
// counts and the (4, num_bins+1) free-path histogram, then clear the staging.
//
// Replaces the deleted Pallas kernel _hist_kernel / histogram_804
// (argon_monte_carlo_tpu/ops/pallas_hist.py:39-85, pallas_call at :71,
// removed in e3a8dc0) and the XLA code that took over its job,
// argon_monte_carlo_tpu/ops/measure.py flush_pending (:131-197) with its
// compaction (ops/compact.py:23).
//
// Bound: memory.  The staging is read once and cleared once (N x 17
// bytes); events are a few thousand a step at 1M particles.
//
// Design, deterministic for a given input:
//   1. per block: fixed-order tree sums of the masked values (4 floats) and
//      the block's event count;
//   2. one block: exclusive scan of the block counts (each event's rank is
//      its block's offset plus its rank inside the block), path_sum added
//      in a fixed order, path_count, hist_drop_count;
//   3. per block: bin every event of rank < capacity (all events when
//      n <= capacity, the reference's dense branch) into shared-memory int
//      bins with integer atomics, add them into a global int histogram, and
//      clear the staging;
//   4. add the integer counts into the float histogram.
// No float atomics anywhere, so a run is repeatable per seed.
//
// amc_flush_hist_compacted is the pairs engine's entry, replacing
// ops/measure.py flush_pending_compacted (:88-128): the events to bin come
// from the engine's one shared per-step compaction (K6), event_idx,
// ascending and padded with n; the staged events it does not list are
// added to hist_drop_count.  It is one launch, in place, deterministic:
//   1. a block takes a tile of 4096 particles.  A thread reads 16 mask
//      bytes at once and the 16-byte value row of each of its staged
//      particles, sums them in index order and counts them; the block
//      tree-sums the threads' sums in a fixed order.  Two binary searches
//      find the tile's range of event_idx; the block bins the listed
//      particles that are staged into shared-memory integer bins, adds them
//      to integer bins kept between calls, adds its events to path_count
//      and its staged-but-unlisted ones to hist_drop_count (integer
//      atomics), and clears its staged rows and mask bytes.  No block reads
//      a row another block clears.
//   2. the last block to finish (a ticket it resets, as in K6) adds the
//      block sums to path_sum in a fixed order, adds float(count) to every
//      bin of hist -- bitwise hist + counts.to(float32) -- and clears the
//      integer bins.
// Only the staged rows are cleared: the staging keeps a row whose mask is
// clear at zero (record_completed, K8 and K3 write a row only where they
// set its mask, and every flush clears what was staged).  The scratch (the
// ticket, the integer bins, a block's sums) belongs to one stream; the
// kernel leaves the ticket and the bins zero, and nothing about a call
// comes from the host, so the launch replays correctly in a CUDA graph.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;

__global__ void partials_kernel(const float* __restrict__ vals,
                                const uint8_t* __restrict__ mask, int n,
                                float* __restrict__ block_sums,
                                int* __restrict__ block_counts) {
  __shared__ float sh[4][amc::kThreads];
  int t = threadIdx.x;
  int i = blockIdx.x * blockDim.x + t;
  bool m = i < n && mask[i];
  for (int k = 0; k < 4; ++k) sh[k][t] = m ? vals[4 * i + k] : 0.0f;
  int count = __syncthreads_count(m);
  for (int s = amc::kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      for (int k = 0; k < 4; ++k) sh[k][t] = sh[k][t] + sh[k][t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int k = 0; k < 4; ++k) block_sums[4 * blockIdx.x + k] = sh[k][0];
    block_counts[blockIdx.x] = count;
  }
}

__global__ void totals_kernel(const int* __restrict__ block_counts,
                              const float* __restrict__ block_sums,
                              int nblocks, int n, int capacity,
                              int* __restrict__ block_offsets,
                              float* __restrict__ path_sum,
                              int* __restrict__ path_count,
                              int* __restrict__ hist_drop_count) {
  __shared__ int isum[kScanThreads];
  __shared__ float fsum[4][kScanThreads];
  int t = threadIdx.x;
  int per = (nblocks + kScanThreads - 1) / kScanThreads;
  int lo = min(t * per, nblocks);
  int hi = min(lo + per, nblocks);
  int s = 0;
  float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = lo; b < hi; ++b) {
    s += block_counts[b];
    for (int k = 0; k < 4; ++k) f[k] = f[k] + block_sums[4 * b + k];
  }
  isum[t] = s;
  for (int k = 0; k < 4; ++k) fsum[k][t] = f[k];
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    int v = t >= d ? isum[t - d] : 0;
    __syncthreads();
    isum[t] += v;
    __syncthreads();
  }
  int run = isum[t] - s;
  for (int b = lo; b < hi; ++b) {
    block_offsets[b] = run;
    run += block_counts[b];
  }
  for (int w = kScanThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      for (int k = 0; k < 4; ++k) fsum[k][t] = fsum[k][t] + fsum[k][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    int events = isum[kScanThreads - 1];
    for (int k = 0; k < 4; ++k) path_sum[k] = path_sum[k] + fsum[k][0];
    *path_count += events;
    if (n > capacity) *hist_drop_count += max(events - capacity, 0);
  }
}

__global__ void bin_kernel(const float* __restrict__ vals,
                           const uint8_t* __restrict__ mask, int n,
                           const int* __restrict__ block_offsets,
                           int capacity, int num_bins, float bin_width,
                           int* __restrict__ bins,
                           float* __restrict__ vals_out,
                           uint8_t* __restrict__ mask_out) {
  extern __shared__ int sh_bins[];
  __shared__ int warp_counts[amc::kThreads / 32];
  int t = threadIdx.x;
  int i = blockIdx.x * blockDim.x + t;
  int row = num_bins + 1;
  for (int b = t; b < 4 * row; b += blockDim.x) sh_bins[b] = 0;
  bool m = i < n && mask[i];
  unsigned ballot = __ballot_sync(0xffffffffu, m);
  int lane = t & 31;
  int warp = t >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int rank = block_offsets[blockIdx.x] + __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_counts[w];
  if (m && (n <= capacity || rank < capacity)) {
    for (int k = 0; k < 4; ++k) {
      int id = static_cast<int>(floorf(vals[4 * i + k] / bin_width));
      id = min(max(id, 0), num_bins);
      atomicAdd(&sh_bins[k * row + id], 1);
    }
  }
  if (i < n) {
    for (int k = 0; k < 4; ++k) vals_out[4 * i + k] = 0.0f;
    mask_out[i] = 0;
  }
  __syncthreads();
  for (int b = t; b < 4 * row; b += blockDim.x) {
    if (sh_bins[b] != 0) atomicAdd(&bins[b], sh_bins[b]);
  }
}

// ---------------------------------------------------------------------------
// The compacted entry
// ---------------------------------------------------------------------------

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

// ints: the ticket, then the 4 * (num_bins + 1) integer bins, all zero
// between calls.  block_sums: 4 floats a block.  kVector: vals and mask are
// 16-byte aligned.
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
  __shared__ bool s_last;
  int t = threadIdx.x;
  int row = num_bins + 1;
  int total_bins = 4 * row;
  unsigned* ticket = reinterpret_cast<unsigned*>(ints);
  int* bins = ints + 1;
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
  unsigned bits = 0;  // bit k: particle first + k is staged
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
  sh_bits[t] = bits;
  float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (unsigned rest = bits; rest != 0; rest &= rest - 1) {
    int i = first + __ffs(rest) - 1;
    float4 v = kVector ? reinterpret_cast<const float4*>(vals)[i]
                       : make_float4(vals[4 * i], vals[4 * i + 1],
                                     vals[4 * i + 2], vals[4 * i + 3]);
    f[0] = f[0] + v.x;
    f[1] = f[1] + v.y;
    f[2] = f[2] + v.z;
    f[3] = f[3] + v.w;
  }
  for (int k = 0; k < 4; ++k) sh_sum[k][t] = f[k];
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
    for (int c = 0; c < 4; ++c) {
      int id = static_cast<int>(floorf(vals[4 * i + c] / bin_width));
      id = min(max(id, 0), num_bins);
      atomicAdd(&sh_bins[c * row + id], 1);
    }
    ++listed;
  }
  if (listed > 0) atomicAdd(&s_listed, listed);
  tree_sum4(sh_sum);  // also orders the binning's reads before the clearing

  // Clear the staged rows: no other block reads them.
  if (bits != 0) {
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
  for (int k = t; k < total_bins; k += amc::kThreads) {
    if (sh_bins[k] != 0) atomicAdd(&bins[k], sh_bins[k]);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    for (int k = 0; k < 4; ++k) block_sums[4 * blockIdx.x + k] = sh_sum[k][0];
    if (s_events > 0) atomicAdd(path_count, s_events);
    if (s_events > s_listed) atomicAdd(hist_drop_count, s_events - s_listed);
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

__global__ void add_hist_kernel(const int* __restrict__ bins, int total,
                                float* __restrict__ hist) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < total) hist[b] = hist[b] + static_cast<float>(bins[b]);
}

}  // namespace

// hist, path_sum, path_count, hist_drop_count are updated in place (the
// wrapper passes fresh copies).  Scratch: block_sums (nblocks*4 f32),
// block_counts, block_offsets (nblocks i32), bins (4*(num_bins+1) i32).
AMC_EXPORT int amc_flush_hist(
    const float* vals, const uint8_t* mask, int n, int capacity,
    int num_bins, float bin_width, float* hist, float* path_sum,
    int* path_count, int* hist_drop_count, float* block_sums,
    int* block_counts, int* block_offsets, int* bins, float* vals_out,
    uint8_t* mask_out, cudaStream_t stream) {
  int total = 4 * (num_bins + 1);
  int nblocks = amc::blocks_for(n);
  cudaMemsetAsync(bins, 0, sizeof(int) * total, stream);
  if (nblocks > 0) {
    partials_kernel<<<nblocks, amc::kThreads, 0, stream>>>(
        vals, mask, n, block_sums, block_counts);
  }
  totals_kernel<<<1, kScanThreads, 0, stream>>>(
      block_counts, block_sums, nblocks, n, capacity, block_offsets, path_sum,
      path_count, hist_drop_count);
  if (nblocks > 0) {
    bin_kernel<<<nblocks, amc::kThreads, sizeof(int) * total, stream>>>(
        vals, mask, n, block_offsets, capacity, num_bins, bin_width, bins,
        vals_out, mask_out);
  }
  add_hist_kernel<<<amc::blocks_for(total), amc::kThreads, 0, stream>>>(
      bins, total, hist);
  return static_cast<int>(cudaGetLastError());
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
  int bytes = static_cast<int>(sizeof(int)) * 4 * (num_bins + 1);
  bool vec = ((reinterpret_cast<uintptr_t>(vals) |
               reinterpret_cast<uintptr_t>(mask)) & 15u) == 0;
  auto kernel = vec ? flush_compacted_kernel<true>
                    : flush_compacted_kernel<false>;
  // Beside ~5 KB of static shared memory, bins above 32 KB need the opt-in.
  if (bytes > 32 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  }
  kernel<<<nblocks, amc::kThreads, bytes, stream>>>(
      vals, mask, n, event_idx, e, num_bins, bin_width, hist, path_sum,
      path_count, hist_drop_count, ints, block_sums);
  return static_cast<int>(cudaGetLastError());
}
