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
// from the engine's one shared per-step compaction (K6) instead of the
// flush's own rank.  Steps 1, 2 and 4 are shared; step 3 bins the listed
// indices whose staging is set, counts them, and the events not listed are
// added to hist_drop_count.
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
                              int* __restrict__ hist_drop_count,
                              int* __restrict__ events_out) {
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
    if (events_out != nullptr) *events_out = events;
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

__global__ void bin_listed_kernel(const float* __restrict__ vals,
                                  const uint8_t* __restrict__ mask, int n,
                                  const int* __restrict__ event_idx, int e,
                                  int num_bins, float bin_width,
                                  int* __restrict__ bins,
                                  int* __restrict__ binned) {
  extern __shared__ int sh_bins[];
  int t = threadIdx.x;
  int k = blockIdx.x * blockDim.x + t;
  int row = num_bins + 1;
  for (int b = t; b < 4 * row; b += blockDim.x) sh_bins[b] = 0;
  __syncthreads();
  int i = k < e ? event_idx[k] : n;
  bool valid = i < n && mask[i];
  if (valid) {
    for (int c = 0; c < 4; ++c) {
      int id = static_cast<int>(floorf(vals[4 * i + c] / bin_width));
      id = min(max(id, 0), num_bins);
      atomicAdd(&sh_bins[c * row + id], 1);
    }
  }
  int count = __syncthreads_count(valid);
  for (int b = t; b < 4 * row; b += blockDim.x) {
    if (sh_bins[b] != 0) atomicAdd(&bins[b], sh_bins[b]);
  }
  if (t == 0 && count > 0) atomicAdd(binned, count);
}

__global__ void drop_kernel(const int* __restrict__ events,
                            const int* __restrict__ binned,
                            int* __restrict__ hist_drop_count) {
  *hist_drop_count += *events - *binned;
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
      path_count, hist_drop_count, nullptr);
  if (nblocks > 0) {
    bin_kernel<<<nblocks, amc::kThreads, sizeof(int) * total, stream>>>(
        vals, mask, n, block_offsets, capacity, num_bins, bin_width, bins,
        vals_out, mask_out);
  }
  add_hist_kernel<<<amc::blocks_for(total), amc::kThreads, 0, stream>>>(
      bins, total, hist);
  return static_cast<int>(cudaGetLastError());
}

// hist, path_sum, path_count, hist_drop_count are updated in place (the
// wrapper passes fresh copies).  event_idx (e,) lists particle indices,
// n = padding.  Scratch: block_sums (nblocks*4 f32), block_counts,
// block_offsets (nblocks i32), bins (4*(num_bins+1) i32), counts (2 i32:
// events, binned).
AMC_EXPORT int amc_flush_hist_compacted(
    const float* vals, const uint8_t* mask, int n, const int* event_idx,
    int e, int num_bins, float bin_width, float* hist, float* path_sum,
    int* path_count, int* hist_drop_count, float* block_sums,
    int* block_counts, int* block_offsets, int* bins, int* counts,
    float* vals_out, uint8_t* mask_out, cudaStream_t stream) {
  int total = 4 * (num_bins + 1);
  int nblocks = amc::blocks_for(n);
  cudaMemsetAsync(bins, 0, sizeof(int) * total, stream);
  cudaMemsetAsync(counts, 0, 2 * sizeof(int), stream);
  if (nblocks > 0) {
    partials_kernel<<<nblocks, amc::kThreads, 0, stream>>>(
        vals, mask, n, block_sums, block_counts);
  }
  totals_kernel<<<1, kScanThreads, 0, stream>>>(
      block_counts, block_sums, nblocks, n, n, block_offsets, path_sum,
      path_count, hist_drop_count, counts);
  if (e > 0) {
    bin_listed_kernel<<<amc::blocks_for(e), amc::kThreads,
                        sizeof(int) * total, stream>>>(
        vals, mask, n, event_idx, e, num_bins, bin_width, bins, counts + 1);
  }
  drop_kernel<<<1, 1, 0, stream>>>(counts, counts + 1, hist_drop_count);
  cudaMemsetAsync(vals_out, 0, sizeof(float) * 4 * n, stream);
  cudaMemsetAsync(mask_out, 0, n, stream);
  add_hist_kernel<<<amc::blocks_for(total), amc::kThreads, 0, stream>>>(
      bins, total, hist);
  return static_cast<int>(cudaGetLastError());
}
