// K6 compact and K5 emit_pairs: two stream compactions on one scan.
//
// K6 replaces argon_monte_carlo_tpu/ops/compact.py compact_indices
// (:23-46), a sort-based lowering of jnp.nonzero(size=, fill_value=) on the
// TPU: the ascending indices of a mask's set entries, truncated to size,
// padded with fill.  The pairs engine compacts with it at the rebuild, in
// K3 (colliding entries), in K4 (appended candidates) and once a step over
// all particles (engine.py:398-419).
//
// K5 replaces argon_monte_carlo_tpu/ops/pairs.py rebuild_finish (:208-277):
// the (N, top_k) rebuild candidates become the pair list (a, b), the
// cursor, the hot and one-shot re-search masks, and the overflow and spill
// counters.  The reference compacts in two stages (the particles with any
// candidate, then their entries); one count -> exclusive scan -> write pass
// gives the same list even when truncated, because the first m_cap entries
// come from at most m_cap particles.
//
// Bound: memory.  Each pass reads the mask or the candidates once; the
// scan over block totals is one block.
//
// Design: per block, a count (__syncthreads_count for a mask, a block scan
// for K5's per-particle entry counts); one block scans the block totals
// (Hillis-Steele over 1024 threads, each owning a contiguous chunk, as K2
// and K7 do) and totals up to three channels; per block, each element
// writes at its block's offset plus its rank inside the block.  Integer
// only, so the output is the same in every run.
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

// Scratch: block_vals, block_offsets (blocks_for(len) ints each).
AMC_EXPORT int amc_compact(const uint8_t* mask, int len, int size, int fill,
                           int* out, int* total, int* block_vals,
                           int* block_offsets, cudaStream_t stream) {
  amc::compact_launch(mask, len, size, fill, out, total, block_vals,
                      block_offsets, stream);
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
