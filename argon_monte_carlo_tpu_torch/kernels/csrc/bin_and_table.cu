// K2 bin_and_table: cell id per particle, the (C+1, cap) cell table, the
// particle -> slot map and the overflow count.
//
// Replaces argon_monte_carlo_tpu/ops/collide.py assign_cells (:317) and
// build_cell_table (:355): on the TPU an XLA stable argsort of the cell ids
// plus an associative scan for the rank inside each cell.
//
// Bound: memory.  Each particle is read once and its index written twice;
// the per-cell arrays are C ints (C ~ N / 5 for the pore grid).
//
// Design: a counting sort.  One thread per particle bins it and counts it
// into its cell (integer atomics); one block takes the exclusive scan of the
// counts; one thread per particle scatters its index into its cell's
// segment (arbitrary order within the cell).  Then one thread per cell
// insertion-sorts its segment by particle index (occupancy ~11), which is
// exactly the order of the reference's stable argsort, so the particles
// that lose their slot in a full cell are the same ones.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// collide.py:324-349: floor, convert to int32, clip.
__global__ void assign_cells_kernel(const float* __restrict__ pos, int n,
                                    const int* __restrict__ nx,
                                    const int* __restrict__ layer_base,
                                    const float* __restrict__ half_extent,
                                    int nz, float z_lo, float cell_size,
                                    int* __restrict__ cell_id,
                                    int* __restrict__ counts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = pos[3 * i];
  float y = pos[3 * i + 1];
  float z = pos[3 * i + 2];
  int iz = clampi(static_cast<int>(floorf((z - z_lo) / cell_size)), 0, nz - 1);
  int m = nx[iz];
  float half = half_extent[iz];
  int ix = clampi(static_cast<int>(floorf((x + half) / cell_size)), 0, m - 1);
  int iy = clampi(static_cast<int>(floorf((y + half) / cell_size)), 0, m - 1);
  int c = layer_base[iz] + iy * m + ix;
  cell_id[i] = c;
  atomicAdd(&counts[c], 1);
}

// Exclusive scan of counts[0, m) by one block: each thread owns one
// contiguous chunk.  offsets and cursor both start at the segment starts.
__global__ void scan_kernel(const int* __restrict__ counts, int m,
                            int* __restrict__ offsets,
                            int* __restrict__ cursor) {
  __shared__ int sums[kScanThreads];
  int t = threadIdx.x;
  int per = (m + kScanThreads - 1) / kScanThreads;
  int lo = min(t * per, m);
  int hi = min(lo + per, m);
  int s = 0;
  for (int c = lo; c < hi; ++c) s += counts[c];
  sums[t] = s;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    int v = t >= d ? sums[t - d] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - s;
  for (int c = lo; c < hi; ++c) {
    offsets[c] = run;
    cursor[c] = run;
    run += counts[c];
  }
}

__global__ void scatter_kernel(const int* __restrict__ cell_id, int n,
                               int* __restrict__ cursor,
                               int* __restrict__ seg) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  seg[atomicAdd(&cursor[cell_id[i]], 1)] = i;
}

// One thread per table row.  Real rows sort their segment and take its
// first cap entries; rank >= cap goes to the dummy slot num_cells*cap and
// counts as overflow (collide.py:373-390).  The dummy row is all n.
__global__ void table_kernel(const int* __restrict__ counts,
                             const int* __restrict__ offsets,
                             int* __restrict__ seg, int n, int num_cells,
                             int cap, int* __restrict__ table,
                             int* __restrict__ pslot,
                             int* __restrict__ overflow) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c > num_cells) return;
  int* row = table + static_cast<long long>(c) * cap;
  if (c == num_cells) {
    for (int r = 0; r < cap; ++r) row[r] = n;
    return;
  }
  int cnt = counts[c];
  int* s = seg + offsets[c];
  for (int a = 1; a < cnt; ++a) {
    int v = s[a];
    int b = a - 1;
    while (b >= 0 && s[b] > v) {
      s[b + 1] = s[b];
      --b;
    }
    s[b + 1] = v;
  }
  for (int r = 0; r < cap; ++r) row[r] = r < cnt ? s[r] : n;
  int dummy = num_cells * cap;
  for (int r = 0; r < cnt; ++r) pslot[s[r]] = r < cap ? c * cap + r : dummy;
  if (cnt > cap) atomicAdd(overflow, cnt - cap);
}

}  // namespace

// Scratch (int32): counts, offsets, cursor (num_cells each), seg (n).
AMC_EXPORT int amc_bin_and_table(
    const float* pos, int n, const int* nx, const int* layer_base,
    const float* half_extent, int nz, float z_lo, float cell_size,
    int num_cells, int cap, int* cell_id, int* counts, int* offsets,
    int* cursor, int* seg, int* table, int* pslot, int* overflow,
    cudaStream_t stream) {
  cudaMemsetAsync(counts, 0, sizeof(int) * num_cells, stream);
  cudaMemsetAsync(overflow, 0, sizeof(int), stream);
  if (n > 0) {
    assign_cells_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        pos, n, nx, layer_base, half_extent, nz, z_lo, cell_size, cell_id,
        counts);
  }
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, num_cells, offsets,
                                              cursor);
  if (n > 0) {
    scatter_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        cell_id, n, cursor, seg);
  }
  table_kernel<<<amc::blocks_for(num_cells + 1), amc::kThreads, 0, stream>>>(
      counts, offsets, seg, n, num_cells, cap, table, pslot, overflow);
  return static_cast<int>(cudaGetLastError());
}
