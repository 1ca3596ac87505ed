// K9 partner_sweep: each particle's lowest-index partner j != i within the
// search radius, over the 27 neighbour cells of its own cell row.
//
// Replaces the deleted Pallas kernel _sweep_kernel / pallas_partner_search
// (argon_monte_carlo_tpu/ops/pallas_sweep.py:255-400, pallas_call at :327,
// removed in 7e76fb0) and the XLA sweep that took over its job,
// argon_monte_carlo_tpu/ops/collide.py cell_partner_search (:423) in radius
// mode, top_k=1, two-sided (:453-961).
//
// Bound: memory latency.  Each particle reads 27 table rows of cap ints and
// the positions of the ~300 particles they hold; at ~11 per cell most of a
// row is the sentinel, so the row loop stops at the first sentinel (rows
// are filled from the front by bin_and_table).
//
// Design: one thread per particle, no shared memory.  Every cell row is
// swept (not only the reference's active-cell list), so a stray keeps its
// own row.  A particle that lost its slot in a full cell (pslot is the
// dummy slot) has no partner, as in the reference.  d^2 is formed in the
// reference's order, (dx*dx + dy*dy) + dz*dz with dx = x_i - x_j, and the
// library is built with -fmad=false so nothing is contracted into an FMA.
#include "common.cuh"

namespace {

__global__ void partner_sweep_kernel(const float* __restrict__ pos,
                                     const int* __restrict__ table,
                                     const int* __restrict__ pslot,
                                     const int* __restrict__ neighbors,
                                     int n, int num_cells, int cap, float r2,
                                     int* __restrict__ partner) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int s = pslot[i];
  if (s >= num_cells * cap) {
    partner[i] = -1;
    return;
  }
  const int* nbr = neighbors + static_cast<long long>(s / cap) * 27;
  float xi = pos[3 * i];
  float yi = pos[3 * i + 1];
  float zi = pos[3 * i + 2];
  int best = amc::kNoPartner;
  for (int o = 0; o < 27; ++o) {
    const int* row = table + static_cast<long long>(nbr[o]) * cap;
    for (int k = 0; k < cap; ++k) {
      int j = row[k];
      if (j >= n) break;
      if (j == i || j >= best) continue;
      float dx = xi - pos[3 * j];
      float dy = yi - pos[3 * j + 1];
      float dz = zi - pos[3 * j + 2];
      float d2 = dx * dx + dy * dy;
      d2 = d2 + dz * dz;
      if (d2 < r2) best = j;
    }
  }
  partner[i] = best < amc::kNoPartner ? best : -1;
}

}  // namespace

AMC_EXPORT int amc_partner_sweep(const float* pos, const int* table,
                                 const int* pslot, const int* neighbors,
                                 int n, int num_cells, int cap, float r2,
                                 int* partner, cudaStream_t stream) {
  if (n > 0) {
    partner_sweep_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        pos, table, pslot, neighbors, n, num_cells, cap, r2, partner);
  }
  return static_cast<int>(cudaGetLastError());
}
