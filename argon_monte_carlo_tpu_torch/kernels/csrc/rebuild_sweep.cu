// K1 rebuild_sweep: the pair-list rebuild's candidate sweep -- reach mode,
// one-sided, half shell, active rows only, top_k lowest indices.
//
// Replaces argon_monte_carlo_tpu/ops/collide.py cell_candidate_search
// (:453-622: the slot planes) and _candidate_sweep (:625-961) as the pairs
// rebuild calls them (ops/pairs.py:182-189): on the TPU a chunked lax.scan
// of (rows, cap, group*cap) hit tests on float-packed planes, with top_k
// masked min-passes.
//
// Bound: memory latency, every rebuild_interval steps.  Each particle reads
// 14 neighbour rows of cap slots (index, position, reach) from the
// rebuild-time planes, which at 1M particles (~180k rows x 24 slots, 17 MB
// a plane set) sit in L2.
//
// Design:
//   1. pack: one thread per slot fills the planes the pair list keeps --
//      pos0 (rows, cap, 3) and reach0 (rows, cap) -- from the K2 table (the
//      index plane is the table itself, int32: no integers ride as floats).
//      Empty slots get the reference's far position 1e9 and reach 0.
//   2. sweep: one thread per particle (the emitter).  A particle that lost
//      its slot (pslot is the dummy slot) emits nothing; one whose cell is
//      not on the active list emits nothing and is reported unswept
//      (collide.py:942-954).  Otherwise it scans neighbour columns 13-26 of
//      its own cell (the half shell, collide.py:809), stops a row at its
//      first sentinel (rows are filled from the front by K2), applies the id
//      test only in its own cell (column 13: neighbour index > own index,
//      collide.py:854-869), and hits when d^2 < (reach_i + reach_j)^2 with
//      d^2 = (dx*dx + dy*dy) + dz*dz, dx = emitter - neighbour, the
//      threshold summed then squared (collide.py:822-853).  The top_k
//      lowest indices are kept ascending by insertion, padded with -1.
#include "common.cuh"

namespace {

constexpr int kMaxTopK = 16;

__global__ void pack_planes_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ reach,
                                   const int* __restrict__ table, int slots,
                                   int n, float* __restrict__ pos0,
                                   float* __restrict__ reach0) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  int j = table[s];
  bool real = j < n;
  pos0[3 * s] = real ? pos[3 * j] : 1e9f;
  pos0[3 * s + 1] = real ? pos[3 * j + 1] : 1e9f;
  pos0[3 * s + 2] = real ? pos[3 * j + 2] : 1e9f;
  reach0[s] = real ? reach[j] : 0.0f;
}

__global__ void rebuild_sweep_kernel(
    const float* __restrict__ pos0, const float* __restrict__ reach0,
    const int* __restrict__ table, const int* __restrict__ pslot,
    const int* __restrict__ neighbors, const int* __restrict__ active_rank,
    int n, int num_cells, int cap, int top_k, int* __restrict__ cands,
    uint8_t* __restrict__ unswept) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int* out = cands + static_cast<long long>(i) * top_k;
  int s = pslot[i];
  bool listed = s < num_cells * cap;
  int cell = listed ? s / cap : num_cells;
  bool covered = listed && active_rank[cell] >= 0;
  unswept[i] = listed && !covered;
  if (!covered) {
    for (int k = 0; k < top_k; ++k) out[k] = -1;
    return;
  }
  float xi = pos0[3 * s];
  float yi = pos0[3 * s + 1];
  float zi = pos0[3 * s + 2];
  float ri = reach0[s];
  int best[kMaxTopK];
  for (int k = 0; k < top_k; ++k) best[k] = amc::kIntBig;
  const int* nbr = neighbors + static_cast<long long>(cell) * 27;
  for (int o = 13; o < 27; ++o) {
    long long row = static_cast<long long>(nbr[o]) * cap;
    for (int k = 0; k < cap; ++k) {
      long long slot = row + k;
      int j = table[slot];
      if (j >= n) break;
      if (o == 13 && j <= i) continue;
      if (j >= best[top_k - 1]) continue;
      float dx = xi - pos0[3 * slot];
      float dy = yi - pos0[3 * slot + 1];
      float dz = zi - pos0[3 * slot + 2];
      float d2 = dx * dx + dy * dy;
      d2 = d2 + dz * dz;
      float th = ri + reach0[slot];
      if (!(d2 < th * th)) continue;
      // Insert j into the ascending list (it beats the last entry).
      int p = top_k - 1;
      while (p > 0 && best[p - 1] > j) {
        best[p] = best[p - 1];
        --p;
      }
      best[p] = j;
    }
  }
  for (int k = 0; k < top_k; ++k) out[k] = best[k] < amc::kIntBig ? best[k] : -1;
}

}  // namespace

// table is K2's (num_cells + 1, cap) table; active_rank is (num_cells + 1,)
// with -1 for inactive cells and the dummy cell.  Outputs: pos0
// (num_cells + 1, cap, 3), reach0 (num_cells + 1, cap), cands (n, top_k),
// unswept (n,).
AMC_EXPORT int amc_rebuild_sweep(
    const float* pos, const float* reach, const int* table, const int* pslot,
    const int* neighbors, const int* active_rank, int n, int num_cells,
    int cap, int top_k, float* pos0, float* reach0, int* cands,
    uint8_t* unswept, cudaStream_t stream) {
  if (top_k < 1 || top_k > kMaxTopK) return static_cast<int>(cudaErrorInvalidValue);
  int slots = (num_cells + 1) * cap;
  pack_planes_kernel<<<amc::blocks_for(slots), amc::kThreads, 0, stream>>>(
      pos, reach, table, slots, n, pos0, reach0);
  if (n > 0) {
    rebuild_sweep_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        pos0, reach0, table, pslot, neighbors, active_rank, n, num_cells, cap,
        top_k, cands, unswept);
  }
  return static_cast<int>(cudaGetLastError());
}
