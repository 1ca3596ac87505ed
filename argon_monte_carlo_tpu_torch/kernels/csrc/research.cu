// K4 research_dirty: re-search the step's dirty particles against the
// rebuild-time planes and append what they find to the pair list.
//
// Replaces argon_monte_carlo_tpu/ops/pairs.py research_dirty (:433-612): on
// the TPU E-row gathers of 27 packed neighbour rows, top-12 masked
// min-passes, a compaction and bump-append scatters.
//
// Bound: memory latency.  Each of the research_capacity (4,096) lanes reads
// 27 rows of cap slots of the rebuild-time planes; the bump touches one
// stored reach a lane.
//
// Design, in launch order (the caller passes fresh copies of reach0, hot,
// a and b, which the kernels update):
//   1. bump: one thread per lane.  Reach radii at the current speed
//      sqrt((vx*vx + vy*vy) + vz*vz); a clipped particle goes hot; the
//      unbounded count (pairs.py:483-487); a speed-changed particle's
//      stored reach grows by its new window allowance, clipped, and a
//      newly clipped one goes hot (:489-507).  Invalid lanes and
//      table-dropped particles write nothing: the reference aliases padded
//      lanes to particle 0 and writes dropped ones into the dummy row,
//      which no search reads.  Every bump lands before any search reads
//      reach0, because the search is the next launch.
//   2. search: one thread per lane.  Bin the particle at its current
//      position with K2's arithmetic, scan the 27 neighbour rows of the
//      rebuild-time planes (stop at a row's first sentinel), skip itself,
//      hit when d^2 < (reach_i + reach0_j)^2, count the hits already within
//      the collision range (latent_per), keep the 12 lowest indices
//      ascending, and count a lane whose list filled (res_overflow).
//   3. K6 compaction of the (E, research_top_k) found-mask at
//      append_capacity.
//   4. append: one thread per selected entry writes (i, c) at cursor + k
//      while the list has room, and counts the rest (cap_dropped).
//   5. finish: cursor, overflow and the coverage-lost flag.
#include "common.cuh"

namespace {

constexpr int kMaxResearchTopK = 16;

__global__ void bump_kernel(const float* __restrict__ vel,
                            const int* __restrict__ dirty_idx, int e, int n,
                            const uint8_t* __restrict__ bump,
                            const int* __restrict__ pslot0, int dummy_slot,
                            float half_cr, float dtk, float max_reach,
                            float unbounded_drift, float dt,
                            float* __restrict__ reach0,
                            uint8_t* __restrict__ hot,
                            int* __restrict__ counters) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  bool unbounded = false;
  if (k < e) {
    int d = dirty_idx[k];
    if (d < n) {
      float vx = vel[3 * d], vy = vel[3 * d + 1], vz = vel[3 * d + 2];
      float s2 = vx * vx + vy * vy;
      s2 = s2 + vz * vz;
      float speed = sqrtf(s2);
      float raw = half_cr + speed * dtk;
      float reach = fminf(raw, max_reach);
      bool clipped = raw > max_reach;
      unbounded = speed * dt > unbounded_drift;
      bool newly = false;
      int s = pslot0[d];
      if (bump[d] && s < dummy_slot) {
        float old = reach0[s];
        float inc = reach - half_cr;
        float grown = old + inc;
        reach0[s] = fminf(grown, max_reach);
        newly = grown > max_reach;
      }
      if (clipped || newly) hot[d] = 1;
    }
  }
  int block_count = __syncthreads_count(unbounded);
  if (threadIdx.x == 0 && block_count > 0) atomicAdd(&counters[0], block_count);
}

__global__ void search_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const int* __restrict__ dirty_idx, int e, int n,
    const float* __restrict__ pos0, const float* __restrict__ reach0,
    const int* __restrict__ idx0, const int* __restrict__ neighbors,
    const int* __restrict__ nx, const int* __restrict__ layer_base,
    const float* __restrict__ half_extent, int nz, float z_lo,
    float cell_size, int cap, int rk, float half_cr, float dtk,
    float max_reach, float cr2, int* __restrict__ cands,
    uint8_t* __restrict__ found, int* __restrict__ latent_per,
    int* __restrict__ counters) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  bool full = false;
  if (k < e) {
    int* out = cands + static_cast<long long>(k) * rk;
    uint8_t* ok = found + static_cast<long long>(k) * rk;
    int d = dirty_idx[k];
    int latent = 0;
    int best[kMaxResearchTopK];
    for (int q = 0; q < rk; ++q) best[q] = amc::kIntBig;
    if (d < n) {
      float x = pos[3 * d], y = pos[3 * d + 1], z = pos[3 * d + 2];
      float vx = vel[3 * d], vy = vel[3 * d + 1], vz = vel[3 * d + 2];
      float s2 = vx * vx + vy * vy;
      s2 = s2 + vz * vz;
      float raw = half_cr + sqrtf(s2) * dtk;
      float ri = fminf(raw, max_reach);
      int cell = amc::assign_cell(x, y, z, nx, layer_base, half_extent, nz,
                                  z_lo, cell_size);
      const int* nbr = neighbors + static_cast<long long>(cell) * 27;
      for (int o = 0; o < 27; ++o) {
        long long row = static_cast<long long>(nbr[o]) * cap;
        for (int q = 0; q < cap; ++q) {
          long long slot = row + q;
          int j = idx0[slot];
          if (j >= n) break;
          if (j == d) continue;
          float dx = x - pos0[3 * slot];
          float dy = y - pos0[3 * slot + 1];
          float dz = z - pos0[3 * slot + 2];
          float d2 = dx * dx + dy * dy;
          d2 = d2 + dz * dz;
          float th = ri + reach0[slot];
          if (!(d2 < th * th)) continue;
          if (d2 < cr2) ++latent;
          if (j >= best[rk - 1]) continue;
          int p = rk - 1;
          while (p > 0 && best[p - 1] > j) {
            best[p] = best[p - 1];
            --p;
          }
          best[p] = j;
        }
      }
      full = best[rk - 1] < amc::kIntBig;
    }
    for (int q = 0; q < rk; ++q) {
      out[q] = best[q];
      ok[q] = best[q] < amc::kIntBig;
    }
    latent_per[k] = latent;
  }
  int block_count = __syncthreads_count(full);
  if (threadIdx.x == 0 && block_count > 0) atomicAdd(&counters[1], block_count);
}

__global__ void append_kernel(const int* __restrict__ sel, int append_cap,
                              const int* __restrict__ total,
                              const int* __restrict__ dirty_idx,
                              const int* __restrict__ cands, int rk,
                              const int* __restrict__ cursor, int m_cap,
                              int* __restrict__ a, int* __restrict__ b,
                              int* __restrict__ counters) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  bool dropped = false;
  if (k < append_cap && k < *total) {
    int p = *cursor + k;
    if (p < m_cap) {
      int s = sel[k];
      a[p] = dirty_idx[s / rk];
      b[p] = cands[s];
    } else {
      dropped = true;
    }
  }
  int block_count = __syncthreads_count(dropped);
  if (threadIdx.x == 0 && block_count > 0) atomicAdd(&counters[2], block_count);
}

__global__ void finish_kernel(const int* __restrict__ total, int append_cap,
                              const int* __restrict__ cursor, int m_cap,
                              const int* __restrict__ overflow,
                              const int* __restrict__ counters,
                              int* __restrict__ cursor_out,
                              int* __restrict__ overflow_out,
                              uint8_t* __restrict__ lost) {
  int n_new = min(*total, append_cap);
  int app_dropped = max(*total - append_cap, 0);
  *cursor_out = min(*cursor + n_new, m_cap);
  int losses = counters[1] + app_dropped + counters[2];
  *overflow_out = *overflow + counters[0] + losses;
  *lost = losses > 0;
}

}  // namespace

// In place: reach0, hot, a, b (the wrapper passes fresh copies).  Outputs:
// cursor_out, overflow_out, lost, latent_per (e,).  Scratch: cands and found
// (e * rk each), sel (append_cap), total (1), block_vals and block_offsets
// (blocks_for(e * rk) each), counters (3).
AMC_EXPORT int amc_research_dirty(
    const float* pos, const float* vel, const int* dirty_idx, int e, int n,
    const uint8_t* bump, const int* pslot0, const float* pos0,
    const int* idx0, const int* neighbors, const int* nx,
    const int* layer_base, const float* half_extent, int nz, float z_lo,
    float cell_size, int num_cells, int cap, int rk, int append_cap,
    int m_cap, float half_cr, float dtk, float max_reach,
    float unbounded_drift, float dt, float cr2, const int* cursor,
    const int* overflow, float* reach0, uint8_t* hot, int* a, int* b,
    int* cursor_out, int* overflow_out, uint8_t* lost, int* latent_per,
    int* cands, uint8_t* found, int* sel, int* total, int* block_vals,
    int* block_offsets, int* counters, cudaStream_t stream) {
  if (rk < 1 || rk > kMaxResearchTopK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaMemsetAsync(counters, 0, 3 * sizeof(int), stream);
  if (e > 0) {
    bump_kernel<<<amc::blocks_for(e), amc::kThreads, 0, stream>>>(
        vel, dirty_idx, e, n, bump, pslot0, num_cells * cap, half_cr, dtk,
        max_reach, unbounded_drift, dt, reach0, hot, counters);
    search_kernel<<<amc::blocks_for(e), amc::kThreads, 0, stream>>>(
        pos, vel, dirty_idx, e, n, pos0, reach0, idx0, neighbors, nx,
        layer_base, half_extent, nz, z_lo, cell_size, cap, rk, half_cr, dtk,
        max_reach, cr2, cands, found, latent_per, counters);
  }
  amc::compact_launch(found, e * rk, append_cap, e * rk, sel, total,
                      block_vals, block_offsets, stream);
  if (append_cap > 0) {
    append_kernel<<<amc::blocks_for(append_cap), amc::kThreads, 0, stream>>>(
        sel, append_cap, total, dirty_idx, cands, rk, cursor, m_cap, a, b,
        counters);
  }
  finish_kernel<<<1, 1, 0, stream>>>(total, append_cap, cursor, m_cap,
                                     overflow, counters, cursor_out,
                                     overflow_out, lost);
  return static_cast<int>(cudaGetLastError());
}
