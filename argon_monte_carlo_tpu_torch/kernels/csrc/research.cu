// K4 research_dirty: re-search the step's dirty particles against the
// rebuild-time planes and append what they find to the pair list.
//
// Replaces argon_monte_carlo_tpu/ops/pairs.py research_dirty (:433-612): on
// the TPU E-row gathers of 27 packed neighbour rows, top-12 masked
// min-passes, a compaction and bump-append scatters.
//
// Bound: bytes, and in practice memory latency.  Each of the
// research_capacity (4,096) lanes reads 27 rows of cap slots of the
// rebuild-time planes (20 bytes a slot, ~53 MB in all, mostly from device
// memory: the planes are larger than L2); the bump touches one stored reach
// a lane.  The first version gave a lane one thread -- 16 blocks on a card
// of 132 SMs, each thread reading its 648 slots one after another -- and
// compacted the found mask with the general multi-pass compaction: thirteen
// device operations and 0.33 ms a call at 1M particles on an H100.
//
// Design, three launches (reach0, hot, a and b are updated where they are:
// the caller passes copies when it wants its inputs kept):
//   1. bump: one thread per lane.  Reach radii at the current speed
//      sqrt((vx*vx + vy*vy) + vz*vz); a clipped particle goes hot
//      (pairs.py:483-487); a speed-changed particle's stored reach grows by
//      its new window allowance, clipped, and a newly clipped one goes hot
//      (:489-507).  Invalid lanes and table-dropped particles write nothing:
//      the reference aliases padded lanes to particle 0 and writes dropped
//      ones into the dummy row, which no search reads.  Every bump lands
//      before any search reads reach0, because the search is the next
//      launch.
//   2. search: one warp per lane, so the 4,096 lanes spread over every SM.
//      The warp bins the particle at its current position with K2's
//      arithmetic and walks the 27 x cap slots of its neighbour rows as one
//      flat range, a thread a slot, 32 slots at a time; the loads of several
//      such steps (index, position, reach: they do not depend on one
//      another, empty slots hold a far position) are started before the first
//      is used.  A slot hits when its index is real and not the particle's
//      own and d^2 < (reach_i + reach0_j)^2.  Hits are found by ballot:
//      latent_per is a population count of the hits already within the
//      collision range; the rk lowest hit indices are a function of the set
//      of hits, not of their order, so the warp keeps them ascending in
//      registers, entry l in lane l, and inserts each set bit in one step
//      (a lane keeps a lower entry, else takes the new index or its left
//      neighbour's entry).  The lane's list, its length and two flags (list
//      full: res_overflow; drift unbounded) go to scratch.
//   3. append: the found entries of a lane are a prefix of its ascending,
//      kIntBig-padded list, so the reference's row-major compaction of the
//      (E, rk) mask is an exclusive scan over the E list lengths.  A block
//      takes 256 lanes, sums the lengths of the lanes before its own (E
//      ints, from L2), scans its own and writes (i, c) at cursor + rank
//      while the append budget and the list have room.  The last block also
//      holds the grand total and the flag sums: it writes cursor, overflow
//      and the coverage-lost flag (the entries the full list turned away,
//      cap_dropped, follow from the total in closed form).
// The z-slab engine's ids (optional, pairs.py:532-538): "not itself" is
// ids[j] != ids[d], a particle and its ghost being two lanes; ids[j] is read
// only for a slot in reach (the reference keeps a global-id plane beside the
// rebuild-time planes; a slab's lanes keep their ids for the whole window,
// so ids[idx0] is the same number).
// No atomics, no tickets and no scratch that outlives the call: the same
// arguments replay correctly in a CUDA graph, and the output is the same in
// every run.
#include "common.cuh"

namespace {

constexpr int kMaxResearchTopK = 16;
// Steps of 32 slots whose loads are in flight together in the search.
constexpr int kSearchBatch = 7;
// A lane's scratch word: list length | kFullBit | kUnboundedBit.
constexpr int kCountMask = 0xff;
constexpr int kFullBit = 1 << 8;
constexpr int kUnboundedBit = 1 << 9;

__global__ void bump_kernel(const float* __restrict__ vel,
                            const int* __restrict__ dirty_idx, int e, int n,
                            const uint8_t* __restrict__ bump,
                            const int* __restrict__ pslot0, int dummy_slot,
                            float half_cr, float dtk, float max_reach,
                            float* __restrict__ reach0,
                            uint8_t* __restrict__ hot) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= e) return;
  int d = dirty_idx[k];
  if (d >= n) return;
  float vx = vel[3 * d], vy = vel[3 * d + 1], vz = vel[3 * d + 2];
  float s2 = vx * vx + vy * vy;
  s2 = s2 + vz * vz;
  float raw = half_cr + sqrtf(s2) * dtk;
  float reach = fminf(raw, max_reach);
  bool clipped = raw > max_reach;
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

__launch_bounds__(amc::kThreads) __global__ void search_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const int* __restrict__ dirty_idx, int e, int n,
    const float* __restrict__ pos0, const float* __restrict__ reach0,
    const int* __restrict__ idx0, const int* __restrict__ neighbors,
    const int* __restrict__ nx, const int* __restrict__ layer_base,
    const float* __restrict__ half_extent, int nz, float z_lo,
    float cell_size, int cap, int rk, float half_cr, float dtk,
    float max_reach, float unbounded_drift, float dt, float cr2,
    const int* __restrict__ ids, int* __restrict__ cands,
    int* __restrict__ meta, int* __restrict__ latent_per) {
  const unsigned kFull = 0xffffffffu;
  int lane = threadIdx.x & 31;
  int k = blockIdx.x * (amc::kThreads / 32) + (threadIdx.x >> 5);
  if (k >= e) return;
  int d = dirty_idx[k];
  if (d >= n) {  // a padding lane: nothing found
    if (lane == 0) {
      meta[k] = 0;
      latent_per[k] = 0;
    }
    return;
  }
  // Every thread of the warp holds the particle (broadcast loads).
  float x = pos[3 * d], y = pos[3 * d + 1], z = pos[3 * d + 2];
  float vx = vel[3 * d], vy = vel[3 * d + 1], vz = vel[3 * d + 2];
  float s2 = vx * vx + vy * vy;
  s2 = s2 + vz * vz;
  float speed = sqrtf(s2);
  float ri = fminf(half_cr + speed * dtk, max_reach);
  bool unbounded = speed * dt > unbounded_drift;
  int my_id = ids != nullptr ? ids[d] : d;
  // No centre: the reference's re-search bins on a pore grid (the pairs
  // engine refuses the cube, the one grid with a centre).
  int cell = amc::assign_cell(x, y, z, 0.0f, 0.0f, nx, layer_base,
                              half_extent, nz, z_lo, cell_size);
  // Thread o < 27 holds the table row of neighbour column o.
  int my_row = lane < 27 ? neighbors[static_cast<long long>(cell) * 27 + lane]
                         : 0;
  int best = amc::kIntBig;  // entry `lane` of the ascending list, lane < rk
  int latent = 0;
  int total = 27 * cap;
  for (int q0 = 0; q0 < total; q0 += 32 * kSearchBatch) {
    int j[kSearchBatch];
    float cx[kSearchBatch], cy[kSearchBatch], cz[kSearchBatch];
    float cr[kSearchBatch];
#pragma unroll
    for (int u = 0; u < kSearchBatch; ++u) {
      int q = q0 + 32 * u + lane;
      int column = min(q / cap, 26);
      int row = __shfl_sync(kFull, my_row, column);
      j[u] = n;
      if (q < total) {
        long long slot =
            static_cast<long long>(row) * cap + (q - column * cap);
        j[u] = idx0[slot];
        cx[u] = pos0[3 * slot];
        cy[u] = pos0[3 * slot + 1];
        cz[u] = pos0[3 * slot + 2];
        cr[u] = reach0[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < kSearchBatch; ++u) {
      bool hit = false;
      bool within = false;
      if (j[u] < n && (ids != nullptr || j[u] != d)) {
        float dx = x - cx[u];
        float dy = y - cy[u];
        float dz = z - cz[u];
        float d2 = dx * dx + dy * dy;
        d2 = d2 + dz * dz;
        float th = ri + cr[u];
        hit = d2 < th * th;
        if (hit && ids != nullptr) hit = ids[j[u]] != my_id;
        within = hit && d2 < cr2;
      }
      unsigned hits = __ballot_sync(kFull, hit);
      latent += __popc(__ballot_sync(kFull, within));
      while (hits != 0) {
        int jb = __shfl_sync(kFull, j[u], __ffs(hits) - 1);
        hits &= hits - 1;
        int left = __shfl_up_sync(kFull, best, 1);
        if (lane == 0) left = -1;
        if (lane < rk && !(best < jb)) best = left < jb ? jb : left;
      }
    }
  }
  unsigned found = __ballot_sync(kFull, lane < rk && best < amc::kIntBig);
  if (lane < rk) cands[static_cast<long long>(k) * rk + lane] = best;
  if (lane == 0) {
    int count = __popc(found);
    meta[k] = count | (count == rk ? kFullBit : 0) |
              (unbounded ? kUnboundedBit : 0);
    latent_per[k] = latent;
  }
}

// Sum of one int a thread over the block (every thread calls it).
__device__ __forceinline__ int block_sum(int v) {
  int total;
  amc::block_exclusive_scan(v, &total);
  return total;
}

__launch_bounds__(amc::kThreads) __global__ void append_kernel(
    const int* __restrict__ dirty_idx, int e, const int* __restrict__ cands,
    const int* __restrict__ meta, int rk, int append_cap, int m_cap,
    const int* __restrict__ cursor, const int* __restrict__ overflow,
    int* __restrict__ a, int* __restrict__ b, int* __restrict__ cursor_out,
    int* __restrict__ overflow_out, uint8_t* __restrict__ lost) {
  int first = blockIdx.x * amc::kThreads;
  int k = first + threadIdx.x;
  // Found entries of the lanes before this block's.
  int earlier = 0;
  for (int q = threadIdx.x; q < first; q += amc::kThreads) {
    earlier += meta[q] & kCountMask;
  }
  int prefix = block_sum(earlier);
  int word = k < e ? meta[k] : 0;
  int count = word & kCountMask;
  int block_total;
  int rank = prefix + amc::block_exclusive_scan(count, &block_total);
  int at = *cursor;
  int i = count > 0 ? dirty_idx[k] : 0;
  for (int q = 0; q < count; ++q) {
    int p = at + rank + q;
    if (rank + q < append_cap && p < m_cap) {
      a[p] = i;
      b[p] = cands[static_cast<long long>(k) * rk + q];
    }
  }
  if (blockIdx.x != gridDim.x - 1) return;
  // The last block: the grand total and the flag sums (pairs.py:590-612).
  int full = 0, unbounded = 0;
  for (int q = threadIdx.x; q < e; q += amc::kThreads) {
    int w = meta[q];
    full += (w & kFullBit) != 0;
    unbounded += (w & kUnboundedBit) != 0;
  }
  full = block_sum(full);
  unbounded = block_sum(unbounded);
  if (threadIdx.x == 0) {
    int total = prefix + block_total;
    int n_new = min(total, append_cap);
    int app_dropped = max(total - append_cap, 0);
    // Of the n_new entries, those at cursor + k >= m_cap found no room.
    int cap_dropped = n_new - min(max(m_cap - at, 0), n_new);
    int losses = full + app_dropped + cap_dropped;
    *cursor_out = min(at + n_new, m_cap);
    *overflow_out = *overflow + unbounded + losses;
    *lost = losses > 0;
  }
}

}  // namespace

// In place: reach0, hot, a, b.  Outputs: cursor_out, overflow_out, lost,
// latent_per (e,).  Scratch: cands (e * rk), meta (e).  ids may be null.
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
    int* cands, int* meta, const int* ids, cudaStream_t stream) {
  if (rk < 1 || rk > kMaxResearchTopK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e > 0) {
    bump_kernel<<<amc::blocks_for(e), amc::kThreads, 0, stream>>>(
        vel, dirty_idx, e, n, bump, pslot0, num_cells * cap, half_cr, dtk,
        max_reach, reach0, hot);
    search_kernel<<<amc::blocks_for(e, amc::kThreads / 32), amc::kThreads, 0,
                    stream>>>(
        pos, vel, dirty_idx, e, n, pos0, reach0, idx0, neighbors, nx,
        layer_base, half_extent, nz, z_lo, cell_size, cap, rk, half_cr, dtk,
        max_reach, unbounded_drift, dt, cr2, ids, cands, meta, latent_per);
  }
  append_kernel<<<max(amc::blocks_for(e), 1), amc::kThreads, 0, stream>>>(
      dirty_idx, e, cands, meta, rk, append_cap, m_cap, cursor, overflow, a,
      b, cursor_out, overflow_out, lost);
  return static_cast<int>(cudaGetLastError());
}
