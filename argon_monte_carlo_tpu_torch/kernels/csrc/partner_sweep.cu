// K9 partner_sweep: each particle's lowest-index (with ids, lowest-id)
// partner j != i within the search radius, over the 27 neighbour cells of
// its own cell row.
//
// Replaces the deleted Pallas kernel _sweep_kernel / pallas_partner_search
// (argon_monte_carlo_tpu/ops/pallas_sweep.py:255-400, pallas_call at :327,
// removed in 7e76fb0) and the XLA sweep that took over its job,
// argon_monte_carlo_tpu/ops/collide.py cell_partner_search (:423) in radius
// mode, top_k=1, two-sided (:453-961).
//
// Bound: operations (~300 pair tests a particle at ~11 particles a cell;
// the inputs are a few tens of MB).  What a particle-ordered walk pays
// instead is memory traffic: particle indices are spatially random, so each
// thread gathers its ~300 candidate positions one by one and a warp shares
// none of them, some 10-20 GB of L2 sectors a call at 1M particles.
//
// Design: the unit of work is a cell (cell_walk.cuh).  A block of eight
// warps owns a run of up to eight consecutive cells of one x-row.  It reads
// the run's 9 x (len + 2) neighbour rows of the table (consecutive rows:
// coalesced), fetches each listed particle's position once and packs
// (x, y, z, j) into shared memory; then warp k tests the particles of cell k
// against the nine contiguous candidate ranges of its 27 cells, lanes over
// candidates, looping over the cell's own particles, whose positions are
// broadcast reads of the same staged plane.  A hit (rare: a few thousand a
// step) lowers the particle's best with a shared-memory atomicMin, so the
// result is the minimum over j whatever the order of the walk.  A run whose
// cells are all empty or outside the window leaves before staging anything.
//
// Every cell row is swept (not only the reference's active-cell list), so a
// stray keeps its own row.  A particle that lost its slot in a full cell is
// in no row: nobody's candidate, and no partner, as in the reference.  The
// walk visits only the listed particles of cells inside the window, so a
// first launch sets every partner to -1.  d^2 is formed in the reference's
// order, (dx*dx + dy*dy) + dz*dz with dx = x_i - x_j, and the library is
// built with -fmad=false so nothing is contracted into an FMA.
//
// The z-slab engine's arguments (collide.py:433-442, 559-563, 955-959):
// ids (optional, the slab's global ids) replaces the lane index in the
// self-exclusion, so a particle never pairs with its own ghost copy, and in
// the order of the candidates: the partner is the candidate of the lowest
// id (the lowest lane among equal ids), the minimum taken over (id, lane)
// packed into 64 bits, the id read only for a candidate already in range.
// The two slabs holding a pair across a face number their lanes
// differently, so only an order both share lets them make the same match;
// by global id it is the one-card rule (the reference orders by lane,
// collide.py:876, and its sharded cube drifts in energy for it).  valid
// (optional) gives a padding lane no partner; a particle whose own cell
// lies outside [cell_start, cell_start + cell_width) gets none either (its
// neighbour rows are staged wherever they lie).  Null pointers and the
// window [0, num_cells) are the single-slab sweep.
#include "cell_walk.cuh"

namespace {

__global__ void partner_init_kernel(int n, int* __restrict__ partner) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) partner[i] = -1;
}

__launch_bounds__(amc::kWalkThreads) __global__ void partner_walk_kernel(
    const float* __restrict__ pos, const int* __restrict__ table,
    const int* __restrict__ neighbors, const int* __restrict__ run_start,
    const int* __restrict__ ids, const uint8_t* __restrict__ valid, int n,
    int num_cells, int cap, int cell_start, int cell_width, float r2,
    int* __restrict__ partner) {
  const unsigned long long kNone = ~0ull;
  extern __shared__ float4 dyn[];
  __shared__ amc::RunIndex index;
  float4* cand = dyn;
  unsigned long long* best_all =
      reinterpret_cast<unsigned long long*>(dyn + amc::kStagedRows * cap);

  int c0 = run_start[blockIdx.x];
  int len = run_start[blockIdx.x + 1] - c0;
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int cell = c0 + warp;
  bool mine = warp < len && cell >= cell_start &&
              cell - cell_start < cell_width;
  // A cell with work: inside the window and its row not empty.
  bool work = mine && table[static_cast<long long>(cell) * cap] < n;
  if (!__syncthreads_or(work)) return;

  amc::stage_run<0, false, false>(pos, nullptr, table, neighbors, c0, len, n,
                                  num_cells, cap, index, cand, nullptr);
  if (!work) return;

  // The cell's own particles: staged row warp + 1 of group 4 (dz = dy = 0).
  int own_n = index.count[4 * amc::kRunRows + warp + 1];
  const float4* own = cand + amc::group_base(4, cap) + index.start[4][warp + 1];
  unsigned long long* best = best_all + warp * cap;
  for (int a = lane; a < own_n; a += 32) best[a] = kNone;
  __syncwarp();

  // Candidate q of the cell, 0 <= q < total, is slot q + shift[g] of the
  // plane for the group g with before[g] <= q < before[g + 1].
  int before[amc::kGroups + 1];
  int shift[amc::kGroups];
  before[0] = 0;
#pragma unroll
  for (int g = 0; g < amc::kGroups; ++g) {
    int lo = index.start[g][warp];
    shift[g] = amc::group_base(g, cap) + lo - before[g];
    before[g + 1] = before[g] + index.start[g][warp + 3] - lo;
  }
  int total = before[amc::kGroups];
  for (int q0 = 0; q0 < total; q0 += 32) {
    int q = q0 + lane;
    bool active = q < total;
    int off = shift[0];
#pragma unroll
    for (int g = 1; g < amc::kGroups; ++g) {
      if (q >= before[g]) off = shift[g];
    }
    float4 c = active ? cand[q + off] : make_float4(0.f, 0.f, 0.f, 0.f);
    int j = __float_as_int(c.w);
    for (int a = 0; a < own_n; ++a) {
      float4 o = own[a];
      float dx = o.x - c.x;
      float dy = o.y - c.y;
      float dz = o.z - c.z;
      float d2 = dx * dx + dy * dy;
      d2 = d2 + dz * dz;
      if (active && d2 < r2) {
        int i = __float_as_int(o.w);
        // The id is read only for a candidate in range: a gather for every
        // candidate made the sweep 1.4x slower.
        int key = ids != nullptr ? ids[j] : j;
        bool other = ids != nullptr ? key != ids[i] : j != i;
        if (other) {
          atomicMin(&best[a],
                    (static_cast<unsigned long long>(
                         static_cast<unsigned>(key)) << 32) |
                        static_cast<unsigned>(j));
        }
      }
    }
  }
  __syncwarp();
  for (int a = lane; a < own_n; a += 32) {
    int i = __float_as_int(own[a].w);
    if (valid != nullptr && !valid[i]) continue;
    unsigned long long b = best[a];
    partner[i] = b != kNone ? static_cast<int>(b & 0xffffffffu) : -1;
  }
}

}  // namespace

// run_start holds num_runs + 1 cell ids: run r is [run_start[r],
// run_start[r + 1]), at most run_cells cells of one x-row
// (ops/collide.py cell_runs).  Two launches: every partner to -1, the walk.
AMC_EXPORT int amc_partner_sweep(const float* pos, const int* table,
                                 const int* neighbors, const int* run_start,
                                 const int* ids, const uint8_t* valid, int n,
                                 int num_cells, int cap, int num_runs,
                                 int run_cells, int cell_start,
                                 int cell_width, float r2, int* partner,
                                 cudaStream_t stream) {
  if (run_cells != amc::kRunCells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    partner_init_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        n, partner);
  }
  if (n > 0 && num_runs > 0) {
    size_t bytes = amc::run_stage_bytes(cap) +
                   sizeof(unsigned long long) * amc::kRunCells *
                       static_cast<size_t>(cap);
    cudaError_t rc = cudaFuncSetAttribute(
        partner_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    partner_walk_kernel<<<num_runs, amc::kWalkThreads, bytes, stream>>>(
        pos, table, neighbors, run_start, ids, valid, n, num_cells,
        cap, cell_start, cell_width, r2, partner);
  }
  return static_cast<int>(cudaGetLastError());
}
