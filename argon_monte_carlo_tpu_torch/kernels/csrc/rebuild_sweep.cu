// K1 rebuild_sweep: the pair-list rebuild's candidate sweep -- reach mode,
// one-sided, half shell, active rows only, top_k lowest indices.
//
// Replaces argon_monte_carlo_tpu/ops/collide.py cell_candidate_search
// (:453-622: the slot planes) and _candidate_sweep (:625-961) as the pairs
// rebuild calls them (ops/pairs.py:182-189): on the TPU a chunked lax.scan
// of (rows, cap, group*cap) hit tests on float-packed planes, with top_k
// masked min-passes.
//
// Bound: bytes (the planes it writes, 20 bytes a slot, and the candidate
// rows); every rebuild_interval steps.  What a particle-ordered walk pays
// instead is latency: particle indices are spatially random, so a thread a
// particle walks 14 table rows with dependent loads (neighbours -> table ->
// position, reach) that no neighbour in its warp shares; that first version
// read 3.51 ms at 1M particles on an H100.
//
// Design: the unit of work is a cell, as in K9 (cell_walk.cuh).
//   1. pack and fill, one launch.  A thread a slot fills the planes the pair
//      list keeps -- pos0 (rows, cap, 3) and reach0 (rows, cap) -- from the
//      K2 table (the index plane is the table itself, int32: no integers
//      ride as floats); empty slots get the reference's far position 1e9 and
//      reach 0.  A thread a particle settles what the walk never visits: a
//      particle that lost its slot (pslot is the dummy slot) emits nothing,
//      a listed particle of a cell off the active list emits nothing and is
//      reported unswept (collide.py:942-954); both get a row of -1.  Every
//      unswept flag is written here and only here, every candidate row
//      either here or by the walk, never by both.
//   2. the walk.  A block of eight warps owns a run of up to eight cells of
//      one x-row and stages the run's half shell once in shared memory:
//      (x, y, z, index) and, in a second plane, the reach of every listed
//      particle of rows k + 1, k + 2 of group 4 and k, k + 1, k + 2 of groups
//      5 to 8 (columns 13-26, collide.py:809).  Warp k tests the particles
//      of cell k (the emitters, broadcast reads of the same planes) against
//      the five contiguous candidate ranges, lanes over candidates.  In its
//      own cell (column 13) only indices above the emitter's count
//      (collide.py:854-869).  A hit is d^2 < (reach_i + reach_j)^2 with
//      d^2 = (dx*dx + dy*dy) + dz*dz, dx = emitter - candidate, the
//      threshold summed then squared (collide.py:822-853).  The top_k lowest
//      hit indices are a function of the set of hits, not of their order:
//      each emitter keeps an ascending list in shared memory, the hit lanes
//      are found by ballot and each is inserted by lanes 0..top_k-1 in one
//      step (lane l keeps its entry if it is lower, else takes the new index
//      or its left neighbour's entry).  Lists are padded with -1 on the way
//      out.  Cells off the active list and empty cells do nothing; a run
//      without any working cell leaves before staging.
#include "cell_walk.cuh"

namespace {

constexpr int kMaxTopK = 16;
constexpr int kShellLo = 4;  // first (dz, dy) group of the half shell
constexpr int kShellGroups = amc::kGroups - kShellLo;

__global__ void pack_and_fill_kernel(
    const float* __restrict__ pos, const float* __restrict__ reach,
    const int* __restrict__ table, const int* __restrict__ pslot,
    const int* __restrict__ active_rank, int slots, int n, int num_cells,
    int cap, int top_k, float* __restrict__ pos0, float* __restrict__ reach0,
    int* __restrict__ cands, uint8_t* __restrict__ unswept) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < slots) {
    int j = table[t];
    bool real = j < n;
    pos0[3 * t] = real ? pos[3 * j] : 1e9f;
    pos0[3 * t + 1] = real ? pos[3 * j + 1] : 1e9f;
    pos0[3 * t + 2] = real ? pos[3 * j + 2] : 1e9f;
    reach0[t] = real ? reach[j] : 0.0f;
  }
  if (t < n) {
    int s = pslot[t];
    bool listed = s < num_cells * cap;
    int cell = listed ? s / cap : num_cells;
    bool covered = listed && active_rank[cell] >= 0;
    unswept[t] = listed && !covered;
    if (!covered) {
      int* out = cands + static_cast<long long>(t) * top_k;
      for (int k = 0; k < top_k; ++k) out[k] = -1;
    }
  }
}

__launch_bounds__(amc::kWalkThreads) __global__ void rebuild_walk_kernel(
    const float* __restrict__ pos, const float* __restrict__ reach,
    const int* __restrict__ table, const int* __restrict__ neighbors,
    const int* __restrict__ run_start, const int* __restrict__ active_rank,
    int n, int num_cells, int cap, int top_k, int* __restrict__ cands) {
  const unsigned kFull = 0xffffffffu;
  extern __shared__ float4 dyn[];
  __shared__ amc::RunIndex index;
  int plane = kShellGroups * amc::kRunRows * cap;
  float4* cand = dyn;
  float* cand_reach = reinterpret_cast<float*>(dyn + plane);
  int* lists = reinterpret_cast<int*>(cand_reach + plane);

  int c0 = run_start[blockIdx.x];
  int len = run_start[blockIdx.x + 1] - c0;
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int cell = c0 + warp;
  // A cell with work: on the active list and its row not empty.
  bool work = warp < len && active_rank[cell] >= 0 &&
              table[static_cast<long long>(cell) * cap] < n;
  if (!__syncthreads_or(work)) return;

  amc::stage_run<kShellLo, true, true>(
      pos, reach, table, neighbors, c0, len, n, num_cells, cap, index, cand,
      cand_reach);
  if (!work) return;

  // The cell's own particles: staged row warp + 1 of group 4 (dz = dy = 0).
  int own_n = index.count[4 * amc::kRunRows + warp + 1];
  int own_at = amc::group_base(4, cap, kShellLo) + index.start[4][warp + 1];
  int* list = lists + warp * cap * top_k;  // (own_n, top_k), ascending
  for (int e = lane; e < own_n * top_k; e += 32) list[e] = amc::kIntBig;
  __syncwarp();

  // Candidate q of the cell, 0 <= q < total, is slot q + shift[h] of the
  // planes for the group 4 + h with before[h] <= q < before[h + 1].  Group 4
  // begins at the cell's own row, so q < own_n is the own cell.
  int before[kShellGroups + 1];
  int shift[kShellGroups];
  before[0] = 0;
#pragma unroll
  for (int h = 0; h < kShellGroups; ++h) {
    int g = kShellLo + h;
    int lo = index.start[g][h == 0 ? warp + 1 : warp];
    shift[h] = amc::group_base(g, cap, kShellLo) + lo - before[h];
    before[h + 1] = before[h] + index.start[g][warp + 3] - lo;
  }
  int total = before[kShellGroups];
  for (int q0 = 0; q0 < total; q0 += 32) {
    int q = q0 + lane;
    bool active = q < total;
    int off = shift[0];
#pragma unroll
    for (int h = 1; h < kShellGroups; ++h) {
      if (q >= before[h]) off = shift[h];
    }
    float4 c = active ? cand[q + off] : make_float4(0.f, 0.f, 0.f, 0.f);
    float rj = active ? cand_reach[q + off] : 0.f;
    int j = __float_as_int(c.w);
    bool own_cell = q < own_n;
    for (int a = 0; a < own_n; ++a) {
      float4 o = cand[own_at + a];
      float dx = o.x - c.x;
      float dy = o.y - c.y;
      float dz = o.z - c.z;
      float d2 = dx * dx + dy * dy;
      d2 = d2 + dz * dz;
      float th = cand_reach[own_at + a] + rj;
      bool hit = active && d2 < th * th &&
                 (!own_cell || j > __float_as_int(o.w));
      unsigned hits = __ballot_sync(kFull, hit);
      while (hits != 0) {
        int jb = __shfl_sync(kFull, j, __ffs(hits) - 1);
        hits &= hits - 1;
        // Lane l < top_k owns entry l of the emitter's list; no lane reads
        // another's entry from memory, so no barrier is needed in between.
        int* mine = list + a * top_k + lane;
        int cur = lane < top_k ? *mine : amc::kIntBig;
        int left = __shfl_up_sync(kFull, cur, 1);
        if (lane == 0) left = -1;
        if (lane < top_k && !(cur < jb)) *mine = left < jb ? jb : left;
      }
    }
  }
  __syncwarp();
  for (int e = lane; e < own_n * top_k; e += 32) {
    int i = __float_as_int(cand[own_at + e / top_k].w);
    int v = list[e];
    cands[static_cast<long long>(i) * top_k + e % top_k] =
        v < amc::kIntBig ? v : -1;
  }
}

}  // namespace

// table is K2's (num_cells + 1, cap) table; active_rank is (num_cells + 1,)
// with -1 for inactive cells and the dummy cell; run_start holds
// num_runs + 1 cell ids, run r being [run_start[r], run_start[r + 1]), at
// most run_cells cells of one x-row (ops/collide.py cell_runs).  Outputs:
// pos0 (num_cells + 1, cap, 3), reach0 (num_cells + 1, cap), cands
// (n, top_k), unswept (n,).  Two launches.
AMC_EXPORT int amc_rebuild_sweep(
    const float* pos, const float* reach, const int* table, const int* pslot,
    const int* neighbors, const int* active_rank, const int* run_start, int n,
    int num_cells, int cap, int top_k, int num_runs, int run_cells,
    float* pos0, float* reach0, int* cands, uint8_t* unswept,
    cudaStream_t stream) {
  if (top_k < 1 || top_k > kMaxTopK || run_cells != amc::kRunCells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int slots = (num_cells + 1) * cap;
  pack_and_fill_kernel<<<amc::blocks_for(max(slots, n)), amc::kThreads, 0,
                         stream>>>(pos, reach, table, pslot, active_rank,
                                   slots, n, num_cells, cap, top_k, pos0,
                                   reach0, cands, unswept);
  if (n > 0 && num_runs > 0) {
    size_t bytes =
        amc::run_stage_bytes(cap, kShellLo) / sizeof(float4) *
            (sizeof(float4) + sizeof(float)) +
        sizeof(int) * amc::kRunCells * static_cast<size_t>(cap) * top_k;
    cudaError_t rc = cudaFuncSetAttribute(
        rebuild_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rebuild_walk_kernel<<<num_runs, amc::kWalkThreads, bytes, stream>>>(
        pos, reach, table, neighbors, run_start, active_rank, n,
        num_cells, cap, top_k, cands);
  }
  return static_cast<int>(cudaGetLastError());
}
