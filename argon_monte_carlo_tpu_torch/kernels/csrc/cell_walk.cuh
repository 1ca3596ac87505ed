// The cell-ordered walk: a block owns a run of consecutive cells of one
// x-row of the grid and stages the particles of the run's whole
// neighbourhood in shared memory, once, before any pair is tested.
//
// Cell ids run x-fastest inside a layer (ops/collide.py _build_neighbors:
// base + iy * n + ix), and neighbour column o of a cell is
// (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1).  So for each of the nine (dz, dy)
// groups g the three dx neighbours of a cell are columns 3g, 3g + 1, 3g + 2,
// and along a run of len cells of one x-row they overlap: column 3g + 1 of
// cell k is column 3g of cell k + 1 and column 3g + 2 of cell k - 1 (the
// neighbour id depends on (jz, jy, jx) alone).  A run therefore needs
// len + 2 table rows a group,
//
//   staged row r of group g = neighbors[c0, 3g]               for r = 0,
//                             neighbors[c0 + r - 1, 3g + 1]   for 1 <= r <= len,
//                             neighbors[c0 + len - 1, 3g + 2] for r = len + 1,
//
// and cell k of the run reads staged rows k, k + 1, k + 2 of every group.
// The ids come from `neighbors` itself, so layer edges, a change of nx
// between layers and the dummy row num_cells come out as the table says
// (ops/collide.py run_rows is the same arithmetic on the host, held against
// Grid.neighbors for every cell by tests/test_torch_collide.py).
//
// The table row of a cell lists its particles ascending and sentinel-padded
// (K2's contract, bin_and_table.cu), the dummy row holds sentinels only.
// Each staged row's occupied entries are packed behind one another inside
// their group, as (x, y, z, index bits), so that the candidates of cell k in
// group g are one contiguous range of shared memory,
// [start[g][k], start[g][k + 3]), and its own particles are the range of
// row k + 1 of group 4.  A position is fetched from global memory
// 9 (len + 2) / len times a call instead of once for every pair test.
//
// K9 (partner_sweep.cu) walks all nine groups.  K1 (rebuild_sweep.cu), the
// pairs rebuild's sweep, reads the half shell, columns 13-26: that is rows
// k + 1 and k + 2 of group 4 (columns 13 and 14; column 12, row k, is outside
// the shell) and rows k, k + 1, k + 2 of groups 5 to 8.  It stages from
// kGroupLo = 4 with kHalfShell set, which leaves out the one staged row that
// only column 12 would read (row 0 of group 4), and keeps each candidate's
// reach in a second plane beside its position (kReach).
#pragma once

#include "common.cuh"

namespace amc {

// Cells a run, one warp each.  On the H100 at the 1M pore K9 read 0.49,
// 0.51 and 0.57 ms at 4, 8 and 16 (scripts/probe_partner_sweep.py builds
// with -DAMC_RUN_CELLS=...): flat, so 8, which stages the least for its
// occupancy.  ops/collide.py RUN_CELLS must say the same.
#ifndef AMC_RUN_CELLS
#define AMC_RUN_CELLS 8
#endif
constexpr int kRunCells = AMC_RUN_CELLS;
constexpr int kRunRows = kRunCells + 2;   // staged rows a group
constexpr int kGroups = 9;                // (dz, dy) pairs
constexpr int kStagedRows = kGroups * kRunRows;
constexpr int kWalkThreads = 32 * kRunCells;

// The small per-run arrays (static shared memory of the calling kernel).
struct RunIndex {
  int row[kStagedRows];                    // table row of each staged row
  int count[kStagedRows];                  // its occupied entries
  int start[kGroups][kRunRows + 1];        // prefix of count inside a group
};

// Bytes of the candidate plane for a table of capacity cap, groups
// group_lo..8 staged.
inline size_t run_stage_bytes(int cap, int group_lo = 0) {
  return sizeof(float4) * (kGroups - group_lo) * kRunRows *
         static_cast<size_t>(cap);
}

// First candidate slot of group g in a candidate plane that begins with
// group group_lo.
__device__ __forceinline__ int group_base(int g, int cap, int group_lo = 0) {
  return (g - group_lo) * kRunRows * cap;
}

// Table row of staged row t = g * kRunRows + r (see the head of this file);
// the empty dummy row num_cells beyond a short run and, for the half shell,
// for row 0 of group 4.
template <bool kHalfShell>
__device__ __forceinline__ int staged_row(const int* __restrict__ neighbors,
                                          int c0, int len, int num_cells,
                                          int t) {
  int g = t / kRunRows;
  int r = t % kRunRows;
  if (r >= len + 2 || (kHalfShell && g == 4 && r == 0)) return num_cells;
  int k = min(max(r - 1, 0), len - 1);
  return neighbors[static_cast<long long>(c0 + k) * 27 + 3 * g + (r - k)];
}

// Stage the neighbourhood of the run [c0, c0 + len), 1 <= len <= kRunCells,
// groups kGroupLo..8.  Every thread of a block of kWalkThreads threads must
// call it; it ends with a __syncthreads().  cand holds
// run_stage_bytes(cap, kGroupLo); with kReach, cand_reach holds a float for
// each of its slots and receives reach[j] beside candidate j.
//
// Three rounds of global loads, each started for all of a warp's rows before
// any is waited for: the row ids, the rows' table entries (a lane a slot),
// the listed particles' positions.  Row by row, every staged row would wait
// out three memory latencies on its own, 12 rows a warp one after another:
// K9 at 1M particles on an H100 read 0.76 ms that way and 0.51 ms this way.
// A capacity above 32 takes the plain loop over chunks of 32 slots instead.
template <int kGroupLo, bool kHalfShell, bool kReach>
__device__ __forceinline__ void stage_run(
    const float* __restrict__ pos, const float* __restrict__ reach,
    const int* __restrict__ table, const int* __restrict__ neighbors, int c0,
    int len, int n, int num_cells, int cap, RunIndex& index,
    float4* __restrict__ cand, float* __restrict__ cand_reach) {
  const unsigned kFull = 0xffffffffu;
  // Staged rows kFirst..kStagedRows - 1; warp w takes kFirst + w,
  // kFirst + w + kRunCells, ...
  constexpr int kFirst = kGroupLo * kRunRows;
  constexpr int kRowsAWarp =
      (kStagedRows - kFirst + kRunCells - 1) / kRunCells;
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  unsigned below = (1u << lane) - 1u;
  if (threadIdx.x < kStagedRows) {
    index.row[threadIdx.x] =
        threadIdx.x < kFirst
            ? num_cells
            : staged_row<kHalfShell>(neighbors, c0, len, num_cells,
                                     threadIdx.x);
  }
  __syncthreads();
  int j[kRowsAWarp];  // cap <= 32: the entry of slot `lane` of each row
  float x[kRowsAWarp], y[kRowsAWarp], z[kRowsAWarp], rr[kRowsAWarp];
  if (cap <= 32) {
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) {
      int t = kFirst + warp + u * kRunCells;
      j[u] = n;
      if (t < kStagedRows && lane < cap && index.row[t] != num_cells) {
        long long slot = static_cast<long long>(index.row[t]) * cap + lane;
        j[u] = table[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) {
      int t = kFirst + warp + u * kRunCells;
      unsigned listed = __ballot_sync(kFull, j[u] < n);
      if (t < kStagedRows && lane == 0) index.count[t] = __popc(listed);
    }
  } else {
    for (int t = kFirst + warp; t < kStagedRows; t += kRunCells) {
      int count = 0;
      if (index.row[t] != num_cells) {
        const int* row = table + static_cast<long long>(index.row[t]) * cap;
        for (int s0 = 0; s0 < cap; s0 += 32) {
          int s = s0 + lane;
          count += __popc(__ballot_sync(kFull, s < cap && row[s] < n));
        }
      }
      if (lane == 0) index.count[t] = count;
    }
  }
  __syncthreads();
  if (threadIdx.x < kGroups) {
    int g = threadIdx.x;
    int run = 0;
    for (int r = 0; r < kRunRows; ++r) {
      index.start[g][r] = run;
      run += g < kGroupLo ? 0 : index.count[g * kRunRows + r];
    }
    index.start[g][kRunRows] = run;
  }
  __syncthreads();
  // Each listed particle's position, fetched once, packed behind the rows
  // before it in its group.
  if (cap <= 32) {
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) {
      if (j[u] < n) {
        x[u] = pos[3 * j[u]];
        y[u] = pos[3 * j[u] + 1];
        z[u] = pos[3 * j[u] + 2];
        if (kReach) rr[u] = reach[j[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) {
      int t = min(kFirst + warp + u * kRunCells, kStagedRows - 1);
      unsigned listed = __ballot_sync(kFull, j[u] < n);
      if (j[u] < n) {
        int p = group_base(t / kRunRows, cap, kGroupLo) +
                index.start[t / kRunRows][t % kRunRows] +
                __popc(listed & below);
        cand[p] = make_float4(x[u], y[u], z[u], __int_as_float(j[u]));
        if (kReach) cand_reach[p] = rr[u];
      }
    }
  } else {
    for (int t = kFirst + warp; t < kStagedRows; t += kRunCells) {
      if (index.count[t] == 0) continue;
      long long first = static_cast<long long>(index.row[t]) * cap;
      int slot = group_base(t / kRunRows, cap, kGroupLo) +
                 index.start[t / kRunRows][t % kRunRows];
      for (int s0 = 0; s0 < cap; s0 += 32) {
        int s = s0 + lane;
        int jj = s < cap ? table[first + s] : n;
        unsigned listed = __ballot_sync(kFull, jj < n);
        if (jj < n) {
          int p = slot + __popc(listed & below);
          cand[p] = make_float4(pos[3 * jj], pos[3 * jj + 1],
                                pos[3 * jj + 2], __int_as_float(jj));
          if (kReach) cand_reach[p] = reach[jj];
        }
        slot += __popc(listed);
      }
    }
  }
  __syncthreads();
}

}  // namespace amc
