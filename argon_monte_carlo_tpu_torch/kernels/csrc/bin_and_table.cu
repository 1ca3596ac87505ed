// K2 bin_and_table: cell id per particle, the (C+1, cap) cell table, the
// particle -> slot map and the overflow count.
//
// Replaces argon_monte_carlo_tpu/ops/collide.py assign_cells (:317) and
// build_cell_table (:355): on the TPU an XLA stable argsort of the cell ids
// plus an associative scan for the rank inside each cell.
//
// Bound: memory.  Each particle's position is read once and its cell id
// and slot written once; the table is written once ((C+1) * cap ints, the
// largest output: 23 MB at 1M particles and cap 32).
//
// Design: a counting sort in four launches, each touching memory in order
// where it can.
//   1. bin: one thread a particle computes its cell (amc::assign_cell) and
//      takes its arrival rank in the cell from the count's atomicAdd; the
//      rank waits in pslot (an output, overwritten by launch 4).
//   2. scan: a single-pass exclusive scan of the C counts (the decoupled
//      look-back of lookback.cuh; 1,024 counts a block, four a thread by one
//      16-byte load) into offsets[0, C], offsets[C] the total; it leaves
//      each count zero after reading it, so no memset comes before launch 1.
//   3. scatter: one thread a particle writes its index at its cell's offset
//      plus its arrival rank: each cell's segment holds its particles in
//      arbitrary order.
//   4. table: a warp takes 8 consecutive cells, their segments loaded at
//      once (lanes over a segment).  Each lane ranks its particle by index
//      among its cell's with warp shuffles (distinct indices, so the rank is
//      the place in the reference's stable argsort), writes the row of cap
//      words (a slot a lane, coalesced) and its pslot, and the warp adds its
//      cells' overflow with one atomic.  A segment longer than 32 takes a
//      slower path of any length: the cap-th smallest index is found by a
//      bitwise search of counts over the segment, the at most cap indices
//      below it are gathered in shared memory, ranked there, and written.
// Nothing is sorted in global memory.  Scratch (counts, zero between calls;
// offsets and seg) is kept by the wrapper for each device and stream, the
// look-back's is K6's; nothing that changes between calls comes from the
// host, so a launch sequence recorded in a CUDA graph replays correctly.
//
// valid (optional, the z-slab engine's padding lanes; collide.py:350-351,
// 374): a lane with valid[i] == 0 gets the dummy cell num_cells and the
// dummy slot, is counted nowhere and enters no segment.  A null pointer
// takes the same path as before the argument existed.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kScanItems = 4;  // counts a thread, one int4
constexpr int kScanTile = amc::kThreads * kScanItems;
constexpr int kCellsPerWarp = 8;
constexpr int kWarps = amc::kThreads / 32;
// The largest capacity the long-segment path gathers in shared memory (the
// wrapper refuses a larger one, as K9's does).
constexpr int kMaxCap = 128;
constexpr unsigned kFull = 0xffffffffu;

// collide.py:324-349 (amc::assign_cell, shared with K4).  *overflow is
// zeroed here, before launch 4 adds to it.
__global__ void assign_cells_kernel(const float* __restrict__ pos,
                                    const uint8_t* __restrict__ valid, int n,
                                    const int* __restrict__ nx,
                                    const int* __restrict__ layer_base,
                                    const float* __restrict__ half_extent,
                                    int nz, float z_lo, float cell_size,
                                    int num_cells, int cap,
                                    int* __restrict__ cell_id,
                                    int* __restrict__ pslot,
                                    int* __restrict__ counts,
                                    int* __restrict__ overflow) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *overflow = 0;
  if (i >= n) return;
  if (valid != nullptr && !valid[i]) {
    cell_id[i] = num_cells;
    pslot[i] = num_cells * cap;
    return;
  }
  int c = amc::assign_cell(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], nx,
                           layer_base, half_extent, nz, z_lo, cell_size);
  cell_id[i] = c;
  pslot[i] = atomicAdd(&counts[c], 1);  // the arrival rank, for launch 3
}

// offsets[c] = counts before cell c, offsets[m] = the total; counts[c] = 0
// after it is read.  kVector: counts and offsets are 16-byte aligned.
template <bool kVector>
__launch_bounds__(amc::kThreads) __global__ void scan_kernel(
    int* __restrict__ counts, int m, int ntiles,
    unsigned long long* __restrict__ scratch, int* __restrict__ offsets) {
  int tile = amc::take_tile(scratch);
  long long first = static_cast<long long>(tile) * kScanTile +
                    threadIdx.x * kScanItems;
  int c[kScanItems] = {0, 0, 0, 0};
  bool vector = kVector && first + kScanItems <= m;
  if (vector) {
    int4 v = *reinterpret_cast<const int4*>(counts + first);
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
    *reinterpret_cast<int4*>(counts + first) = make_int4(0, 0, 0, 0);
  } else {
    for (int k = 0; k < kScanItems; ++k) {
      if (first + k < m) {
        c[k] = counts[first + k];
        counts[first + k] = 0;
      }
    }
  }
  int own = c[0] + c[1] + c[2] + c[3];
  int tile_total;
  int rank = amc::block_exclusive_scan(own, &tile_total);
  bool last;
  int run = amc::tile_prefix(scratch, tile, tile_total, ntiles, &last) +
            rank;
  int o[kScanItems];
  for (int k = 0; k < kScanItems; ++k) {
    o[k] = run;
    run += c[k];
  }
  if (vector) {
    *reinterpret_cast<int4*>(offsets + first) =
        make_int4(o[0], o[1], o[2], o[3]);
  } else {
    for (int k = 0; k < kScanItems; ++k) {
      if (first + k < m) offsets[first + k] = o[k];
    }
  }
  // The thread that holds count m - 1 knows the total.
  if (first <= m - 1 && m - 1 < first + kScanItems) offsets[m] = run;
  if (m == 0 && tile == 0 && threadIdx.x == 0) offsets[0] = 0;
  if (last) amc::release_tiles(scratch, ntiles);
}

__global__ void scatter_kernel(const int* __restrict__ cell_id,
                               const int* __restrict__ arrival, int n,
                               int num_cells,
                               const int* __restrict__ offsets,
                               int* __restrict__ seg) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int c = cell_id[i];
  if (c < num_cells) seg[offsets[c] + arrival[i]] = i;
}

// A segment of at most 32: lane l < cnt holds v, the cell's l-th particle
// in segment order.  Its rank is the number of the cell's particles with a
// lower index.
__device__ __forceinline__ void short_cell(int v, int cnt, int c, int n,
                                           int cap, int dummy,
                                           int* __restrict__ table,
                                           int* __restrict__ pslot) {
  int lane = threadIdx.x & 31;
  int rank = 0;
  for (int j = 0; j < cnt; ++j) rank += __shfl_sync(kFull, v, j) < v;
  int* row = table + static_cast<long long>(c) * cap;
  if (lane < cnt) {
    bool kept = rank < cap;
    if (kept) row[rank] = v;
    pslot[v] = kept ? c * cap + rank : dummy;
  }
  for (int r = cnt + lane; r < cap; r += 32) row[r] = n;
}

// A segment of any length above 32 at s (global memory), by the whole
// warp; gathered holds kMaxCap ints of this warp's.  The kept particles
// are the min(cnt, cap) lowest indices: those below t, the largest t with
// at most cap indices below it, found bit by bit (indices are below n <
// 2^bits).
__device__ __noinline__ void long_cell(const int* __restrict__ s, int cnt,
                                       int c, int n, int cap, int dummy,
                                       int* __restrict__ table,
                                       int* __restrict__ pslot,
                                       int* gathered) {
  int lane = threadIdx.x & 31;
  int t = 0x7fffffff;
  if (cnt > cap) {
    t = 0;
    for (int b = 31 - __clz(n); b >= 0; --b) {
      int cand = t | (1 << b);
      int below = 0;
      for (int p = lane; p < cnt; p += 32) below += s[p] < cand;
      if (__reduce_add_sync(kFull, below) <= cap) t = cand;
    }
  }
  int m = min(cnt, cap);
  // The kept ones into shared memory in segment order; the others lose
  // their slot.
  int base = 0;
  for (int p0 = 0; p0 < cnt; p0 += 32) {
    int p = p0 + lane;
    int v = p < cnt ? s[p] : 0;
    bool kept = p < cnt && v < t;
    unsigned ballot = __ballot_sync(kFull, kept);
    if (kept) {
      gathered[base + __popc(ballot & ((1u << lane) - 1u))] = v;
    } else if (p < cnt) {
      pslot[v] = dummy;
    }
    base += __popc(ballot);
  }
  __syncwarp();
  int* row = table + static_cast<long long>(c) * cap;
  for (int q = lane; q < m; q += 32) {
    int v = gathered[q];
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += gathered[j] < v;
    row[rank] = v;
    pslot[v] = c * cap + rank;
  }
  for (int r = m + lane; r < cap; r += 32) row[r] = n;
  __syncwarp();  // gathered is free for the warp's next cell
}

// A warp takes cells c0 .. c0 + kCellsPerWarp - 1 (the dummy row num_cells
// is the last warp's): their offsets in one load, their segments (the
// first 32 entries of each) in kCellsPerWarp loads in flight together.
// Real rows hold their cell's first cap particles by index, then n; a
// particle ranked cap or later takes the dummy slot num_cells * cap and
// counts as overflow (collide.py:373-390).  The dummy row is all n.
__launch_bounds__(amc::kThreads) __global__ void table_kernel(
    const int* __restrict__ offsets, const int* __restrict__ seg, int n,
    int num_cells, int cap, int* __restrict__ table,
    int* __restrict__ pslot, int* __restrict__ overflow) {
  __shared__ int gathered[kWarps][kMaxCap];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  long long c0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) *
                 kCellsPerWarp;
  if (c0 > num_cells) return;
  int dummy = num_cells * cap;
  int o = lane <= kCellsPerWarp
              ? offsets[min(c0 + lane, static_cast<long long>(num_cells))]
              : 0;
  int start[kCellsPerWarp], cnt[kCellsPerWarp], v[kCellsPerWarp];
#pragma unroll
  for (int k = 0; k < kCellsPerWarp; ++k) {
    start[k] = __shfl_sync(kFull, o, k);
    cnt[k] = c0 + k < num_cells ? __shfl_sync(kFull, o, k + 1) - start[k]
                                : 0;
    v[k] = lane < cnt[k] ? seg[start[k] + lane] : 0x7fffffff;
  }
  int spill = 0;
#pragma unroll
  for (int k = 0; k < kCellsPerWarp; ++k) {
    int c = static_cast<int>(c0) + k;
    if (c < num_cells) {
      if (cnt[k] <= 32) {
        short_cell(v[k], cnt[k], c, n, cap, dummy, table, pslot);
      } else {
        long_cell(seg + start[k], cnt[k], c, n, cap, dummy, table, pslot,
                  gathered[warp]);
      }
      spill += max(cnt[k] - cap, 0);
    } else if (c == num_cells) {
      int* row = table + static_cast<long long>(c) * cap;
      for (int r = lane; r < cap; r += 32) row[r] = n;
    }
  }
  if (lane == 0 && spill > 0) atomicAdd(overflow, spill);
}

}  // namespace

// Scratch: counts (num_cells ints, zero, and left zero), offsets
// (num_cells + 1), seg (n), 16-byte aligned; the look-back scratch
// (lookback.cuh) of 1 + ceil(num_cells / 1024) words, zero, this stream's.
// cap <= 128.
AMC_EXPORT int amc_bin_and_table(
    const float* pos, const uint8_t* valid, int n, const int* nx,
    const int* layer_base, const float* half_extent, int nz, float z_lo,
    float cell_size, int num_cells, int cap, int* cell_id, int* table,
    int* pslot, int* overflow, int* counts, int* offsets, int* seg,
    unsigned long long* scratch, cudaStream_t stream) {
  if (cap < 1 || cap > kMaxCap) return static_cast<int>(cudaErrorInvalidValue);
  assign_cells_kernel<<<max(amc::blocks_for(n), 1), amc::kThreads, 0,
                        stream>>>(pos, valid, n, nx, layer_base, half_extent,
                                  nz, z_lo, cell_size, num_cells, cap,
                                  cell_id, pslot, counts, overflow);
  int ntiles = max(amc::blocks_for(num_cells, kScanTile), 1);
  uintptr_t aligned = reinterpret_cast<uintptr_t>(counts) |
                      reinterpret_cast<uintptr_t>(offsets);
  if ((aligned & 15u) == 0) {
    scan_kernel<true><<<ntiles, amc::kThreads, 0, stream>>>(
        counts, num_cells, ntiles, scratch, offsets);
  } else {
    scan_kernel<false><<<ntiles, amc::kThreads, 0, stream>>>(
        counts, num_cells, ntiles, scratch, offsets);
  }
  if (n > 0) {
    scatter_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        cell_id, pslot, n, num_cells, offsets, seg);
  }
  long long warps = (static_cast<long long>(num_cells) + kCellsPerWarp) /
                    kCellsPerWarp;
  table_kernel<<<amc::blocks_for(warps * 32), amc::kThreads, 0, stream>>>(
      offsets, seg, n, num_cells, cap, table, pslot, overflow);
  return static_cast<int>(cudaGetLastError());
}
