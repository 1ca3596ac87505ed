// K11 allpairs_partner: each particle's lowest-index partner j != i over
// all N particles with d^2 < r^2, or -1 -- the cube's broad phase.
//
// Replaces argon_monte_carlo_tpu/ops/collide.py allpairs_partner_search
// (:1001-1034): on the TPU an XLA scan over (N_pad, 2048) tiles of the
// masked minimum.
//
// The function is the reference's exactly; the work is a z-window's, as in
// the plain version (ops/collide.allpairs_partner_search_plain), which
// sorts by z and meets each block of rows with the j within reach of it.
// Here the particles are counted into z-slabs of width w = 1.001 sqrt(r2)
// and each particle meets the particles of its own slab and the two beside
// it, four launches:
//   1. key and count: a particle's slab is floor(z / w) mod S, from z
//      alone (S from N, at least 3); warp-aggregated integer atomics count
//      each slab and give the particle its arrival rank in it, kept in
//      `partner` until launch 4 overwrites it;
//   2. the slabs' offsets: the single-pass scan of counts of lookback.cuh
//      (K2's too), each count left zero;
//   3. scatter: a 16-byte row (x, y, z, index) a particle into a
//      slab-ordered copy, at its slab's offset plus its rank;
//   4. search: a block takes 128 consecutive rows of the copy (one slab, a
//      chunk of a crowded one, or a few small ones) and stages the rows of
//      its slabs and of the two beside them in shared memory, a tile at a
//      time; a thread tests its row against its own three slabs, keeps the
//      lowest index among its hits and stores it once.
// The order inside a slab does not matter: the answer is a minimum over
// indices, so it is order-free and deterministic.  With every particle in
// one slab the search is quadratic, as the reference is, and still exact.
//
// Why no hit is missed.  d^2 = (dx*dx + dy*dy) + dz*dz with dx = x_i - x_j,
// each operation rounded once (-fmad=false), as in the plain version.
//   - A hit has |z_i - z_j| < sqrt(r2) (1 + 2^-22): the terms are >= 0 and
//     rounding is monotone, so d^2 >= fl(dz*dz) >= dz^2 (1 - 2^-24), and
//     |dz| = |fl(z_i - z_j)| >= |z_i - z_j| (1 - 2^-24).
//   - The key is q = floor(fl64(z * c)), c = fl64(1 / w), in double.  For
//     |z| < 2^38 w the two roundings move z * c by under 2^-50 |z| / w <
//     2^-12 slabs, so a hit's two products differ by less than
//     (1 + 2^-22) / 1.001 + 2^-11 < 1 slab and their floors by at most 1.
//     A hit with |z| >= 2^38 w somewhere has both |z| > 2^37 w, where
//     float32 z are at least 2^13 w apart: z_i == z_j, one key.
//   - mod S keeps neighbouring keys neighbours (S >= 3: three distinct
//     slabs).  A wrapped slab only adds candidates, never loses one.
//   - A non-finite product (z infinite or NaN, r2 zero or negative or NaN)
//     goes to slab 0: such a z meets no j (dz is infinite or NaN), and such
//     an r2 admits no hit.  An infinite r2 makes c 0 and every finite z one
//     slab: the quadratic search, exact.
//
// Bound: the bytes, pos read and partner written (16 a particle); the pair
// tests the function needs are a cell grid's, about one a particle at the
// cube's density, 9 float32 operations each (3 sub, 3 mul, 2 add, 1
// compare).  The window's own work is more: its copy written and read (32
// bytes a particle) and sum_s n_s (n_{s-1} + n_s + n_{s+1}) pair tests, ~6e6
// a step at the cube's 24,627 particles against the brute force's N^2 =
// 6.1e8.  Each is a microsecond or less, so the four launches' latency
// bounds the kernel.
//
// Scratch (the wrapper keeps it for each device and stream, as K6's): the
// slab counts (S ints, zero between calls: the scan clears them), the
// offsets (S + 1 ints), the slab-ordered copy (N x 16 bytes) and the
// look-back words (zero between calls).  Nothing about a call comes from
// the host but the sizes and r2, so a launch replays in a CUDA graph.
#include <math.h>

#include "lookback.cuh"

namespace {

constexpr int kSearchRows = 128;              // rows (threads) a block
constexpr int kStage = 4 * kSearchRows;       // candidate rows staged a tile

// The slab of z: floor(z * inv_w) mod slabs, in double; a non-finite
// product goes to slab 0 (see the header).
__device__ __forceinline__ int slab_of(float z, double inv_w, int slabs) {
  double q = floor(static_cast<double>(z) * inv_w);
  if (!isfinite(q)) return 0;
  double m = fmod(q, static_cast<double>(slabs));
  if (m < 0.0) m += static_cast<double>(slabs);
  return static_cast<int>(m);
}

// 1. Each particle's slab counted; its arrival rank in the slab into rank.
__global__ void slab_count_kernel(const float* __restrict__ pos, int n,
                                  double inv_w, int slabs,
                                  int* __restrict__ counts,
                                  int* __restrict__ rank) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool active = i < n;
  unsigned live = __ballot_sync(0xffffffffu, active);
  if (!active) return;
  int s = slab_of(pos[3 * i + 2], inv_w, slabs);
  unsigned peers = __match_any_sync(live, s);
  int lane = threadIdx.x & 31;
  int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&counts[s], __popc(peers));
  base = __shfl_sync(peers, base, leader);
  rank[i] = base + __popc(peers & ((1u << lane) - 1u));
}

// 3. Each particle's row (x, y, z, index) at its slab's offset + its rank.
__global__ void slab_scatter_kernel(const float* __restrict__ pos, int n,
                                    double inv_w, int slabs,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ rank,
                                    int4* __restrict__ rows) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
  int s = slab_of(z, inv_w, slabs);
  rows[offsets[s] + rank[i]] = make_int4(
      __float_as_int(x), __float_as_int(y), __float_as_int(z), i);
}

// The lowest index among the hits of row (xi, yi, zi, me) in the staged
// rows [lo, hi) of the copy; the stage holds rows [base, base + kStage).
__device__ __forceinline__ int min_hit(const int4* stage, int base, int lo,
                                       int hi, float xi, float yi, float zi,
                                       int me, float r2, int best) {
  for (int p = lo; p < hi; ++p) {
    int4 c = stage[p - base];
    float dx = xi - __int_as_float(c.x);
    float dy = yi - __int_as_float(c.y);
    float dz = zi - __int_as_float(c.z);
    float d2 = dx * dx + dy * dy;
    d2 = d2 + dz * dz;
    if (d2 < r2 && c.w != me) best = min(best, c.w);
  }
  return best;
}

// 4. A block of kSearchRows rows of the copy: the union of its rows'
// windows staged tile by tile; each thread's lowest hit, stored once.
__launch_bounds__(kSearchRows) __global__ void slab_search_kernel(
    const int4* __restrict__ rows, int n, double inv_w, int slabs,
    const int* __restrict__ offsets, float r2, int* __restrict__ partner) {
  __shared__ int4 stage[kStage];
  int t = threadIdx.x;
  int first_row = blockIdx.x * kSearchRows;
  int last_row = min(first_row + kSearchRows, n) - 1;
  int row = min(first_row + t, last_row);
  int4 mine = rows[row];
  float xi = __int_as_float(mine.x), yi = __int_as_float(mine.y);
  float zi = __int_as_float(mine.z);
  int s = slab_of(zi, inv_w, slabs);
  // The thread's window: slabs s-1, s, s+1 as one range of the copy, and
  // the slab that wraps around at an end.
  int a_lo = offsets[max(s - 1, 0)], a_hi = offsets[min(s + 2, slabs)];
  int b_lo = 0, b_hi = 0;
  if (s == 0) {
    b_lo = offsets[slabs - 1];
    b_hi = n;
  } else if (s == slabs - 1) {
    b_hi = offsets[1];
  }
  // The block's: its rows' slabs are consecutive (the copy is in slab
  // order), so the windows' union is one range and the wrapped slabs.
  int s_first = slab_of(__int_as_float(rows[first_row].z), inv_w, slabs);
  int s_last = slab_of(__int_as_float(rows[last_row].z), inv_w, slabs);
  int ranges[3][2] = {
      {offsets[max(s_first - 1, 0)], offsets[min(s_last + 2, slabs)]},
      {s_first == 0 ? offsets[slabs - 1] : 0, s_first == 0 ? n : 0},
      {0, s_last == slabs - 1 ? offsets[1] : 0}};
  int best = amc::kNoPartner;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    for (int base = ranges[r][0]; base < ranges[r][1]; base += kStage) {
      int end = min(base + kStage, ranges[r][1]);
      __syncthreads();  // the previous tile is read
      for (int p = base + t; p < end; p += kSearchRows) {
        stage[p - base] = rows[p];
      }
      __syncthreads();
      best = min_hit(stage, base, max(a_lo, base), min(a_hi, end), xi, yi,
                     zi, mine.w, r2, best);
      best = min_hit(stage, base, max(b_lo, base), min(b_hi, end), xi, yi,
                     zi, mine.w, r2, best);
    }
  }
  if (first_row + t <= last_row) {
    partner[mine.w] = best < amc::kNoPartner ? best : -1;
  }
}

}  // namespace

// partner (n i32) is written in full.  Scratch: counts (slabs i32, zero
// between calls), offsets (slabs + 1 i32), rows (n x 4 i32), scan
// (scan_words u64, zero between calls).  With slabs < 3 or a scan shorter
// than 1 + ceil(slabs / 1024) words nothing is launched and the call fails.
AMC_EXPORT int amc_allpairs_partner(const float* pos, int n, float r2,
                                    int slabs, int* counts, int* offsets,
                                    int* rows, unsigned long long* scan,
                                    int scan_words, int* partner,
                                    cudaStream_t stream) {
  if (slabs < 3 || scan_words < amc::count_scan_words(slabs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  double inv_w = 1.0 / (sqrt(static_cast<double>(r2)) * 1.001);
  int blocks = amc::blocks_for(n);
  slab_count_kernel<<<blocks, amc::kThreads, 0, stream>>>(
      pos, n, inv_w, slabs, counts, partner);
  amc::count_scan(counts, slabs, offsets, scan, scan_words, stream);
  slab_scatter_kernel<<<blocks, amc::kThreads, 0, stream>>>(
      pos, n, inv_w, slabs, offsets, partner,
      reinterpret_cast<int4*>(rows));
  slab_search_kernel<<<amc::blocks_for(n, kSearchRows), kSearchRows, 0,
                       stream>>>(reinterpret_cast<const int4*>(rows), n,
                                 inv_w, slabs, offsets, r2, partner);
  return static_cast<int>(cudaGetLastError());
}
