// K3 test_and_resolve: the pairs engine's per-step narrow phase on the
// listed entries -- test every entry, compact the colliding ones, match each
// particle with its lowest-index colliding partner, resolve the mutual
// pairs, stage completed paths, reset path accumulators, count.
//
// Replaces argon_monte_carlo_tpu/ops/pairs.py test_and_resolve (:282-430),
// with ops/measure.py record_completed (:38-75) and
// end_paths(zero_residual=False) (:200-221): on the TPU two M-row gathers
// of a packed (N+1, 6) source, a compaction, two scatter-mins and E-row
// gathers and scatters.
//
// Bound: memory.  The test reads each of the ~430k entries' a and b and the
// positions of the listed particles; everything after it touches only the
// few thousand colliding entries and the particles they resolve.  The
// state, the staging and the counters are updated in place: no pass over
// all particles and no whole-array copy.
//
// Design, three launches:
//   1. test and compact: one thread takes four consecutive entries,
//      colliding = a < n && b < n && d^2 < cr^2 with
//      d^2 = (dx*dx + dy*dy) + dz*dz, dx = pos_b - pos_a (the sentinel
//      entry a == b == n is never tested).  The ranks come from K6's
//      single-pass scan (lookback.cuh); an entry of rank < event_capacity
//      writes its endpoints into the event list and takes part in the
//      choice: integer atomicMin of each endpoint's partner into choice (the
//      reference's .at[].min scatters; an integer minimum is the same in any
//      order).  The block of the last tile knows the number of colliding
//      entries: it stores the number of events kept and adds the rest to
//      overflow_count.  The same launch zeroes the (N,) collided mask.
//   2. resolve: one thread an event.  A pair (lo, hi) is mutual when
//      choice[hi] == lo and choice[lo] == hi; duplicate and reversed
//      entries list it more than once, so the thread whose atomicCAS turns
//      choice[lo] from hi into INT_BIG claims it, and only that thread
//      reads and writes the two particles.  Every candidate would compute
//      the same values (each step of the formula is sign-symmetric, and the
//      library is built with -fmad=false), so the result does not depend on
//      which one wins.  A claimed pair that approaches and overlaps is
//      rewound, exchanges the impulse and replays (pairs.py:358-383, the
//      same operation order); then for both particles record_completed
//      with the pre-collision velocity it holds in registers and
//      end_paths along the new velocity, and the pair is counted (an
//      integer block count, one atomicAdd a block into n_collisions and
//      collision_count).
//   3. reset: choice back to INT_BIG at every event's endpoints, so the
//      scratch is INT_BIG between calls and no N-sized fill is needed.
// The z-slab engine's arguments (pairs.py:300-309, 340-346, 415-428),
// written simply: with ids (optional) the choice holds the partner's global
// id instead of its lane, and the claim above orders a pair by id (the ids
// of the lanes an entry names are distinct, so the argument is the same);
// with local_mask (optional) every lane's state is updated, as the owner of
// a ghost updates it, but only a local lane is staged, and a pair is counted
// when its lane of the lower id is local: once over the slabs.
// The scratches (look-back words, choice, event list) belong to one stream
// and are kept so by the kernels themselves; nothing about a call comes
// from the host, so the launches replay correctly in a CUDA graph.  No
// float atomics.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kEntries = 4;  // entries a thread of the test, one int4 load
constexpr int kTile = amc::kThreads * kEntries;

// The key the choice orders partners by: the global id, or the lane.
__device__ __forceinline__ int key_of(const int* __restrict__ ids, int i) {
  return ids != nullptr ? ids[i] : i;
}

__device__ __forceinline__ bool collides(const float* __restrict__ pos,
                                         int i, int j, int n, float cr2) {
  if (i >= n || j >= n) return false;
  float dx = pos[3 * j] - pos[3 * i];
  float dy = pos[3 * j + 1] - pos[3 * i + 1];
  float dz = pos[3 * j + 2] - pos[3 * i + 2];
  float d2 = dx * dx + dy * dy;
  d2 = d2 + dz * dz;
  return d2 < cr2;
}

// kVector: a and b are 16-byte aligned.
template <bool kVector>
__launch_bounds__(amc::kThreads) __global__ void test_compact_kernel(
    const float* __restrict__ pos, const int* __restrict__ a,
    const int* __restrict__ b, int m, int n, float cr2, int e_cap,
    int ntiles, unsigned long long* __restrict__ scan,
    int* __restrict__ ev_a, int* __restrict__ ev_b, int* __restrict__ events,
    int* choice, const int* __restrict__ ids, uint8_t* __restrict__ collided,
    int* __restrict__ n_collisions, int* __restrict__ overflow_count) {
  long long gid = static_cast<long long>(blockIdx.x) * blockDim.x +
                  threadIdx.x;
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(collided) & 15u) == 0) {
    head = n / 16;
    for (long long q = gid; q < head; q += stride) {
      reinterpret_cast<uint4*>(collided)[q] = make_uint4(0u, 0u, 0u, 0u);
    }
    head *= 16;
  }
  for (long long i = head + gid; i < n; i += stride) collided[i] = 0;

  int tile = amc::take_tile(scan);
  long long first = static_cast<long long>(tile) * kTile +
                    threadIdx.x * kEntries;
  int ia[kEntries], ib[kEntries];
  if (kVector && first + kEntries <= m) {
    int4 va = *reinterpret_cast<const int4*>(a + first);
    int4 vb = *reinterpret_cast<const int4*>(b + first);
    ia[0] = va.x, ia[1] = va.y, ia[2] = va.z, ia[3] = va.w;
    ib[0] = vb.x, ib[1] = vb.y, ib[2] = vb.z, ib[3] = vb.w;
  } else {
    for (int k = 0; k < kEntries; ++k) {
      bool in = first + k < m;
      ia[k] = in ? a[first + k] : n;
      ib[k] = in ? b[first + k] : n;
    }
  }
  unsigned bits = 0;  // bit k: entry first + k collides
#pragma unroll
  for (int k = 0; k < kEntries; ++k) {
    if (collides(pos, ia[k], ib[k], n, cr2)) bits |= 1u << k;
  }
  int tile_total;
  int rank = amc::block_exclusive_scan(__popc(bits), &tile_total);
  bool last;
  int prefix = amc::tile_prefix(scan, tile, tile_total, ntiles, &last);
  rank += prefix;
#pragma unroll
  for (int k = 0; k < kEntries; ++k) {
    if (!((bits >> k) & 1u)) continue;
    if (rank < e_cap) {
      ev_a[rank] = ia[k];
      ev_b[rank] = ib[k];
      atomicMin(&choice[ia[k]], key_of(ids, ib[k]));
      atomicMin(&choice[ib[k]], key_of(ids, ia[k]));
    }
    ++rank;
  }
  if (tile == ntiles - 1 && threadIdx.x == 0) {
    // Every ticket is taken and every earlier tile is counted in prefix.
    int total = prefix + tile_total;
    *events = min(total, e_cap);
    *overflow_count += max(total - e_cap, 0);
    *n_collisions = 0;
  }
  if (last) amc::release_tiles(scan, ntiles);
}

// record_completed with the pre-collision velocity v (a local lane only),
// then end_paths along the new velocity u (the reference's order of
// operations).
__device__ __forceinline__ void end_path(
    int i, float vx, float vy, float vz, float ux, float uy, float uz,
    float t, float* __restrict__ paths, uint8_t* __restrict__ has_collided,
    float* __restrict__ pend_vals, uint8_t* __restrict__ pend_mask,
    const uint8_t* __restrict__ local, uint8_t* __restrict__ collided) {
  float* pth = paths + 4 * i;
  float p0 = pth[0], p1 = pth[1], p2 = pth[2], p3 = pth[3];
  if (has_collided[i] && (local == nullptr || local[i])) {
    float s2 = vx * vx + vy * vy;
    s2 = s2 + vz * vz;
    float* out = pend_vals + 4 * i;
    out[0] = fabsf(p0 - sqrtf(s2) * t);
    out[1] = fabsf(p1 - fabsf(vx) * t);
    out[2] = fabsf(p2 - fabsf(vy) * t);
    out[3] = fabsf(p3 - fabsf(vz) * t);
    pend_mask[i] = 1;
  }
  float u2 = ux * ux + uy * uy;
  u2 = u2 + uz * uz;
  pth[0] = fabsf(sqrtf(u2) * t);
  pth[1] = fabsf(fabsf(ux) * t);
  pth[2] = fabsf(fabsf(uy) * t);
  pth[3] = fabsf(fabsf(uz) * t);
  has_collided[i] = 1;
  collided[i] = 1;
}

// Rewind, exchange and replay the pair (i, j) in place when it approaches
// and overlaps; returns whether it did.
__device__ __forceinline__ bool resolve_pair(
    int i, int j, float cr, float cr2, float* __restrict__ pos,
    float* __restrict__ vel, float* __restrict__ paths,
    uint8_t* __restrict__ has_collided, float* __restrict__ pend_vals,
    uint8_t* __restrict__ pend_mask, const uint8_t* __restrict__ local,
    uint8_t* __restrict__ collided) {
  float ax = pos[3 * i], ay = pos[3 * i + 1], az = pos[3 * i + 2];
  float avx = vel[3 * i], avy = vel[3 * i + 1], avz = vel[3 * i + 2];
  float bx = pos[3 * j], by = pos[3 * j + 1], bz = pos[3 * j + 2];
  float bvx = vel[3 * j], bvy = vel[3 * j + 1], bvz = vel[3 * j + 2];
  float dxx = bx - ax, dxy = by - ay, dxz = bz - az;
  float dvx = avx - bvx, dvy = avy - bvy, dvz = avz - bvz;
  float aa = dvx * dvx + dvy * dvy;
  aa = aa + dvz * dvz;
  float bs = dxx * dvx + dxy * dvy;
  bs = bs + dxz * dvz;
  float bb = 2.0f * bs;
  float cs = dxx * dxx + dxy * dxy;
  cs = cs + dxz * dxz;
  float cc = cs - cr2;
  float disc = bb * bb - (4.0f * aa) * cc;
  if (!((aa > 0.0f) && (disc >= 0.0f) && (cc < 0.0f))) return false;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float den = 2.0f * aa;
  float t = fmaxf((-bb + sq) / den, (-bb - sq) / den);

  float qax = ax - avx * t, qay = ay - avy * t, qaz = az - avz * t;
  float qbx = bx - bvx * t, qby = by - bvy * t, qbz = bz - bvz * t;
  float nx = (qbx - qax) / cr, ny = (qby - qay) / cr, nz = (qbz - qaz) / cr;
  float ps = dvx * nx + dvy * ny;
  ps = ps + dvz * nz;
  float nax = avx - ps * nx, nay = avy - ps * ny, naz = avz - ps * nz;
  float nbx = bvx + ps * nx, nby = bvy + ps * ny, nbz = bvz + ps * nz;

  pos[3 * i] = qax + nax * t;
  pos[3 * i + 1] = qay + nay * t;
  pos[3 * i + 2] = qaz + naz * t;
  vel[3 * i] = nax;
  vel[3 * i + 1] = nay;
  vel[3 * i + 2] = naz;
  pos[3 * j] = qbx + nbx * t;
  pos[3 * j + 1] = qby + nby * t;
  pos[3 * j + 2] = qbz + nbz * t;
  vel[3 * j] = nbx;
  vel[3 * j + 1] = nby;
  vel[3 * j + 2] = nbz;
  end_path(i, avx, avy, avz, nax, nay, naz, t, paths, has_collided,
           pend_vals, pend_mask, local, collided);
  end_path(j, bvx, bvy, bvz, nbx, nby, nbz, t, paths, has_collided,
           pend_vals, pend_mask, local, collided);
  return true;
}

__global__ void resolve_kernel(
    const int* __restrict__ ev_a, const int* __restrict__ ev_b,
    const int* __restrict__ events, int* choice, const int* __restrict__ ids,
    const uint8_t* __restrict__ local, float cr, float cr2,
    float* __restrict__ pos, float* __restrict__ vel,
    float* __restrict__ paths, uint8_t* __restrict__ has_collided,
    float* __restrict__ pend_vals, uint8_t* __restrict__ pend_mask,
    uint8_t* __restrict__ collided, int* __restrict__ n_collisions,
    int* __restrict__ collision_count) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  bool counted = false;
  if (k < *events) {
    int i = ev_a[k];
    int j = ev_b[k];
    int ki = key_of(ids, i);
    int kj = key_of(ids, j);
    int lo = ki < kj ? i : j;  // the lane of the lower key
    int hi = ki < kj ? j : i;
    int klo = min(ki, kj);
    int khi = max(ki, kj);
    // choice[hi] == klo is never rewritten in this launch (only a pair's
    // lane of the lower key is claimed, and hi's own pair would be
    // (lo, hi)), so the claim on choice[lo] alone decides which candidate
    // resolves the pair.
    if (choice[hi] == klo &&
        atomicCAS(&choice[lo], khi, amc::kIntBig) == khi &&
        resolve_pair(i, j, cr, cr2, pos, vel, paths, has_collided, pend_vals,
                     pend_mask, local, collided)) {
      counted = local == nullptr || local[lo];
    }
  }
  int count = __syncthreads_count(counted);
  if (threadIdx.x == 0 && count > 0) {
    atomicAdd(n_collisions, count);
    atomicAdd(collision_count, count);
  }
}

__global__ void reset_choice_kernel(const int* __restrict__ ev_a,
                                    const int* __restrict__ ev_b,
                                    const int* __restrict__ events,
                                    int* __restrict__ choice) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < *events) {
    choice[ev_a[k]] = amc::kIntBig;
    choice[ev_b[k]] = amc::kIntBig;
  }
}

}  // namespace

// In place: pos, vel, paths, has_collided, pend_vals, pend_mask,
// collision_count (+= resolved pairs) and overflow_count (+= colliding
// entries beyond e_cap).  Outputs: collided (n,) and n_collisions (the
// resolved pairs).  ids and local_mask may be null (the single-card
// engine).  Scratch of this stream, kept by the kernels: scan
// (1 + ceil(m / 1024) words, zero between calls), choice (n ints, INT_BIG
// between calls), events (1 + 2 * e_cap ints: the number kept, then the
// kept entries' a and b).
AMC_EXPORT int amc_test_and_resolve(
    float* pos, float* vel, float* paths, uint8_t* has_collided,
    float* pend_vals, uint8_t* pend_mask, int* collision_count,
    int* overflow_count, const int* a, const int* b, int n, int m, int e_cap,
    float cr, float cr2, uint8_t* collided, int* n_collisions,
    unsigned long long* scan, int* choice, int* events, const int* ids,
    const uint8_t* local_mask, cudaStream_t stream) {
  int ntiles = max(amc::blocks_for(m, kTile), 1);
  int* ev_a = events + 1;
  int* ev_b = ev_a + e_cap;
  if (((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
       15u) == 0) {
    test_compact_kernel<true><<<ntiles, amc::kThreads, 0, stream>>>(
        pos, a, b, m, n, cr2, e_cap, ntiles, scan, ev_a, ev_b, events, choice,
        ids, collided, n_collisions, overflow_count);
  } else {
    test_compact_kernel<false><<<ntiles, amc::kThreads, 0, stream>>>(
        pos, a, b, m, n, cr2, e_cap, ntiles, scan, ev_a, ev_b, events, choice,
        ids, collided, n_collisions, overflow_count);
  }
  if (e_cap > 0) {
    int blocks = amc::blocks_for(e_cap);
    resolve_kernel<<<blocks, amc::kThreads, 0, stream>>>(
        ev_a, ev_b, events, choice, ids, local_mask, cr, cr2, pos, vel, paths,
        has_collided, pend_vals, pend_mask, collided, n_collisions,
        collision_count);
    reset_choice_kernel<<<blocks, amc::kThreads, 0, stream>>>(ev_a, ev_b,
                                                             events, choice);
  }
  return static_cast<int>(cudaGetLastError());
}
