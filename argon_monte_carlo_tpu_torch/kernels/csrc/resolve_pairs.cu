// K10 resolve_pairs: mutually matched elastic hard-sphere impulse exchange,
// completed-path staging and path reset, and the pair count, in place.
//
// Replaces argon_monte_carlo_tpu/ops/collide.py resolve_collisions
// (:1042-1142) with ops/measure.py record_completed (:38-75) and
// end_paths(zero_residual=False) (:200-221): XLA elementwise code with a
// packed-row partner gather on the TPU.
//
// Bound: memory, of the partner array.  Every lane reads its partner
// (4 bytes), a lane with a partner its partner's partner; only a mutual
// pair reads its two rows, and only a matched pair writes them (a few
// hundred bytes a pair, ~0.1% of the lanes a step at 1M).
//
// Design: in place on the step's own tensors, a thread takes 1, 2, 4 or 8
// lanes, the fewest that run the grid in one wave of blocks (8 at the 1M
// pore, two 16-byte loads of the partner array; 1 at the cube's 24,627,
// where more lanes a thread would serialise the pairs' chains of loads on
// a few SMs).  A lane i whose partner p is none (p < 0), itself, or not
// mutual (partner[p] != i) touches nothing.  Of a mutual pair only the
// thread of the lower lane goes on: it loads both rows into registers
// before any store (paths and has_collided with pos and vel, one round
// trip), tests the match once (a, c and disc are equal from either side
// bit for bit: the differences only flip sign), and computes each side in
// that side's own operation order (dxv = x_other - x_self, dvv = v_self -
// v_other, the normal, record_completed, end_paths), so both lanes round
// exactly as the plain version does.  The decisions read only the partner
// array, which nothing writes, and a lane belongs to at most one mutual
// pair, so no thread reads a row another thread writes.  Staging is
// written only where a path is emitted: the mask is set there and left as
// it was elsewhere.
//
// The count is added into a counter the caller holds (an integer block
// sum, one atomicAdd a block): no memset, no allocation, and nothing
// about a call passed from the host, so a captured launch replays.
//
// local (optional, the z-slab engine; collide.py:1067-1071, 1122-1142): a
// lane that holds a neighbour's ghost is 0 there.  It takes part in the
// match, but position, velocity, staging and path resets apply to a lane
// of a matched pair only where it is local; the count is then the number
// of lanes applied to, and the matched mask goes to ok_out, which every
// lane gets (the lower thread writes both lanes of a mutual pair).  Null
// pointers take the path without the arguments; a null count counts
// nothing.
#include "common.cuh"

namespace {

// One side of a matched pair, computed from that side ("self") in the plain
// version's operation order.
struct Side {
  float pos[3], vel[3], paths[4], staged[4];
  bool emit;
};

__device__ __forceinline__ Side resolve_side(const float* xs, const float* vs,
                                             const float* ps,
                                             bool has_collided,
                                             const float* xo, const float* vo,
                                             float t, float cr) {
  Side s;
  // dvv = v_self - v_other.
  float dvx = vs[0] - vo[0], dvy = vs[1] - vo[1], dvz = vs[2] - vo[2];
  // Rewind, exchange along the contact normal, replay.
  float qax = xs[0] - vs[0] * t, qay = xs[1] - vs[1] * t,
        qaz = xs[2] - vs[2] * t;
  float qbx = xo[0] - vo[0] * t, qby = xo[1] - vo[1] * t,
        qbz = xo[2] - vo[2] * t;
  float nx = (qbx - qax) / cr, ny = (qby - qay) / cr, nz = (qbz - qaz) / cr;
  float pr = dvx * nx + dvy * ny;
  pr = pr + dvz * nz;
  float nvx = vs[0] - pr * nx, nvy = vs[1] - pr * ny, nvz = vs[2] - pr * nz;

  // record_completed with the pre-collision velocity.
  float s2 = vs[0] * vs[0] + vs[1] * vs[1];
  s2 = s2 + vs[2] * vs[2];
  float speed = sqrtf(s2);
  s.emit = has_collided;
  s.staged[0] = fabsf(ps[0] - speed * t);
  s.staged[1] = fabsf(ps[1] - fabsf(vs[0]) * t);
  s.staged[2] = fabsf(ps[2] - fabsf(vs[1]) * t);
  s.staged[3] = fabsf(ps[3] - fabsf(vs[2]) * t);

  // end_paths(zero_residual=False): residual |v'_k| t along the new
  // direction.
  float n2 = nvx * nvx + nvy * nvy;
  n2 = n2 + nvz * nvz;
  s.paths[0] = fabsf(sqrtf(n2) * t);
  s.paths[1] = fabsf(fabsf(nvx) * t);
  s.paths[2] = fabsf(fabsf(nvy) * t);
  s.paths[3] = fabsf(fabsf(nvz) * t);

  s.pos[0] = qax + nvx * t;
  s.pos[1] = qay + nvy * t;
  s.pos[2] = qaz + nvz * t;
  s.vel[0] = nvx;
  s.vel[1] = nvy;
  s.vel[2] = nvz;
  return s;
}

__device__ __forceinline__ void store_side(
    const Side& s, int i, float* __restrict__ pos, float* __restrict__ vel,
    float* __restrict__ paths, uint8_t* __restrict__ has_collided,
    float* __restrict__ pend_vals, uint8_t* __restrict__ pend_mask) {
  for (int k = 0; k < 3; ++k) {
    pos[3 * i + k] = s.pos[k];
    vel[3 * i + k] = s.vel[k];
  }
  for (int k = 0; k < 4; ++k) paths[4 * i + k] = s.paths[k];
  has_collided[i] = 1;
  if (s.emit) {
    for (int k = 0; k < 4; ++k) pend_vals[4 * i + k] = s.staged[k];
    pend_mask[i] = 1;
  }
}

// Blocks an SM at 64 registers a thread (the kernel's launch bounds).
constexpr int kBlocksPerSm = 4;

// The mutual pair (i, j), i < j: both rows loaded before any store, the
// match tested once, each side computed and stored.  Returns the lanes
// applied to that count (the pair once without local, each local lane
// with it).
__device__ __forceinline__ int resolve_pair(
    int i, int j, float* __restrict__ pos, float* __restrict__ vel,
    float* __restrict__ paths, uint8_t* __restrict__ has_collided,
    float* __restrict__ pend_vals, uint8_t* __restrict__ pend_mask,
    const uint8_t* __restrict__ local, float cr, float cr2,
    uint8_t* __restrict__ ok_out) {
  float xi[3], vi[3], xj[3], vj[3], pi[4], pj[4];
  for (int k = 0; k < 3; ++k) {
    xi[k] = pos[3 * i + k];
    vi[k] = vel[3 * i + k];
    xj[k] = pos[3 * j + k];
    vj[k] = vel[3 * j + k];
  }
  // Loaded with the rows, not after the test: one round trip fewer.
  for (int k = 0; k < 4; ++k) {
    pi[k] = paths[4 * i + k];
    pj[k] = paths[4 * j + k];
  }
  bool hi_ = has_collided[i] != 0, hj = has_collided[j] != 0;
  bool li = local == nullptr || local[i];
  bool lj = local == nullptr || local[j];
  // The match test from the lower lane's side: dxv = x2 - x1,
  // dvv = v1 - v2.
  float dxx = xj[0] - xi[0], dxy = xj[1] - xi[1], dxz = xj[2] - xi[2];
  float dvx = vi[0] - vj[0], dvy = vi[1] - vj[1], dvz = vi[2] - vj[2];
  float a = dvx * dvx + dvy * dvy;
  a = a + dvz * dvz;
  float bs = dxx * dvx + dxy * dvy;
  bs = bs + dxz * dvz;
  float b = 2.0f * bs;
  float cs = dxx * dxx + dxy * dxy;
  cs = cs + dxz * dxz;
  float c = cs - cr2;
  float disc = b * b - (4.0f * a) * c;
  bool matched = (a > 0.0f) && (disc >= 0.0f) && (c < 0.0f);
  if (ok_out != nullptr) {
    ok_out[i] = matched;
    ok_out[j] = matched;
  }
  if (!matched) return 0;
  float sq = sqrtf(disc);
  float den = 2.0f * a;
  float t = fmaxf((-b + sq) / den, (-b - sq) / den);
  // Each side reads the rows from registers, so side i may be stored
  // before side j is computed.
  if (li) {
    store_side(resolve_side(xi, vi, pi, hi_, xj, vj, t, cr), i, pos, vel,
               paths, has_collided, pend_vals, pend_mask);
  }
  if (lj) {
    store_side(resolve_side(xj, vj, pj, hj, xi, vi, t, cr), j, pos, vel,
               paths, has_collided, pend_vals, pend_mask);
  }
  return local == nullptr ? 1 : li + lj;
}

// kLanes lanes a thread; kVector: partner is 16-byte aligned, read 16 bytes
// at a time when kLanes is a multiple of 4.
template <bool kVector, int kLanes>
__launch_bounds__(amc::kThreads, kBlocksPerSm) __global__ void
resolve_pairs_kernel(
    float* __restrict__ pos, float* __restrict__ vel,
    float* __restrict__ paths, uint8_t* __restrict__ has_collided,
    const int* __restrict__ partner, float* __restrict__ pend_vals,
    uint8_t* __restrict__ pend_mask, const uint8_t* __restrict__ local,
    int n, float cr, float cr2, uint8_t* __restrict__ ok_out,
    int* __restrict__ count) {
  long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kLanes;
  int p[kLanes];
  if (kVector && kLanes % 4 == 0 && first + kLanes <= n) {
    const int4* p4 = reinterpret_cast<const int4*>(partner + first);
#pragma unroll
    for (int q = 0; q < kLanes / 4; ++q) {
      int4 u = p4[q];
      p[4 * q] = u.x;
      p[4 * q + 1] = u.y;
      p[4 * q + 2] = u.z;
      p[4 * q + 3] = u.w;
    }
  } else {
    for (int k = 0; k < kLanes; ++k) {
      p[k] = first + k < n ? partner[first + k] : -1;
    }
  }
  int applied = 0;
  for (int k = 0; k < kLanes; ++k) {
    int i = static_cast<int>(first) + k;
    int j = p[k];
    if (i >= n) break;
    if (j < 0 || j == i) {
      // No pair: nothing to write but ok.
      if (ok_out != nullptr) ok_out[i] = 0;
    } else if (j < i) {
      // The higher lane: the lower one's thread writes a mutual pair,
      // this one only ok of a lane that is not mutual.
      if (ok_out != nullptr && partner[j] != i) ok_out[i] = 0;
    } else if (partner[j] != i) {
      if (ok_out != nullptr) ok_out[i] = 0;
    } else {
      applied += resolve_pair(i, j, pos, vel, paths, has_collided, pend_vals,
                              pend_mask, local, cr, cr2, ok_out);
    }
  }
  int block;
  amc::block_exclusive_scan(applied, &block);
  if (count != nullptr && threadIdx.x == 0 && block > 0) {
    atomicAdd(count, block);
  }
}

template <int kLanes>
void launch_lanes(bool vector, float* pos, float* vel, float* paths,
                  uint8_t* has_collided, const int* partner, float* pend_vals,
                  uint8_t* pend_mask, const uint8_t* local, int n, float cr,
                  float cr2, uint8_t* ok_out, int* count,
                  cudaStream_t stream) {
  auto kernel = vector ? resolve_pairs_kernel<true, kLanes>
                       : resolve_pairs_kernel<false, kLanes>;
  kernel<<<amc::blocks_for(n, amc::kThreads * kLanes), amc::kThreads, 0,
           stream>>>(pos, vel, paths, has_collided, partner, pend_vals,
                     pend_mask, local, n, cr, cr2, ok_out, count);
}

}  // namespace

// In place on pos, vel, paths, has_collided, pend_vals and pend_mask;
// count (nullable) grows by the pairs resolved, or with local by the lanes
// applied to; ok_out (nullable, with local) gets the matched mask.
AMC_EXPORT int amc_resolve_pairs(float* pos, float* vel, float* paths,
                                 uint8_t* has_collided, const int* partner,
                                 float* pend_vals, uint8_t* pend_mask,
                                 const uint8_t* local, int n, float cr,
                                 float cr2, uint8_t* ok_out, int* count,
                                 cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  // The fewest lanes a thread (1, 2, 4 or 8) that run the grid in one wave
  // of blocks: a lane with a pair is a chain of dependent loads, which
  // several lanes a thread serialise, and a second wave waits for them.
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long wave = static_cast<long long>(sms) * kBlocksPerSm * amc::kThreads;
  bool vector = (reinterpret_cast<uintptr_t>(partner) & 15u) == 0;
  if (n <= wave) {
    launch_lanes<1>(vector, pos, vel, paths, has_collided, partner, pend_vals,
                    pend_mask, local, n, cr, cr2, ok_out, count, stream);
  } else if (n <= 2 * wave) {
    launch_lanes<2>(vector, pos, vel, paths, has_collided, partner, pend_vals,
                    pend_mask, local, n, cr, cr2, ok_out, count, stream);
  } else if (n <= 4 * wave) {
    launch_lanes<4>(vector, pos, vel, paths, has_collided, partner, pend_vals,
                    pend_mask, local, n, cr, cr2, ok_out, count, stream);
  } else {
    launch_lanes<8>(vector, pos, vel, paths, has_collided, partner, pend_vals,
                    pend_mask, local, n, cr, cr2, ok_out, count, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
