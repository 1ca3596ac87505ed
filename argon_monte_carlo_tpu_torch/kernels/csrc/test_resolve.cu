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
// Bound: memory.  The test reads each of the ~430k entries' two rows of
// position (24 bytes); everything after it touches only the few thousand
// colliding entries and one pass over the particles.
//
// Design, in launch order:
//   1. test: one thread per entry, colliding = a < n && d^2 < cr^2 with
//      d^2 = (dx*dx + dy*dy) + dz*dz, dx = pos_b - pos_a.  The sentinel
//      entry (a == b == n) is never tested, so no far dummy row is needed.
//   2. K6 compaction of the colliding entries at event_capacity; the
//      number beyond it is the caller's ev_dropped.
//   3. choice: integer atomicMin over (n+1,) of each endpoint's partner
//      (the reference's .at[].min scatters; an integer minimum is the same
//      in any order).
//   4. resolve: one thread per event; a mutual pair that approaches and
//      overlaps is rewound, exchanges the impulse and replays
//      (pairs.py:358-383, the same operation order).  The thread reads
//      only the inputs and writes both particles into fresh output arrays.
//      Duplicate and reversed entries (i, j) and (j, i) write bitwise
//      identical values: every step of the formula is sign-symmetric, and
//      the library is built with -fmad=false.
//   5. one thread per particle: record_completed with the pre-collision
//      velocity, end_paths with the residual along the new velocity, and
//      the count of resolved particles (integer block count plus one
//      atomicAdd a block); the caller halves it.
#include "common.cuh"

namespace {

__global__ void test_entries_kernel(const float* __restrict__ pos,
                                    const int* __restrict__ a,
                                    const int* __restrict__ b, int m, int n,
                                    float cr2,
                                    uint8_t* __restrict__ colliding) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  int i = a[e];
  int j = b[e];
  bool hit = false;
  if (i < n && j < n) {
    float dx = pos[3 * j] - pos[3 * i];
    float dy = pos[3 * j + 1] - pos[3 * i + 1];
    float dz = pos[3 * j + 2] - pos[3 * i + 2];
    float d2 = dx * dx + dy * dy;
    d2 = d2 + dz * dz;
    hit = d2 < cr2;
  }
  colliding[e] = hit;
}

__global__ void choice_kernel(const int* __restrict__ eidx, int e_cap, int m,
                              const int* __restrict__ a,
                              const int* __restrict__ b,
                              int* __restrict__ choice) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= e_cap) return;
  int e = eidx[k];
  if (e >= m) return;
  int i = a[e];
  int j = b[e];
  atomicMin(&choice[i], j);
  atomicMin(&choice[j], i);
}

__global__ void resolve_events_kernel(
    const int* __restrict__ eidx, int e_cap, int m, const int* __restrict__ a,
    const int* __restrict__ b, const int* __restrict__ choice,
    const float* __restrict__ pos, const float* __restrict__ vel, float cr,
    float cr2, float* __restrict__ pos_out, float* __restrict__ vel_out,
    uint8_t* __restrict__ mask_n, float* __restrict__ t_n) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= e_cap) return;
  int e = eidx[k];
  if (e >= m) return;
  int i = a[e];
  int j = b[e];
  if (choice[i] != j || choice[j] != i) return;

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
  if (!((aa > 0.0f) && (disc >= 0.0f) && (cc < 0.0f))) return;
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

  pos_out[3 * i] = qax + nax * t;
  pos_out[3 * i + 1] = qay + nay * t;
  pos_out[3 * i + 2] = qaz + naz * t;
  vel_out[3 * i] = nax;
  vel_out[3 * i + 1] = nay;
  vel_out[3 * i + 2] = naz;
  pos_out[3 * j] = qbx + nbx * t;
  pos_out[3 * j + 1] = qby + nby * t;
  pos_out[3 * j + 2] = qbz + nbz * t;
  vel_out[3 * j] = nbx;
  vel_out[3 * j + 1] = nby;
  vel_out[3 * j + 2] = nbz;
  mask_n[i] = 1;
  mask_n[j] = 1;
  t_n[i] = t;
  t_n[j] = t;
}

__global__ void particle_pass_kernel(
    const float* __restrict__ vel, const float* __restrict__ vel_out,
    const float* __restrict__ paths, const uint8_t* __restrict__ has_collided,
    const float* __restrict__ pend_vals, const uint8_t* __restrict__ pend_mask,
    const uint8_t* __restrict__ mask_n, const float* __restrict__ t_n, int n,
    float* __restrict__ paths_out, uint8_t* __restrict__ has_out,
    float* __restrict__ pend_vals_out, uint8_t* __restrict__ pend_mask_out,
    int* __restrict__ count) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool m = false;
  if (i < n) {
    m = mask_n[i] != 0;
    float t = t_n[i];
    const float* pth = paths + 4 * i;
    // record_completed with the pre-collision velocity.
    float vx = vel[3 * i], vy = vel[3 * i + 1], vz = vel[3 * i + 2];
    float s2 = vx * vx + vy * vy;
    s2 = s2 + vz * vz;
    bool emit = m && has_collided[i];
    float comp[4] = {fabsf(pth[0] - sqrtf(s2) * t), fabsf(pth[1] - fabsf(vx) * t),
                     fabsf(pth[2] - fabsf(vy) * t), fabsf(pth[3] - fabsf(vz) * t)};
    for (int k = 0; k < 4; ++k)
      pend_vals_out[4 * i + k] = emit ? comp[k] : pend_vals[4 * i + k];
    pend_mask_out[i] = pend_mask[i] | emit;
    // end_paths(zero_residual=False) along the new velocity.
    float ux = vel_out[3 * i], uy = vel_out[3 * i + 1], uz = vel_out[3 * i + 2];
    float u2 = ux * ux + uy * uy;
    u2 = u2 + uz * uz;
    float res[4] = {fabsf(sqrtf(u2) * t), fabsf(fabsf(ux) * t),
                    fabsf(fabsf(uy) * t), fabsf(fabsf(uz) * t)};
    for (int k = 0; k < 4; ++k) paths_out[4 * i + k] = m ? res[k] : pth[k];
    has_out[i] = has_collided[i] | m;
  }
  int block_count = __syncthreads_count(m);
  if (threadIdx.x == 0 && block_count > 0) atomicAdd(count, block_count);
}

__global__ void fill_int_kernel(int* __restrict__ out, int size, int value) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < size) out[k] = value;
}

}  // namespace

// Outputs: the six state/staging arrays (fresh), mask_n (n,), count (the
// number of resolved particles), ev_total (the number of colliding
// entries).  Scratch: colliding (m) u8, eidx (e_cap) i32, block_vals and
// block_offsets (blocks_for(m) i32 each), choice (n + 1) i32, t_n (n) f32.
AMC_EXPORT int amc_test_and_resolve(
    const float* pos, const float* vel, const float* paths,
    const uint8_t* has_collided, const float* pend_vals,
    const uint8_t* pend_mask, const int* a, const int* b, int n, int m,
    int e_cap, float cr, float cr2, float* pos_out, float* vel_out,
    float* paths_out, uint8_t* has_out, float* pend_vals_out,
    uint8_t* pend_mask_out, uint8_t* mask_n, int* count, int* ev_total,
    uint8_t* colliding, int* eidx, int* block_vals, int* block_offsets,
    int* choice, float* t_n, cudaStream_t stream) {
  if (m > 0) {
    test_entries_kernel<<<amc::blocks_for(m), amc::kThreads, 0, stream>>>(
        pos, a, b, m, n, cr2, colliding);
  }
  amc::compact_launch(colliding, m, e_cap, m, eidx, ev_total, block_vals,
                      block_offsets, stream);
  cudaMemcpyAsync(pos_out, pos, sizeof(float) * 3 * n,
                  cudaMemcpyDeviceToDevice, stream);
  cudaMemcpyAsync(vel_out, vel, sizeof(float) * 3 * n,
                  cudaMemcpyDeviceToDevice, stream);
  cudaMemsetAsync(mask_n, 0, n, stream);
  cudaMemsetAsync(t_n, 0, sizeof(float) * n, stream);
  cudaMemsetAsync(count, 0, sizeof(int), stream);
  fill_int_kernel<<<amc::blocks_for(n + 1), amc::kThreads, 0, stream>>>(
      choice, n + 1, amc::kIntBig);
  if (e_cap > 0) {
    choice_kernel<<<amc::blocks_for(e_cap), amc::kThreads, 0, stream>>>(
        eidx, e_cap, m, a, b, choice);
    resolve_events_kernel<<<amc::blocks_for(e_cap), amc::kThreads, 0,
                            stream>>>(eidx, e_cap, m, a, b, choice, pos, vel,
                                      cr, cr2, pos_out, vel_out, mask_n, t_n);
  }
  if (n > 0) {
    particle_pass_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        vel, vel_out, paths, has_collided, pend_vals, pend_mask, mask_n, t_n,
        n, paths_out, has_out, pend_vals_out, pend_mask_out, count);
  }
  return static_cast<int>(cudaGetLastError());
}
