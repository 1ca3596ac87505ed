// K10 resolve_pairs: mutually matched elastic hard-sphere impulse exchange,
// completed-path staging and path reset, and the pair count.
//
// Replaces argon_monte_carlo_tpu/ops/collide.py resolve_collisions
// (:1042-1142) with ops/measure.py record_completed (:38-75) and
// end_paths(zero_residual=False) (:200-221): XLA elementwise code with a
// packed-row partner gather on the TPU.
//
// Bound: memory.  Each particle reads its own and its partner's pos/vel,
// its paths and staging, and writes them back (~100 bytes a particle).
//
// Design: one thread per particle, transcribing collide.py:1075-1134 in
// the same operation order.  The partner's own choice is read from the
// int32 partner array (the reference rode it as a float column, a TPU
// gather workaround exact only below 2^24 particles).  Each thread writes
// only its own particle, into separate output arrays, so there are no
// races.  The count of matched particles is an integer block reduction
// plus one atomicAdd a block; the pair count is half of it.
#include "common.cuh"

namespace {

__global__ void resolve_pairs_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ paths, const uint8_t* __restrict__ has_collided,
    const int* __restrict__ partner, const float* __restrict__ pend_vals,
    const uint8_t* __restrict__ pend_mask, int n, float cr, float cr2,
    float* __restrict__ pos_out, float* __restrict__ vel_out,
    float* __restrict__ paths_out, uint8_t* __restrict__ has_out,
    float* __restrict__ pend_vals_out, uint8_t* __restrict__ pend_mask_out,
    int* __restrict__ ok_count) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool ok = false;
  if (i < n) {
    int p = partner[i];
    bool has = p >= 0;
    int sp = has ? p : 0;
    bool mutual = has && partner[sp] == i;

    float ax = pos[3 * i], ay = pos[3 * i + 1], az = pos[3 * i + 2];
    float avx = vel[3 * i], avy = vel[3 * i + 1], avz = vel[3 * i + 2];
    float bx = pos[3 * sp], by = pos[3 * sp + 1], bz = pos[3 * sp + 2];
    float bvx = vel[3 * sp], bvy = vel[3 * sp + 1], bvz = vel[3 * sp + 2];

    // dxv = x2 - x1 from this particle's side; dvv = v1 - v2.
    float dxx = bx - ax, dxy = by - ay, dxz = bz - az;
    float dvx = avx - bvx, dvy = avy - bvy, dvz = avz - bvz;
    float a = dvx * dvx + dvy * dvy;
    a = a + dvz * dvz;
    float bs = dxx * dvx + dxy * dvy;
    bs = bs + dxz * dvz;
    float b = 2.0f * bs;
    float cs = dxx * dxx + dxy * dxy;
    cs = cs + dxz * dxz;
    float c = cs - cr2;
    float disc = b * b - (4.0f * a) * c;
    ok = mutual && (a > 0.0f) && (disc >= 0.0f) && (c < 0.0f);
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float den = 2.0f * (a == 0.0f ? 1.0f : a);
    float t = fmaxf((-b + sq) / den, (-b - sq) / den);

    // Rewind, exchange along the contact normal, replay.
    float qax = ax - avx * t, qay = ay - avy * t, qaz = az - avz * t;
    float qbx = bx - bvx * t, qby = by - bvy * t, qbz = bz - bvz * t;
    float nx = (qbx - qax) / cr, ny = (qby - qay) / cr, nz = (qbz - qaz) / cr;
    float ps = dvx * nx + dvy * ny;
    ps = ps + dvz * nz;
    float nvx = avx - ps * nx, nvy = avy - ps * ny, nvz = avz - ps * nz;

    // record_completed with the pre-collision velocity.
    float s2 = avx * avx + avy * avy;
    s2 = s2 + avz * avz;
    float speed = sqrtf(s2);
    bool emit = ok && has_collided[i];
    const float* pth = paths + 4 * i;
    float comp[4] = {fabsf(pth[0] - speed * t), fabsf(pth[1] - fabsf(avx) * t),
                     fabsf(pth[2] - fabsf(avy) * t),
                     fabsf(pth[3] - fabsf(avz) * t)};
    for (int k = 0; k < 4; ++k)
      pend_vals_out[4 * i + k] = emit ? comp[k] : pend_vals[4 * i + k];
    pend_mask_out[i] = pend_mask[i] | emit;

    // end_paths(zero_residual=False): residual |v'_k| t along the new
    // direction.
    float n2 = nvx * nvx + nvy * nvy;
    n2 = n2 + nvz * nvz;
    float res[4] = {fabsf(sqrtf(n2) * t), fabsf(fabsf(nvx) * t),
                    fabsf(fabsf(nvy) * t), fabsf(fabsf(nvz) * t)};
    for (int k = 0; k < 4; ++k) paths_out[4 * i + k] = ok ? res[k] : pth[k];
    has_out[i] = has_collided[i] | ok;

    pos_out[3 * i] = ok ? qax + nvx * t : ax;
    pos_out[3 * i + 1] = ok ? qay + nvy * t : ay;
    pos_out[3 * i + 2] = ok ? qaz + nvz * t : az;
    vel_out[3 * i] = ok ? nvx : avx;
    vel_out[3 * i + 1] = ok ? nvy : avy;
    vel_out[3 * i + 2] = ok ? nvz : avz;
  }
  int block_ok = __syncthreads_count(ok);
  if (threadIdx.x == 0 && block_ok > 0) atomicAdd(ok_count, block_ok);
}

}  // namespace

AMC_EXPORT int amc_resolve_pairs(
    const float* pos, const float* vel, const float* paths,
    const uint8_t* has_collided, const int* partner, const float* pend_vals,
    const uint8_t* pend_mask, int n, float cr, float cr2, float* pos_out,
    float* vel_out, float* paths_out, uint8_t* has_out, float* pend_vals_out,
    uint8_t* pend_mask_out, int* ok_count, cudaStream_t stream) {
  cudaMemsetAsync(ok_count, 0, sizeof(int), stream);
  if (n > 0) {
    resolve_pairs_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        pos, vel, paths, has_collided, partner, pend_vals, pend_mask, n, cr,
        cr2, pos_out, vel_out, paths_out, has_out, pend_vals_out,
        pend_mask_out, ok_count);
  }
  return static_cast<int>(cudaGetLastError());
}
