// K8 pore_advance: one fused per-particle pass of the temperature pore --
// drift and path accrual, the six wall cases in the reference's order, the
// post-wall recapture -- with the step's momentum/energy ledger, wall hits,
// solver errors and recapture count, and on request the missed-case audit's
// ten counts.
//
// Replaces, in the JAX package, the drift at the head of both step
// functions (argon_monte_carlo_tpu/engine.py:153-156 and :352-357), the
// wall pass models/temperature_pore.py:65-212 on the ops/walls.py
// primitives (:52-252) with models/base.py apply_tracked (:65) and
// ops/measure.py record_completed (:38) / end_paths (:200), the post-wall
// ops/oob.py pore_recapture (:67-111), and the pairs engine's speed_pre and
// recap_w (engine.py:352, :367-369).  There it is ~950 masked whole-array
// XLA (or, in the port's plain version, PyTorch) operations a step.
//
// In place: pos, vel, paths, has_collided and the first n rows of the
// staging are the step's own arrays, read and written through one pointer
// each.  Bound: bytes.  Each particle reads pos, vel, paths and
// has_collided (41 bytes) and writes pos and paths (the drift moves every
// particle: 28) and recap_w and speed_pre (5); only a lane that a wall case
// takes also writes vel, has_collided and its staging row, and only an
// energized hit reads its two uniforms: ~74 bytes a particle, 0.022 ms at
// 1M particles on an H100's 3.35 TB/s.  No case reads a staged value
// before it overwrites it, so the staging is never read.  The arithmetic
// (~60 flops a particle, sin/cos only on a hit) is far below that.
//
// Design: one thread per particle runs every case in order on its own
// registers, so each case reads the state the previous case left -- which
// is what the masked whole-array passes compute -- and each changed lane is
// written once at the end.  A case changes only the particles it takes; no
// array is rewritten per case (the plain version's 27 cats a step).  paths
// and the staging rows (16 bytes) move as float4; pos and vel rows (12
// bytes) as three scalar loads and stores, coalesced across the warp
// (staged through shared memory as float4, by the block or by the warp,
// they measured 20-30% slower on an H100).  The staging and path resets
// follow record_completed and end_paths(zero_residual=True): a later case
// of the same step overwrites an earlier one's staged values.  The ledger
// uses the reference's mask per case: the plane cases sum over the raw
// case mask, the cylinder cases over the handled subset, and hits count
// the whole case mask, errors included.  Ledger floats are summed per
// block in a fixed tree order and then over the blocks by one block in a
// fixed order: no float atomics, so a launch is bitwise repeatable.
// Integer counts use atomics.
//
// Rounding: every constant is a float32 rounded once on the host from the
// plain version's double (params, in the order of enum Param in
// pore_recapture.cuh; ops/pore_pass.py PARAM_NAMES lists the same names),
// every operation is written in the plain version's order, divisions are
// IEEE divisions, the library is built with -fmad=false, and
// sqrtf/cosf/sinf are the accurate (non-fast-math) functions PyTorch's own
// CUDA kernels call.
//
// The audit (models/base.py pore_missed_case_audit, its energized set,
// replacing the reference's models/base.py:12-62 as its engine calls it
// between the wall pass and the recapture, engine.py:162-165, 363-366):
// with a `missed` array, each thread evaluates the ten wall-case
// predicates on its post-wall position against its prior one, before the
// recapture block, and the counts are warp-summed and added to missed[]
// with one integer atomic a warp each, as the other counts are.  Without
// it (a null pointer) nothing of it runs, and the state and ledger are
// those of a launch without the audit to the bit.
#include "common.cuh"
#include "pore_recapture.cuh"

namespace {

// Host-rounded constants: enum Param of pore_recapture.cuh.
using namespace amc::pore;
using amc::backtrace;
using amc::safe;

constexpr int kTotalsThreads = 1024;
constexpr int kMaxHorner = 32;
constexpr int kAuditCases = 10;

// The block partials of the ledger are summed by ledger_totals_kernel's
// kTotalsThreads threads, thread v over the contiguous run of `per` blocks
// [v * per, v * per + per), in order.  Block b's partials are stored at
// (q, b % per, b / per) of a (3, per, kTotalsThreads) array, so that the
// threads' j-th loads are adjacent.
__host__ __device__ __forceinline__ int totals_per(int nblocks) {
  return (nblocks + kTotalsThreads - 1) / kTotalsThreads;
}

// One particle in registers, and what the step's cases changed of it
// beyond pos and paths: its velocity (any wall case that took it), its
// partial path ended (has_collided set), its completed path staged (pv).
struct Particle {
  float x, y, z, vx, vy, vz;
  float p[4];
  bool has;
  bool vel_set, ended, staged;
  float pv[4];
};

// The step's cone draw (rng.cone_trig), evaluated on the first energized
// hit only.
struct Trig {
  bool ready;
  float cos_t, a, b;
};

struct Ctx {
  const float* c;  // params in shared memory
  const float* horner;
  int num_horner;
  const float* uniforms;
  int i;
};

__device__ __forceinline__ void cone_trig(const Ctx& k, Trig& tr) {
  if (tr.ready) return;
  float u1 = k.uniforms[2 * k.i];
  float u2 = k.uniforms[2 * k.i + 1];
  float cos_t = k.c[kCosCone] + u1 * k.c[kOneMCos];
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float phi = k.c[kTwoPi] * u2;
  tr.cos_t = cos_t;
  tr.a = sin_t * cosf(phi);
  tr.b = sin_t * sinf(phi);
  tr.ready = true;
}

// E' = E + (E_surf - E) alpha; returns the new speed, *d_energy = E' - E
// (walls.py _thermal_exchange).
__device__ __forceinline__ float exchange(const Particle& s, float e_surf,
                                          float alpha, const float* c,
                                          float* d_energy) {
  float speed2 = s.vx * s.vx + s.vy * s.vy + s.vz * s.vz;
  float energy = c[kHalfMass] * speed2;
  float new_energy = energy + (e_surf - energy) * alpha;
  *d_energy = new_energy - energy;
  return sqrtf(fmaxf(new_energy * 2.0f / c[kMass], 0.0f));
}

// record_completed with the velocity before the case, then
// end_paths(zero_residual=True).
__device__ __forceinline__ void stage_and_end(Particle& s, float t) {
  if (s.has) {
    float speed = sqrtf(s.vx * s.vx + s.vy * s.vy + s.vz * s.vz);
    s.pv[0] = fabsf(s.p[0] - speed * t);
    s.pv[1] = fabsf(s.p[1] - fabsf(s.vx) * t);
    s.pv[2] = fabsf(s.p[2] - fabsf(s.vy) * t);
    s.pv[3] = fabsf(s.p[3] - fabsf(s.vz) * t);
    s.staged = true;
  }
  for (int k = 0; k < 4; ++k) s.p[k] = 0.0f;
  s.has = true;
  s.ended = true;
  s.vel_set = true;  // every caller re-emits the particle
}

// Thermal wall on a z-plane (walls.py energized_plane): placed at the
// impact point, re-emitted about (0, 0, sign).  Returns d_pz.
__device__ __forceinline__ float energized_plane(const Ctx& k, Particle& s,
                                                 Trig& tr, float plane,
                                                 float sign, float e_surf,
                                                 float* d_energy) {
  const float* c = k.c;
  float t = (s.z - plane) / safe(s.vz);
  float col_x = s.x - s.vx * t;
  float col_y = s.y - s.vy * t;
  cone_trig(k, tr);
  float dir_z = sign * tr.cos_t;
  float speed = exchange(s, e_surf, c[kAlphaCoat], c, d_energy);
  float nvx = tr.a * speed;
  float nvy = tr.b * speed;
  float nvz = dir_z * speed;
  float d_pz = c[kMass] * (nvz - s.vz);
  stage_and_end(s, t);
  s.x = col_x;
  s.y = col_y;
  s.z = plane;
  s.vx = nvx;
  s.vy = nvy;
  s.vz = nvz;
  return d_pz;
}

// Thermal cylinder side wall (walls.py energized_cylinder): back-trace to
// the wall, re-emit in the cone about the inward normal; the gap's
// surface energy is the Horner polynomial of the impact z.  Returns false
// (and changes nothing) where the back-trace misses.
__device__ __forceinline__ bool energized_cylinder(
    const Ctx& k, Particle& s, Trig& tr, float radius, float rr, bool gap,
    float e_surf, float alpha, float* d_pz, float* d_energy) {
  const float* c = k.c;
  bool ok;
  float t = backtrace(s.x, s.y, s.vx, s.vy, rr, &ok);
  if (!ok) return false;
  float cx = s.x - s.vx * t;
  float cy = s.y - s.vy * t;
  float cz = s.z - s.vz * t;
  // rng.orthonormal_frame of the inward normal (nz = +0, so s = 1).
  float nx = -cx / radius;
  float ny = -cy / radius;
  float nz = 0.0f;
  float sg = nz >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sg + nz);
  float b = nx * ny * a;
  float e1x = 1.0f + sg * nx * nx * a, e1y = sg * b, e1z = -sg * nx;
  float e2x = b, e2y = sg + ny * ny * a, e2z = -ny;
  cone_trig(k, tr);
  float dx = tr.cos_t * nx + tr.a * e1x + tr.b * e2x;
  float dy = tr.cos_t * ny + tr.a * e1y + tr.b * e2y;
  float dz = tr.cos_t * nz + tr.a * e1z + tr.b * e2z;
  if (gap) {
    float u = (cz - c[kTableZLo]) / c[kTableSpan] * 2.0f - 1.0f;
    u = fminf(fmaxf(u, -1.0f), 1.0f);
    float acc = k.horner[0];
    for (int j = 1; j < k.num_horner; ++j) acc = acc * u + k.horner[j];
    e_surf = acc;
  }
  float speed = exchange(s, e_surf, alpha, c, d_energy);
  float nvx = dx * speed;
  float nvy = dy * speed;
  float nvz = dz * speed;
  *d_pz = c[kMass] * (nvz - s.vz);
  stage_and_end(s, t);
  s.x = cx;
  s.y = cy;
  s.z = cz;
  s.vx = nvx;
  s.vy = nvy;
  s.vz = nvz;
  return true;
}

__device__ __forceinline__ float r2(const Particle& s) {
  return s.x * s.x + s.y * s.y;
}

__global__ void pore_advance_kernel(
    float* __restrict__ pos, float* __restrict__ vel,
    float* __restrict__ paths, uint8_t* __restrict__ has_collided,
    float* __restrict__ pend_vals, uint8_t* __restrict__ pend_mask,
    const float* __restrict__ uniforms, const float* __restrict__ params,
    const float* __restrict__ horner, int num_horner, int n,
    uint8_t* __restrict__ recap_out, float* __restrict__ speed_pre_out,
    float* __restrict__ block_ledger, int* __restrict__ counts,
    int* __restrict__ missed) {
  __shared__ float c[kNumParams];
  __shared__ float coef[kMaxHorner];
  __shared__ float sh[3][amc::kThreads];
  int t = threadIdx.x;
  if (t < kNumParams) c[t] = params[t];
  if (t < num_horner) coef[t] = horner[t];
  __syncthreads();

  int i = blockIdx.x * blockDim.x + t;
  float mz = 0.0f, e_hot = 0.0f, e_cold = 0.0f;
  int hits = 0, errs = 0, recaptured = 0;
  int audit[kAuditCases] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (i < n) {
    Ctx k{c, coef, num_horner, uniforms, i};
    Particle s;
    s.x = pos[3 * i];
    s.y = pos[3 * i + 1];
    s.z = pos[3 * i + 2];
    s.vx = vel[3 * i];
    s.vy = vel[3 * i + 1];
    s.vz = vel[3 * i + 2];
    float4 p4 = reinterpret_cast<const float4*>(paths)[i];
    s.p[0] = p4.x;
    s.p[1] = p4.y;
    s.p[2] = p4.z;
    s.p[3] = p4.w;
    s.has = has_collided[i] != 0;
    s.vel_set = s.ended = s.staged = false;
    Trig tr{false, 0.0f, 0.0f, 0.0f};
    float dt = c[kDt];

    // DRIFT + path accrual (measure.accumulate_drift); the speed is also
    // the pairs engine's speed_pre.
    float speed = sqrtf(s.vx * s.vx + s.vy * s.vy + s.vz * s.vz);
    speed_pre_out[i] = speed;
    s.p[0] = s.p[0] + dt * speed;
    s.p[1] = s.p[1] + dt * fabsf(s.vx);
    s.p[2] = s.p[2] + dt * fabsf(s.vy);
    s.p[3] = s.p[3] + dt * fabsf(s.vz);
    float pz = s.z;
    float prior_r2 = s.x * s.x + s.y * s.y;
    s.x = s.x + dt * s.vx;
    s.y = s.y + dt * s.vy;
    s.z = s.z + dt * s.vz;

    // CASE 1: specular open-air cylinder side (errors counted, no hit).
    if (sqrtf(r2(s)) > c[kROa]) {
      bool ok;
      float tb = backtrace(s.x, s.y, s.vx, s.vy, c[kCrOaRr], &ok);
      if (ok) {
        float col_x = s.x - s.vx * tb;
        float col_y = s.y - s.vy * tb;
        float nx = col_x / c[kCrOa];
        float ny = col_y / c[kCrOa];
        float dot = s.vx * nx + s.vy * ny;
        float nvx = s.vx - 2.0f * dot * nx;
        float nvy = s.vy - 2.0f * dot * ny;
        s.x = col_x + nvx * tb;
        s.y = col_y + nvy * tb;
        s.vx = nvx;
        s.vy = nvy;
        s.vel_set = true;
      } else {
        errs += 1;
      }
    }

    // CASE 2: specular z caps.
    if (s.z < 0.0f) {
      float tp = (s.z - 0.0f) / safe(s.vz);
      float nvz = -s.vz;
      s.z = 0.0f + tp * nvz;
      s.vz = nvz;
      s.vel_set = true;
    }
    if (s.z > c[kH]) {
      float tp = (s.z - c[kH]) / safe(s.vz);
      float nvz = -s.vz;
      s.z = c[kH] + tp * nvz;
      s.vz = nvz;
      s.vel_set = true;
    }

    float d_pz, d_e;
    // CASE 3: coated annular faces, cold then hot.
    if (pz >= c[kPlaneCold] && s.z < c[kPlaneCold] && r2(s) > c[kRcSq]) {
      hits += 1;
      mz += energized_plane(k, s, tr, c[kPlaneCold], 1.0f, c[kECold], &d_e);
      e_cold += d_e;
    }
    if (pz <= c[kPlaneHot] && s.z > c[kPlaneHot] && r2(s) > c[kRcSq]) {
      hits += 1;
      mz += energized_plane(k, s, tr, c[kPlaneHot], -1.0f, c[kEHot], &d_e);
      e_hot += d_e;
    }

    // CASE 4: alumina gap side wall with the temperature ramp (momentum
    // only).
    if (pz < c[kGapHiMAr] && pz > c[kGapLoPAr] && prior_r2 <= c[kCrGapSq] &&
        r2(s) > c[kCrGapSq]) {
      hits += 1;
      if (energized_cylinder(k, s, tr, c[kCrGap], c[kCrGapRr], true, 0.0f,
                             c[kAlphaGap], &d_pz, &d_e)) {
        mz += d_pz;
      } else {
        errs += 1;
      }
    }

    // CASE 5: gap cylinder bases, bottom (hot) then top (cold).
    bool in_gap_prior = pz <= c[kGapHiMAr] && pz >= c[kGapLoPAr];
    if (prior_r2 >= c[kCrPoreSq] && s.z < c[kGapLoPAr] && in_gap_prior) {
      hits += 1;
      mz += energized_plane(k, s, tr, c[kGapLoPAr], 1.0f, c[kEHot], &d_e);
      e_hot += d_e;
    }
    if (prior_r2 >= c[kCrPoreSq] && s.z > c[kGapHiMAr] && in_gap_prior) {
      hits += 1;
      mz += energized_plane(k, s, tr, c[kGapHiMAr], -1.0f, c[kECold], &d_e);
      e_cold += d_e;
    }

    // CASE 6: coated pore side wall, hot band then cold band.
    if (prior_r2 <= c[kCrPoreSq] && r2(s) > c[kCrPoreSq] &&
        s.z <= c[kGapLoPAr] && s.z >= c[kPlaneHot]) {
      hits += 1;
      if (energized_cylinder(k, s, tr, c[kCrPore], c[kCrPoreRr], false,
                             c[kEHot], c[kAlphaCoat], &d_pz, &d_e)) {
        mz += d_pz;
        e_hot += d_e;
      } else {
        errs += 1;
      }
    }
    if (prior_r2 <= c[kCrPoreSq] && r2(s) > c[kCrPoreSq] &&
        s.z < c[kPlaneCold] && s.z > c[kGapHiMAr]) {
      hits += 1;
      if (energized_cylinder(k, s, tr, c[kCrPore], c[kCrPoreRr], false,
                             c[kECold], c[kAlphaCoat], &d_pz, &d_e)) {
        mz += d_pz;
        e_cold += d_e;
      } else {
        errs += 1;
      }
    }

    // AUDIT: [case 1, 2a, 2b, 3a, 3b, 4, 5a, 5b, 6a, 6b] on the post-wall
    // position, in the reference's predicates (the energized set, insets
    // included).
    if (missed != nullptr) {
      float r2w = r2(s);
      float zw = s.z;
      bool in_gap = pz <= c[kGapHiMAr] && pz >= c[kGapLoPAr];
      bool crossed = prior_r2 <= c[kCrPoreSq] && r2w > c[kCrPoreSq];
      audit[0] = r2w > c[kROaSq];
      audit[1] = zw < 0.0f;
      audit[2] = zw > c[kH];
      audit[3] = pz >= c[kPlaneCold] && zw < c[kPlaneCold] && r2w > c[kRcSq];
      audit[4] = pz <= c[kPlaneHot] && zw > c[kPlaneHot] && r2w > c[kRcSq];
      audit[5] = pz < c[kGapHiMAr] && pz > c[kGapLoPAr] &&
                 prior_r2 <= c[kCrGapSq] && r2w > c[kCrGapSq];
      audit[6] = prior_r2 >= c[kCrPoreSq] && zw < c[kGapLoPAr] && in_gap;
      audit[7] = prior_r2 >= c[kCrPoreSq] && zw > c[kGapHiMAr] && in_gap;
      audit[8] = crossed && zw <= c[kGapLoPAr] && zw >= c[kPlaneHot];
      audit[9] = crossed && zw < c[kPlaneCold] && zw > c[kGapHiMAr];
    }

    // RECAPTURE (oob.pore_recapture, pore_recapture.cuh).
    float x = s.x, y = s.y, z = s.z;
    recaptured += recapture(c, x, y, z);
    recap_out[i] = (x != s.x) || (y != s.y) || (z != s.z);

    // Written back: pos and paths on every lane, the rest where a case
    // changed it.
    pos[3 * i] = x;
    pos[3 * i + 1] = y;
    pos[3 * i + 2] = z;
    reinterpret_cast<float4*>(paths)[i] =
        make_float4(s.p[0], s.p[1], s.p[2], s.p[3]);
    if (s.vel_set) {
      vel[3 * i] = s.vx;
      vel[3 * i + 1] = s.vy;
      vel[3 * i + 2] = s.vz;
    }
    if (s.ended) has_collided[i] = 1;
    if (s.staged) {
      reinterpret_cast<float4*>(pend_vals)[i] =
          make_float4(s.pv[0], s.pv[1], s.pv[2], s.pv[3]);
      pend_mask[i] = 1;
    }
  }

  // Ledger: a fixed-order tree over the block, the last five levels in
  // the first warp's registers.
  sh[0][t] = mz;
  sh[1][t] = e_hot;
  sh[2][t] = e_cold;
  __syncthreads();
  for (int w = amc::kThreads / 2; w >= 32; w >>= 1) {
    if (t < w) {
      for (int q = 0; q < 3; ++q) sh[q][t] = sh[q][t] + sh[q][t + w];
    }
    __syncthreads();
  }
  if (t < 32) {
    float f[3] = {sh[0][t], sh[1][t], sh[2][t]};
    for (int w = 16; w > 0; w >>= 1) {
      for (int q = 0; q < 3; ++q) {
        f[q] = f[q] + __shfl_down_sync(0xffffffffu, f[q], w);
      }
    }
    if (t == 0) {
      int per = totals_per(gridDim.x);
      int at = (blockIdx.x % per) * kTotalsThreads + blockIdx.x / per;
      for (int q = 0; q < 3; ++q) {
        block_ledger[(q * per) * kTotalsThreads + at] = f[q];
      }
    }
  }
  // Counts: integer warp sums, one atomic a warp.
  int v[3] = {hits, errs, recaptured};
  for (int q = 0; q < 3; ++q) {
    int w = __reduce_add_sync(0xffffffffu, v[q]);
    if ((t & 31) == 0 && w != 0) atomicAdd(&counts[q], w);
  }
  if (missed != nullptr) {  // uniform over the launch
    for (int q = 0; q < kAuditCases; ++q) {
      int w = __reduce_add_sync(0xffffffffu, audit[q]);
      if ((t & 31) == 0 && w != 0) atomicAdd(&missed[q], w);
    }
  }
}

// One block: each thread sums its contiguous run of block partials in
// order, then a fixed tree over the threads.
__global__ void ledger_totals_kernel(const float* __restrict__ block_ledger,
                                     int nblocks, float* __restrict__ ledger) {
  __shared__ float sh[3][kTotalsThreads];
  int t = threadIdx.x;
  int per = totals_per(nblocks);
  int lo = min(t * per, nblocks);
  int hi = min(lo + per, nblocks);
  float f[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < hi - lo; ++j) {
    for (int q = 0; q < 3; ++q) {
      f[q] = f[q] + block_ledger[(q * per + j) * kTotalsThreads + t];
    }
  }
  for (int q = 0; q < 3; ++q) sh[q][t] = f[q];
  __syncthreads();
  for (int w = kTotalsThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      for (int q = 0; q < 3; ++q) sh[q][t] = sh[q][t] + sh[q][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int q = 0; q < 3; ++q) ledger[q] = sh[q][0];
  }
}

}  // namespace

// params: kNumParams float32 constants (enum Param); horner: num_horner
// (1..32) coefficients, highest degree first.  pos, vel, paths,
// has_collided and the first n rows of pend_vals / pend_mask are updated in
// place (paths and pend_vals 16-byte aligned); recap_out and speed_pre_out
// are written; ledger (3 f32: momentum_z, energy_hot, energy_cold) and
// counts (3 i32: wall hits, errors, recaptured).  missed: null, or 10 i32
// to which the audit's counts are added (the caller zeroes it).  Scratch:
// block_ledger, 3 * ceil(nblocks / 1024) * 1024 f32 (nblocks = the
// 256-particle blocks).
AMC_EXPORT int amc_pore_advance(
    float* pos, float* vel, float* paths, uint8_t* has_collided,
    float* pend_vals, uint8_t* pend_mask, const float* uniforms,
    const float* params, const float* horner, int num_horner, int n,
    uint8_t* recap_out, float* speed_pre_out, float* block_ledger,
    float* ledger, int* counts, int* missed, cudaStream_t stream) {
  uintptr_t rows16 = reinterpret_cast<uintptr_t>(paths) |
                     reinterpret_cast<uintptr_t>(pend_vals);
  if (num_horner < 1 || num_horner > kMaxHorner || (rows16 & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int nblocks = amc::blocks_for(n);
  cudaMemsetAsync(counts, 0, 3 * sizeof(int), stream);
  if (nblocks > 0) {
    pore_advance_kernel<<<nblocks, amc::kThreads, 0, stream>>>(
        pos, vel, paths, has_collided, pend_vals, pend_mask, uniforms, params,
        horner, num_horner, n, recap_out, speed_pre_out, block_ledger, counts,
        missed);
  }
  ledger_totals_kernel<<<1, kTotalsThreads, 0, stream>>>(block_ledger,
                                                         nblocks, ledger);
  return static_cast<int>(cudaGetLastError());
}
