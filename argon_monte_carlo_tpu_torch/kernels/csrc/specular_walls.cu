// K14 specular_advance: one per-particle pass of the specular pore
// (Open_Air_Pore_MC) -- the speed before the drift, drift and path
// accrual, the six specular wall cases in the reference's order, each
// ending the free path with its overshoot, and the v1 nudge -- with the
// step's wall hits, solver errors and nudge count, and on request the
// missed-case audit's ten counts.
//
// Replaces, in the JAX package, the drift at the head of both step
// functions (argon_monte_carlo_tpu/engine.py:153-156 and :352-357), the
// wall pass models/pore.py:55-144 on the ops/walls.py specular primitives
// with its tracked bookkeeping (models/pore.py:39-53: ops/measure.py
// record_completed (:38) and end_paths (:200) keeping the overshoot), the
// post-wall ops/oob.py pore_v1_audit_nudge (:114) and the pairs engine's
// speed_pre and recap_w (engine.py:352, :367-369).  In the port's plain
// version (engine.advance_plain over models/pore.py's wall pass) it is
// ~740 masked whole-array PyTorch operations a step.
//
// In place, as K8 (pore_walls.cu): pos, vel, paths, has_collided and the
// first n rows of the staging are the step's own arrays.  Bound: bytes.
// Each particle reads pos, vel, paths and has_collided (41 bytes) and
// writes pos and paths (28) and recap_w and speed_pre (5); only a lane
// that a wall case takes also writes vel, has_collided and its staging row
// (30): ~74 bytes a particle, 0.022 ms at 1M particles on an H100's 3.35
// TB/s (bench_torch/counts/walls.py).  No case reads a staged value before
// it overwrites it, so the staging is never read.  ~40 flops a particle,
// far below that.
//
// Design: K8's.  One thread per particle runs every case in order on its
// own registers, so each case reads the state the previous case left --
// what the masked whole-array passes compute -- and each changed lane is
// written once at the end.  It is a kernel of its own, not a mode of K8:
// the two passes differ in every part (square-root radii here, K8's r^2
// with argon-radius insets; the overshoot kept, not zeroed; the nudge, not
// the recapture; no ledger and no uniforms), and a mode would add
// registers and branches to K8.  The staging and path resets follow
// record_completed and end_paths(zero_residual=False): a later case of the
// same step overwrites an earlier one's staged values.  Hits count every
// lane of a case mask, solver errors included (Open_Air_Pore_MC.py:348);
// case 1 counts too, unlike K8's bare open-air side.  Counts are integer
// warp sums, one atomic a warp: a launch is bitwise repeatable.
//
// Rounding: every constant is a float32 rounded once on the host from the
// plain version's double (params, in the order of enum Param below;
// ops/pore_pass.py SPECULAR_PARAM_NAMES lists the same names), every
// operation is written in the plain version's order, divisions are IEEE
// divisions, sqrtf is the IEEE square root, and the library is built with
// -fmad=false.
//
// The audit (models/base.py pore_missed_case_audit, pore v1's set, as the
// engine calls it between the wall pass and the nudge): with a `missed`
// array each thread evaluates the ten predicates on its post-wall position
// against its prior one, and the counts are warp-summed and added to
// missed[]; without it (a null pointer) nothing of it runs.
#include "common.cuh"
#include "pore_recapture.cuh"

namespace {

using amc::backtrace;
using amc::safe;

// Host-rounded constants, in the order of SPECULAR_PARAM_NAMES.
enum Param {
  kDt, kROa, kCrOa, kCrOaRr, kH, kHMOah, kOah, kRPore, kGapSideTop, kGapLo,
  kGapHi, kRGap, kCrGap, kCrGapRr, kCrPore, kCrPoreRr, kNudge, kROaSq,
  kGapRSq, kRcSq, kNumParams
};

constexpr int kAuditCases = 10;

// One particle in registers, and what the step's cases changed of it
// beyond pos and paths: its velocity, its partial path ended (has_collided
// set), its completed path staged (pv).
struct Particle {
  float x, y, z, vx, vy, vz;
  float p[4];
  bool has;
  bool vel_set, ended, staged;
  float pv[4];
};

__device__ __forceinline__ float radius(const Particle& s) {
  return sqrtf(s.x * s.x + s.y * s.y);
}

// A handled wall event, after the case moved the particle and set its new
// velocity: record_completed with the velocity before the case (o*), then
// end_paths(zero_residual=False), the overshoot |v'_k| t along the new
// direction.
__device__ __forceinline__ void end_path(Particle& s, float ox, float oy,
                                         float oz, float t) {
  if (s.has) {
    float speed = sqrtf(ox * ox + oy * oy + oz * oz);
    s.pv[0] = fabsf(s.p[0] - speed * t);
    s.pv[1] = fabsf(s.p[1] - fabsf(ox) * t);
    s.pv[2] = fabsf(s.p[2] - fabsf(oy) * t);
    s.pv[3] = fabsf(s.p[3] - fabsf(oz) * t);
    s.staged = true;
  }
  float speed = sqrtf(s.vx * s.vx + s.vy * s.vy + s.vz * s.vz);
  s.p[0] = fabsf(speed * t);
  s.p[1] = fabsf(fabsf(s.vx) * t);
  s.p[2] = fabsf(fabsf(s.vy) * t);
  s.p[3] = fabsf(fabsf(s.vz) * t);
  s.has = true;
  s.ended = true;
  s.vel_set = true;
}

// Specular z-plane (walls.py specular_plane, axis 2): t = (z - level) / vz,
// vz' = -vz, z' = level + t vz'.
__device__ __forceinline__ void plane(Particle& s, float level) {
  float ox = s.vx, oy = s.vy, oz = s.vz;
  float t = (s.z - level) / safe(s.vz);
  float nvz = -s.vz;
  s.z = level + t * nvz;
  s.vz = nvz;
  end_path(s, ox, oy, oz, t);
}

// Specular cylinder side wall (walls.py specular_cylinder): back-trace to
// the wall, reflect (vx, vy) about the normal, replay.  Returns false (and
// changes nothing) where the back-trace misses: a solver error.
__device__ __forceinline__ bool cylinder(Particle& s, float r, float rr) {
  bool ok;
  float t = backtrace(s.x, s.y, s.vx, s.vy, rr, &ok);
  if (!ok) return false;
  float ox = s.vx, oy = s.vy, oz = s.vz;
  float col_x = s.x - s.vx * t;
  float col_y = s.y - s.vy * t;
  float nx = col_x / r;
  float ny = col_y / r;
  float dot = s.vx * nx + s.vy * ny;
  float nvx = s.vx - 2.0f * dot * nx;
  float nvy = s.vy - 2.0f * dot * ny;
  s.x = col_x + nvx * t;
  s.y = col_y + nvy * t;
  s.vx = nvx;
  s.vy = nvy;
  end_path(s, ox, oy, oz, t);
  return true;
}

__global__ void specular_advance_kernel(
    float* __restrict__ pos, float* __restrict__ vel,
    float* __restrict__ paths, uint8_t* __restrict__ has_collided,
    float* __restrict__ pend_vals, uint8_t* __restrict__ pend_mask,
    const float* __restrict__ params, int n,
    uint8_t* __restrict__ recap_out, float* __restrict__ speed_pre_out,
    int* __restrict__ counts, int* __restrict__ missed) {
  __shared__ float c[kNumParams];
  int t = threadIdx.x;
  if (t < kNumParams) c[t] = params[t];
  __syncthreads();

  int i = blockIdx.x * blockDim.x + t;
  int hits = 0, errs = 0, nudged = 0;
  int audit[kAuditCases] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (i < n) {
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
    float prior_r = sqrtf(s.x * s.x + s.y * s.y);
    s.x = s.x + dt * s.vx;
    s.y = s.y + dt * s.vy;
    s.z = s.z + dt * s.vz;

    // CASE 1: specular side of the open-air cylinder.
    if (radius(s) > c[kROa]) {
      hits += 1;
      errs += !cylinder(s, c[kCrOa], c[kCrOaRr]);
    }

    // CASE 2: exterior z caps.
    if (s.z < 0.0f) {
      hits += 1;
      plane(s, 0.0f);
    }
    if (s.z > c[kH]) {
      hits += 1;
      plane(s, c[kH]);
    }

    // CASE 3: annular faces where open air meets the pore, cold then hot.
    if (pz > c[kHMOah] && s.z < c[kHMOah] && radius(s) > c[kRPore]) {
      hits += 1;
      plane(s, c[kHMOah]);
    }
    if (pz < c[kOah] && s.z > c[kOah] && radius(s) > c[kRPore]) {
      hits += 1;
      plane(s, c[kOah]);
    }

    // CASE 4: gap interior side wall.
    if (pz < c[kGapSideTop] && pz > c[kGapLo] && prior_r < c[kRGap] &&
        radius(s) > c[kRGap]) {
      hits += 1;
      errs += !cylinder(s, c[kCrGap], c[kCrGapRr]);
    }

    // CASE 5: gap cylinder bases, bottom then top.
    bool in_gap_prior = pz < c[kGapHi] && pz > c[kGapLo];
    if (prior_r > c[kRPore] && s.z < c[kGapLo] && in_gap_prior) {
      hits += 1;
      plane(s, c[kGapLo]);
    }
    if (prior_r > c[kRPore] && s.z > c[kGapHi] && in_gap_prior) {
      hits += 1;
      plane(s, c[kGapHi]);
    }

    // CASE 6: coated pore side wall, in either coated band.
    bool in_cold = s.z < c[kHMOah] && s.z > c[kGapHi];
    bool in_hot = s.z < c[kGapLo] && s.z > c[kOah];
    if (prior_r < c[kRPore] && radius(s) > c[kRPore] && (in_cold || in_hot)) {
      hits += 1;
      errs += !cylinder(s, c[kCrPore], c[kCrPoreRr]);
    }

    // AUDIT: [case 1, 2a, 2b, 3a, 3b, 4, 5a, 5b, 6a, 6b] on the post-wall
    // position, in pore v1's predicates (square-root radii, no insets).
    if (missed != nullptr) {
      float r2w = s.x * s.x + s.y * s.y;
      float r = sqrtf(r2w);
      float zw = s.z;
      bool in_gap = pz < c[kGapHi] && pz > c[kGapLo];
      bool crossed = prior_r < c[kRPore] && r > c[kRPore];
      audit[0] = r2w > c[kROaSq];
      audit[1] = zw < 0.0f;
      audit[2] = zw > c[kH];
      audit[3] = pz > c[kHMOah] && zw < c[kHMOah] && r > c[kRPore];
      audit[4] = pz < c[kOah] && zw > c[kOah] && r > c[kRPore];
      audit[5] = in_gap && prior_r < c[kRGap] && r > c[kRGap];
      audit[6] = prior_r > c[kRPore] && zw < c[kGapLo] && in_gap;
      audit[7] = prior_r > c[kRPore] && zw > c[kGapHi] && in_gap;
      audit[8] = crossed && zw < c[kHMOah] && zw > c[kGapHi];
      audit[9] = crossed && zw < c[kGapLo] && zw > c[kOah];
    }

    // NUDGE (oob.pore_v1_audit_nudge): a z stray moves back by ten argon
    // radii, then the recapture's radial checks (pore_recapture.cuh).
    float x = s.x, y = s.y, z = s.z;
    if (z < 0.0f) {
      z = z + c[kNudge];
      nudged += 1;
    }
    if (z > c[kH]) {
      z = z - c[kNudge];
      nudged += 1;
    }
    nudged += amc::pore::radial(x, y, z, c[kROaSq], c[kOah], c[kHMOah],
                                c[kGapRSq], c[kRcSq], c[kGapLo], c[kGapHi]);
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

  // Counts: integer warp sums, one atomic a warp.
  int v[3] = {hits, errs, nudged};
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

}  // namespace

// params: kNumParams float32 constants (enum Param).  pos, vel, paths,
// has_collided and the first n rows of pend_vals / pend_mask are updated in
// place (paths and pend_vals 16-byte aligned); recap_out (the lanes the
// nudge moved) and speed_pre_out are written; counts (3 i32: wall hits,
// solver errors, nudged) and, where not null, missed (10 i32: the audit)
// are added to: the caller zeroes them.
AMC_EXPORT int amc_specular_advance(
    float* pos, float* vel, float* paths, uint8_t* has_collided,
    float* pend_vals, uint8_t* pend_mask, const float* params, int n,
    uint8_t* recap_out, float* speed_pre_out, int* counts, int* missed,
    cudaStream_t stream) {
  uintptr_t rows16 = reinterpret_cast<uintptr_t>(paths) |
                     reinterpret_cast<uintptr_t>(pend_vals);
  if ((rows16 & 15u) != 0) return static_cast<int>(cudaErrorInvalidValue);
  int nblocks = amc::blocks_for(n);
  if (nblocks > 0) {
    specular_advance_kernel<<<nblocks, amc::kThreads, 0, stream>>>(
        pos, vel, paths, has_collided, pend_vals, pend_mask, params, n,
        recap_out, speed_pre_out, counts, missed);
  }
  return static_cast<int>(cudaGetLastError());
}
