// K13 post_pairs: the temperature pore's pairs step between K3 and K4 in
// one pass over the particles -- the post-pairs recapture, which particles
// it moved, the speed after the collisions, the bump, hot and dirty masks,
// the mask the shared compaction (K6) takes, and their four counts.
//
// Replaces no TPU kernel: in the JAX package this is XLA's fusion of the
// post-pairs ops/oob.py pore_recapture (:67-111) and the dirty masks of
// make_pairs_step_fn (engine.py:379-391); in the port's plain version
// (ops/post_pairs.py post_pairs_plain) it is ~69 whole-array PyTorch
// operations a step, each reading and writing 10-80 MB at 10M particles.
//
// Bound: bytes.  A particle reads pos, vel (24 bytes), speed_pre (4) and
// five masks (collided, recap_w, hot, pending1, pending_mask) and writes
// bump, dirty and the compaction's mask (3 bytes); hot, pending1 and pos
// are written only where they change.  36 bytes a particle, 0.011 ms at
// 1M particles on an H100's 3.35 TB/s; ~10 flops a particle.  The job
// itself needs 35 (bench_torch/counts/k13.py, with hot written whole and
// without the pending_mask that the compaction's mask reads).
//
// Design: a grid-stride loop over the particles, one particle a thread an
// iteration, with a grid of one full wave of resident blocks, so the counts
// take one integer atomic a block each: warp sums (__reduce_add_sync), then
// the block's warps summed in shared memory in a fixed order.  Integer sums
// are exact and independent of order, so a launch is bitwise repeatable.
// The recapture is K8's (pore_recapture.cuh), on the same PoreParams, and
// moves pos in place where it takes a condition; hot and pending1 are
// updated in place.
//
// Rounding: the speed is sqrt((vx*vx + vy*vy) + vz*vz) in float32 under the
// library's -fmad=false, with the IEEE sqrtf, as measure.speed computes it;
// the recapture compares and assigns host-rounded float32 constants as
// the plain version's float32 tensors do.
#include "common.cuh"
#include "pore_recapture.cuh"

namespace {

using namespace amc::pore;

constexpr int kCounts = 4;
constexpr int kWarps = amc::kThreads / 32;
constexpr int kMaxDevices = 64;

__global__ void post_pairs_kernel(
    float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ speed_pre, const uint8_t* __restrict__ collided,
    const uint8_t* __restrict__ recap_w, uint8_t* __restrict__ hot,
    uint8_t* __restrict__ pending1, const uint8_t* __restrict__ pending_mask,
    const float* __restrict__ params, int n, uint8_t* __restrict__ bump_out,
    uint8_t* __restrict__ dirty_out, uint8_t* __restrict__ shared_out,
    int* __restrict__ counts) {
  __shared__ float c[kNumParams];
  __shared__ int warp_sums[kCounts][kWarps];
  int t = threadIdx.x;
  if (t < kNumParams) c[t] = params[t];
  __syncthreads();

  // oob_after_pairs, latent_full, dirty_count, teleports.
  int v[kCounts] = {0, 0, 0, 0};
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + t;
       i < n; i += stride) {
    float x0 = pos[3 * i], y0 = pos[3 * i + 1], z0 = pos[3 * i + 2];
    float x = x0, y = y0, z = z0;
    int taken = recapture(c, x, y, z);
    if (taken > 0) {
      pos[3 * i] = x;
      pos[3 * i + 1] = y;
      pos[3 * i + 2] = z;
    }
    // recap_p: any coordinate differs (NaN differs from itself).
    bool moved = (x != x0) || (y != y0) || (z != z0);

    float vx = vel[3 * i], vy = vel[3 * i + 1], vz = vel[3 * i + 2];
    float speed = sqrtf(vx * vx + vy * vy + vz * vz);
    bool bump = (speed != speed_pre[i]) || collided[i] != 0;
    bool was_hot = hot[i] != 0;
    bool teleported = recap_w[i] != 0 || moved;
    bool now_hot = was_hot || teleported;
    bool queued = pending1[i] != 0;
    bool dirty = bump || now_hot || queued;

    if (now_hot != was_hot) hot[i] = 1;
    if (queued) pending1[i] = 0;
    bump_out[i] = bump;
    dirty_out[i] = dirty;
    shared_out[i] = dirty || pending_mask[i] != 0;
    v[0] += taken;
    v[1] += queued;
    v[2] += dirty;
    v[3] += teleported;
  }

  int lane = t & 31, warp = t >> 5;
  for (int q = 0; q < kCounts; ++q) {
    int w = __reduce_add_sync(0xffffffffu, v[q]);
    if (lane == 0) warp_sums[q][warp] = w;
  }
  __syncthreads();
  if (t < kCounts) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[t][w];
    if (total != 0) atomicAdd(&counts[t], total);
  }
}

}  // namespace

// In place: pos (n*3 f32; moved rows only), hot and pending1 (n u8: hot
// |= teleported, pending1 = 0).  Read: vel (n*3 f32), speed_pre (n f32, K8's
// speed before the drift), collided (K3's), recap_w (K8's), pending_mask
// (n u8, the staging after K3), params (the PoreParams floats).  Written:
// bump, dirty and shared (= dirty | pending_mask), n u8 each, and counts (4
// i32: conditions the recapture took, pending1 set, dirty, teleported),
// zeroed here.
AMC_EXPORT int amc_post_pairs(float* pos, const float* vel,
                              const float* speed_pre, const uint8_t* collided,
                              const uint8_t* recap_w, uint8_t* hot,
                              uint8_t* pending1, const uint8_t* pending_mask,
                              const float* params, int n, uint8_t* bump,
                              uint8_t* dirty, uint8_t* shared, int* counts,
                              cudaStream_t stream) {
  // A wave of resident blocks a device, found at its first call (made
  // before any capture: a query is no stream work).
  static int wave_blocks[kMaxDevices] = {};
  cudaMemsetAsync(counts, 0, kCounts * sizeof(int), stream);
  if (n > 0) {
    int device = 0;
    cudaGetDevice(&device);
    int wave = device < kMaxDevices ? wave_blocks[device] : 0;
    if (wave == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, post_pairs_kernel, amc::kThreads, 0);
      wave = sms * (per_sm > 0 ? per_sm : 1);
      if (wave < 1) wave = 1;
      if (device < kMaxDevices) wave_blocks[device] = wave;
    }
    int need = amc::blocks_for(n);
    int blocks = need < wave ? need : wave;
    post_pairs_kernel<<<blocks, amc::kThreads, 0, stream>>>(
        pos, vel, speed_pre, collided, recap_w, hot, pending1, pending_mask,
        params, n, bump, dirty, shared, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
