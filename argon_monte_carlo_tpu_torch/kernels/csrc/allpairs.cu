// K11 allpairs_partner: each particle's lowest-index partner j != i over
// all N particles with d^2 < r^2, or -1 -- the cube's broad phase.
//
// Replaces argon_monte_carlo_tpu/ops/collide.py allpairs_partner_search
// (:1001-1034): on the TPU an XLA scan over (N_pad, 2048) tiles of the
// masked minimum.
//
// Bound: operations.  A particle with no partner tests all N others, one
// with a partner tests up to its first hit: ~N^2 = 6.1e8 pair tests a step
// at the cube's 24,627 particles, 9 float32 operations each (3 sub, 3 mul,
// 2 add, 1 compare), ~0.08 ms at the H100's 67 TFLOP/s (twice that, since
// -fmad=false leaves no FMA to pair).  The bytes are 16 a particle.
//
// Design: one thread per particle i; a block stages j-tiles of 256
// positions in shared memory (every thread reads the same j, a broadcast)
// and each thread scans them in ascending j, so its first hit is the
// lowest index; the block leaves its tile loop when every thread has a hit
// (__syncthreads_and).  d^2 is (dx*dx + dy*dy) + dz*dz with dx = x_i - x_j,
// as in K9.  Occupancy: 24,627 particles make only 97 blocks of 256 for
// 132 SMs, so the j-range is split across blocks as well -- enough splits
// for ~8 blocks an SM -- and each split's first hit is combined by an
// integer atomicMin, which is order-free, so the result is deterministic.
// Smaller blocks would also fill the SMs but would stage each tile for
// fewer rows.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTile = amc::kThreads;

__global__ void fill_kernel(int* __restrict__ best, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) best[i] = amc::kNoPartner;
}

__global__ void allpairs_kernel(const float* __restrict__ pos, int n,
                                float r2, int span, int* __restrict__ best) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  int t = threadIdx.x;
  int i = blockIdx.x * blockDim.x + t;
  int j_lo = blockIdx.y * span;
  int j_hi = min(n, j_lo + span);
  bool active = i < n;
  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  if (active) {
    xi = pos[3 * i];
    yi = pos[3 * i + 1];
    zi = pos[3 * i + 2];
  }
  bool done = !active;
  int hit = amc::kNoPartner;
  for (int j0 = j_lo; j0 < j_hi; j0 += kTile) {
    // Also the barrier before the tile is overwritten.
    if (__syncthreads_and(done)) break;
    int j = j0 + t;
    if (j < j_hi) {
      sx[t] = pos[3 * j];
      sy[t] = pos[3 * j + 1];
      sz[t] = pos[3 * j + 2];
    }
    __syncthreads();
    if (!done) {
      int count = min(kTile, j_hi - j0);
      for (int k = 0; k < count; ++k) {
        float dx = xi - sx[k];
        float dy = yi - sy[k];
        float dz = zi - sz[k];
        float d2 = dx * dx + dy * dy;
        d2 = d2 + dz * dz;
        if (d2 < r2 && j0 + k != i) {
          hit = j0 + k;
          done = true;
          break;
        }
      }
    }
  }
  if (hit < amc::kNoPartner) atomicMin(&best[i], hit);
}

__global__ void finish_kernel(int* __restrict__ best, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && best[i] >= amc::kNoPartner) best[i] = -1;
}

}  // namespace

// partner (n i32) is written in full.
AMC_EXPORT int amc_allpairs_partner(const float* pos, int n, float r2,
                                    int* partner, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int row_blocks = amc::blocks_for(n);
  int tiles = (n + kTile - 1) / kTile;
  int splits = std::min(std::max((8 * sms + row_blocks - 1) / row_blocks, 1),
                        tiles);
  int span = ((tiles + splits - 1) / splits) * kTile;
  splits = (n + span - 1) / span;
  fill_kernel<<<row_blocks, amc::kThreads, 0, stream>>>(partner, n);
  allpairs_kernel<<<dim3(row_blocks, splits), amc::kThreads, 0, stream>>>(
      pos, n, r2, span, partner);
  finish_kernel<<<row_blocks, amc::kThreads, 0, stream>>>(partner, n);
  return static_cast<int>(cudaGetLastError());
}
