// Shared helpers of the port's hand-written kernels.
//
// Every exported function has a plain C interface (bound with ctypes),
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  The library is built with -fmad=false and
// without fast math, so each float operation rounds exactly like the
// op-by-op plain PyTorch version beside each wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AMC_EXPORT extern "C" __attribute__((visibility("default")))

namespace amc {

constexpr int kThreads = 256;
constexpr int kNoPartner = 1 << 30;
// The reference's INT_BIG (ops/pairs.py:73): "no candidate" in a top-k.
constexpr int kIntBig = 1 << 30;

inline int blocks_for(long long n, int threads = kThreads) {
  return static_cast<int>((n + threads - 1) / threads);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Exclusive prefix sum of one int per thread over a block of kThreads
// threads; *total receives the block's sum.  Every thread of the block must
// call it (it synchronises).
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int warp_sums[kWarps];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

// The port's cell binning (reference ops/collide.py:324-349): floor,
// convert to int32, clip.  Shared by K2 and K4.
__device__ __forceinline__ int assign_cell(float x, float y, float z,
                                           const int* __restrict__ nx,
                                           const int* __restrict__ layer_base,
                                           const float* __restrict__ half_extent,
                                           int nz, float z_lo,
                                           float cell_size) {
  int iz = clampi(static_cast<int>(floorf((z - z_lo) / cell_size)), 0, nz - 1);
  int m = nx[iz];
  float half = half_extent[iz];
  int ix = clampi(static_cast<int>(floorf((x + half) / cell_size)), 0, m - 1);
  int iy = clampi(static_cast<int>(floorf((y + half) / cell_size)), 0, m - 1);
  return layer_base[iz] + iy * m + ix;
}

}  // namespace amc
