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

inline int blocks_for(long long n, int threads = kThreads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace amc
