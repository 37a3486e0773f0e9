// Shared helpers of the front-end kernels (plain C interface, no PyTorch
// headers: the library builds with nvcc alone in seconds).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define CPE_API extern "C" __attribute__((visibility("default")))

// Return the first launch error (a refused launch never runs, and a later
// synchronize would not report it).
#define CPE_CHECK_LAUNCH()                    \
  do {                                        \
    cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

namespace cpe {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace cpe
