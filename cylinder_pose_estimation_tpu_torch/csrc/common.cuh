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

inline bool cluster_size_ok(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

// Opt `kernel` in to `smem` bytes of dynamic shared memory and fill `cfg`
// for cluster * n CTAs of `threads` along x, in thread-block clusters of
// `cluster` CTAs; `attr` holds the cluster dimension `cfg` points to.  The
// one setup of the launch and of its occupancy query.  Returns 0 or the
// CUDA error.
template <typename... Params>
int cluster_config(void (*kernel)(Params...), int cluster, int n, int threads, int smem,
                   cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  *cfg = {};
  cfg->gridDim = dim3(cluster * n, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// Launch `kernel` over cluster * n CTAs of `threads` along x, in
// thread-block clusters of `cluster` CTAs (cluster i: CTAs i * cluster ..),
// with `smem` bytes of dynamic shared memory (opted in above 48 KB).
// Returns 0 or the CUDA error.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int cluster, int n, int threads, int smem,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int rc = cluster_config(kernel, cluster, n, threads, smem, stream, &cfg, &attr);
  if (rc) return rc;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  CPE_CHECK_LAUNCH();
  return 0;
}

}  // namespace cpe
