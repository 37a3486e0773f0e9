// Per-pixel minimum AND maximum of an int32 payload over the pixel's
// 8-connected component, for a batch of (N, H, W) masks, on the exact round
// schedule of connected_components.cu.
//
// Replaces the TPU kernel cylinder_pose_estimation_tpu/ops/pallas/frontend.py
// component_payload_minmax (_cc_payload_minmax_kernel, _seg_max_scan_roll).
// Two channels ride one launch sequence:
//   init:  lo = mask ? payload : H*W,  hi = mask ? payload : -1
//          (a 1-px ring is forced out of the mask)
//   per round: pools_per_round masked 3x3 pools, each JACOBI (both channels
//   read the previous buffers and write the other pair, never in place),
//   then a row pass (every in-mask pixel takes the minimum / maximum over
//   its contiguous in-mask run of the row, the out-of-mask values H*W / -1
//   at the run's ends included, as the TPU's doubling scan includes them),
//   then the same along columns.
// The payload is an arbitrary value per pixel (the bridge passes a scan
// order), so neither channel can be derived from the labels.  The number of
// rounds is exact: the output may be unconverged on purpose, and the
// detector reads it as it is.
//
// Bound: memory traffic, (pools + 2) passes over two int32 planes per round,
// plus launch count; column passes are coalesced (adjacent threads, adjacent
// x), row passes stride through L1.  The design is connected_components.cu's
// with a second channel carried in every pass.

#include "common.cuh"

namespace {

using cpe::blocks_for;
using cpe::kThreads;

__device__ __forceinline__ bool in_mask(const float* mask, long long idx, int y, int x, int h,
                                        int w) {
  return y >= 1 && y < h - 1 && x >= 1 && x < w - 1 && mask[idx] > 0.5f;
}

__global__ void pm_init(const float* __restrict__ mask, const int* __restrict__ pay,
                        int* __restrict__ lo, int* __restrict__ hi, int n, int h, int w) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)n * h * w;
  if (idx >= total) return;
  int x = idx % w;
  int y = (idx / w) % h;
  bool m = in_mask(mask, idx, y, x, h, w);
  lo[idx] = m ? pay[idx] : h * w;
  hi[idx] = m ? pay[idx] : -1;
}

__global__ void pm_pool(const float* __restrict__ mask, const int* __restrict__ lo_in,
                        const int* __restrict__ hi_in, int* __restrict__ lo_out,
                        int* __restrict__ hi_out, int n, int h, int w) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)n * h * w;
  if (idx >= total) return;
  int x = idx % w;
  int y = (idx / w) % h;
  if (!in_mask(mask, idx, y, x, h, w)) {
    lo_out[idx] = h * w;
    hi_out[idx] = -1;
    return;
  }
  // In-mask pixels lie inside the ring, so all 8 neighbours are in range.
  int mn = lo_in[idx];
  int mx = hi_in[idx];
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      long long q = idx + (long long)dy * w + dx;
      mn = min(mn, lo_in[q]);
      mx = max(mx, hi_in[q]);
    }
  lo_out[idx] = mn;
  hi_out[idx] = mx;
}

// Run min and max along one line per thread: rows (n*h lines of w pixels)
// or columns (n*w lines of h pixels, stride w).
__global__ void pm_run(const float* __restrict__ mask, int* __restrict__ lo,
                       int* __restrict__ hi, int n, int h, int w, bool rows) {
  long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long count = rows ? (long long)n * h : (long long)n * w;
  if (line >= count) return;
  long long start;
  int len, step;
  if (rows) {
    start = line * w;
    len = w;
    step = 1;
  } else {
    long long b = line / w;
    start = b * h * w + line % w;
    len = h;
    step = w;
  }
  const int big = h * w;
  auto inm = [&](int i) {
    int y = rows ? (int)(line % h) : i;
    int x = rows ? i : (int)(line % w);
    return in_mask(mask, start + (long long)i * step, y, x, h, w);
  };
  // Forward: running extremes within the run, stored in place; each run
  // starts from the out-of-mask values (big, -1) of the pixel before it.
  int rmin = big, rmax = -1;
  for (int i = 0; i < len; ++i) {
    long long p = start + (long long)i * step;
    if (inm(i)) {
      rmin = min(rmin, lo[p]);
      rmax = max(rmax, hi[p]);
      lo[p] = rmin;
      hi[p] = rmax;
    } else {
      rmin = big;
      rmax = -1;
      lo[p] = big;
      hi[p] = -1;
    }
  }
  // Backward: the extreme over [i, run end] of the forward extremes is the
  // extreme of the whole run.
  rmin = big;
  rmax = -1;
  for (int i = len - 1; i >= 0; --i) {
    long long p = start + (long long)i * step;
    if (inm(i)) {
      rmin = min(rmin, lo[p]);
      rmax = max(rmax, hi[p]);
      lo[p] = rmin;
      hi[p] = rmax;
    } else {
      rmin = big;
      rmax = -1;
    }
  }
}

}  // namespace

// pmin/pmax (out) and tmin/tmax (scratch): (N, H, W) int32.
CPE_API int cpe_component_payload_minmax(const float* mask, const int* payload, int* pmin,
                                         int* pmax, int* tmin, int* tmax, int n, int h, int w,
                                         int rounds, int pools_per_round, cudaStream_t stream) {
  long long total = (long long)n * h * w;
  unsigned g = blocks_for(total);
  pm_init<<<g, kThreads, 0, stream>>>(mask, payload, pmin, pmax, n, h, w);
  CPE_CHECK_LAUNCH();
  int *lo = pmin, *hi = pmax, *lo2 = tmin, *hi2 = tmax;
  for (int r = 0; r < rounds; ++r) {
    for (int p = 0; p < pools_per_round; ++p) {
      pm_pool<<<g, kThreads, 0, stream>>>(mask, lo, hi, lo2, hi2, n, h, w);
      CPE_CHECK_LAUNCH();
      int* t = lo;
      lo = lo2;
      lo2 = t;
      t = hi;
      hi = hi2;
      hi2 = t;
    }
    pm_run<<<blocks_for((long long)n * h), kThreads, 0, stream>>>(mask, lo, hi, n, h, w, true);
    CPE_CHECK_LAUNCH();
    pm_run<<<blocks_for((long long)n * w), kThreads, 0, stream>>>(mask, lo, hi, n, h, w, false);
    CPE_CHECK_LAUNCH();
  }
  if (lo != pmin) {
    cudaMemcpyAsync(pmin, lo, total * sizeof(int), cudaMemcpyDeviceToDevice, stream);
    CPE_CHECK_LAUNCH();
    cudaMemcpyAsync(pmax, hi, total * sizeof(int), cudaMemcpyDeviceToDevice, stream);
    CPE_CHECK_LAUNCH();
  }
  return 0;
}
