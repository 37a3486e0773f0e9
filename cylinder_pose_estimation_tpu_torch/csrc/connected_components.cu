// 8-connected component labels of a batch of (N, H, W) masks on an exact
// round schedule.
//
// Replaces the TPU kernel cylinder_pose_estimation_tpu/ops/pallas/frontend.py
// connected_components (_cc_kernel, _seg_min_scan_roll).  Each in-mask pixel
// converges towards the minimum linear index of its component:
//   init:  lab = mask ? min(init, idx) : H*W   (a 1-px ring is forced out)
//   per round: pools_per_round masked 3x3 min-pools, each JACOBI (reads the
//   previous buffer, writes the other: never in place), then a row run-min
//   pass (every in-mask pixel takes the minimum over its contiguous in-mask
//   run of the row), then the same along columns.
// The TPU computed the run-min with Hillis-Steele doubling over rolls; the
// result is the same run minimum, so here one thread walks one row (or
// column) forward and back.  The number of rounds is exact: the output may
// be unconverged on purpose, and the detector's convergence checks read it.
//
// Bound: memory traffic, (pools + 2) passes over the labels per round, plus
// launch count; column passes are coalesced (adjacent threads, adjacent x),
// row passes stride through L1.

#include "common.cuh"

namespace {

using cpe::blocks_for;
using cpe::kThreads;

__device__ __forceinline__ bool in_mask(const float* mask, long long idx, int y, int x, int h,
                                        int w) {
  return y >= 1 && y < h - 1 && x >= 1 && x < w - 1 && mask[idx] > 0.5f;
}

__global__ void cc_init(const float* __restrict__ mask, const int* __restrict__ init,
                        int* __restrict__ lab, int n, int h, int w) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)n * h * w;
  if (idx >= total) return;
  int x = idx % w;
  int y = (idx / w) % h;
  int own = y * w + x;
  int v = h * w;
  if (in_mask(mask, idx, y, x, h, w)) v = init ? min(init[idx], own) : own;
  lab[idx] = v;
}

__global__ void cc_pool(const float* __restrict__ mask, const int* __restrict__ in,
                        int* __restrict__ out, int n, int h, int w) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)n * h * w;
  if (idx >= total) return;
  int x = idx % w;
  int y = (idx / w) % h;
  int big = h * w;
  if (!in_mask(mask, idx, y, x, h, w)) {
    out[idx] = big;
    return;
  }
  // In-mask pixels lie inside the ring, so all 8 neighbours are in range.
  int m = in[idx];
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) m = min(m, in[idx + (long long)dy * w + dx]);
  out[idx] = m;
}

// Run-min along one line per thread: `count` lines of `len` pixels, line i
// starting at start(i) with element stride `step`.
__global__ void cc_run_min(const float* __restrict__ mask, int* __restrict__ lab, int n, int h,
                           int w, bool rows) {
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
  int big = h * w;
  auto inm = [&](int i) {
    int y = rows ? (int)(line % h) : i;
    int x = rows ? i : (int)(line % w);
    return in_mask(mask, start + (long long)i * step, y, x, h, w);
  };
  // Forward: running minimum within the run, stored in place.
  int run = big;
  for (int i = 0; i < len; ++i) {
    long long p = start + (long long)i * step;
    if (inm(i)) {
      run = min(run, lab[p]);
      lab[p] = run;
    } else {
      run = big;
      lab[p] = big;
    }
  }
  // Backward: the minimum over [i, run end] of the forward minima is the
  // minimum of the whole run.
  run = big;
  for (int i = len - 1; i >= 0; --i) {
    long long p = start + (long long)i * step;
    if (lab[p] < big) {
      run = min(run, lab[p]);
      lab[p] = run;
    } else {
      run = big;
    }
  }
}

}  // namespace

// labels (out) and tmp: (N, H, W) int32; init may be null (cold start).
CPE_API int cpe_connected_components(const float* mask, const int* init, int* out, int* tmp,
                                     int n, int h, int w, int rounds, int pools_per_round,
                                     cudaStream_t stream) {
  long long total = (long long)n * h * w;
  unsigned g = blocks_for(total);
  cc_init<<<g, kThreads, 0, stream>>>(mask, init, out, n, h, w);
  CPE_CHECK_LAUNCH();
  int* cur = out;
  int* other = tmp;
  for (int r = 0; r < rounds; ++r) {
    for (int p = 0; p < pools_per_round; ++p) {
      cc_pool<<<g, kThreads, 0, stream>>>(mask, cur, other, n, h, w);
      CPE_CHECK_LAUNCH();
      int* t = cur;
      cur = other;
      other = t;
    }
    cc_run_min<<<blocks_for((long long)n * h), kThreads, 0, stream>>>(mask, cur, n, h, w, true);
    CPE_CHECK_LAUNCH();
    cc_run_min<<<blocks_for((long long)n * w), kThreads, 0, stream>>>(mask, cur, n, h, w, false);
    CPE_CHECK_LAUNCH();
  }
  if (cur != out) {
    cudaMemcpyAsync(out, cur, total * sizeof(int), cudaMemcpyDeviceToDevice, stream);
    CPE_CHECK_LAUNCH();
  }
  return 0;
}
