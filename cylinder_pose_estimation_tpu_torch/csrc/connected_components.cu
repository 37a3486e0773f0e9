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
// The number of rounds is exact: the output may be unconverged on purpose,
// and the detector's convergence checks read it.
//
// Bound: memory.  The function reads the mask (and the warm start) once and
// writes the labels once: 16.8, 47.2 and 70.8 MB at the detector's three
// sites, 0.040 ms together at 3.35 TB/s.
//
// Design: one launch per call, and the label image never leaves the chip
// between rounds, as the TPU kept it in VMEM.  A mask's rows are split over
// a thread-block cluster of c CTAs (c in {1, 2, 4, 8}, the smallest whose
// two Jacobi buffers fit in shared memory; the wrapper's plan picks it).
// Pools read the neighbours' edge rows through distributed shared memory,
// and cluster.sync() separates passes; background pixels are skipped.  The
// row run-min is one warp per row: each lane walks 13 consecutive pixels in
// registers (an odd stride: no bank conflicts), and a segmented min-scan
// over the lanes with shuffles joins the runs that cross lanes.  The column
// run-min walks each column of a CTA's rows forward and back; each CTA then
// publishes, per column, the minimum of the runs touching its top and bottom
// edges and whether its whole segment is one run, and every CTA finishes its
// edge runs from its neighbours' entries.  In-mask pixels are exactly those
// with a label below H*W, so the mask itself is not kept.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCCThreads = 1024;
constexpr int kIlp = 8;  // global loads in flight per thread while loading
constexpr int kSeg = 13;  // pixels per lane in a row scan step: odd, so the
                          // lanes' strided loads hit 32 distinct banks
constexpr unsigned kFull = 0xffffffffu;

// The run minimum entering a lane's segment in a row scan step.  Each lane
// brings the minimum of the run touching its far end and whether its whole
// segment is in the mask; `carry` enters the step at lane 0 (forward) or
// lane 31 (backward).  A segmented scan over the lanes, then one shift.
__device__ __forceinline__ int carry_in(int run, bool all, int carry, int lane, bool forward) {
  for (int d = 1; d < 32; d *= 2) {
    int ro = forward ? __shfl_up_sync(kFull, run, d) : __shfl_down_sync(kFull, run, d);
    bool ao = (forward ? __shfl_up_sync(kFull, (int)all, d) : __shfl_down_sync(kFull, (int)all, d)) != 0;
    if (forward ? lane >= d : lane + d < 32) {
      if (all) run = min(run, ro);
      all = all && ao;
    }
  }
  if (all) run = min(run, carry);  // the whole prefix is one run: the step's carry joins it
  int in = forward ? __shfl_up_sync(kFull, run, 1) : __shfl_down_sync(kFull, run, 1);
  return (forward ? lane == 0 : lane == 31) ? carry : in;
}

// Shared ints: two label buffers of rows_per x w, then per column the top
// edge run's minimum, the bottom edge run's minimum and the one-run flag.
// A pixel is in the mask exactly when its label is below H*W.
__global__ void __launch_bounds__(kCCThreads, 1) cc_cluster(
    const float* __restrict__ mask, const int* __restrict__ init, int* __restrict__ out, int h,
    int w, int rounds, int pools, int rows_per) {
  extern __shared__ int smem_cc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = kCCThreads / 32;
  const int r0 = rank * rows_per;
  const int nr = min(rows_per, h - r0);
  const int n_px = nr * w;
  const int big = h * w;
  const int buf_len = rows_per * w;
  int* top = smem_cc + 2 * buf_len;
  int* bot = top + w;
  int* one_run = bot + w;
  const size_t base = (size_t)blockIdx.y * h * w + (size_t)r0 * w;
  const float* m = mask + base;
  const int* ini = init ? init + base : nullptr;

  for (int i0 = tid; i0 < n_px; i0 += kIlp * kCCThreads) {
    float mv[kIlp];
    int iv[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      int i = i0 + u * kCCThreads;
      mv[u] = i < n_px ? m[i] : 0.0f;
      iv[u] = (ini && i < n_px) ? ini[i] : big;
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      int i = i0 + u * kCCThreads;
      int y = r0 + i / w;
      int x = i % w;
      int g = y * w + x;
      bool in = y >= 1 && y < h - 1 && x >= 1 && x < w - 1 && mv[u] > 0.5f;
      if (i < n_px) smem_cc[i] = smem_cc[buf_len + i] = in ? min(iv[u], g) : big;
    }
  }
  cluster.sync();

  int cur = 0;
  for (int round = 0; round < rounds; ++round) {
    for (int p = 0; p < pools; ++p) {
      int* src = smem_cc + cur * buf_len;
      int* dst = smem_cc + (cur ^ 1) * buf_len;
      // In-mask pixels lie inside the ring, so their edge rows' neighbours
      // exist in the neighbouring CTA.
      const int* above = rank > 0 ? cluster.map_shared_rank(src, rank - 1) + (rows_per - 1) * w
                                  : nullptr;
      const int* below = rank < csize - 1 ? cluster.map_shared_rank(src, rank + 1) : nullptr;
      // Background pixels hold H*W in both buffers from the start and
      // are never written again.
#pragma unroll 4
      for (int i = tid; i < n_px; i += kCCThreads) {
        int v = src[i];
        if (v < big) {
          const int ly = i / w;
          const int* mid = src + i;
          const int* up = ly > 0 ? mid - w : above + (i - ly * w);
          const int* dn = ly < nr - 1 ? mid + w : below + (i - ly * w);
          v = min(v, min(mid[-1], mid[1]));
          v = min(v, min(up[-1], min(up[0], up[1])));
          v = min(v, min(dn[-1], min(dn[0], dn[1])));
          dst[i] = v;
        }
      }
      cur ^= 1;
      cluster.sync();
    }

    int* lab = smem_cc + cur * buf_len;
    // Row run-min: one warp per row, in steps of 32 x kSeg pixels, each lane
    // on kSeg consecutive pixels in registers.  A lane's (minimum of the run
    // touching its end, all in mask) pair goes through a segmented warp scan
    // to give the next lane its carry; the step's carry goes on to the next.
    // Forward, then back on the forward minima.
    for (int ly = warp; ly < nr; ly += nwarps) {
      int* row = lab + ly * w;
      int carry = big;
      for (int x0 = 0; x0 < w; x0 += 32 * kSeg) {
        const int xs = x0 + lane * kSeg;
        int v[kSeg];
#pragma unroll
        for (int k = 0; k < kSeg; ++k) v[k] = xs + k < w ? row[xs + k] : big;
        int run = big;
        bool all = true;
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          run = v[k] < big ? min(run, v[k]) : big;
          all = all && v[k] < big;
        }
        run = carry_in(run, all, carry, lane, true);
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          run = v[k] < big ? min(run, v[k]) : big;
          if (xs + k < w) row[xs + k] = run;
        }
        carry = __shfl_sync(kFull, run, 31);
      }
      carry = big;
      for (int x0 = ((w - 1) / (32 * kSeg)) * (32 * kSeg); x0 >= 0; x0 -= 32 * kSeg) {
        const int xs = x0 + lane * kSeg;
        int v[kSeg];
#pragma unroll
        for (int k = 0; k < kSeg; ++k) v[k] = xs + k < w ? row[xs + k] : big;
        int run = big;
        bool all = true;
#pragma unroll
        for (int k = kSeg - 1; k >= 0; --k) {
          run = v[k] < big ? min(run, v[k]) : big;
          all = all && v[k] < big;
        }
        run = carry_in(run, all, carry, lane, false);
#pragma unroll
        for (int k = kSeg - 1; k >= 0; --k) {
          run = v[k] < big ? min(run, v[k]) : big;
          if (xs + k < w) row[xs + k] = run;
        }
        carry = __shfl_sync(kFull, run, 0);
      }
    }
    __syncthreads();

    // Column run-min within this CTA's rows, then the edge entries.
    for (int x = tid; x < w; x += kCCThreads) {
      int run = big;
      bool all = true;
      for (int ly = 0; ly < nr; ++ly) {
        int v = lab[ly * w + x];
        if (v < big) {
          run = min(run, v);
          lab[ly * w + x] = run;
        } else {
          run = big;
          all = false;
        }
      }
      run = big;
      for (int ly = nr - 1; ly >= 0; --ly) {
        int v = lab[ly * w + x];
        if (v < big) {
          run = min(run, v);
          lab[ly * w + x] = run;
        } else {
          run = big;
        }
      }
      top[x] = lab[x];
      bot[x] = lab[(nr - 1) * w + x];
      one_run[x] = all ? 1 : 0;
    }
    cluster.sync();
    if (csize > 1) {
      for (int x = tid; x < w; x += kCCThreads) {
        // Runs crossing the CTA edges: walk up (down) while the neighbour's
        // edge pixel is in the mask, past neighbours that are one run.
        int up = big;
        if (top[x] < big) {
          for (int r = rank - 1; r >= 0; --r) {
            int e = cluster.map_shared_rank(bot, r)[x];
            if (e >= big) break;
            up = min(up, e);
            if (!cluster.map_shared_rank(one_run, r)[x]) break;
          }
        }
        int dn = big;
        if (bot[x] < big) {
          for (int r = rank + 1; r < csize; ++r) {
            int e = cluster.map_shared_rank(top, r)[x];
            if (e >= big) break;
            dn = min(dn, e);
            if (!cluster.map_shared_rank(one_run, r)[x]) break;
          }
        }
        if (one_run[x]) {
          int v = min(top[x], min(up, dn));
          for (int ly = 0; ly < nr; ++ly) lab[ly * w + x] = v;
        } else {
          if (up < big)
            for (int ly = 0; ly < nr && lab[ly * w + x] < big; ++ly)
              lab[ly * w + x] = min(lab[ly * w + x], up);
          if (dn < big)
            for (int ly = nr - 1; ly >= 0 && lab[ly * w + x] < big; --ly)
              lab[ly * w + x] = min(lab[ly * w + x], dn);
        }
      }
    }
    cluster.sync();
  }

  int* o = out + base;
  const int* lab = smem_cc + cur * buf_len;
  for (int i = tid; i < n_px; i += kCCThreads) o[i] = lab[i];
}

}  // namespace

// labels (out): (N, H, W) int32; init may be null (cold start).  The
// wrapper's plan (ops/frontend.cc_plan) passes the cluster size, the rows
// per CTA and the shared bytes; they must agree with this kernel's layout,
// or nothing launches.
CPE_API int cpe_connected_components(const float* mask, const int* init, int* out, int n, int h,
                                     int w, int rounds, int pools_per_round, int cluster,
                                     int rows_per, int smem_bytes, cudaStream_t stream) {
  bool csize_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (!csize_ok || rows_per < 1 || (long long)rows_per * cluster < h ||
      (long long)rows_per * (cluster - 1) >= h ||
      smem_bytes != (int)((2LL * rows_per * w + 3LL * w) * sizeof(int)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cc_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n, 1);
  cfg.blockDim = dim3(kCCThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cc_cluster, mask, init, out, h, w, rounds, pools_per_round,
                         rows_per);
  if (e != cudaSuccess) return (int)e;
  CPE_CHECK_LAUNCH();
  return 0;
}
