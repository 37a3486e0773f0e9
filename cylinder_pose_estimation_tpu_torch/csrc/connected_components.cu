// 8-connected component labels of a batch of (N, H, W) masks on an exact
// round schedule, and the per-component minimum and maximum of a payload on
// the same schedule: one kernel with one or two channels.
//
// Replaces the TPU kernels cylinder_pose_estimation_tpu/ops/pallas/frontend.py
// connected_components (_cc_kernel, _seg_min_scan_roll) and
// component_payload_minmax (_cc_payload_minmax_kernel, _seg_max_scan_roll).
// Each channel starts from a value per in-mask pixel and a background value
// (a 1-px ring is forced out of the mask):
//   labels (1 channel):  min(init, idx), background H*W, min;
//   payload (2 channels): lo = payload, background H*W, min;
//                         hi = payload, background -1, max.
// Per round: pools_per_round masked 3x3 pools, each JACOBI (reads the
// previous buffers, writes the others: never in place), then a row run pass
// (every in-mask pixel takes the extreme over its contiguous in-mask run of
// the row), then the same along columns.  The number of rounds is exact: the
// output may be unconverged on purpose, and the detector reads it as it is.
// In-mask values are never the background (labels and payloads lie in
// [0, H*W)), so each channel tells the mask from its own values.
//
// Bound: memory.  The function reads the mask (and the warm start or the
// payload) once and writes its channels once: 16.8, 47.2 and 70.8 MB at the
// detector's three CC sites, 94.4 MB for the payload at (64, 240, 384).
//
// Design: one launch per call, and the channels never leave the chip
// between rounds, as the TPU kept them in VMEM.  A mask's rows are split over
// a thread-block cluster of c CTAs (c in {1, 2, 4, 8}, the smallest whose
// two Jacobi buffers per channel fit in shared memory; the wrapper's plan
// picks it).  Pools read the neighbours' edge rows through distributed
// shared memory, and cluster.sync() separates passes; background pixels are
// skipped.  The row run pass is one warp per row: each lane walks 13
// consecutive pixels in registers (an odd stride: no bank conflicts), and a
// segmented scan over the lanes with shuffles joins the runs that cross
// lanes.  The column run pass walks each column of a CTA's rows forward and
// back; each CTA then publishes, per column and channel, the extreme of the
// runs touching its top and bottom edges, and whether its whole segment is
// one run, and every CTA finishes its edge runs from its neighbours' entries.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCCThreads = 1024;
constexpr int kIlp = 8;  // global loads in flight per thread while loading
constexpr int kSeg = 13;  // pixels per lane in a row scan step: odd, so the
                          // lanes' strided loads hit 32 distinct banks
constexpr unsigned kFull = 0xffffffffu;

// Channel 0 keeps minima, channel 1 maxima.
__device__ __forceinline__ int comb(int c, int a, int b) { return c ? max(a, b) : min(a, b); }

// The run extreme entering a lane's segment in a row scan step.  Each lane
// brings the extreme of the run touching its far end and whether its whole
// segment is in the mask; `carry` enters the step at lane 0 (forward) or
// lane 31 (backward).  A segmented scan over the lanes, then one shift.
__device__ __forceinline__ int carry_in(int c, int run, bool all, int carry, int lane, bool forward) {
  for (int d = 1; d < 32; d *= 2) {
    int ro = forward ? __shfl_up_sync(kFull, run, d) : __shfl_down_sync(kFull, run, d);
    bool ao = (forward ? __shfl_up_sync(kFull, (int)all, d) : __shfl_down_sync(kFull, (int)all, d)) != 0;
    if (forward ? lane >= d : lane + d < 32) {
      if (all) run = comb(c, run, ro);
      all = all && ao;
    }
  }
  if (all) run = comb(c, run, carry);  // the whole prefix is one run: the step's carry joins it
  int in = forward ? __shfl_up_sync(kFull, run, 1) : __shfl_down_sync(kFull, run, 1);
  return (forward ? lane == 0 : lane == 31) ? carry : in;
}

// Shared ints: per channel two buffers of rows_per x w, then per channel and
// column the top edge run's extreme and the bottom edge run's extreme, then
// per column the one-run flag.
// kCh 1: src is the warm start (may be null), out0 the labels.
// kCh 2: src is the payload, out0 / out1 its minima / maxima.
template <int kCh>
__global__ void __launch_bounds__(kCCThreads, 1) cc_cluster(
    const float* __restrict__ mask, const int* __restrict__ src, int* __restrict__ out0,
    int* __restrict__ out1, int h, int w, int rounds, int pools, int rows_per) {
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
  const int bg[2] = {big, -1};
  const int buf_len = rows_per * w;
  auto buf = [&](int c, int b) { return smem_cc + (2 * c + b) * buf_len; };
  int* top = smem_cc + 2 * kCh * buf_len;  // [channel][w]
  int* bot = top + kCh * w;                // [channel][w]
  int* one_run = bot + kCh * w;
  const size_t base = (size_t)(blockIdx.x / csize) * h * w + (size_t)r0 * w;
  const float* m = mask + base;
  const int* s = src ? src + base : nullptr;

  for (int i0 = tid; i0 < n_px; i0 += kIlp * kCCThreads) {
    float mv[kIlp];
    int sv[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      int i = i0 + u * kCCThreads;
      mv[u] = i < n_px ? m[i] : 0.0f;
      sv[u] = (s && i < n_px) ? s[i] : big;
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      int i = i0 + u * kCCThreads;
      int y = r0 + i / w;
      int x = i % w;
      bool in = y >= 1 && y < h - 1 && x >= 1 && x < w - 1 && mv[u] > 0.5f;
      if (i < n_px) {
        int v0 = kCh == 1 ? min(sv[u], y * w + x) : sv[u];
#pragma unroll
        for (int c = 0; c < kCh; ++c) buf(c, 0)[i] = buf(c, 1)[i] = in ? v0 : bg[c];
      }
    }
  }
  cluster.sync();

  int cur = 0;
  for (int round = 0; round < rounds; ++round) {
    for (int p = 0; p < pools; ++p) {
      // In-mask pixels lie inside the ring, so their edge rows' neighbours
      // exist in the neighbouring CTA.
      const int* above[kCh];
      const int* below[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        above[c] = rank > 0 ? cluster.map_shared_rank(buf(c, cur), rank - 1) + (rows_per - 1) * w
                            : nullptr;
        below[c] = rank < csize - 1 ? cluster.map_shared_rank(buf(c, cur), rank + 1) : nullptr;
      }
      // Background pixels hold their channel's background in both buffers
      // from the start and are never written again.
#pragma unroll 4
      for (int i = tid; i < n_px; i += kCCThreads) {
        if (buf(0, cur)[i] != big) {
          const int ly = i / w;
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const int* mid = buf(c, cur) + i;
            const int* up = ly > 0 ? mid - w : above[c] + (i - ly * w);
            const int* dn = ly < nr - 1 ? mid + w : below[c] + (i - ly * w);
            int v = comb(c, mid[0], comb(c, mid[-1], mid[1]));
            v = comb(c, v, comb(c, up[-1], comb(c, up[0], up[1])));
            v = comb(c, v, comb(c, dn[-1], comb(c, dn[0], dn[1])));
            buf(c, cur ^ 1)[i] = v;
          }
        }
      }
      cur ^= 1;
      cluster.sync();
    }

    // Row run pass: one warp per row, in steps of 32 x kSeg pixels, each
    // lane on kSeg consecutive pixels in registers.  A lane's (extreme of
    // the run touching its end, all in mask) pair goes through a segmented
    // warp scan to give the next lane its carry; the step's carry goes on to
    // the next.  Forward, then back on the forward extremes.
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int b = bg[c];
      for (int ly = warp; ly < nr; ly += nwarps) {
        int* row = buf(c, cur) + ly * w;
        int carry = b;
        for (int x0 = 0; x0 < w; x0 += 32 * kSeg) {
          const int xs = x0 + lane * kSeg;
          int v[kSeg];
#pragma unroll
          for (int k = 0; k < kSeg; ++k) v[k] = xs + k < w ? row[xs + k] : b;
          int run = b;
          bool all = true;
#pragma unroll
          for (int k = 0; k < kSeg; ++k) {
            run = v[k] != b ? comb(c, run, v[k]) : b;
            all = all && v[k] != b;
          }
          run = carry_in(c, run, all, carry, lane, true);
#pragma unroll
          for (int k = 0; k < kSeg; ++k) {
            run = v[k] != b ? comb(c, run, v[k]) : b;
            if (xs + k < w) row[xs + k] = run;
          }
          carry = __shfl_sync(kFull, run, 31);
        }
        carry = b;
        for (int x0 = ((w - 1) / (32 * kSeg)) * (32 * kSeg); x0 >= 0; x0 -= 32 * kSeg) {
          const int xs = x0 + lane * kSeg;
          int v[kSeg];
#pragma unroll
          for (int k = 0; k < kSeg; ++k) v[k] = xs + k < w ? row[xs + k] : b;
          int run = b;
          bool all = true;
#pragma unroll
          for (int k = kSeg - 1; k >= 0; --k) {
            run = v[k] != b ? comb(c, run, v[k]) : b;
            all = all && v[k] != b;
          }
          run = carry_in(c, run, all, carry, lane, false);
#pragma unroll
          for (int k = kSeg - 1; k >= 0; --k) {
            run = v[k] != b ? comb(c, run, v[k]) : b;
            if (xs + k < w) row[xs + k] = run;
          }
          carry = __shfl_sync(kFull, run, 0);
        }
      }
    }
    __syncthreads();

    // Column run pass within this CTA's rows, then the edge entries.
    for (int x = tid; x < w; x += kCCThreads) {
      bool all = true;
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const int b = bg[c];
        int* lab = buf(c, cur);
        int run = b;
        for (int ly = 0; ly < nr; ++ly) {
          int v = lab[ly * w + x];
          if (v != b) {
            run = comb(c, run, v);
            lab[ly * w + x] = run;
          } else {
            run = b;
            all = false;
          }
        }
        run = b;
        for (int ly = nr - 1; ly >= 0; --ly) {
          int v = lab[ly * w + x];
          if (v != b) {
            run = comb(c, run, v);
            lab[ly * w + x] = run;
          } else {
            run = b;
          }
        }
        top[c * w + x] = lab[x];
        bot[c * w + x] = lab[(nr - 1) * w + x];
      }
      one_run[x] = all ? 1 : 0;
    }
    cluster.sync();
    if (csize > 1) {
      for (int x = tid; x < w; x += kCCThreads) {
        // Runs crossing the CTA edges: walk up (down) while the neighbour's
        // edge pixel is in the mask, past neighbours that are one run.
        int up[kCh], dn[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c) up[c] = dn[c] = bg[c];
        if (top[x] != big) {
          for (int r = rank - 1; r >= 0; --r) {
            const int* e = cluster.map_shared_rank(bot, r);
            if (e[x] == big) break;
#pragma unroll
            for (int c = 0; c < kCh; ++c) up[c] = comb(c, up[c], e[c * w + x]);
            if (!cluster.map_shared_rank(one_run, r)[x]) break;
          }
        }
        if (bot[x] != big) {
          for (int r = rank + 1; r < csize; ++r) {
            const int* e = cluster.map_shared_rank(top, r);
            if (e[x] == big) break;
#pragma unroll
            for (int c = 0; c < kCh; ++c) dn[c] = comb(c, dn[c], e[c * w + x]);
            if (!cluster.map_shared_rank(one_run, r)[x]) break;
          }
        }
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          const int b = bg[c];
          int* lab = buf(c, cur);
          if (one_run[x]) {
            int v = comb(c, top[c * w + x], comb(c, up[c], dn[c]));
            for (int ly = 0; ly < nr; ++ly) lab[ly * w + x] = v;
          } else {
            if (up[c] != b)
              for (int ly = 0; ly < nr && lab[ly * w + x] != b; ++ly)
                lab[ly * w + x] = comb(c, lab[ly * w + x], up[c]);
            if (dn[c] != b)
              for (int ly = nr - 1; ly >= 0 && lab[ly * w + x] != b; --ly)
                lab[ly * w + x] = comb(c, lab[ly * w + x], dn[c]);
          }
        }
      }
    }
    cluster.sync();
  }

  int* outs[2] = {out0, out1};
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    int* o = outs[c] + base;
    const int* lab = buf(c, cur);
    for (int i = tid; i < n_px; i += kCCThreads) o[i] = lab[i];
  }
}

template <int kCh>
int launch_cc(const float* mask, const int* src, int* out0, int* out1, int n, int h, int w, int rounds,
              int pools, int cluster, int rows_per, int smem_bytes, cudaStream_t stream) {
  if (!cpe::cluster_size_ok(cluster) || rows_per < 1 || (long long)rows_per * cluster < h ||
      (long long)rows_per * (cluster - 1) >= h ||
      smem_bytes != (int)((2LL * kCh * rows_per * w + (2LL * kCh + 1) * w) * sizeof(int)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return cpe::launch_clusters(cc_cluster<kCh>, cluster, n, kCCThreads, smem_bytes, stream, mask, src,
                              out0, out1, h, w, rounds, pools, rows_per);
}

}  // namespace

// labels (out): (N, H, W) int32; init may be null (cold start).  The
// wrapper's plan (ops/frontend.cc_plan) passes the cluster size, the rows
// per CTA and the shared bytes; they must agree with this kernel's layout,
// or nothing launches.
CPE_API int cpe_connected_components(const float* mask, const int* init, int* out, int n, int h,
                                     int w, int rounds, int pools_per_round, int cluster,
                                     int rows_per, int smem_bytes, cudaStream_t stream) {
  return launch_cc<1>(mask, init, out, nullptr, n, h, w, rounds, pools_per_round, cluster, rows_per,
                      smem_bytes, stream);
}

// pmin, pmax (out): (N, H, W) int32 per-component minima and maxima of the
// (N, H, W) int32 payload, whose values lie in [0, H*W); background H*W and
// -1.  The plan is ops/frontend.cc_plan(..., channels=2).
CPE_API int cpe_component_payload_minmax(const float* mask, const int* payload, int* pmin, int* pmax,
                                         int n, int h, int w, int rounds, int pools_per_round,
                                         int cluster, int rows_per, int smem_bytes,
                                         cudaStream_t stream) {
  if (!payload) return (int)cudaErrorInvalidValue;
  return launch_cc<2>(mask, payload, pmin, pmax, n, h, w, rounds, pools_per_round, cluster, rows_per,
                      smem_bytes, stream);
}
