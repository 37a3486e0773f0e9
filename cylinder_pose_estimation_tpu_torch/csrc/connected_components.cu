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
// Capped scans (labels only; the TPU kernel's cap_axis / cap): the scan
// along the capped axis runs ceil(log2(min(n, cap))) Hillis-Steele steps,
// which take every in-mask pixel to the minimum of its run within
// reach = 2^steps - 1 pixels on each side (ops/frontend.cap_reach).  The
// kernels compute that by segmented block minima (below): O(1) a pixel
// after scans within blocks of reach + 1 pixels, up to the reach one pass
// takes (31 along W, 15 along H).  Past it every in-mask pixel walks its run
// (capped_min): on the detector's sparse masks a walk stops at the run's
// end, so its cost does not grow with the reach, while passes that add up
// to the reach measured slower (PERF.md section 6).  A capped call takes
// the large-frame route at every size (on the detector's masks that route
// measured faster for capped calls than the cluster kernel): along W the
// band kernel's row pass runs capped, in place, a warp per row
// (capped_row), or walks into its second buffer; along H a column pass over
// the state plane replaces the band kernel's column runs and the fix
// (cc_capped_cols_stream, or cc_capped_cols walking).
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
//
// Large frames: where even 8 CTAs cannot hold a mask's buffers (at the
// detector's half-res canvas from 720x1280 on, with two channels from
// 600x800 on, and every full-resolution 480x640 mask), the wrapper's plan
// picks the global route at the end of this file.  It is bound by memory as
// well: each round must read the state once and write it once (at
// (64, 480, 640) one channel plane is 78.6 MB, past the 50 MB L2).  A first
// version ran one launch per pass and walked each column with one thread
// over the full height, ~2h dependent loads per thread on 10 warps per SM or
// fewer: latency-bound, 1.5-4% of the byte bound.  The band design keeps a
// round in one pass over the planes: each CTA holds a band of rows with a
// halo of `pools` rows in shared memory, runs the pools, the row runs and
// its band's column runs there, and a small edge table joins the runs that
// cross bands (the cluster kernel's scheme, with device memory in place of
// distributed shared memory).  Column walks shrink from 2h steps to 2
// band_rows steps on n x bands x w threads.

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

// Row run pass of channel c over one row of w pixels, by one warp, in steps
// of 32 x kSeg pixels, each lane on kSeg consecutive pixels in registers.  A
// lane's (extreme of the run touching its end, all in mask) pair goes through
// a segmented warp scan to give the next lane its carry; the step's carry
// goes on to the next.  Forward, then back on the forward extremes.
__device__ __forceinline__ void row_runs(int c, int b, int* row, int w, int lane) {
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

// ---------------------------------------------------------------------------
// Capped scans by segmented block minima (labels only).
//
// Reach r = 2^k - 1 (ops/frontend.cap_reach): every in-mask pixel j of a line
// takes the minimum over its run and [j - r, j + r], as min(left, right) of
// the one-sided windows [j - r, j] and [j, j + r].  The line is cut into
// blocks of L = r + 1 pixels, aligned on multiples of L.  In each block:
//   P[i]: the minimum from i back to max(block start, run start), with the
//         flag "reaches the block start";
//   S[i]: the minimum from i on to min(block end, run end), with the flag
//         "reaches the block end"
// (background: big, no flag; the flag in bit 31, which labels < 2^31 leave
// free).  A one-sided window of L pixels spans at most two blocks, so
//   left(j)  = P[j], joined, if P[j] reaches its block start, with S[j - r]
//              where that reaches its block end (the run covers j - r) and
//              else with P[block start - 1] (the run's part in the block
//              before: empty for background);
//   right(j) = S[j], joined, if S[j] reaches its block end, with P[j + r]
//              where that reaches its block start and else with
//              S[block end + 1]
// with pixels past either end of the line as background.  O(1) per pixel
// after the scans, and exact: min is exact in any order.
// tests/test_torch_capped_blocks.py holds a numpy model of these steps, at
// the kernels' blocks, chunks and strips, to the plain version.
// ---------------------------------------------------------------------------

constexpr unsigned kReachFlag = 0x80000000u;

__device__ __forceinline__ int bm_val(unsigned e) { return (int)(e & ~kReachFlag); }
__device__ __forceinline__ bool bm_reaches(unsigned e) { return (e & kReachFlag) != 0u; }

// One step of a P (forward) or S (backward) scan at a pixel of value v; edge:
// the pixel starts (P) or ends (S) its block.  cur / fl: the running minimum
// and its flag.
__device__ __forceinline__ unsigned bm_step(int v, bool edge, int big, int& cur, bool& fl) {
  if (edge) {
    cur = big;
    fl = true;
  }
  if (v == big) {
    cur = big;
    fl = false;
    return (unsigned)big;
  }
  cur = min(cur, v);
  return (unsigned)cur | (fl ? kReachFlag : 0u);
}

// The capped minimum of pixel j from P[j], S[j], S[j - r], P[block start - 1],
// P[j + r] and S[block end + 1].
__device__ __forceinline__ int bm_combine(unsigned pj, unsigned sj, unsigned s_back, unsigned p_prev,
                                          unsigned p_fwd, unsigned s_next) {
  int left = bm_val(pj);
  int right = bm_val(sj);
  if (bm_reaches(pj)) left = min(left, bm_reaches(s_back) ? bm_val(s_back) : bm_val(p_prev));
  if (bm_reaches(sj)) right = min(right, bm_reaches(p_fwd) ? bm_val(p_fwd) : bm_val(s_next));
  return min(left, right);
}

// Bits lo .. hi of m all set (0 <= lo <= hi <= 31).
__device__ __forceinline__ bool bits_set(unsigned m, int lo, int hi) {
  const unsigned want = (kFull >> (31 - (hi - lo))) << lo;
  return (m & want) == want;
}

// P and S of one 32-pixel chunk of a row from its values v (lane = pixel;
// past the row: background) and their in-mask ballot m, blocks of
// L = 2^kLog <= 32 pixels, so a chunk holds whole blocks: segmented warp
// scans of kLog steps within each block.
template <int kLog>
__device__ __forceinline__ void bm_chunk(int v, unsigned m, int big, int lane, unsigned& p, unsigned& s) {
  constexpr int L = 1 << kLog;
  const int b0 = lane & ~(L - 1);
  const int b1 = b0 + L - 1;
  int fwd = v, bwd = v;
#pragma unroll
  for (int d = 1; d < L; d *= 2) {
    const int up = __shfl_up_sync(kFull, fwd, d, L);
    const int dn = __shfl_down_sync(kFull, bwd, d, L);
    if (lane - d >= b0 && bits_set(m, lane - d, lane)) fwd = min(fwd, up);
    if (lane + d <= b1 && bits_set(m, lane, lane + d)) bwd = min(bwd, dn);
  }
  const bool in = v != big;
  p = (unsigned)fwd | (in && bits_set(m, b0, lane) ? kReachFlag : 0u);
  s = (unsigned)bwd | (in && bits_set(m, lane, b1) ? kReachFlag : 0u);
}

// One capped pass of reach 2^kLog - 1 over a row of n pixels in shared
// memory, in place, by one warp: P and S of the chunks before, at and after
// the one being finished stay in registers, and the six entries of each
// pixel come by shuffles.  A chunk's results are written after the next
// chunk is read, so no pixel is read after it is rewritten.  The masks are
// sparse (a few percent of a line, in runs of a few pixels), so a chunk
// with no in-mask pixel costs one load and one ballot: its P and S are the
// background, and it has nothing to write.  Kept out of line: each reach's
// pass has its own registers.
template <int kLog>
__device__ __noinline__ void capped_row_pass(int* row, int n, int big, int lane) {
  constexpr int L = 1 << kLog;
  constexpr int R = L - 1;
  const int b0 = lane & ~(L - 1);
  unsigned pp = big, sp = big, pc = big, sc = big, pn, sn;
  const int v0 = lane < n ? row[lane] : big;
  unsigned mc = __ballot_sync(kFull, v0 != big);
  if (mc) bm_chunk<kLog>(v0, mc, big, lane, pc, sc);
  for (int x0 = 0; x0 < n; x0 += 32) {
    const int vn = x0 + 32 + lane < n ? row[x0 + 32 + lane] : big;
    const unsigned mn = __ballot_sync(kFull, vn != big);
    pn = sn = big;
    if (mn) bm_chunk<kLog>(vn, mn, big, lane, pn, sn);
    if (mc) {
      const unsigned sb_c = __shfl_sync(kFull, sc, (lane - R) & 31);
      const unsigned sb_p = __shfl_sync(kFull, sp, (lane - R) & 31);
      const unsigned pv_c = __shfl_sync(kFull, pc, (b0 - 1) & 31);
      const unsigned pv_p = __shfl_sync(kFull, pp, 31);
      const unsigned pf_c = __shfl_sync(kFull, pc, (lane + R) & 31);
      const unsigned pf_n = __shfl_sync(kFull, pn, (lane + R) & 31);
      const unsigned sn_c = __shfl_sync(kFull, sc, (b0 + L) & 31);
      const unsigned sn_n = __shfl_sync(kFull, sn, 0);
      if (bm_val(pc) != big)
        row[x0 + lane] = bm_combine(pc, sc, lane >= R ? sb_c : sb_p, b0 > 0 ? pv_c : pv_p,
                                    lane + R < 32 ? pf_c : pf_n, b0 + L < 32 ? sn_c : sn_n);
    }
    pp = pc;
    sp = sc;
    pc = pn;
    sc = sn;
    mc = mn;
  }
  __syncwarp();
}

// The capped scan of reach `reach` (at most kRowPassReach) along a row of n
// pixels in shared memory, in place, by one warp.
constexpr int kRowPassReach = 31;

__device__ void capped_row(int* row, int n, int reach, int big, int lane) {
  switch (reach) {
    case 0: break;
    case 1: capped_row_pass<1>(row, n, big, lane); break;
    case 3: capped_row_pass<2>(row, n, big, lane); break;
    case 7: capped_row_pass<3>(row, n, big, lane); break;
    case 15: capped_row_pass<4>(row, n, big, lane); break;
    default: capped_row_pass<5>(row, n, big, lane); break;
  }
}

// The capped scan of one in-mask pixel from its value v by a walk: the
// minimum of v and its run's pixels at most `reach` steps away, at(j)
// giving the j-th pixel along the axis (j in [lo, hi)); the background ends
// the run.
template <typename At>
__device__ __forceinline__ int capped_min(int v, int j, int lo, int hi, int reach, int big, At at) {
  int m = v;
  for (int d = 1; d <= reach && j - d >= lo; ++d) {
    const int u = at(j - d);
    if (u == big) break;
    m = min(m, u);
  }
  for (int d = 1; d <= reach && j + d < hi; ++d) {
    const int u = at(j + d);
    if (u == big) break;
    m = min(m, u);
  }
  return m;
}

// The capped scan of reach 2^kLog - 1 along one column of a (h, w) plane in
// device memory by one thread, streaming: the outputs of rows [y0, y1) from
// rows [a0, a1) = [y0 - reach, y1 + reach) within the plane, read once each,
// block by block (L = 2^kLog rows, up to 16 loads in flight); P and S of
// the blocks before, at and after the one being finished stay in registers
// (5 L of them), so every entry has a constant index.  A block with no
// in-mask pixel is not scanned, and only in-mask outputs are written unless
// `dense` (see cc_capped_cols_stream).
template <int kLog>
__device__ __forceinline__ void capped_column_stream(const int* __restrict__ col, int* __restrict__ out, int w, int a0,
                                                     int y0, int y1, int a1, int big, bool dense) {
  constexpr int L = 1 << kLog;
  unsigned s_prev[L], p_cur[L], s_cur[L], p_next[L], s_next[L];
  unsigned p_prev_end = big;
  // Load block k's rows (past [a0, a1): background) and scan them.
  auto scan = [&](int k, unsigned (&p)[L], unsigned (&s)[L]) {
    int v[L];
    bool any = false;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const int y = k * L + t;
      v[t] = y >= a0 && y < a1 ? col[(size_t)y * w] : big;
      any = any || v[t] != big;
    }
    if (!any) {
#pragma unroll
      for (int t = 0; t < L; ++t) p[t] = s[t] = big;
      return false;
    }
    int cur = big;
    bool fl = true;
#pragma unroll
    for (int t = 0; t < L; ++t) p[t] = bm_step(v[t], false, big, cur, fl);
    cur = big;
    fl = true;
#pragma unroll
    for (int t = L - 1; t >= 0; --t) s[t] = bm_step(v[t], false, big, cur, fl);
    return true;
  };
#pragma unroll
  for (int t = 0; t < L; ++t) s_prev[t] = big;
  const int k0 = y0 >> kLog;
  const int k1 = (y1 - 1) >> kLog;
  // The block before the first output block: P at its end and its S.
  if (k0 > 0 && (k0 << kLog) > a0) {
    unsigned p_tmp[L];
    scan(k0 - 1, p_tmp, s_prev);
    p_prev_end = p_tmp[L - 1];
  }
  bool any_cur = scan(k0, p_cur, s_cur);
  for (int k = k0; k <= k1; ++k) {
    const bool any_next = scan(k + 1, p_next, s_next);
    if (any_cur || dense) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const int j = k * L + t;
        const bool in = bm_val(p_cur[t]) != big;
        if (j >= y0 && j < y1 && (in || dense))
          out[(size_t)j * w] = in ? bm_combine(p_cur[t], s_cur[t], t == L - 1 ? s_cur[0] : s_prev[t + 1], p_prev_end,
                                               t == 0 ? p_cur[L - 1] : p_next[t - 1], s_next[0])
                                  : big;
      }
    }
    p_prev_end = p_cur[L - 1];
#pragma unroll
    for (int t = 0; t < L; ++t) {
      s_prev[t] = s_cur[t];
      p_cur[t] = p_next[t];
      s_cur[t] = s_next[t];
    }
    any_cur = any_next;
  }
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

    // Row run pass: one warp per row (row_runs).
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      for (int ly = warp; ly < nr; ly += nwarps) row_runs(c, bg[c], buf(c, cur) + ly * w, w, lane);
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

// A cap the kernels take: none (-1), or along H (0) or W (1) with a reach of
// 2^k - 1 (k >= 0), for labels only.
inline bool cap_ok(int kch, int cap_axis, int reach) {
  return cap_axis == -1 || (kch == 1 && (cap_axis == 0 || cap_axis == 1) && reach >= 0 && (reach & (reach + 1)) == 0);
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

// ---------------------------------------------------------------------------
// The large-frame route, for masks whose buffers do not fit in one cluster's
// shared memory: the same schedule in bands of band_rows rows at full width,
// two launches per round.
//  * cc_band: one CTA per (mask, band) loads the band's rows of the exact
//    state (round 1: the start values from the mask and src) with a halo of
//    `pools` rows on each side into shared memory, runs the round's Jacobi
//    pools there (the rows it can trust shrink by one per pool, so after the
//    pools the band's own rows are exact), then the row runs (row_runs) and
//    the column runs over the band's rows.  It writes the band and, per
//    column, the edge tables: per channel the extreme of the run touching
//    the band's top and bottom edges, and the two runs' lengths in rows (the
//    band's height: the whole column segment is one run).
//  * cc_fix: one thread per (mask, band, column) finishes the runs that
//    cross band edges, as the cluster kernel joins its CTAs: it walks up
//    (down) over the other bands' edge entries while they stay in the mask
//    and are one run, and rewrites its band's edge runs in place.  The state
//    is then exact, and the next round's halos read it.
// A capped scan along W runs in cc_band in the row run pass's place, in
// place (capped_row); one along H replaces cc_band's column runs and cc_fix
// with cc_capped_cols_stream, passes over the state plane in device memory.
// Where two buffers per channel and the halo leave fewer than max(pools, 1)
// rows of a band (masks some thousands of pixels wide), the pools run as one
// launch each on device-memory planes (cc_global_pool) and the band kernel
// runs the row and column runs only (the plan's "fused" false).  The state
// lives in the output and a scratch plane per channel, ordered so that the
// last round writes the output.
// ---------------------------------------------------------------------------

constexpr int kGThreads = 256;

struct Planes {
  int* buf[2][2];  // [channel][buffer]
};

// The planes a band launch reads (unused in round 1 of the fused route) and
// writes, per channel.
struct BandIo {
  const int* in[2];
  int* out[2];
};

// The edge tables, per (mask, band) = blockIdx.x of cc_band, and side (0:
// top, 1: bottom): vals [mask, band][side][channel][w] holds the extreme of
// the run touching that edge (the channel's background where the edge pixel
// is out of the mask), lens [mask, band][side][w] that run's length in rows.
struct Edges {
  int* vals;
  int* lens;
};

__device__ __forceinline__ long long global_tid() { return (long long)blockIdx.x * kGThreads + threadIdx.x; }

template <int kCh>
__global__ void __launch_bounds__(kGThreads) cc_global_start(const float* __restrict__ mask,
                                                             const int* __restrict__ src, Planes p, int n,
                                                             int h, int w) {
  const long long i = global_tid();
  if (i >= (long long)n * h * w) return;
  const int hw = h * w;
  const int px = (int)(i % hw);
  const int y = px / w;
  const int x = px - y * w;
  const int bg[2] = {hw, -1};
  const bool in = y >= 1 && y < h - 1 && x >= 1 && x < w - 1 && mask[i] > 0.5f;
  const int s = src ? src[i] : hw;
  const int v0 = kCh == 1 ? min(s, px) : s;
#pragma unroll
  for (int c = 0; c < kCh; ++c) p.buf[c][0][i] = p.buf[c][1][i] = in ? v0 : bg[c];
}

template <int kCh>
__global__ void __launch_bounds__(kGThreads) cc_global_pool(Planes p, int cur, int n, int h, int w) {
  const long long i = global_tid();
  if (i >= (long long)n * h * w || p.buf[0][cur][i] == h * w) return;  // background stays
  // In-mask pixels lie inside the ring: their 8 neighbours are in the image.
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int* mid = p.buf[c][cur] + i;
    const int* up = mid - w;
    const int* dn = mid + w;
    int v = comb(c, mid[0], comb(c, mid[-1], mid[1]));
    v = comb(c, v, comb(c, up[-1], comb(c, up[0], up[1])));
    v = comb(c, v, comb(c, dn[-1], comb(c, dn[0], dn[1])));
    p.buf[c][cur ^ 1][i] = v;
  }
}

// Shared ints: per channel nbuf buffers (band_buffers: 2 with pools, for the
// Jacobi passes, or for a walk along W; else 1) of (band_rows + 2 pools) x w.
__host__ __device__ inline int band_buffers(int pools, bool row_walk) { return pools > 0 || row_walk ? 2 : 1; }

template <int kCh, int kCap>
__global__ void __launch_bounds__(kCCThreads, 1) cc_band(const float* __restrict__ mask,
                                                        const int* __restrict__ src, BandIo io, Edges e,
                                                        int h, int w, int bands, int band_rows, int pools,
                                                        int first, int reach) {
  static_assert(kCap == -1 || (kCh == 1 && (kCap == 0 || kCap == 1)), "capped scans take labels only");
  extern __shared__ int smem_band[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = kCCThreads / 32;
  const int img = blockIdx.x / bands;
  const int y0 = (blockIdx.x - img * bands) * band_rows;
  const int nr = min(band_rows, h - y0);            // the band's rows
  const int ly0 = max(y0 - pools, 0);               // the first loaded row
  const int n_px = (min(y0 + nr + pools, h) - ly0) * w;
  const int off = (y0 - ly0) * w;                   // the band's first pixel in a buffer
  const int hw = h * w;
  const int big = hw;
  const int bg[2] = {big, -1};
  const int nbuf = band_buffers(pools, kCap == 1 && reach > kRowPassReach);
  const int buf_len = (band_rows + 2 * pools) * w;
  auto buf = [&](int c, int b) { return smem_band + (nbuf * c + b) * buf_len; };
  const size_t base = (size_t)img * hw + (size_t)ly0 * w;

  // Round 1's pixel (y, x), stepped kCCThreads pixels at a time without a
  // division per pixel.
  const int step_y = kCCThreads / w;
  const int step_x = kCCThreads - step_y * w;
  int y = ly0 + tid / w;
  int x = tid % w;
  for (int i0 = tid; i0 < n_px; i0 += kIlp * kCCThreads) {
    int v[kCh][kIlp];
    if (first) {
      float mv[kIlp];
      int sv[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int i = i0 + u * kCCThreads;
        mv[u] = i < n_px ? mask[base + i] : 0.0f;
        sv[u] = (src && i < n_px) ? src[base + i] : big;
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const bool in = y >= 1 && y < h - 1 && x >= 1 && x < w - 1 && mv[u] > 0.5f;
        const int v0 = kCh == 1 ? min(sv[u], y * w + x) : sv[u];
        y += step_y;
        x += step_x;
        if (x >= w) {
          x -= w;
          ++y;
        }
#pragma unroll
        for (int c = 0; c < kCh; ++c) v[c][u] = in ? v0 : bg[c];
      }
    } else {
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int i = i0 + u * kCCThreads;
#pragma unroll
        for (int c = 0; c < kCh; ++c) v[c][u] = i < n_px ? io.in[c][base + i] : bg[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int i = i0 + u * kCCThreads;
      if (i < n_px) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          buf(c, 0)[i] = v[c][u];
          if (nbuf == 2) buf(c, 1)[i] = v[c][u];
        }
      }
    }
  }
  __syncthreads();

  // Jacobi pools over the loaded rows.  The first and last loaded rows lack
  // a neighbour row and keep their loaded values; only halo rows read them.
  // Background pixels hold their background in both buffers from the load.
  int cur = 0;
  for (int q = 0; q < pools; ++q) {
#pragma unroll 4
    for (int i = w + tid; i < n_px - w; i += kCCThreads) {
      if (buf(0, cur)[i] != big) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          const int* mid = buf(c, cur) + i;
          const int* up = mid - w;
          const int* dn = mid + w;
          int v = comb(c, mid[0], comb(c, mid[-1], mid[1]));
          v = comb(c, v, comb(c, up[-1], comb(c, up[0], up[1])));
          v = comb(c, v, comb(c, dn[-1], comb(c, dn[0], dn[1])));
          buf(c, cur ^ 1)[i] = v;
        }
      }
    }
    cur ^= 1;
    __syncthreads();
  }

  if (kCap == 1 && reach <= kRowPassReach) {
    // Capped scan along W over the band's rows: one warp per row, in place
    // (capped_row).
    for (int ly = warp; ly < nr; ly += nwarps) capped_row(buf(0, cur) + off + ly * w, w, reach, big, lane);
  } else if (kCap == 1) {
    // Past one pass's reach: each in-mask pixel walks its run into the other
    // buffer (whose background pixels hold the background from the load).
    const int* lab = buf(0, cur);
    for (int i = off + tid; i < off + nr * w; i += kCCThreads) {
      const int v = lab[i];
      if (v != big) {
        const int x = (i - off) % w;
        const int* row = lab + (i - x);
        buf(0, cur ^ 1)[i] = capped_min(v, x, 0, w, reach, big, [&](int j) { return row[j]; });
      }
    }
    cur ^= 1;
  } else {
    // Row run pass over the band's rows: one warp per row (row_runs).
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      for (int ly = warp; ly < nr; ly += nwarps) row_runs(c, bg[c], buf(c, cur) + off + ly * w, w, lane);
  }
  __syncthreads();

  // Column run pass over the band's rows, then the edge tables (none with a
  // cap along H: cc_capped_cols_stream follows).
  const size_t edge = (size_t)blockIdx.x * 2;  // [mask, band][side 0]
  for (int x = tid; x < w && kCap != 0; x += kCCThreads) {
    int top = nr, bot = nr;  // lengths of the runs touching the top and bottom edges
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int b = bg[c];
      int* lab = buf(c, cur) + off + x;
      int run = b;
      for (int ly = 0; ly < nr; ++ly) {
        const int v = lab[ly * w];
        if (v != b) {
          run = comb(c, run, v);
          lab[ly * w] = run;
        } else {
          run = b;
          if (top == nr) top = ly;
        }
      }
      run = b;
      for (int ly = nr - 1; ly >= 0; --ly) {
        const int v = lab[ly * w];
        if (v != b) {
          run = comb(c, run, v);
          lab[ly * w] = run;
        } else {
          run = b;
          if (bot == nr) bot = nr - 1 - ly;
        }
      }
      e.vals[(edge * kCh + c) * w + x] = lab[0];
      e.vals[((edge + 1) * kCh + c) * w + x] = lab[(nr - 1) * w];
    }
    e.lens[edge * w + x] = top;
    e.lens[(edge + 1) * w + x] = bot;
  }
  __syncthreads();

  const size_t out = (size_t)img * hw + (size_t)y0 * w;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int* lab = buf(c, cur) + off;
    for (int i = tid; i < nr * w; i += kCCThreads) io.out[c][out + i] = lab[i];
  }
}

// Runs crossing band edges: one thread per (mask, band, column) walks up
// (down) while the neighbour's edge pixel is in the mask, past neighbours
// that are one run, then rewrites its own edge runs of io.out (in place:
// no other thread touches them).
template <int kCh>
__global__ void __launch_bounds__(kGThreads) cc_fix(BandIo io, Edges e, int n, int h, int w, int bands,
                                                    int band_rows) {
  const long long t = global_tid();
  if (t >= (long long)n * bands * w) return;
  const int x = (int)(t % w);
  const int mb = (int)(t / w);  // mask * bands + band
  const int band = mb % bands;
  const int m0 = mb - band;     // the mask's first band
  const int y0 = band * band_rows;
  const int nr = min(band_rows, h - y0);
  const int bg[2] = {h * w, -1};
  auto len = [&](int b, int side) { return e.lens[((size_t)(m0 + b) * 2 + side) * w + x]; };
  auto val = [&](int b, int side, int c) { return e.vals[(((size_t)(m0 + b) * 2 + side) * kCh + c) * w + x]; };
  auto rows = [&](int b) { return min(band_rows, h - b * band_rows); };
  const int top = len(band, 0);
  const int bot = len(band, 1);
  int up[kCh], dn[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) up[c] = dn[c] = bg[c];
  if (top > 0) {
    for (int b = band - 1; b >= 0; --b) {
      if (len(b, 1) == 0) break;
#pragma unroll
      for (int c = 0; c < kCh; ++c) up[c] = comb(c, up[c], val(b, 1, c));
      if (len(b, 0) < rows(b)) break;
    }
  }
  if (bot > 0) {
    for (int b = band + 1; b < bands; ++b) {
      if (len(b, 0) == 0) break;
#pragma unroll
      for (int c = 0; c < kCh; ++c) dn[c] = comb(c, dn[c], val(b, 0, c));
      if (len(b, 1) < rows(b)) break;
    }
  }
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    int* o = io.out[c] + (size_t)(mb / bands) * h * w + (size_t)y0 * w + x;
    const int vt = val(band, 0, c);
    const int vb = val(band, 1, c);
    if (top == nr) {  // one run: both carries reach every row
      const int v = comb(c, vt, comb(c, up[c], dn[c]));
      if (v != vt)
        for (int ly = 0; ly < nr; ++ly) o[(size_t)ly * w] = v;
    } else {
      const int a = comb(c, vt, up[c]);
      if (a != vt)
        for (int ly = 0; ly < top; ++ly) o[(size_t)ly * w] = a;
      const int z = comb(c, vb, dn[c]);
      if (z != vb)
        for (int ly = nr - bot; ly < nr; ++ly) o[(size_t)ly * w] = z;
    }
  }
}

// The capped scan along H of the (n, h, w) label plane `in` into `out`.
// Up to kCapStreamReach (cc_capped_cols_stream): one CTA per (strip of
// `strip` rows, kCapCols columns, mask), one thread per column, over the
// strip's rows and `reach` rows above and below it within the mask,
// streamed through registers block by block (capped_column_stream), each
// label read once for the strip and its halo.  Once both planes hold the
// background at every background pixel (cc_global_start writes both; the
// band kernel writes every pixel of its plane and the other passes keep
// it), only in-mask outputs are written; `dense` (the first round of the
// fused route, whose output plane nothing has written yet) writes every
// pixel.  Past it (cc_capped_cols): one thread per pixel walks its column's
// run (capped_min) and writes every pixel.
constexpr int kCapCols = 128;
constexpr int kCapStreamReach = 15;

template <int kLog>
__global__ void __launch_bounds__(kCapCols) cc_capped_cols_stream(const int* __restrict__ in, int* __restrict__ out,
                                                                  int h, int w, int strip, int dense) {
  const int x = blockIdx.x * kCapCols + threadIdx.x;
  if (x >= w) return;
  const int reach = (1 << kLog) - 1;
  const int y0 = blockIdx.y * strip;
  const int y1 = min(y0 + strip, h);
  const size_t img = (size_t)blockIdx.z * h * w;
  capped_column_stream<kLog>(in + img + x, out + img + x, w, max(y0 - reach, 0), y0, y1, min(y1 + reach, h), h * w,
                             dense != 0);
}

__global__ void __launch_bounds__(kGThreads) cc_capped_cols(const int* __restrict__ in, int* __restrict__ out,
                                                            int n, int h, int w, int reach) {
  const long long i = global_tid();
  if (i >= (long long)n * h * w) return;
  const int big = h * w;
  const int v = in[i];
  if (v == big) {
    out[i] = big;
    return;
  }
  const int y = (int)(i % big) / w;
  const int* col = in + (i - (long long)y * w);  // the column's top pixel
  out[i] = capped_min(v, y, 0, h, reach, big, [&](int j) { return col[(size_t)j * w]; });
}

inline unsigned blocks_for(long long threads) { return (unsigned)((threads + kGThreads - 1) / kGThreads); }

// outs: kCh output planes; scratch: kCh planes of n * h * w ints, then the
// edge tables, n * bands * w * (2 kCh + 2) ints.  The plan
// (ops/frontend.cc_plan) passes band_rows, fused and the shared bytes, and
// with a cap along H the column pass's strip rows; they must agree with
// cc_band's layout, or nothing launches.  Launches: fused, 2 per round (1
// with no round); else the start, then per round the pools, the band and
// the fix (with a cap along H: the column pass in the fix's place).
template <int kCh>
int launch_cc_global(const float* mask, const int* src, int* const* outs, int* scratch, int n, int h,
                     int w, int rounds, int pools, int band_rows, int fused, int smem_bytes, int cap_axis,
                     int reach, int cap_strip, cudaStream_t stream) {
  if (h < 1 || w < 1 || rounds < 0 || pools < 0 || band_rows < 1 || (long long)n * h * w >= (1LL << 31) ||
      !cap_ok(kCh, cap_axis, reach))
    return (int)cudaErrorInvalidValue;
  const int kp = fused ? pools : 0;  // pools inside the band kernel
  const bool row_walk = cap_axis == 1 && reach > kRowPassReach;
  if ((long long)smem_bytes != 4LL * kCh * band_buffers(kp, row_walk) * (band_rows + 2LL * kp) * w)
    return (int)cudaErrorInvalidValue;
  if (cap_axis == 0 ? cap_strip < 1 : cap_strip != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long px = (long long)n * h * w;
  const int bands = (h + band_rows - 1) / band_rows;
  // Buffer swaps per round: the pools unfused, the band kernel, and the
  // capped column pass.
  const int flips = (fused ? 0 : pools) + 1 + (cap_axis == 0 ? 1 : 0);
  const int last = (int)(((long long)rounds * flips) & 1);
  Planes p = {};
  for (int c = 0; c < kCh; ++c) {
    p.buf[c][last] = outs[c];
    p.buf[c][last ^ 1] = scratch + c * px;
  }
  const Edges e = {scratch + kCh * px, scratch + kCh * px + 2LL * kCh * n * bands * w};
  if (!fused || rounds == 0) {
    cc_global_start<kCh><<<blocks_for(px), kGThreads, 0, stream>>>(mask, src, p, n, h, w);
    CPE_CHECK_LAUNCH();
  }
  if (rounds == 0) return 0;
  void (*band)(const float*, const int*, BandIo, Edges, int, int, int, int, int, int, int) =
      cap_axis == 0 ? cc_band<1, 0> : cap_axis == 1 ? cc_band<1, 1> : cc_band<kCh, -1>;
  cudaError_t err = cudaFuncSetAttribute(band, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int cur = 0;
  for (int r = 0; r < rounds; ++r) {
    for (int q = 0; q < pools - kp; ++q) {
      cc_global_pool<kCh><<<blocks_for(px), kGThreads, 0, stream>>>(p, cur, n, h, w);
      CPE_CHECK_LAUNCH();
      cur ^= 1;
    }
    BandIo io = {};
    for (int c = 0; c < kCh; ++c) {
      io.in[c] = p.buf[c][cur];
      io.out[c] = p.buf[c][cur ^ 1];
    }
    band<<<(unsigned)(n * bands), kCCThreads, smem_bytes, stream>>>(mask, src, io, e, h, w, bands, band_rows, kp,
                                                                     fused && r == 0, reach);
    CPE_CHECK_LAUNCH();
    cur ^= 1;
    if (cap_axis == 0) {
      const dim3 grid((w + kCapCols - 1) / kCapCols, (h + cap_strip - 1) / cap_strip, n);
      const int* src_plane = p.buf[0][cur];
      int* dst_plane = p.buf[0][cur ^ 1];
      const int dense = fused && r == 0;
      switch (reach) {
        case 0: cc_capped_cols_stream<0><<<grid, kCapCols, 0, stream>>>(src_plane, dst_plane, h, w, cap_strip, dense); break;
        case 1: cc_capped_cols_stream<1><<<grid, kCapCols, 0, stream>>>(src_plane, dst_plane, h, w, cap_strip, dense); break;
        case 3: cc_capped_cols_stream<2><<<grid, kCapCols, 0, stream>>>(src_plane, dst_plane, h, w, cap_strip, dense); break;
        case 7: cc_capped_cols_stream<3><<<grid, kCapCols, 0, stream>>>(src_plane, dst_plane, h, w, cap_strip, dense); break;
        case 15: cc_capped_cols_stream<4><<<grid, kCapCols, 0, stream>>>(src_plane, dst_plane, h, w, cap_strip, dense); break;
        default: cc_capped_cols<<<blocks_for(px), kGThreads, 0, stream>>>(src_plane, dst_plane, n, h, w, reach);
      }
      CPE_CHECK_LAUNCH();
      cur ^= 1;
    } else {
      cc_fix<kCh><<<blocks_for((long long)n * bands * w), kGThreads, 0, stream>>>(io, e, n, h, w, bands,
                                                                                 band_rows);
      CPE_CHECK_LAUNCH();
    }
  }
  return 0;
}

}  // namespace

// labels (out): (N, H, W) int32; init may be null (cold start).  The
// wrapper's plan (ops/frontend.cc_plan) passes the cluster size, the rows
// per CTA and the shared bytes; they must agree with this kernel's layout,
// or nothing launches.  A capped scan takes the large-frame route.
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

// The large-frame route of cpe_connected_components (cc_plan's "global"
// plan): scratch holds one (N, H, W) int32 plane and the edge tables
// (plan["scratch_ints"]); band_rows, fused and smem_bytes come from the plan,
// cap_axis and reach from the plan's "cap_axis" and "cap_reach" (-1, -1
// without a cap), cap_strip from its "cap_strip" (0 without a cap along H).
CPE_API int cpe_connected_components_global(const float* mask, const int* init, int* out, int* scratch,
                                            int n, int h, int w, int rounds, int pools_per_round,
                                            int band_rows, int fused, int smem_bytes, int cap_axis, int reach,
                                            int cap_strip, cudaStream_t stream) {
  int* outs[1] = {out};
  return launch_cc_global<1>(mask, init, outs, scratch, n, h, w, rounds, pools_per_round, band_rows, fused,
                             smem_bytes, cap_axis, reach, cap_strip, stream);
}

// The large-frame route of cpe_component_payload_minmax: scratch holds two
// (N, H, W) int32 planes and the edge tables.  cap_axis and reach must be -1,
// cap_strip 0 (the labels' entry's signature: the payload has no capped
// scan).
CPE_API int cpe_component_payload_minmax_global(const float* mask, const int* payload, int* pmin,
                                                int* pmax, int* scratch, int n, int h, int w, int rounds,
                                                int pools_per_round, int band_rows, int fused,
                                                int smem_bytes, int cap_axis, int reach, int cap_strip,
                                                cudaStream_t stream) {
  if (!payload) return (int)cudaErrorInvalidValue;
  int* outs[2] = {pmin, pmax};
  return launch_cc_global<2>(mask, payload, outs, scratch, n, h, w, rounds, pools_per_round, band_rows, fused,
                             smem_bytes, cap_axis, reach, cap_strip, stream);
}
