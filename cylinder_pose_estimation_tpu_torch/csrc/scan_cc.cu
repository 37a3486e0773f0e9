// Connected components of the XLA detection branch: ops/labeling.
// connected_components_plain, the JAX package's segmented-scan labelling,
// on (n, h, w) bool masks, bit for bit.
//
// Replaces no TPU kernel.  The JAX package writes each round as a masked
// 3x3 min-pool and forward and backward associative scans along rows and
// columns, which XLA fuses on the TPU; in plain PyTorch a round is ~71
// kernels over int64 keys, materialised transposes and flips, ~800 bytes a
// pixel, and the detector's three calls (8, 8 and 16 rounds) were ~2,270 of
// a B=16 batch step's kernel nodes.
//
// The round, as the plain version computes it, with simultaneous updates
// within each phase: labels start at the linear index in the mask and at
// h * w (the background) outside it; then
//   lab = where(mask, min over the 3x3 window of lab, bg)  (frame border ignored)
//   lab = where(mask, min over the pixel's in-mask run of its row, bg)
//   lab = where(mask, min over the pixel's in-mask run of its column, bg)
// exactly `iters` times, converged or not.  The plain pool's float32 detour
// is exact below 2^24, so an integer minimum is the same function.  Every
// label image after the first keeps lab < bg exactly on the mask, so only
// the first round reads the mask: later rounds take the mask from the labels.
//
// Bound: bytes.  A round reads and writes the int32 labels twice (16 bytes
// a pixel; the pool's neighbour rows come from L1/L2), the first round also
// reads the mask.  Compute is three short walks of shared memory a pixel.
//
// Design: two launches a round, int32 labels in global memory (the largest
// call site, (128, 240, 384), is 47 MB of labels).  Both find run minima
// the same way: a thread holds a segment of a line, summarises it (the
// minima of its leading and trailing runs, and whether the mask breaks in
// it), takes the minima of the runs that enter it from either side from
// its neighbours' summaries, then walks its segment forward and backward.
//   rows: a warp a row.  The 3x3 minimum is taken 32 pixels a step, left
//     to right, from the rows above and below (the neighbours along the row
//     by shuffles) into shared memory; then each lane takes a segment of
//     `seg` pixels (odd, so the lanes hit distinct banks), and the lanes'
//     summaries meet by shuffles.  Reads `src` (or the mask in the first
//     round) and writes `dst`: other warps read the row.
//   cols: a block per image and strip of `strip` columns holds the strip's h
//     rows in shared memory (row stride strip + 1), a thread a segment of a
//     column, the summaries through shared memory; the strip is written
//     back in place.
// The rounds alternate two buffers so that the last one lands in `out`.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// A thread's segment of a line: n values at p[0], p[step], ...; bg marks a
// pixel outside the mask.
struct Segment {
  int head;  // minimum of the leading in-mask run (bg: none)
  int tail;  // minimum of the trailing in-mask run (bg: none)
  bool brk;  // a pixel outside the mask
};

__device__ __forceinline__ Segment summarise(const int* p, int n, int step, int bg) {
  Segment s{bg, bg, false};
  for (int i = 0; i < n; ++i) {
    const int v = p[i * step];
    if (v < bg) {
      s.tail = min(s.tail, v);
      if (!s.brk) s.head = s.tail;
    } else {
      s.brk = true;
      s.tail = bg;
    }
  }
  return s;
}

// Each in-mask value of the segment becomes the minimum of its run, given
// the minima of the runs that enter the segment from before (`before`) and
// after it (`after`), bg for none: a forward walk gives the minimum from
// the run's start, and the backward walk over those gives the run's.
__device__ __forceinline__ void run_minima(int* p, int n, int step, int bg, int before, int after) {
  int run = before;
  for (int i = 0; i < n; ++i) {
    const int v = p[i * step];
    run = v < bg ? min(run, v) : bg;
    p[i * step] = run;
  }
  run = after;
  for (int i = n - 1; i >= 0; --i) {
    const int v = p[i * step];
    run = v < bg ? min(run, v) : bg;
    p[i * step] = run;
  }
}

// The label of pixel (r, x) of image `base` at the start of the round, bg
// outside the frame.  mode 2 reads `src`; modes 0 and 1 the initial labels.
__device__ __forceinline__ int label_at(const uint8_t* __restrict__ mask, const int* __restrict__ src, size_t base,
                                        int r, int x, int h, int w, int mode) {
  if (r < 0 || r >= h || x < 0 || x >= w) return h * w;
  const size_t p = base + (size_t)r * w + x;
  if (mode == 2) return src[p];
  return mask[p] ? r * w + x : h * w;
}

// Launch "rows": grid (ceil(h / kWarps), n), kThreads threads, kWarps * 32
// * seg ints of dynamic shared memory (seg: odd, 32 * seg >= w).  mode 0:
// write the initial labels alone (iters 0); 1: the first round, from the
// mask; 2: a later round, from src.
__global__ void __launch_bounds__(kThreads) scan_cc_rows(const uint8_t* __restrict__ mask,
                                                         const int* __restrict__ src, int* __restrict__ dst,
                                                         int h, int w, int mode, int seg) {
  extern __shared__ int rows_buf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= h) return;
  const int bg = h * w;
  const size_t base = (size_t)blockIdx.y * bg;
  int* out = dst + base + (size_t)r * w;
  const int chunks = (w + 31) / 32;
  if (mode == 0) {
    for (int c = 0; c < chunks; ++c) {
      const int x = c * 32 + lane;
      if (x < w) out[x] = label_at(mask, src, base, r, x, h, w, mode);
    }
    return;
  }
  int* buf = rows_buf + warp * 32 * seg;
  // The column minimum over rows r - 1 .. r + 1 at x, and the centre.
  auto column_min = [&](int x, int& centre) {
    centre = label_at(mask, src, base, r, x, h, w, mode);
    return min(centre, min(label_at(mask, src, base, r - 1, x, h, w, mode),
                           label_at(mask, src, base, r + 1, x, h, w, mode)));
  };
  int centre, vm = column_min(lane, centre);
  int prev = bg;
  for (int c = 0; c < chunks; ++c) {
    const int x = c * 32 + lane;
    int centre_next = bg, vm_next = bg;
    if (c + 1 < chunks) vm_next = column_min(x + 32, centre_next);
    int left = __shfl_up_sync(kFull, vm, 1);
    int right = __shfl_down_sync(kFull, vm, 1);
    const int next_first = __shfl_sync(kFull, vm_next, 0);
    const int last = __shfl_sync(kFull, vm, 31);
    if (lane == 0) left = prev;
    if (lane == 31) right = next_first;
    prev = last;
    if (x < w) buf[x] = centre < bg ? min(vm, min(left, right)) : bg;
    vm = vm_next;
    centre = centre_next;
  }
  for (int x = w + lane; x < 32 * seg; x += 32) buf[x] = bg;
  __syncwarp();
  // Lane l holds pixels l * seg ..; the runs entering its segment from the
  // left and right: inclusive scans of the lanes' summaries.
  int* mine = buf + lane * seg;
  const Segment g = summarise(mine, seg, 1, bg);
  int tail = g.tail, head = g.head, tail_brk = g.brk, head_brk = g.brk;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, tail, d), tb = __shfl_up_sync(kFull, tail_brk, d);
    const int hd = __shfl_down_sync(kFull, head, d), hb = __shfl_down_sync(kFull, head_brk, d);
    if (lane >= d) {
      if (!tail_brk) tail = min(tail, t);
      tail_brk |= tb;
    }
    if (lane + d < 32) {
      if (!head_brk) head = min(head, hd);
      head_brk |= hb;
    }
  }
  const int before = __shfl_up_sync(kFull, tail, 1), after = __shfl_down_sync(kFull, head, 1);
  run_minima(mine, seg, 1, bg, lane == 0 ? bg : before, lane == 31 ? bg : after);
  __syncwarp();
  for (int x = lane; x < w; x += 32) out[x] = buf[x];
}

// Launch "cols": grid (ceil(w / strip), n), kThreads threads, h * (strip +
// 1) + 3 * kThreads ints of dynamic shared memory; `lab` in place.  Thread
// t holds rows s * len .. of column t % strip, s = t / strip.
__global__ void __launch_bounds__(kThreads) scan_cc_cols(int* __restrict__ lab, int h, int w, int strip) {
  extern __shared__ int tile[];
  const int c0 = blockIdx.x * strip;
  const int cols = min(strip, w - c0);
  const int stride = strip + 1;
  const int bg = h * w;
  const int shift = __ffs(strip) - 1;
  int* img = lab + (size_t)blockIdx.y * bg + c0;
  for (int i = threadIdx.x; i < h * strip; i += kThreads) {
    const int r = i >> shift, j = i & (strip - 1);
    tile[r * stride + j] = j < cols ? img[(size_t)r * w + j] : bg;
  }
  const int segs = kThreads >> shift, len = (h + segs - 1) / segs;
  const int j = threadIdx.x & (strip - 1), s = threadIdx.x >> shift;
  const int r0 = min(h, s * len), n = min(h, r0 + len) - r0;
  int* mine = tile + r0 * stride + j;
  int* heads = tile + h * stride;
  int* tails = heads + kThreads;
  int* brks = tails + kThreads;
  __syncthreads();
  const Segment g = summarise(mine, j < cols ? n : 0, stride, bg);
  heads[threadIdx.x] = g.head;
  tails[threadIdx.x] = g.tail;
  brks[threadIdx.x] = g.brk;
  __syncthreads();
  int before = bg, after = bg;
  for (int q = s - 1; q >= 0; --q) {
    before = min(before, tails[q * strip + j]);
    if (brks[q * strip + j]) break;
  }
  for (int q = s + 1; q < segs; ++q) {
    after = min(after, heads[q * strip + j]);
    if (brks[q * strip + j]) break;
  }
  if (j < cols) run_minima(mine, n, stride, bg, before, after);
  __syncthreads();
  for (int i = threadIdx.x; i < h * strip; i += kThreads) {
    const int r = i >> shift, j = i & (strip - 1);
    if (j < cols) img[(size_t)r * w + j] = tile[r * stride + j];
  }
}

bool strip_ok(int s) { return s == 1 || s == 2 || s == 4 || s == 8 || s == 16 || s == 32; }

}  // namespace

// The labels of n (h, w) bool masks (one byte each) after `iters` rounds,
// into out (n, h, w) int32; scratch: a second (n, h, w) int32 buffer (may be
// null when iters < 2).  strip: the columns a block of the column launch
// holds (labeling.scan_cc_plan).  2 * iters launches (1 when iters is 0).
CPE_API int cpe_scan_cc(const void* mask, void* out, void* scratch, int n, int h, int w, int iters, int strip,
                        cudaStream_t stream) {
  if (n < 0 || n > 65535 || h < 1 || w < 1 || (long long)h * w >= (1LL << 24) || iters < 0 || !strip_ok(strip) ||
      (iters >= 2 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int seg = ((w + 31) / 32) | 1;
  const int row_smem = kWarps * 32 * seg * (int)sizeof(int);
  const int col_smem = (h * (strip + 1) + 3 * kThreads) * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(scan_cc_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, row_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(scan_cc_cols, cudaFuncAttributeMaxDynamicSharedMemorySize, col_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 row_grid((h + kWarps - 1) / kWarps, n), col_grid((w + strip - 1) / strip, n);
  const uint8_t* m = (const uint8_t*)mask;
  if (iters == 0) {
    scan_cc_rows<<<row_grid, kThreads, 0, stream>>>(m, nullptr, (int*)out, h, w, 0, seg);
    CPE_CHECK_LAUNCH();
    return 0;
  }
  int* bufs[2] = {(int*)out, (int*)scratch};
  for (int k = 1; k <= iters; ++k) {
    int* dst = bufs[(iters - k) & 1];
    const int* src = bufs[(iters - k + 1) & 1];
    scan_cc_rows<<<row_grid, kThreads, row_smem, stream>>>(m, k == 1 ? nullptr : src, dst, h, w,
                                                            k == 1 ? 1 : 2, seg);
    CPE_CHECK_LAUNCH();
    scan_cc_cols<<<col_grid, kThreads, col_smem, stream>>>(dst, h, w, strip);
    CPE_CHECK_LAUNCH();
  }
  return 0;
}
