// The kernel branch's banded separable correlations as tiled stencils:
// the composed-Gaussian smoothing before the preprocess kernel (S0) and the
// statistic images after it (T).
//
// Replaces no TPU kernel.  The JAX package writes these filters as dense
// products with banded W x W and H x H matrices (ops/mxu_conv.py: the TPU's
// matrix unit makes them cheap there), and ops/stencils.smooth_plain /
// stats_images_plain keep that code for CPU tensors.  On the card a dense
// product does W (or H) multiply-adds a pixel, 640 to 1920, where the bands
// hold at most 29 nonzero taps: ten such products a view were the largest
// block of the kernel branch's device time.
//
// Bound: memory.  S0 reads the grey plane and writes the smoothed one (8 B a
// pixel: 78.6 MB at (32, 480, 640), 0.023 ms at 3.35 TB/s); T reads gray,
// joints and the joint count and writes the saturation mask (bool), the
// index-brightness image and the two centroid images (float32), plus the
// centre-seed image when bright_at_points is False: 29 or 33 B a pixel.
// The arithmetic, 2 x 29 fused multiply-adds a pixel for S0 and about 110
// for T, stays below the byte bound.
//
// Design: each launch covers 2-D tiles (blockIdx.z = image, 32-bit index
// math inside an image).  A tile loads its source plane once, with the halo
// of its widest band, by asynchronous copies (zero outside the image, as
// the band matrices are zero past the border), runs the passes in shared
// memory over the band's taps only, and writes its outputs once.  Each
// thread keeps a run of kRun outputs of a line in registers and loads the
// run's window once; the radii of the detector's defaults are template
// parameters (S0: 14; T: 9, 3, 5, 5), every other radius takes a generic
// instantiation that reads its inputs tap by tap from shared memory.
//   S0 (smooth_zero): 64 x 128 output tiles, halo r; the pass along W over
//     the tile's rows and halo rows into shared memory, then the pass along
//     H from shared memory to the plane.
//   T (stats_tiles): 64 x 64 output tiles, a tile per source plane in one
//     launch (blockIdx.z < N: the grey plane; else the joints).  A grey
//     tile loads gray with the halo of the widest of its three bands and
//     makes the saturation blur, the index blur and (bright_at_points
//     False) the centre box along W into shared memory, then along H
//     straight to the saturation mask, the index-brightness and the
//     centre-seed images.  A joint tile loads the joints with the joint
//     window's halo and makes the ramp along W and the ramp along H, then
//     the box along H of the first and along W of the second, and combines
//     them with the joint count into the centroid images.
//
// Numerics: the route's, with only the summation order changed.  Each
// output is sum_t k[t] * x[i + t - r] (a correlation, the orientation of
// ops/mxu_conv.conv_x / conv_y), accumulated in tap order by fused
// multiply-adds as a matrix product's inner loop is.  S0 and the centre box
// keep float32 operands; the saturation blur, the index blur and the joint
// ramps and boxes round their inputs, their taps (the wrapper passes them
// rounded) and the intermediate between the two passes to bfloat16
// (round to nearest even), where conv_x / conv_y round them: a product of
// two bfloat16 values is exact in float32.  The joint sums are sums of
// integers, exact in any order, so the centroid images equal the matrix
// route's bit for bit; the rest differs from it by the summation order
// alone.  Built with --fmad=false: the centroid's cx * cnt + s and the
// divisions are the correctly rounded operations of the plain version.  A
// non-finite input pixel reaches only the outputs within its band (a dense
// product spreads 0 x inf over the whole row).

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;          // outputs of a line per thread in a pass
constexpr int kSmoothH = 64;     // S0 output tile (ops/stencils SMOOTH_TILE)
constexpr int kSmoothW = 128;
constexpr int kStatsTile = 64;   // T output tile, square (ops/stencils STATS_TILE)
constexpr int kMaxRadius = 31;   // ops/stencils MAX_RADIUS
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
// T's taps: the saturation blur, the index blur, the centre box, the joint
// ramp and the joint box.
constexpr int kStatsMaxTaps = 5 * kMaxTaps;
constexpr int kOutPitch = kStatsTile | 1;  // T's pass outputs: odd pitch
static_assert(kSmoothH % kRun == 0 && kSmoothW % kRun == 0 && kStatsTile % kRun == 0, "whole runs");

struct SmoothTaps {
  float k[kMaxTaps];
};

struct StatsTaps {
  float k[kStatsMaxTaps];
};

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Asynchronous 4-byte copies from device to shared memory (cp.async): a
// thread issues all of its share of a tile's loads before it waits.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The rows x cols window of plane `g` (h x w) whose corner is image pixel
// (gy0, gx0), into shared memory at `x` (pitch xp): zero outside the image.
__device__ __forceinline__ void load_window(const float* __restrict__ g, int h, int w, int gy0, int gx0, int rows,
                                            int cols, float* __restrict__ x, int xp) {
  int row = threadIdx.x / cols;
  int col = threadIdx.x % cols;
  const int step_row = kThreads / cols;
  const int step_col = kThreads % cols;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int gy = gy0 + row;
    const int gx = gx0 + col;
    float* d = x + row * xp + col;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      copy_async(d, g + gy * w + gx);
    else
      *d = 0.0f;
    row += step_row;
    col += step_col;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
  copy_async_wait();
  __syncthreads();
}

// One banded pass over a rows x cols output region: output (y, x) is
// acc = sum_t k[t] * q(in[y * ip + x + t]) along W, or
// q(in[(y + t) * ip + x]) along H, t = 0 .. 2r in order, by fused
// multiply-adds from 0; q rounds to bfloat16 when kRoundIn.  store(y, x,
// acc) takes each output.  R >= 0: the radius at compile time, each task a
// run of kRun outputs of a line (the run axis a multiple of kRun) with its
// window of kRun + 2R inputs in registers; along W a warp's tasks take
// consecutive rows (odd pitches: 32 banks), along H consecutive columns.
// R < 0: the generic instantiation, radius r at run time, one output a
// task, its inputs read tap by tap.
template <int R, bool kAlongW, bool kRoundIn, typename Store>
__device__ __forceinline__ void band_pass(const float* __restrict__ in, int ip, int rows, int cols,
                                          const float* __restrict__ k, int r, Store store) {
  const int lines = kAlongW ? rows : cols;
  const int step = kAlongW ? 1 : ip;
  if constexpr (R >= 0) {
    constexpr int nt = 2 * R + 1;
    constexpr int nv = kRun + 2 * R;
    float kr[nt];
#pragma unroll
    for (int t = 0; t < nt; ++t) kr[t] = k[t];
    const int tasks = lines * ((kAlongW ? cols : rows) / kRun);
    for (int task = threadIdx.x; task < tasks; task += kThreads) {
      const int line = task % lines;
      const int p0 = (task / lines) * kRun;
      const float* src = kAlongW ? in + line * ip + p0 : in + p0 * ip + line;
      float v[nv];
#pragma unroll
      for (int i = 0; i < nv; ++i) v[i] = kRoundIn ? bf16_round(src[i * step]) : src[i * step];
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < nt; ++t) acc = __fmaf_rn(kr[t], v[o + t], acc);
        if (kAlongW)
          store(line, p0 + o, acc);
        else
          store(p0 + o, line, acc);
      }
    }
  } else {
    const int nt = 2 * r + 1;
    for (int task = threadIdx.x; task < rows * cols; task += kThreads) {
      const int line = task % lines;
      const int pos = task / lines;
      const float* src = kAlongW ? in + line * ip + pos : in + pos * ip + line;
      float acc = 0.0f;
      for (int t = 0; t < nt; ++t) {
        const float x = src[t * step];
        acc = __fmaf_rn(k[t], kRoundIn ? bf16_round(x) : x, acc);
      }
      if (kAlongW)
        store(line, pos, acc);
      else
        store(pos, line, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// S0: zero-padded separable smoothing
// ---------------------------------------------------------------------------

// Shared-memory layout of S0 at radius r, in floats: X, the grey tile with
// its halo (rows xh, pitch xp), then A, the pass along W (xh rows of
// kSmoothW, pitch ap).  Odd pitches.
struct LayoutS0 {
  int xh, xw, xp, ap;
  __host__ __device__ explicit LayoutS0(int r) {
    xh = kSmoothH + 2 * r;
    xw = kSmoothW + 2 * r;
    xp = xw | 1;
    ap = kSmoothW | 1;
  }
  __host__ __device__ int a_off() const { return xh * xp; }
  __host__ __device__ int words() const { return a_off() + xh * ap; }
};

template <int R>
__global__ void __launch_bounds__(kThreads) smooth_zero(const float* __restrict__ gray, float* __restrict__ out,
                                                        int h, int w, int r, const __grid_constant__ SmoothTaps taps) {
  extern __shared__ float smem_s0[];
  if constexpr (R >= 0) r = R;
  const LayoutS0 L(r);
  float* X = smem_s0;
  float* A = smem_s0 + L.a_off();
  const int y0 = blockIdx.y * kSmoothH;
  const int x0 = blockIdx.x * kSmoothW;
  const size_t plane = (size_t)h * w;
  load_window(gray + blockIdx.z * plane, h, w, y0 - r, x0 - r, L.xh, L.xw, X, L.xp);
  band_pass<R, true, false>(X, L.xp, L.xh, kSmoothW, taps.k, r,
                            [&](int y, int x, float acc) { A[y * L.ap + x] = acc; });
  __syncthreads();
  float* o = out + blockIdx.z * plane;
  band_pass<R, false, false>(A, L.ap, kSmoothH, kSmoothW, taps.k, r, [&](int y, int x, float acc) {
    const int gy = y0 + y;
    const int gx = x0 + x;
    if (gy < h && gx < w) o[gy * w + gx] = acc;
  });
}

// ---------------------------------------------------------------------------
// T: the statistic images
// ---------------------------------------------------------------------------

// Shared-memory layout of T for radii rs (saturation blur), ri (index
// blur), rb (centre box; < 0: none) and rj (joint window), in floats.  A
// grey tile: G, gray with the halo R = max(rs, ri, rb) (gh rows and
// columns, pitch gp), then the passes along W of the three bands (their
// own halo rows, pitch kOutPitch).  A joint tile: J, the joints with the
// halo rj (jh rows and columns, pitch jp), then TX, the ramp along W (jh
// rows, pitch kOutPitch), then TY, the ramp along H (kStatsTile rows,
// pitch jp); the box along H of TX goes to J's place, the box along W of
// TY to TX's.  Both kinds use the larger of the two.
struct LayoutT {
  int rs, ri, rb, rj, halo, gh, gp, jh, jp;
  __host__ __device__ LayoutT(int rs_, int ri_, int rb_, int rj_) {
    rs = rs_;
    ri = ri_;
    rb = rb_;
    rj = rj_;
    halo = rs > ri ? rs : ri;
    if (rb > halo) halo = rb;
    gh = kStatsTile + 2 * halo;
    gp = gh | 1;
    jh = kStatsTile + 2 * rj;
    jp = jh | 1;
  }
  __host__ __device__ int sh_off() const { return gh * gp; }
  __host__ __device__ int ih_off() const { return sh_off() + (kStatsTile + 2 * rs) * kOutPitch; }
  __host__ __device__ int bh_off() const { return ih_off() + (kStatsTile + 2 * ri) * kOutPitch; }
  __host__ __device__ int grey_words() const {
    return bh_off() + (rb >= 0 ? (kStatsTile + 2 * rb) * kOutPitch : 0);
  }
  __host__ __device__ int tx_off() const { return jh * jp; }
  __host__ __device__ int ty_off() const { return tx_off() + jh * kOutPitch; }
  __host__ __device__ int joint_words() const { return ty_off() + kStatsTile * jp; }
  __host__ __device__ int words() const {
    return grey_words() > joint_words() ? grey_words() : joint_words();
  }
};

struct StatsArgs {
  const float* gray;
  const float* joints;
  const float* cnt;
  unsigned char* sat_mask;
  float* bright_blur;
  float* bright_center;  // null: bright_at_points
  float* cx;
  float* cy;
  float* sat;            // null, or the saturation blur before its threshold
  int n, h, w, margin;
  float sat_threshold;
  float center_area;     // (2 rb + 1)^2
};

template <int RS, int RI, int RB, int RJ>
__global__ void __launch_bounds__(kThreads) stats_tiles(const StatsArgs a, int rs, int ri, int rb, int rj,
                                                        const __grid_constant__ StatsTaps taps) {
  extern __shared__ float smem_t[];
  if constexpr (RS >= 0) {
    rs = RS;
    ri = RI;
    rj = RJ;
    if (rb >= 0) rb = RB;
  }
  const LayoutT L(rs, ri, rb, rj);
  const int h = a.h;
  const int w = a.w;
  const int y0 = blockIdx.y * kStatsTile;
  const int x0 = blockIdx.x * kStatsTile;
  const size_t plane = (size_t)h * w;
  const bool grey = (int)blockIdx.z < a.n;
  const size_t img = (grey ? blockIdx.z : blockIdx.z - a.n) * plane;
  const float* ks = taps.k;
  const float* ki = ks + 2 * rs + 1;
  const float* kb = ki + 2 * ri + 1;
  const float* jr = kb + (rb >= 0 ? 2 * rb + 1 : 0);
  const float* jb = jr + 2 * rj + 1;
  constexpr int T = kStatsTile;
  constexpr int P = kOutPitch;

  if (grey) {
    float* G = smem_t;
    float* SH = smem_t + L.sh_off();
    float* IH = smem_t + L.ih_off();
    float* BH = smem_t + L.bh_off();
    const int R = L.halo;
    load_window(a.gray + img, h, w, y0 - R, x0 - R, L.gh, L.gh, G, L.gp);
    band_pass<RS, true, true>(G + (R - rs) * L.gp + (R - rs), L.gp, T + 2 * rs, T, ks, rs,
                              [&](int y, int x, float acc) { SH[y * P + x] = bf16_round(acc); });
    band_pass<RI, true, true>(G + (R - ri) * L.gp + (R - ri), L.gp, T + 2 * ri, T, ki, ri,
                              [&](int y, int x, float acc) { IH[y * P + x] = bf16_round(acc); });
    if (rb >= 0)
      band_pass<RB, true, false>(G + (R - rb) * L.gp + (R - rb), L.gp, T + 2 * rb, T, kb, rb,
                                 [&](int y, int x, float acc) { BH[y * P + x] = acc; });
    __syncthreads();
    const int m = a.margin;
    band_pass<RS, false, false>(SH, P, T, T, ks, rs, [&](int y, int x, float acc) {
      const int gy = y0 + y;
      const int gx = x0 + x;
      if (gy >= h || gx >= w) return;
      const bool inside = gy >= m && gy < h - m && gx >= m && gx < w - m;
      a.sat_mask[img + gy * w + gx] = (acc > a.sat_threshold) && inside;
      if (a.sat) a.sat[img + gy * w + gx] = acc;
    });
    band_pass<RI, false, false>(IH, P, T, T, ki, ri, [&](int y, int x, float acc) {
      const int gy = y0 + y;
      const int gx = x0 + x;
      if (gy < h && gx < w) a.bright_blur[img + gy * w + gx] = acc;
    });
    if (rb >= 0)
      band_pass<RB, false, false>(BH, P, T, T, kb, rb, [&](int y, int x, float acc) {
        const int gy = y0 + y;
        const int gx = x0 + x;
        if (gy < h && gx < w) a.bright_center[img + gy * w + gx] = __fdiv_rn(acc, a.center_area);
      });
    return;
  }

  float* J = smem_t;
  float* TX = smem_t + L.tx_off();
  float* TY = smem_t + L.ty_off();
  float* SX = J;   // the box along H of TX, once J is read
  float* SY = TX;  // the box along W of TY, once TX is read
  load_window(a.joints + img, h, w, y0 - rj, x0 - rj, L.jh, L.jh, J, L.jp);
  band_pass<RJ, true, true>(J, L.jp, L.jh, T, jr, rj,
                            [&](int y, int x, float acc) { TX[y * P + x] = bf16_round(acc); });
  band_pass<RJ, false, true>(J, L.jp, T, L.jh, jr, rj,
                             [&](int y, int x, float acc) { TY[y * L.jp + x] = bf16_round(acc); });
  __syncthreads();
  band_pass<RJ, false, false>(TX, P, T, T, jb, rj, [&](int y, int x, float acc) { SX[y * P + x] = acc; });
  __syncthreads();
  band_pass<RJ, true, false>(TY, L.jp, T, T, jb, rj, [&](int y, int x, float acc) { SY[y * P + x] = acc; });
  __syncthreads();
  for (int i = threadIdx.x; i < T * T; i += kThreads) {
    const int gy = y0 + i / T;
    const int gx = x0 + i % T;
    if (gy >= h || gx >= w) continue;
    const size_t o = img + gy * w + gx;
    const float c = a.cnt[o];
    const float sx = __fadd_rn(__fmul_rn((float)gx, c), SX[(i / T) * P + i % T]);
    const float sy = __fadd_rn(__fmul_rn((float)gy, c), SY[(i / T) * P + i % T]);
    const float d = c < 1.0f ? 1.0f : c;  // torch.clamp(cnt, min=1): NaN passes
    a.cx[o] = floorf(__fdiv_rn(sx, d));
    a.cy[o] = floorf(__fdiv_rn(sy, d));
  }
}

template <int R>
int launch_smooth(dim3 grid, int smem, cudaStream_t stream, const float* in, float* out, int h, int w, int r,
                  const SmoothTaps& taps) {
  cudaError_t e = cudaFuncSetAttribute(smooth_zero<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  smooth_zero<R><<<grid, kThreads, smem, stream>>>(in, out, h, w, r, taps);
  CPE_CHECK_LAUNCH();
  return 0;
}

template <int RS, int RI, int RB, int RJ>
int launch_stats(dim3 grid, int smem, cudaStream_t stream, const StatsArgs& a, int rs, int ri, int rb, int rj,
                 const StatsTaps& taps) {
  cudaError_t e =
      cudaFuncSetAttribute(stats_tiles<RS, RI, RB, RJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  stats_tiles<RS, RI, RB, RJ><<<grid, kThreads, smem, stream>>>(a, rs, ri, rb, rj, taps);
  CPE_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// S0: (N, H, W) float32 grey images in, the zero-padded correlation with
// the 2 r + 1 taps at `host_taps` (HOST memory, copied into the launch's
// parameters) along W, rounded to float32, then along H, out.  The
// wrapper's plan (ops/stencils.smooth_plan) passes the tile shape and the
// shared bytes; they must equal this file's, or nothing launches.
CPE_API int cpe_stencil_smooth(const float* in, float* out, const float* host_taps, int n, int h, int w, int r,
                               int tile_h, int tile_w, int smem, cudaStream_t stream) {
  if (tile_h != kSmoothH || tile_w != kSmoothW || r < 0 || r > kMaxRadius || !host_taps ||
      smem != (int)(LayoutS0(r).words() * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0) return 0;
  SmoothTaps taps = {};
  for (int i = 0; i < 2 * r + 1; ++i) taps.k[i] = host_taps[i];
  dim3 grid((w + kSmoothW - 1) / kSmoothW, (h + kSmoothH - 1) / kSmoothH, n);
  // The detector's radius (blur_ksize 5 composed with ridge_sigma 3) at
  // compile time; every other radius through the generic instantiation.
  if (r == 14) return launch_smooth<14>(grid, smem, stream, in, out, h, w, r, taps);
  return launch_smooth<-1>(grid, smem, stream, in, out, h, w, r, taps);
}

// T: gray, joints and joint_cnt (N, H, W) float32 in; sat_mask (bool, as
// bytes), bright_blur, bright_center (null when rb < 0), cx, cy (float32)
// out, and, when `sat` is not null, the saturation blur before its
// threshold.  The taps at `host_taps` (HOST memory): the saturation blur's
// 2 rs + 1 and the index blur's 2 ri + 1 (rounded to bfloat16), the centre
// box's 2 rb + 1 (none when rb < 0), the joint ramp's and the joint box's
// 2 rj + 1 each.  The wrapper's plan (ops/stencils.stats_plan) passes the
// tile and the shared bytes; they must equal this file's, or nothing
// launches.
CPE_API int cpe_stencil_stats(const float* gray, const float* joints, const float* cnt, unsigned char* sat_mask,
                              float* bright_blur, float* bright_center, float* cx, float* cy, float* sat,
                              const float* host_taps, int n, int h, int w, int rs, int ri, int rb, int rj,
                              int margin, int tile, int smem, float sat_threshold, cudaStream_t stream) {
  const bool radii_ok = rs >= 0 && rs <= kMaxRadius && ri >= 0 && ri <= kMaxRadius && rb >= -1 &&
                        rb <= kMaxRadius && rj >= 0 && rj <= kMaxRadius;
  if (!radii_ok || tile != kStatsTile || !host_taps || (rb >= 0) != (bright_center != nullptr) ||
      smem != (int)(LayoutT(rs, ri, rb, rj).words() * sizeof(float)) || n > 65535 / 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0) return 0;
  StatsTaps taps = {};
  const int n_taps = (2 * rs + 1) + (2 * ri + 1) + (rb >= 0 ? 2 * rb + 1 : 0) + 2 * (2 * rj + 1);
  for (int i = 0; i < n_taps; ++i) taps.k[i] = host_taps[i];
  StatsArgs a = {gray, joints, cnt, sat_mask, bright_blur, bright_center, cx, cy, sat, n, h, w, margin,
                 sat_threshold, (float)((2 * rb + 1) * (2 * rb + 1))};
  dim3 grid((w + kStatsTile - 1) / kStatsTile, (h + kStatsTile - 1) / kStatsTile, 2 * n);
  // The detector's radii (sat_blur_ksize 19, index_blur_ksize 7, the
  // 11-pixel centre patch and joint window) at compile time; every other
  // set through the generic instantiation.
  if (rs == 9 && ri == 3 && (rb == 5 || rb < 0) && rj == 5)
    return launch_stats<9, 3, 5, 5>(grid, smem, stream, a, rs, ri, rb, rj, taps);
  return launch_stats<-1, -1, -1, -1>(grid, smem, stream, a, rs, ri, rb, rj, taps);
}
