// Smoothing / preprocess / binarize / line openings / joints / joint count /
// joint peak for a batch of (N, H, W) float32 grey images, or of already
// smoothed ones.
//
// Replaces the TPU kernel cylinder_pose_estimation_tpu/ops/pallas/frontend.py
// preprocess_binarize (_preprocess_kernel, both branches of pre_smoothed),
// which kept a whole image in VMEM and shifted it with circular rolls.
//
// Bound: memory.  At (32, 480, 640) the function reads 39.3 MB and writes six
// float planes, 235.9 MB: 275.3 MB, 0.0822 ms at 3.35 TB/s.  A few dozen
// operations per pixel stay below the byte bound.  The smoothing adds about
// 110 float operations a pixel over its tile and halo (1.1 GFLOP at
// (32, 480, 640), 0.033 ms at 33.5 T non-fused operations a second) and a
// smoothed plane written and read once (2 x 39.3 MB, 0.023 ms).
//
// Design: three launches, the first only with the smoothing, each over 2-D
// tiles (blockIdx.z = image, 32-bit index math inside an image).
//   S (smooth_tiles, pre_smoothed=False only): the grey tile of kSmoothH x
//     kSmoothW outputs comes in with a halo of r1 + r2 (14 px for the 5-tap
//     and 25-tap Gaussians), indexed modulo H and W because the TPU kernel's
//     rolls wrap, by asynchronous copies (all of a tile's loads in flight at
//     once); four separable passes in shared memory (the blur along W, then
//     H, then the ridge Gaussian along W, then H) write the smoothed tile to
//     a scratch plane.  Each thread keeps a run of kSmoothRun outputs of a
//     line in registers and loads the run's window once (2r + 8 loads for 8
//     outputs), with the radii as template parameters; other radii take a
//     generic instantiation, one output a thread, its inputs read tap by tap
//     from shared memory.  Launches A and B then run on the scratch plane as
//     on any smoothed image.  A launch of its own because inside launch A
//     the smoothing would need a 4.2x halo on A's 32 x 64 tiles and leave 2
//     CTAs an SM.
// Launches A and B work on tiles of kTileH x kTileW output pixels.  Each
// tile loads its input once, with its halo, into shared memory and runs its
// part of the chain there; HBM sees the input, the six outputs and one
// bit-packed copy of `binary` (1/32 of a plane) between the two launches.
//   A (binarize_tiles): smoothed -> Hessian minima -> 15x15 Sauvola box sums
//     -> binary.  Halo 9 (2 for the Hessian, 7 for the box).  Each thread
//     keeps a run of kRun outputs of a line in registers and builds the
//     doubling planes pows[2], pows[4], pows[8] of that run once, so a box
//     sum costs about 6 adds and 1 shared load instead of 14 and 15.
//   B (mask_tiles): packed binary -> 1x20 / 20x1 openings (shifted word
//     ANDs / ORs, 32 px per word) -> joints -> 11x11 count (popcounts along
//     x, sliding sums along y) -> joint_peak_iters masked max rounds on int
//     keys in shared memory, each round one pass over a list of the tile's
//     joints.  The tile's halo covers the rounds' reach, so no round leaves
//     the block.
//
// Exactness: built with --fmad=false; each smoothing pass evaluates the TPU
// kernel's k[r] * x, then + k[r - i] * (x[p - i] + x[p + i]) for i = 1 .. r,
// in that order (_sep_conv_roll, symmetric taps), each pass rounded to
// float32, its reads wrapped around the image as the rolls do; every float
// box sum evaluates the addition tree of the TPU kernel's Hillis-Steele
// doubling (_box_sum_roll: parts largest first, summed left to right,
// recentred by size / 2); the Sauvola division and square root are the
// correctly rounded ones.  Masks, counts and keys are integers, exact in any
// order.  After the smoothing, out-of-image reads return 0 (INT_MIN for
// keys) where the TPU wrapped around: the margin, which the wrapper requires
// to cover the stencil reach, zeroes every mask within it, so both
// conventions give the same whole images.

#include "common.cuh"

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;    // a multiple of 32: tiles start on bit-word bounds
constexpr int kRun = 8;       // outputs of a line per thread in the box sums
constexpr int kThreadsA = kTileW * (kTileH / kRun);
constexpr int kThreadsB = 256;
constexpr int kTileWords = kTileW / 32;
static_assert(kThreadsA == 256, "one column-phase task per thread");
static_assert(kTileH % kRun == 0 && kTileW % 32 == 0, "tile shape");

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTaps = 64;  // both smoothing passes' taps (ops/frontend MAX_SMOOTHING_TAPS)

constexpr int kSmoothH = 64;      // smoothed outputs per tile (ops/frontend SMOOTH_TILE)
constexpr int kSmoothW = 128;
constexpr int kSmoothThreads = 256;
constexpr int kSmoothRun = 8;     // outputs of a line per thread in a pass

// The smoothing's taps, by value in the launch's parameters: the blur's
// 2 r1 + 1, then the ridge Gaussian's 2 r2 + 1.
struct Taps {
  float k[kMaxTaps];
};

// ---------------------------------------------------------------------------
// Launch S: wrapped separable smoothing -> scratch plane
// ---------------------------------------------------------------------------

// Shared-memory layout of launch S for smoothing radii r1, r2, in 4-byte
// words: X, the grey tile with its halo of r1 + r2 (rows xh, pitch xp), A,
// the first pass's output (the blur along W: xh rows, pitch ap), and the
// wrapped image row and column of each of X's rows and columns.  The second
// pass (along H) writes into X, the third (along W) into A; the fourth
// writes the plane.  Odd pitches: a warp's 32 rows of a row pass fall in 32
// banks.
struct LayoutS {
  int r1, r2, xh, xw, xp, aw, ap, bh, bp;
  __host__ __device__ LayoutS(int r1_, int r2_) {
    r1 = r1_;
    r2 = r2_;
    xh = kSmoothH + 2 * (r1 + r2);
    xw = kSmoothW + 2 * (r1 + r2);
    xp = xw | 1;
    aw = kSmoothW + 2 * r2;     // pass 1 and 2 outputs: columns
    ap = aw | 1;
    bh = kSmoothH + 2 * r2;     // pass 2 and 3 outputs: rows
    bp = kSmoothW | 1;          // pass 3 output pitch
  }
  __host__ __device__ int a_off() const { return xh * xp; }
  __host__ __device__ int gy_off() const { return a_off() + xh * ap; }
  __host__ __device__ int gx_off() const { return gy_off() + xh; }
  __host__ __device__ int words() const { return gx_off() + xw; }
};

// One smoothing pass over a rows x cols output region of shared memory:
// out[y][x] = k[r] * c, then + k[r - i] * (c[-i] + c[+i]) for i = 1 .. r,
// c the input centred on (y, x + r) along W or (y + r, x) along H (`in`
// pitch ip, `out` pitch op).  R > 0: each task is a run of kSmoothRun
// outputs of a line, its window of kSmoothRun + 2 R inputs loaded once into
// registers (cols, for W, or rows, for H, a multiple of kSmoothRun); along W
// a warp's tasks take consecutive rows, along H consecutive columns, so its
// loads fall in 32 banks.  R == 0: the generic instantiation, radius r at run
// time, one output per task read tap by tap from shared memory.
template <int R, bool kAlongW>
__device__ __forceinline__ void smooth_pass(const float* __restrict__ in, int ip, float* __restrict__ out, int op,
                                            int rows, int cols, const float* __restrict__ k, int r) {
  if constexpr (R > 0) {
    constexpr int nv = kSmoothRun + 2 * R;
    float kr[R + 1];
#pragma unroll
    for (int i = 0; i <= R; ++i) kr[i] = k[i];
    const int lines = kAlongW ? rows : cols;
    const int runs = (kAlongW ? cols : rows) / kSmoothRun;
    for (int t = threadIdx.x; t < lines * runs; t += kSmoothThreads) {
      const int line = t % lines;
      const int p0 = (t / lines) * kSmoothRun;
      const float* src = kAlongW ? in + line * ip + p0 : in + p0 * ip + line;
      float* dst = kAlongW ? out + line * op + p0 : out + p0 * op + line;
      const int step_in = kAlongW ? 1 : ip;
      const int step_out = kAlongW ? 1 : op;
      float v[nv];
#pragma unroll
      for (int i = 0; i < nv; ++i) v[i] = src[i * step_in];
#pragma unroll
      for (int o = 0; o < kSmoothRun; ++o) {
        float acc = kr[R] * v[o + R];
#pragma unroll
        for (int i = 1; i <= R; ++i) acc = acc + kr[R - i] * (v[o + R - i] + v[o + R + i]);
        dst[o * step_out] = acc;
      }
    }
  } else {
    // Tasks with the line index fastest (rows along W, columns along H),
    // their coordinates stepped without a division per output.
    const int step = kAlongW ? 1 : ip;
    const int lines = kAlongW ? rows : cols;
    int line = threadIdx.x % lines;
    int pos = threadIdx.x / lines;
    const int d_line = kSmoothThreads % lines;
    const int d_pos = kSmoothThreads / lines;
    for (int t = threadIdx.x; t < rows * cols; t += kSmoothThreads) {
      const int y = kAlongW ? line : pos;
      const int x = kAlongW ? pos : line;
      const float* c = kAlongW ? in + y * ip + x + r : in + (y + r) * ip + x;
      float acc = k[r] * c[0];
      for (int i = 1; i <= r; ++i) acc = acc + k[r - i] * (c[-i * step] + c[i * step]);
      out[y * op + x] = acc;
      line += d_line;
      pos += d_pos;
      if (line >= lines) {
        line -= lines;
        ++pos;
      }
    }
  }
}

// Asynchronous 4-byte copies from device to shared memory (cp.async): a
// thread issues all of its share of a tile's loads before it waits, so a
// tile's whole input is in flight at once.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The four passes of one tile: the grey tile with its halo, wrapped around
// the image, then the blur (radius r1) along W and H and the ridge Gaussian
// (r2) along W and H; the last pass writes the tile's smoothed pixels.
// R1, R2 > 0: the radii at compile time; 0, 0: the generic instantiation.
template <int R1, int R2>
__global__ void __launch_bounds__(kSmoothThreads) smooth_tiles(const float* __restrict__ gray,
                                                               float* __restrict__ smoothed, int h, int w,
                                                               int r1, int r2, const __grid_constant__ Taps taps) {
  static_assert(R1 == 0 || ((kSmoothW + 2 * R2) % kSmoothRun == 0 && (kSmoothH + 2 * R2) % kSmoothRun == 0 &&
                            kSmoothH % kSmoothRun == 0 && kSmoothW % kSmoothRun == 0),
                "the passes' regions must be whole runs");
  extern __shared__ float smem_s[];
  if constexpr (R1 > 0) {
    r1 = R1;
    r2 = R2;
  }
  const LayoutS L(r1, r2);
  float* X = smem_s;
  float* A = smem_s + L.a_off();
  int* gys = (int*)(smem_s + L.gy_off());
  int* gxs = (int*)(smem_s + L.gx_off());
  const int y0 = blockIdx.y * kSmoothH;
  const int x0 = blockIdx.x * kSmoothW;
  const size_t plane = (size_t)h * w;
  const float* g = gray + blockIdx.z * plane;
  const int hz = r1 + r2;

  // The halo tile, wrapped: each row's and column's image index once, then
  // every thread on consecutive pixels of the tile, all copies in flight
  // before the wait.
  for (int i = threadIdx.x; i < L.xh; i += kSmoothThreads) gys[i] = ((y0 - hz + i) % h + h) % h * w;
  for (int i = threadIdx.x; i < L.xw; i += kSmoothThreads) gxs[i] = ((x0 - hz + i) % w + w) % w;
  __syncthreads();
  {
    const int n = L.xh * L.xw;
    int row = threadIdx.x / L.xw;
    int col = threadIdx.x % L.xw;
    const int step_row = kSmoothThreads / L.xw;
    const int step_col = kSmoothThreads % L.xw;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kSmoothThreads) {
      copy_async(X + row * L.xp + col, g + gys[row] + gxs[col]);
      row += step_row;
      col += step_col;
      if (col >= L.xw) {
        col -= L.xw;
        ++row;
      }
    }
  }
  copy_async_wait();
  __syncthreads();
  const float* k1 = taps.k;
  const float* k2 = taps.k + 2 * r1 + 1;
  smooth_pass<R1, true>(X, L.xp, A, L.ap, L.xh, L.aw, k1, r1);
  __syncthreads();
  smooth_pass<R1, false>(A, L.ap, X, L.ap, L.bh, L.aw, k1, r1);
  __syncthreads();
  smooth_pass<R2, true>(X, L.ap, A, L.bp, L.bh, kSmoothW, k2, r2);
  __syncthreads();
  // The last pass along H, from registers to the plane (outputs past the
  // image are computed and dropped).
  float* o = smoothed + blockIdx.z * plane;
  if constexpr (R2 > 0) {
    constexpr int nv = kSmoothRun + 2 * R2;
    for (int t = threadIdx.x; t < kSmoothW * (kSmoothH / kSmoothRun); t += kSmoothThreads) {
      const int col = t % kSmoothW;
      const int row0 = (t / kSmoothW) * kSmoothRun;
      const float* src = A + row0 * L.bp + col;
      float v[nv];
#pragma unroll
      for (int i = 0; i < nv; ++i) v[i] = src[i * L.bp];
      const int gx = x0 + col;
      float kr[R2 + 1];
#pragma unroll
      for (int i = 0; i <= R2; ++i) kr[i] = k2[i];
#pragma unroll
      for (int q = 0; q < kSmoothRun; ++q) {
        float acc = kr[R2] * v[q + R2];
#pragma unroll
        for (int i = 1; i <= R2; ++i) acc = acc + kr[R2 - i] * (v[q + R2 - i] + v[q + R2 + i]);
        const int gy = y0 + row0 + q;
        if (gy < h && gx < w) o[gy * w + gx] = acc;
      }
    }
  } else {
    static_assert(kSmoothThreads % kSmoothW == 0, "a stride of whole rows");
    const int col = threadIdx.x % kSmoothW;
    for (int row = threadIdx.x / kSmoothW; row < kSmoothH; row += kSmoothThreads / kSmoothW) {
      const float* c = A + (row + r2) * L.bp + col;
      float acc = k2[r2] * c[0];
      for (int i = 1; i <= r2; ++i) acc = acc + k2[r2 - i] * (c[-i * L.bp] + c[i * L.bp]);
      const int gy = y0 + row;
      const int gx = x0 + col;
      if (gy < h && gx < w) o[gy * w + gx] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch A: smoothed -> binary (float plane and packed bits)
// ---------------------------------------------------------------------------

// Shared-memory layout of launch A for box size `box`, in floats.
struct LayoutA {
  int hs, rb, sh, sw, mh, mw, rw;
  __host__ __device__ explicit LayoutA(int box) {
    rb = box / 2;
    hs = rb + 2;
    sh = kTileH + 2 * hs;
    sw = kTileW + 2 * hs;
    mh = kTileH + 2 * rb;
    mw = (kTileW + 2 * rb) | 1;  // odd strides: conflict-free column walks
    rw = kTileW + 1;
  }
  __host__ __device__ int s_off() const { return 0; }
  __host__ __device__ int m_off() const { return sh * sw; }
  __host__ __device__ int r1_off() const { return m_off() + mh * mw; }
  __host__ __device__ int r2_off() const { return r1_off() + mh * rw; }
  __host__ __device__ int floats() const { return r2_off() + mh * rw; }
};

// Centred box sums of kRun consecutive outputs from the kRun + BOX - 1
// values v[] of a line: out[k] sums v[k .. k + BOX).  pows[2m][i] =
// pows[m][i] + pows[m][i + m]; parts of BOX largest first, left to right.
template <int BOX>
__device__ __forceinline__ void box_run(const float (&v)[kRun + BOX - 1], float (&out)[kRun]) {
  constexpr int nv = kRun + BOX - 1;
  float p2[nv - 1], p4[nv - 3], p8[nv - 7];
#pragma unroll
  for (int i = 0; i < nv - 1; ++i) p2[i] = v[i] + v[i + 1];
#pragma unroll
  for (int i = 0; i < nv - 3; ++i) p4[i] = p2[i] + p2[i + 2];
#pragma unroll
  for (int i = 0; i < nv - 7; ++i) p8[i] = p4[i] + p4[i + 4];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    float acc = 0.0f;
    bool first = true;
    int off = 0;
#pragma unroll
    for (int p = 8; p >= 1; p >>= 1) {
      if (BOX & p) {
        float part = p == 8 ? p8[k + off] : p == 4 ? p4[k + off] : p == 2 ? p2[k + off] : v[k + off];
        acc = first ? part : acc + part;
        first = false;
        off += p;
      }
    }
    out[k] = acc;
  }
}

template <int BOX>
__global__ void __launch_bounds__(kThreadsA) binarize_tiles(
    const float* __restrict__ smoothed, float* __restrict__ binary, unsigned* __restrict__ bits,
    int h, int w, int words, int margin, float k, float r, float min_contrast) {
  extern __shared__ float smem_a[];
  const LayoutA L(BOX);
  float* S = smem_a + L.s_off();
  float* M = smem_a + L.m_off();
  float* R1 = smem_a + L.r1_off();
  float* R2 = smem_a + L.r2_off();
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const size_t plane = (size_t)h * w;
  const float* s = smoothed + blockIdx.z * plane;

  // Input tile with a halo of hs, zero outside the image.
#pragma unroll 4
  for (int i = tid; i < L.sh * L.sw; i += kThreadsA) {
    int gy = y0 - L.hs + i / L.sw;
    int gx = x0 - L.hs + i % L.sw;
    S[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? s[gy * w + gx] : 0.0f;
  }
  __syncthreads();

  // Hessian minimum eigenvalue over the tile with a halo of rb (0 outside
  // the image, as the box sums read it).
  const int mw_used = kTileW + 2 * L.rb;
  for (int i = tid; i < L.mh * mw_used; i += kThreadsA) {
    int ly = i / mw_used;
    int lx = i % mw_used;
    int gy = y0 - L.rb + ly;
    int gx = x0 - L.rb + lx;
    float mn = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const float* c = S + (ly + 2) * L.sw + (lx + 2);
      const int sw = L.sw;
      float gr_dn = 0.5f * (c[2 * sw] - c[0]);
      float gr_up = 0.5f * (c[0] - c[-2 * sw]);
      float hrr = 0.5f * (gr_dn - gr_up);
      float gr_r = 0.5f * (c[sw + 1] - c[-sw + 1]);
      float gr_l = 0.5f * (c[sw - 1] - c[-sw - 1]);
      float hrc = 0.5f * (gr_r - gr_l);
      float gc_r = 0.5f * (c[2] - c[0]);
      float gc_l = 0.5f * (c[0] - c[-2]);
      float hcc = 0.5f * (gc_r - gc_l);
      float half_tr = 0.5f * (hrr + hcc);
      float half_diff = 0.5f * (hrr - hcc);
      float root = sqrtf(half_diff * half_diff + hrc * hrc);
      mn = half_tr - root;
    }
    M[ly * L.mw + lx] = mn;
  }
  __syncthreads();

  // Row box sums of minima and minima^2 for every halo row: task = (row,
  // run of kRun outputs), rows fastest (odd stride: no bank conflicts).
  constexpr int nv = kRun + BOX - 1;
  constexpr int runs = kTileW / kRun;
  for (int t = tid; t < L.mh * runs; t += kThreadsA) {
    int ly = t % L.mh;
    int x = (t / L.mh) * kRun;
    float v[nv], out[kRun];
#pragma unroll
    for (int i = 0; i < nv; ++i) v[i] = M[ly * L.mw + x + i];
    box_run<BOX>(v, out);
#pragma unroll
    for (int j = 0; j < kRun; ++j) R1[ly * L.rw + x + j] = out[j];
#pragma unroll
    for (int i = 0; i < nv; ++i) v[i] = v[i] * v[i];
    box_run<BOX>(v, out);
#pragma unroll
    for (int j = 0; j < kRun; ++j) R2[ly * L.rw + x + j] = out[j];
  }
  __syncthreads();

  // Column box sums -> Sauvola threshold -> binary; one column and a run of
  // kRun rows per thread, a warp on 32 consecutive columns of one run.
  const int tx = tid % kTileW;
  const int ty0 = (tid / kTileW) * kRun;
  const int gx = x0 + tx;
  float c1[kRun], c2[kRun];
  {
    float v[nv];
#pragma unroll
    for (int i = 0; i < nv; ++i) v[i] = R1[(ty0 + i) * L.rw + tx];
    box_run<BOX>(v, c1);
#pragma unroll
    for (int i = 0; i < nv; ++i) v[i] = R2[(ty0 + i) * L.rw + tx];
    box_run<BOX>(v, c2);
  }
  const float n_px = (float)(BOX * BOX);
  const int word = (x0 + (tid % kTileW) - (tid % 32)) / 32;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int gy = y0 + ty0 + j;
    float m1 = c1[j] / n_px;
    float m2 = c2[j] / n_px;
    float var = fmaxf(m2 - m1 * m1, 0.0f);
    float sd = sqrtf(var);
    float thresh = m1 * (1.0f + k * (sd / r - 1.0f));
    float mn = M[(ty0 + j + L.rb) * L.mw + tx + L.rb];
    float bf = (mn > thresh) ? 0.0f : 1.0f;
    if (min_contrast > 0.0f) bf = bf * ((mn < -min_contrast) ? 1.0f : 0.0f);
    bool inside = gy >= margin && gy < h - margin && gx >= margin && gx < w - margin;
    float b = bf * (inside ? 1.0f : 0.0f);
    bool in_img = gy < h && gx < w;
    if (in_img) binary[blockIdx.z * plane + gy * w + gx] = b;
    unsigned ball = __ballot_sync(kFull, in_img && b > 0.5f);
    if ((tid % 32) == 0 && gy < h && word < words) bits[(blockIdx.z * (size_t)h + gy) * words + word] = ball;
  }
}

// ---------------------------------------------------------------------------
// Launch B: packed binary -> h_mask, v_mask, joints, joint_cnt, joint_peak
// ---------------------------------------------------------------------------

// Bit j of the result: AND (OR) of bits j .. j + len - 1 of (hi:lo), len <= 33
// (the doubling of _line_minmax; any order is exact on bits).
__device__ __forceinline__ unsigned run_and(unsigned lo, unsigned hi, int len) {
  unsigned long long v = ((unsigned long long)hi << 32) | lo;
  for (int covered = 1; covered < len;) {
    int take = min(covered, len - covered);
    v &= v >> take;
    covered += take;
  }
  return (unsigned)v;
}

__device__ __forceinline__ unsigned run_or(unsigned lo, unsigned hi, int len) {
  unsigned long long v = ((unsigned long long)hi << 32) | lo;
  for (int covered = 1; covered < len;) {
    int take = min(covered, len - covered);
    v |= v >> take;
    covered += take;
  }
  return (unsigned)v;
}

// Bit j of the result: bit j - a of the stream (prev word, then cur), 0 <= a < 32.
__device__ __forceinline__ unsigned back(unsigned prev, unsigned cur, int a) {
  return (unsigned)((((unsigned long long)cur << 32) | prev) >> (32 - a));
}

// Shared-memory layout of launch B (32-bit words).  Row ranges are relative
// to the tile's first row, word ranges to its first word:
//   B  binary bits  rows [-rj - up, TH + rj + down), words [-3, TW/32 + 3)
//   E  row erosion  rows [-rj - a, TH + rj + len - 1 - a), words [-1, TW/32 + 1)
//   DH, DV, J       rows [-rj, TH + rj), words [-1, TW/32 + 1)
//   RC row counts   rows [-rj, TH + rj), pixels [-R, TW + R)
//   CNT, K0, K1     rows [-R, TH + R), pixels [-R, TW + R)
//   one word: the number of joints in the key region
// with a = (len - 1) / 2, up = 2a, down = 2 (len - 1 - a), rj = R + jw / 2.
struct LayoutB {
  int a, up, down, rj, bh, bk, eh, jk, jh, kh, kw;
  __host__ __device__ LayoutB(int len, int jw, int iters) {
    a = (len - 1) / 2;
    up = 2 * a;
    down = 2 * (len - 1 - a);
    rj = iters + jw / 2;
    jh = kTileH + 2 * rj;
    bh = jh + up + down;
    bk = kTileWords + 6;
    eh = jh + len - 1;
    jk = kTileWords + 2;
    kh = kTileH + 2 * iters;
    kw = kTileW + 2 * iters;
  }
  __host__ __device__ int b_off() const { return 0; }
  __host__ __device__ int e_off() const { return bh * bk; }
  __host__ __device__ int dh_off() const { return e_off() + eh * jk; }
  __host__ __device__ int dv_off() const { return dh_off() + jh * jk; }
  __host__ __device__ int j_off() const { return dv_off() + jh * jk; }
  __host__ __device__ int rc_off() const { return j_off() + jh * jk; }
  __host__ __device__ int cnt_off() const { return rc_off() + jh * kw; }
  __host__ __device__ int k0_off() const { return cnt_off() + kh * kw; }
  __host__ __device__ int k1_off() const { return k0_off() + kh * kw; }
  __host__ __device__ int words() const { return k1_off() + kh * kw + 1; }  // + joint count
};

__global__ void __launch_bounds__(kThreadsB) mask_tiles(
    const unsigned* __restrict__ bits, float* __restrict__ hmask, float* __restrict__ vmask,
    float* __restrict__ joints, float* __restrict__ jcnt, float* __restrict__ jpeak, int h, int w,
    int words, int len, int jw, int iters, int shift) {
  extern __shared__ unsigned smem_b[];
  const LayoutB L(len, jw, iters);
  unsigned* B = smem_b + L.b_off();
  unsigned* E = smem_b + L.e_off();
  unsigned* DH = smem_b + L.dh_off();
  unsigned* DV = smem_b + L.dv_off();
  unsigned* J = smem_b + L.j_off();
  int* RC = (int*)(smem_b + L.rc_off());
  int* CNT = (int*)(smem_b + L.cnt_off());
  int* K0 = (int*)(smem_b + L.k0_off());
  int* K1 = (int*)(smem_b + L.k1_off());
  int* n_joints = (int*)(smem_b + L.k1_off() + L.kh * L.kw);
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int w0 = x0 / 32;
  const size_t img = blockIdx.z;
  const int R = iters;
  const int jr = jw / 2;

  for (int i = tid; i < L.bh * L.bk; i += kThreadsB) {
    int gy = y0 - L.rj - L.up + i / L.bk;
    int gw = w0 - 3 + i % L.bk;
    B[i] = (gy >= 0 && gy < h && gw >= 0 && gw < words) ? bits[(img * h + gy) * words + gw] : 0u;
  }
  __syncthreads();

  // Horizontal opening (erode then dilate along x) and the row erosion of
  // the vertical opening.
  for (int i = tid; i < L.jh * L.jk; i += kThreadsB) {
    int row = i / L.jk;
    int k = i % L.jk;
    // The output word g needs binary words g - 2 .. g + 2: b[0 .. 4].
    const unsigned* b = B + (row + L.up) * L.bk + k;
    unsigned ar[4], er[3], orr[2];
#pragma unroll
    for (int j = 0; j < 4; ++j) ar[j] = run_and(b[j], b[j + 1], len);
#pragma unroll
    for (int j = 0; j < 3; ++j) er[j] = back(ar[j], ar[j + 1], L.a);
#pragma unroll
    for (int j = 0; j < 2; ++j) orr[j] = run_or(er[j], er[j + 1], len);
    DH[i] = back(orr[0], orr[1], L.a);
  }
  for (int i = tid; i < L.eh * L.jk; i += kThreadsB) {
    int row = i / L.jk;
    int k = i % L.jk;
    unsigned v = kFull;
    for (int t = 0; t < len; ++t) v &= B[(row + t) * L.bk + k + 2];
    E[i] = v;
  }
  __syncthreads();
  for (int i = tid; i < L.jh * L.jk; i += kThreadsB) {
    int row = i / L.jk;
    int k = i % L.jk;
    unsigned v = 0u;
    for (int t = 0; t < len; ++t) v |= E[(row + t) * L.jk + k];
    DV[i] = v;
    J[i] = DH[i] & v;
  }
  __syncthreads();

  // The tile's three mask planes.
  const size_t plane = (size_t)h * w;
  for (int i = tid; i < kTileH * kTileW; i += kThreadsB) {
    int ty = i / kTileW;
    int tx = i % kTileW;
    int gy = y0 + ty;
    int gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    int wi = (ty + L.rj) * L.jk + tx / 32 + 1;
    unsigned bit = 1u << (tx % 32);
    size_t o = img * plane + gy * w + gx;
    hmask[o] = (DH[wi] & bit) ? 1.0f : 0.0f;
    vmask[o] = (DV[wi] & bit) ? 1.0f : 0.0f;
    joints[o] = (J[wi] & bit) ? 1.0f : 0.0f;
  }

  // Joint counts along x (popcount of jw bits), then along y.
  const unsigned long long wmask = (1ull << jw) - 1ull;
  for (int i = tid; i < L.jh * L.kw; i += kThreadsB) {
    int row = i / L.kw;
    int u = i % L.kw - R - jr + 32;  // window start, in bits from word -1
    int k = u >> 5;
    const unsigned* jrow = J + row * L.jk;
    unsigned long long v = jrow[k];
    if (k + 1 < L.jk) v |= (unsigned long long)jrow[k + 1] << 32;
    RC[i] = __popcll((v >> (u & 31)) & wmask);
  }
  __syncthreads();

  // Counts along y: each task slides a window of jw row counts down a band
  // of kBand rows of one column (integers: exact in any order).
  constexpr int kBand = 16;
  const int bands = (L.kh + kBand - 1) / kBand;
  for (int t = tid; t < bands * L.kw; t += kThreadsB) {
    const int kx = t % L.kw;
    const int ky0 = (t / L.kw) * kBand;
    const int ky1 = min(ky0 + kBand, L.kh);
    int c = 0;
    for (int d = 0; d < jw; ++d) c += RC[(ky0 + d) * L.kw + kx];
    CNT[ky0 * L.kw + kx] = c;
    for (int ky = ky0 + 1; ky < ky1; ++ky) {
      c += RC[(ky + jw - 1) * L.kw + kx] - RC[(ky - 1) * L.kw + kx];
      CNT[ky * L.kw + kx] = c;
    }
  }
  if (tid == 0) *n_joints = 0;
  __syncthreads();

  // Keys, INT_MIN off the joints, in both buffers; the joints' positions go
  // to a list (in RC's space, free now) in any order.
  auto is_joint = [&](int ky, int kx) {  // key-region coordinates
    int u = kx - R + 32;
    return (J[(ky - R + L.rj) * L.jk + (u >> 5)] >> (u & 31)) & 1u;
  };
  int* joints_at = RC;
  for (int i = tid; i < L.kh * L.kw; i += kThreadsB) {
    int ky = i / L.kw;
    int kx = i % L.kw;
    int key = INT_MIN;
    if (is_joint(ky, kx)) {
      key = CNT[i] * (1 << shift) + ((y0 - R + ky) * w + (x0 - R + kx));
      joints_at[atomicAdd(n_joints, 1)] = i;
    }
    K0[i] = K1[i] = key;
  }
  __syncthreads();

  // Peak rounds.  A vertical 3-max, then a horizontal 3-max under the joint
  // mask, is a 3x3 max at the joints (INT_MIN elsewhere, and off the image,
  // stays so): one Jacobi pass over the joints per round.  Reads outside
  // the key region are INT_MIN; its halo of R absorbs the error at its edge.
  const int nj = *n_joints;
  int* cur = K0;
  int* nxt = K1;
  for (int it = 0; it < iters; ++it) {
    for (int t = tid; t < nj; t += kThreadsB) {
      const int i = joints_at[t];
      const int ky = i / L.kw;
      const int kx = i % L.kw;
      int v = INT_MIN;
      for (int yy = max(ky - 1, 0); yy <= min(ky + 1, L.kh - 1); ++yy) {
        const int* r = cur + yy * L.kw + kx;
        v = max(v, r[0]);
        if (kx > 0) v = max(v, r[-1]);
        if (kx < L.kw - 1) v = max(v, r[1]);
      }
      nxt[i] = v;
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = tid; i < kTileH * kTileW; i += kThreadsB) {
    int ty = i / kTileW;
    int tx = i % kTileW;
    int gy = y0 + ty;
    int gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    int ki = (ty + R) * L.kw + tx + R;
    int c = CNT[ki];
    int key = c * (1 << shift) + (gy * w + gx);
    float jf = is_joint(ty + R, tx + R) ? 1.0f : 0.0f;
    size_t o = img * plane + gy * w + gx;
    jcnt[o] = (float)c;
    jpeak[o] = (cur[ki] == key ? 1.0f : 0.0f) * jf;
  }
}

template <int BOX>
int launch_binarize(dim3 grid, int smem, cudaStream_t stream, const float* smoothed, float* binary,
                    unsigned* bits, int h, int w, int words, int margin, float k, float r,
                    float min_contrast) {
  if (smem != (int)(LayoutA(BOX).floats() * sizeof(float))) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(binarize_tiles<BOX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  binarize_tiles<BOX><<<grid, kThreadsA, smem, stream>>>(smoothed, binary, bits, h, w, words,
                                                         margin, k, r, min_contrast);
  CPE_CHECK_LAUNCH();
  return 0;
}

template <int R1, int R2>
int launch_smooth(dim3 grid, int smem, cudaStream_t stream, const float* gray, float* out, int h, int w,
                  int r1, int r2, const Taps& taps) {
  cudaError_t e = cudaFuncSetAttribute(smooth_tiles<R1, R2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  smooth_tiles<R1, R2><<<grid, kSmoothThreads, smem, stream>>>(gray, out, h, w, r1, r2, taps);
  CPE_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// The preprocess kernel's own smoothing (pre_smoothed=False): (N, H, W)
// float32 grey images in, the four wrapped passes out (same shape).  The
// taps at `host_taps` (HOST memory: the 2 r1 + 1 blur taps, then the
// 2 r2 + 1 ridge taps) are copied into the launch.  The wrapper's plan
// (ops/frontend.smoothing_plan) passes the tile shape and the shared bytes;
// they must equal this file's, or nothing launches.
CPE_API int cpe_smooth_wrapped(const float* in, float* out, const float* host_taps, int n, int h, int w,
                               int r1, int r2, int tile_h, int tile_w, int smem, cudaStream_t stream) {
  const int n_taps = 2 * (r1 + r2) + 2;
  if (tile_h != kSmoothH || tile_w != kSmoothW || r1 < 0 || r2 < 0 || n_taps > kMaxTaps || !host_taps ||
      smem != (int)(LayoutS(r1, r2).words() * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Taps taps = {};
  for (int i = 0; i < n_taps; ++i) taps.k[i] = host_taps[i];
  dim3 grid((w + kSmoothW - 1) / kSmoothW, (h + kSmoothH - 1) / kSmoothH, n);
  // The detector's radii (blur_ksize 5, ridge_sigma 3) at compile time;
  // every other pair through the generic instantiation.
  if (r1 == 2 && r2 == 12) return launch_smooth<2, 12>(grid, smem, stream, in, out, h, w, r1, r2, taps);
  return launch_smooth<0, 0>(grid, smem, stream, in, out, h, w, r1, r2, taps);
}

// Outputs: binary, h_mask, v_mask, joints, joint_cnt, joint_peak (N, H, W)
// float32 of the smoothed images `in` (cpe_smooth_wrapped's output, or the
// caller's own smoothing).  Scratch: bits, (N, H, ceil(W / 32)) uint32.  The
// wrapper's plan (ops/frontend.preprocess_plan) passes the tile shape and
// each launch's shared bytes; they must equal this file's, or nothing
// launches.
CPE_API int cpe_preprocess_binarize(const float* in, float* binary, float* hmask,
                                    float* vmask, float* joints, float* jcnt, float* jpeak,
                                    unsigned* bits, int n, int h, int w,
                                    int sauvola_window, int line_len, int margin, int joint_window,
                                    int joint_peak_iters, int key_shift, int tile_h, int tile_w,
                                    int smem_a, int smem_b, float sauvola_k,
                                    float sauvola_r, float min_contrast, cudaStream_t stream) {
  if (tile_h != kTileH || tile_w != kTileW || line_len < 1 || line_len > 32 ||
      joint_peak_iters < 0 || joint_peak_iters + joint_window / 2 > 32)
    return (int)cudaErrorInvalidValue;
  const int words = (w + 31) / 32;
  dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  int rc;
  switch (sauvola_window) {
#define CPE_BOX(B)                                                                          \
  case B:                                                                                   \
    rc = launch_binarize<B>(grid, smem_a, stream, in, binary, bits, h, w, words, margin,    \
                            sauvola_k, sauvola_r, min_contrast);                            \
    break;
    CPE_BOX(1) CPE_BOX(3) CPE_BOX(5) CPE_BOX(7) CPE_BOX(9) CPE_BOX(11) CPE_BOX(13) CPE_BOX(15)
#undef CPE_BOX
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const LayoutB lb(line_len, joint_window, joint_peak_iters);
  if (smem_b != (int)(lb.words() * sizeof(unsigned))) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mask_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_b);
  if (e != cudaSuccess) return (int)e;
  mask_tiles<<<grid, kThreadsB, smem_b, stream>>>(bits, hmask, vmask, joints, jcnt, jpeak, h, w,
                                                  words, line_len, joint_window,
                                                  joint_peak_iters, key_shift);
  CPE_CHECK_LAUNCH();
  return 0;
}

CPE_API const char* cpe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
