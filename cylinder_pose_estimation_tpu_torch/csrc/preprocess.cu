// Preprocess / binarize / line openings / joints / joint count / joint peak
// for a batch of already smoothed (N, H, W) float32 images.
//
// Replaces the TPU kernel cylinder_pose_estimation_tpu/ops/pallas/frontend.py
// preprocess_binarize (_preprocess_kernel, pre_smoothed=True).  The TPU kept a
// whole image in VMEM and shifted it with circular rolls; a 480x640 float
// image (1.2 MB) does not fit in an SM's shared memory, so this is a chain of
// simple one-thread-per-pixel passes through global memory / L2.  Every pass
// reads a small stencil, so the chain is bound by memory traffic and launch
// count (about 20 launches), not by arithmetic.
//
// Exactness: built with --fmad=false, and every float sum evaluates the same
// addition tree as the TPU kernel's Hillis-Steele doubling (_box_sum_roll),
// so the outputs equal the plain PyTorch version bit for bit.  Out-of-image
// reads return 0 (INT_MIN for the peak keys) where the TPU wrapped around:
// the detector margin (>= the 23 px stencil reach) zeroes every mask within
// it, so both conventions give the same whole images.

#include "common.cuh"

namespace {

using cpe::blocks_for;
using cpe::kThreads;

struct Dims {
  int n, h, w;
};

__device__ __forceinline__ float at(const float* img, const Dims& d, int y, int x) {
  return (y >= 0 && y < d.h && x >= 0 && x < d.w) ? img[y * d.w + x] : 0.0f;
}

// Sum of the p = 2^k values line[pos .. pos + p) (optionally squared), in the
// doubling order pows[2m][i] = pows[m][i] + pows[m][i + m].
__device__ float pow_sum(const float* line, int stride, int len, int pos, int p, bool square) {
  float v[16];
  for (int i = 0; i < p; ++i) {
    int q = pos + i;
    float t = (q >= 0 && q < len) ? line[q * stride] : 0.0f;
    v[i] = square ? t * t : t;
  }
  for (int width = p; width > 1; width >>= 1)
    for (int i = 0; i < width / 2; ++i) v[i] = v[2 * i] + v[2 * i + 1];
  return v[0];
}

// Centred odd-size box sum at index i of a line: the parts of the binary
// decomposition of `size`, largest first, summed left to right, recentred
// by size / 2 (_box_sum_roll).
__device__ float box_tree(const float* line, int stride, int len, int i, int size, bool square) {
  int j = i - size / 2;
  int off = 0;
  float acc = 0.0f;
  bool first = true;
  while (size) {
    int p = 1 << (31 - __clz(size));
    float part = pow_sum(line, stride, len, j + off, p, square);
    acc = first ? part : acc + part;
    first = false;
    off += p;
    size -= p;
  }
  return acc;
}

__global__ void hessian_minima(const float* __restrict__ s, float* __restrict__ minima, Dims d) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)d.n * d.h * d.w;
  if (idx >= total) return;
  int x = idx % d.w;
  int y = (idx / d.w) % d.h;
  const float* img = s + (idx / ((long long)d.h * d.w)) * d.h * d.w;
  auto gr = [&](int yy, int xx) { return 0.5f * (at(img, d, yy + 1, xx) - at(img, d, yy - 1, xx)); };
  auto gc = [&](int yy, int xx) { return 0.5f * (at(img, d, yy, xx + 1) - at(img, d, yy, xx - 1)); };
  float hrr = 0.5f * (gr(y + 1, x) - gr(y - 1, x));
  float hrc = 0.5f * (gr(y, x + 1) - gr(y, x - 1));
  float hcc = 0.5f * (gc(y, x + 1) - gc(y, x - 1));
  float half_tr = 0.5f * (hrr + hcc);
  float half_diff = 0.5f * (hrr - hcc);
  float root = sqrtf(half_diff * half_diff + hrc * hrc);
  minima[idx] = half_tr - root;
}

// Row (x) box sums of x and, if out2 is given, of x*x.
__global__ void box_rows(const float* __restrict__ in, float* __restrict__ out1,
                         float* __restrict__ out2, Dims d, int size) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)d.n * d.h * d.w;
  if (idx >= total) return;
  int x = idx % d.w;
  const float* line = in + (idx - x);
  out1[idx] = box_tree(line, 1, d.w, x, size, false);
  if (out2) out2[idx] = box_tree(line, 1, d.w, x, size, true);
}

// Column box sums of the row sums -> Sauvola threshold -> binary mask.
__global__ void sauvola_binarize(const float* __restrict__ r1, const float* __restrict__ r2,
                                 const float* __restrict__ minima, float* __restrict__ binary,
                                 Dims d, int window, float k, float r, float min_contrast,
                                 int margin) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)d.n * d.h * d.w;
  if (idx >= total) return;
  int x = idx % d.w;
  int y = (idx / d.w) % d.h;
  long long base = idx - (long long)y * d.w;
  float n_px = (float)(window * window);
  float m1 = box_tree(r1 + base, d.w, d.h, y, window, false) / n_px;
  float m2 = box_tree(r2 + base, d.w, d.h, y, window, false) / n_px;
  float var = fmaxf(m2 - m1 * m1, 0.0f);
  float sd = sqrtf(var);
  float thresh = m1 * (1.0f + k * (sd / r - 1.0f));
  float mn = minima[idx];
  float bf = (mn > thresh) ? 0.0f : 1.0f;
  if (min_contrast > 0.0f) bf = bf * ((mn < -min_contrast) ? 1.0f : 0.0f);
  bool inside = y >= margin && y < d.h - margin && x >= margin && x < d.w - margin;
  binary[idx] = bf * (inside ? 1.0f : 0.0f);
}

// Window [i - (len-1)/2, i - (len-1)/2 + len) min (erode) or max (dilate)
// along x (into out_h) and along y (into out_v), of in_h / in_v.
__global__ void line_minmax(const float* __restrict__ in_h, const float* __restrict__ in_v,
                            float* __restrict__ out_h, float* __restrict__ out_v, Dims d,
                            int len, bool take_max) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)d.n * d.h * d.w;
  if (idx >= total) return;
  int x = idx % d.w;
  int y = (idx / d.w) % d.h;
  long long img = idx - (long long)y * d.w - x;
  int a = (len - 1) / 2;
  float eh = take_max ? 0.0f : 1.0f;
  float ev = eh;
  for (int t = 0; t < len; ++t) {
    int xx = x - a + t;
    int yy = y - a + t;
    float vh = (xx >= 0 && xx < d.w) ? in_h[img + (long long)y * d.w + xx] : 0.0f;
    float vv = (yy >= 0 && yy < d.h) ? in_v[img + (long long)yy * d.w + x] : 0.0f;
    eh = take_max ? fmaxf(eh, vh) : fminf(eh, vh);
    ev = take_max ? fmaxf(ev, vv) : fminf(ev, vv);
  }
  out_h[idx] = eh;
  out_v[idx] = ev;
}

__global__ void joints_of(const float* __restrict__ hm, const float* __restrict__ vm,
                          float* __restrict__ joints, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  joints[idx] = fminf(hm[idx], vm[idx]);
}

__device__ __forceinline__ int peak_key(float cnt, int y, int x, int w, int shift) {
  return (int)cnt * (1 << shift) + (y * w + x);
}

// Column box sums of the joint row counts -> joint_cnt, and the initial
// peak keys (INT_MIN off the joints).
__global__ void joint_count(const float* __restrict__ rows, const float* __restrict__ joints,
                            float* __restrict__ cnt, int* __restrict__ km, Dims d, int window,
                            int shift) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)d.n * d.h * d.w;
  if (idx >= total) return;
  int x = idx % d.w;
  int y = (idx / d.w) % d.h;
  long long base = idx - (long long)y * d.w;
  float c = box_tree(rows + base, d.w, d.h, y, window, false);
  cnt[idx] = c;
  km[idx] = joints[idx] > 0.5f ? peak_key(c, y, x, d.w, shift) : INT_MIN;
}

// One half of a peak round: vertical 3-max (mask=false) or horizontal
// 3-max followed by the joint mask (mask=true).
__global__ void peak_pass(const int* __restrict__ in, int* __restrict__ out,
                          const float* __restrict__ joints, Dims d, bool horizontal) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)d.n * d.h * d.w;
  if (idx >= total) return;
  int x = idx % d.w;
  int y = (idx / d.w) % d.h;
  int v = in[idx];
  if (horizontal) {
    int a = x > 0 ? in[idx - 1] : INT_MIN;
    int b = x < d.w - 1 ? in[idx + 1] : INT_MIN;
    v = max(v, max(a, b));
    out[idx] = joints[idx] > 0.5f ? v : INT_MIN;
  } else {
    int a = y > 0 ? in[idx - d.w] : INT_MIN;
    int b = y < d.h - 1 ? in[idx + d.w] : INT_MIN;
    out[idx] = max(v, max(a, b));
  }
}

__global__ void peak_final(const int* __restrict__ km, const float* __restrict__ cnt,
                           const float* __restrict__ joints, float* __restrict__ peak, Dims d,
                           int shift) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)d.n * d.h * d.w;
  if (idx >= total) return;
  int x = idx % d.w;
  int y = (idx / d.w) % d.h;
  float hit = km[idx] == peak_key(cnt[idx], y, x, d.w, shift) ? 1.0f : 0.0f;
  peak[idx] = hit * joints[idx];
}

}  // namespace

// Outputs: binary, h_mask, v_mask, joints, joint_cnt, joint_peak (N, H, W)
// float32.  Scratch: three float and two int32 (N, H, W) buffers.
CPE_API int cpe_preprocess_binarize(const float* smoothed, float* binary, float* hmask,
                                    float* vmask, float* joints, float* jcnt, float* jpeak,
                                    float* f0, float* f1, float* f2, int* i0, int* i1, int n,
                                    int h, int w, int sauvola_window, int line_len, int margin,
                                    int joint_window, int joint_peak_iters, int key_shift,
                                    float sauvola_k, float sauvola_r, float min_contrast,
                                    cudaStream_t stream) {
  Dims d{n, h, w};
  long long total = (long long)n * h * w;
  unsigned g = blocks_for(total);
  float* minima = f0;
  hessian_minima<<<g, kThreads, 0, stream>>>(smoothed, minima, d);
  CPE_CHECK_LAUNCH();
  box_rows<<<g, kThreads, 0, stream>>>(minima, f1, f2, d, sauvola_window);
  CPE_CHECK_LAUNCH();
  sauvola_binarize<<<g, kThreads, 0, stream>>>(f1, f2, minima, binary, d, sauvola_window,
                                               sauvola_k, sauvola_r, min_contrast, margin);
  CPE_CHECK_LAUNCH();
  // Openings: erode (into f1 / f2), then dilate.
  line_minmax<<<g, kThreads, 0, stream>>>(binary, binary, f1, f2, d, line_len, false);
  CPE_CHECK_LAUNCH();
  line_minmax<<<g, kThreads, 0, stream>>>(f1, f2, hmask, vmask, d, line_len, true);
  CPE_CHECK_LAUNCH();
  joints_of<<<g, kThreads, 0, stream>>>(hmask, vmask, joints, total);
  CPE_CHECK_LAUNCH();
  box_rows<<<g, kThreads, 0, stream>>>(joints, f0, nullptr, d, joint_window);
  CPE_CHECK_LAUNCH();
  joint_count<<<g, kThreads, 0, stream>>>(f0, joints, jcnt, i0, d, joint_window, key_shift);
  CPE_CHECK_LAUNCH();
  for (int it = 0; it < joint_peak_iters; ++it) {
    peak_pass<<<g, kThreads, 0, stream>>>(i0, i1, joints, d, false);
    CPE_CHECK_LAUNCH();
    peak_pass<<<g, kThreads, 0, stream>>>(i1, i0, joints, d, true);
    CPE_CHECK_LAUNCH();
  }
  peak_final<<<g, kThreads, 0, stream>>>(i0, jcnt, joints, jpeak, d, key_shift);
  CPE_CHECK_LAUNCH();
  return 0;
}

CPE_API const char* cpe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
