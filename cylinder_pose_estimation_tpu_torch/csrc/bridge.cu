// Bridge morphology for a batch of (N, H, W) line masks, one CTA per mask.
//
// Replaces the TPU kernel cylinder_pose_estimation_tpu/ops/pallas/frontend.py
// bridge_morphology (_bridge_kernel, _dshift): endpoint ray counts ->
// oriented line dilation by doubling with a traced length -> 3x3 dilation
// (fill 0) -> out = m | (erode3x3(m | grown, fill 1) & grown).
//
// Design: each mask's working planes live in shared memory as bytes (two
// H*W buffers: 184 KB at the half-res 240x384 canvas, opted in above 48 KB)
// and every doubling step is its own whole-mask step between
// __syncthreads(), ping-ponging the buffers, so no step ever reads a value
// written in the same step.  Shifts fill (never wrap) at the border, and the
// fills of intermediate steps make the composed footprint differ from a
// plain sum over composed offsets, so each step is reproduced offset for
// offset.  The per-mask offsets (round-half-even of sin/cos times the step)
// come precomputed from the wrapper, shared with the plain version.
// The endpoint ray counts are evaluated per pixel from the doubling's
// recursion (pows[2m](q) = pows[m](q) + pows[m](q + d(m)), with every
// intermediate position range-checked as the fills demand); the counts are
// small integers, so their order of addition cannot matter.
//
// Bound: one CTA per mask (N = 64 CTAs at the production batch), about 15
// synchronised passes over 92k bytes of shared memory each; latency and
// occupancy bound, not memory.

#include "common.cuh"

namespace {

constexpr int kBridgeThreads = 1024;

struct Mask {
  const float* m;
  int h, w;
  __device__ bool in(int y, int x) const { return y >= 0 && y < h && x >= 0 && x < w; }
  __device__ float at(int y, int x) const { return m[y * w + x]; }
};

// Value of pows[p](y, x) for p = 2^levels of the ray count (see header).
// d: (probe_len + 1) x 2 offsets (dy, dx) for k = 0 .. probe_len.
__device__ float ray_pow(const Mask& mk, const int* d, int p, int y, int x) {
  float total = 0.0f;
  int levels = 31 - __clz(p);
  for (int b = 0; b < p; ++b) {
    int yy = y, xx = x;
    bool ok = true;
    for (int lv = levels - 1; lv >= 0 && ok; --lv) {
      if (b & (1 << lv)) {
        int m = 1 << lv;
        yy += d[2 * m];
        xx += d[2 * m + 1];
        ok = mk.in(yy, xx);
      }
    }
    if (!ok) continue;
    yy += d[2];
    xx += d[3];
    if (mk.in(yy, xx)) total += mk.at(yy, xx);
  }
  return total;
}

__device__ float ray_count(const Mask& mk, const int* d, int probe_len, int y, int x) {
  float cnt = 0.0f;
  int off = 0, size = probe_len;
  while (size) {
    int p = 1 << (31 - __clz(size));
    if (off == 0) {
      cnt += ray_pow(mk, d, p, y, x);
    } else {
      int yy = y + d[2 * off], xx = x + d[2 * off + 1];
      if (mk.in(yy, xx)) cnt += ray_pow(mk, d, p, yy, xx);
    }
    off += p;
    size -= p;
  }
  return cnt;
}

__device__ __forceinline__ unsigned char px(const unsigned char* buf, int h, int w, int y, int x,
                                            unsigned char fill) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? buf[y * w + x] : fill;
}

__global__ void __launch_bounds__(kBridgeThreads)
bridge_kernel(const float* __restrict__ masks, const float* __restrict__ exps,
              const int* __restrict__ ray, const int* __restrict__ line, float* __restrict__ out,
              int h, int w, int probe_len, int n_steps) {
  extern __shared__ unsigned char smem[];
  const int hw = h * w;
  unsigned char* a = smem;
  unsigned char* b = smem + hw;
  const int mi = blockIdx.x;
  Mask mk{masks + (long long)mi * hw, h, w};
  const float* ex = exps + (long long)mi * hw;
  const int* dfwd = ray + (long long)mi * 2 * (probe_len + 1) * 2;
  const int* dbwd = dfwd + (probe_len + 1) * 2;
  const int* steps = line + (long long)mi * n_steps * 2;

  // Endpoints of the expandable mask pixels.
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    int y = p / w, x = p % w;
    unsigned char v = 0;
    if (mk.m[p] > 0.5f && ex[p] > 0.5f) {
      float f = ray_count(mk, dfwd, probe_len, y, x);
      float g = ray_count(mk, dbwd, probe_len, y, x);
      v = (f <= 1.0f || g <= 1.0f) ? 1 : 0;
    }
    a[p] = v;
  }
  __syncthreads();

  // Oriented line dilation: out |= shift(out, d) | shift(out, -d) per step.
  for (int s = 0; s < n_steps; ++s) {
    int dy = steps[2 * s], dx = steps[2 * s + 1];
    for (int p = threadIdx.x; p < hw; p += blockDim.x) {
      int y = p / w, x = p % w;
      b[p] = a[p] | px(a, h, w, y - dy, x - dx, 0) | px(a, h, w, y + dy, x + dx, 0);
    }
    __syncthreads();
    unsigned char* t = a;
    a = b;
    b = t;
  }

  // grown = 3x3 dilation (fill 0), separable: x then y.
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    int y = p / w, x = p % w;
    b[p] = a[p] | px(a, h, w, y, x - 1, 0) | px(a, h, w, y, x + 1, 0);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    int y = p / w, x = p % w;
    a[p] = b[p] | px(b, h, w, y - 1, x, 0) | px(b, h, w, y + 1, x, 0);
  }
  __syncthreads();

  // e1 = x-erosion (fill 1) of u = m | grown, into b; grown stays in a.
  auto u = [&](int y, int x) -> unsigned char {
    if (!(y >= 0 && y < h && x >= 0 && x < w)) return 1;
    int q = y * w + x;
    return (mk.m[q] > 0.5f ? 1 : 0) | a[q];
  };
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    int y = p / w, x = p % w;
    b[p] = u(y, x) & u(y, x - 1) & u(y, x + 1);
  }
  __syncthreads();
  float* o = out + (long long)mi * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    int y = p / w, x = p % w;
    unsigned char er = b[p] & px(b, h, w, y - 1, x, 1) & px(b, h, w, y + 1, x, 1);
    bool m = mk.m[p] > 0.5f;
    o[p] = (m || (er & a[p])) ? 1.0f : 0.0f;
  }
}

}  // namespace

// masks, exps, out: (N, H, W) float32 0/1; ray: (N, 2, probe_len + 1, 2)
// int32; line: (N, n_steps, 2) int32 (see ops/frontend.bridge_schedule).
CPE_API int cpe_bridge_morphology(const float* masks, const float* exps, const int* ray,
                                  const int* line, float* out, int n, int h, int w,
                                  int probe_len, int n_steps, cudaStream_t stream) {
  size_t smem = 2 * (size_t)h * w;
  cudaError_t e = cudaFuncSetAttribute(bridge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  bridge_kernel<<<n, kBridgeThreads, smem, stream>>>(masks, exps, ray, line, out, h, w, probe_len,
                                                     n_steps);
  CPE_CHECK_LAUNCH();
  return 0;
}
