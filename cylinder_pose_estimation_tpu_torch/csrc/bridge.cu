// Bridge morphology for a batch of (N, H, W) line masks: one thread-block
// cluster per mask, every plane bit-packed in shared memory.
//
// Replaces the TPU kernel cylinder_pose_estimation_tpu/ops/pallas/frontend.py
// bridge_morphology (_bridge_kernel, _dshift): endpoint ray counts ->
// oriented line dilation by doubling with a traced length -> 3x3 dilation
// (fill 0) -> out = m | (erode3x3(m | grown, fill 1) & grown).
//
// Bound: memory.  The function reads two planes and writes one: 17.7 MB as
// bytes (bool) and 70.8 MB as float32 at the detector's (64, 240, 384),
// 0.0053 and 0.0211 ms at 3.35 TB/s.
//
// Design:
// - The schedule is computed in the kernel.  The first warp of each CTA turns
//   its mask's angle and kernel length into the ray offsets and the line
//   steps, in shared memory: sinf/cosf, rintf (round half to even, as
//   jnp.round) and the float operations of ops/frontend.bridge_schedule in
//   its order.  It can write them out, for comparison.
// - Every plane is bit-packed: a row is ceil(W / 32) words, bit b of word j
//   is pixel 32 j + b, and the bits past W stay 0.  A shift by a traced
//   (dy, dx) is a row offset plus a funnel shift across two words that reads
//   the fill (0, or 1 for the erosion) outside the image: _dshift's fill on
//   0/1 data, so every doubling step is reproduced offset for offset.
// - The ray counts are only compared with <= 1, so a count is two saturating
//   bit planes, ">= 1" and ">= 2", and adding two is exact for that
//   predicate: ge1 = a1 | b1, ge2 = a2 | b2 | (a1 & b1).  Each part of the
//   doubling's sum is added as soon as its level is built (the sum
//   saturates, so the order cannot matter).
// - A mask's rows are split over a cluster of c CTAs (ops/frontend.
//   bridge_plan: c = 2 at N = 64, so that c N CTAs fill the SMs in one wave).
//   Each CTA loads and packs its rows (vector loads of 4 pixels a lane where
//   W is a multiple of 32, one pixel a lane and a warp ballot elsewhere),
//   copies its peers' packed rows through distributed shared memory (a few
//   KB), runs the ~25 bit passes (~3 words a thread each) on the whole mask
//   and writes only its own rows.
// - Large frames: where the nine planes of a mask do not fit in one CTA's
//   shared memory (H ceil(W / 32) > 6,420 words: the detector's half-res
//   canvas from 720x1280 on), the plan picks the global route at the end of
//   this file instead: the same bit passes, one launch each, on planes in
//   device memory (17,408 words, 68 KB a plane at 1080x1920).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBridgeThreads = 1024;
constexpr int kWarps = kBridgeThreads / 32;
constexpr int kIlp = 4;  // loads in flight per lane while packing
constexpr unsigned kFull = 0xffffffffu;
// Shared memory: kPlanes bit planes of H x ceil(W / 32) words, then the
// schedule (ray offsets for probe_len <= kMaxProbe, line steps <= kMaxSteps).
constexpr int kPlanes = 9;
constexpr int kMaxProbe = 64;
constexpr int kMaxSteps = 32;
constexpr int kScheduleInts = 4 * (kMaxProbe + 1) + 2 * kMaxSteps;
constexpr int kMaxHalf = 1 << 20;

// The pixel types: bytes (bool, uint8; set when nonzero) and float32 (set
// above 0.5), four pixels to a vector.
template <typename T>
struct Px;

template <>
struct Px<unsigned char> {
  using Vec = uint32_t;
  __device__ static bool on(unsigned char v) { return v != 0; }
  __device__ static unsigned nibble(Vec v) {
    return (unsigned)((v & 0xffu) != 0) | ((unsigned)((v & 0xff00u) != 0) << 1) |
           ((unsigned)((v & 0xff0000u) != 0) << 2) | ((unsigned)((v & 0xff000000u) != 0) << 3);
  }
  __device__ static unsigned char value(unsigned bit) { return (unsigned char)bit; }
  __device__ static Vec vec(unsigned nib) {
    return (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) | ((nib & 8u) << 21);
  }
};

template <>
struct Px<float> {
  using Vec = float4;
  __device__ static bool on(float v) { return v > 0.5f; }
  __device__ static unsigned nibble(Vec v) {
    return (unsigned)(v.x > 0.5f) | ((unsigned)(v.y > 0.5f) << 1) | ((unsigned)(v.z > 0.5f) << 2) |
           ((unsigned)(v.w > 0.5f) << 3);
  }
  __device__ static float value(unsigned bit) { return bit ? 1.0f : 0.0f; }
  __device__ static Vec vec(unsigned nib) {
    return make_float4(value(nib & 1u), value((nib >> 1) & 1u), value((nib >> 2) & 1u),
                       value((nib >> 3) & 1u));
  }
};

struct Geo {
  int h, ww;      // rows, words per row
  uint32_t last;  // the bits of a row's last word that lie in the image
};

// Word readers for shifted(): word i of a plane, or of the union of two.
struct Plane {
  const uint32_t* p;
  __device__ uint32_t operator()(int i) const { return p[i]; }
};
struct Union {
  const uint32_t* a;
  const uint32_t* b;
  __device__ uint32_t operator()(int i) const { return a[i] | b[i]; }
};

// Word j of row y of the plane shifted by (dy, dx), as _dshift:
// out(y, x) = src(y - dy, x - dx), and `fill` (0 or ~0) where that lies
// outside the image, past W in the last word included.
template <typename Src>
__device__ __forceinline__ uint32_t shifted(Src src, const Geo& g, int y, int j, int dy, int dx,
                                            uint32_t fill) {
  const int sy = y - dy;
  if (sy < 0 || sy >= g.h) return fill;
  const int off = -dx;             // source column of bit 0: 32 j + off
  const int q = j + (off >> 5);    // floor division
  const int r = off & 31;
  const uint32_t pad = fill & ~g.last;
  auto word = [&](int k) -> uint32_t {
    if (k < 0 || k >= g.ww) return fill;
    const uint32_t v = src(sy * g.ww + k);
    return k == g.ww - 1 ? v | pad : v;
  };
  return __funnelshift_r(word(q), word(q + 1), r);
}

// A word to store: the bits past W stay 0.
__device__ __forceinline__ uint32_t keep(uint32_t v, const Geo& g, int j) {
  return j == g.ww - 1 ? v & g.last : v;
}

// One mask's schedule (ops/frontend.bridge_schedule), by one warp: the ray
// offsets [sign][k][dy, dx] for k = 0..probe_len into `ray`, the line steps
// [step][dy, dx] into `line`.  sinf/cosf, rintf (round half to even, as
// jnp.round) and the float operations of bridge_schedule in its order.
__device__ __forceinline__ void mask_schedule(int* ray, int* line, float a, float kl, int probe_len,
                                              int half, int lane) {
  const float sa = sinf(a);
  const float ca = cosf(a);
  for (int k = lane; k <= probe_len; k += 32) {
    for (int s = 0; s < 2; ++s) {
      const float sgn = s ? -1.0f : 1.0f;
      int* d = ray + 2 * (s * (probe_len + 1) + k);
      d[0] = (int)rintf(sa * (float)k * sgn);
      d[1] = (int)rintf(ca * (float)k * sgn);
    }
  }
  if (lane == 0) {
    const float dyn_half = fminf(fmaxf(kl / 2.0f, 0.0f), (float)half);
    float dyn_covered = 0.0f;
    for (int s = 0, covered = 0, stride = 1; covered < half; ++s, stride *= 2) {
      const int step = min(stride, half - covered);
      const float eff = fminf(fmaxf(dyn_half - dyn_covered, 0.0f), (float)step);
      line[2 * s] = (int)rintf(sa * eff);
      line[2 * s + 1] = (int)rintf(ca * eff);
      covered += step;
      dyn_covered = dyn_covered + eff;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBridgeThreads, 1) bridge_cluster(
    const T* __restrict__ masks, const T* __restrict__ exps, const float* __restrict__ angles,
    const float* __restrict__ klen, int klen_group, T* __restrict__ out, int* __restrict__ sched_out,
    int h, int w, int probe_len, int half, int rows_per, bool vec) {
  extern __shared__ uint32_t smem_bridge[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mi = blockIdx.x / csize;
  const Geo g{h, (w + 31) / 32, (w & 31) ? (1u << (w & 31)) - 1u : kFull};
  const int n_words = h * g.ww;
  uint32_t* const M = smem_bridge;    // the mask
  uint32_t* const E = M + n_words;    // expandable pixels
  uint32_t* const F = E + n_words;    // expandable forward endpoints, then the endpoints
  uint32_t* const A1 = F + n_words;   // the ray count being summed: >= 1,
  uint32_t* const A2 = A1 + n_words;  // >= 2
  uint32_t* const P1 = A2 + n_words;  // pows[p] and pows[2p]: >= 1, >= 2
  uint32_t* const P2 = P1 + n_words;
  uint32_t* const Q1 = P2 + n_words;
  uint32_t* const Q2 = Q1 + n_words;
  int* const ray = reinterpret_cast<int*>(Q2 + n_words);  // [sign][k][dy, dx], k = 0..probe_len
  int* const line = ray + 4 * (probe_len + 1);            // [step][dy, dx]
  int n_steps = 0;
  for (int covered = 0, stride = 1; covered < half; stride *= 2, ++n_steps)
    covered += min(stride, half - covered);
  const int r0 = rank * rows_per;
  const int nr = min(rows_per, h - r0);
  const int n_px = nr * w;
  const size_t base = ((size_t)mi * h + r0) * w;

  // The schedule (ops/frontend.bridge_schedule).
  if (warp == 0) mask_schedule(ray, line, angles[mi], klen[mi / klen_group], probe_len, half, lane);

  // Pack this CTA's rows of the mask and the expandable pixels.
  if (vec) {
    using Vec = typename Px<T>::Vec;
    const Vec* mv = reinterpret_cast<const Vec*>(masks + base);
    const Vec* ev = reinterpret_cast<const Vec*>(exps + base);
    uint32_t* mw = M + r0 * g.ww;
    uint32_t* ew = E + r0 * g.ww;
    const int n_vec = n_px / 4;  // W % 32 == 0: 8 vectors to a word
    for (int k0 = warp * 32 * kIlp; k0 < n_vec; k0 += kWarps * 32 * kIlp) {
      Vec a[kIlp], b[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int k = k0 + u * 32 + lane;
        if (k < n_vec) {
          a[u] = mv[k];
          b[u] = ev[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int k = k0 + u * 32 + lane;
        uint32_t wm = k < n_vec ? Px<T>::nibble(a[u]) << (4 * (lane & 7)) : 0u;
        uint32_t we = k < n_vec ? Px<T>::nibble(b[u]) << (4 * (lane & 7)) : 0u;
#pragma unroll
        for (int d = 1; d < 8; d *= 2) {
          wm |= __shfl_xor_sync(kFull, wm, d);
          we |= __shfl_xor_sync(kFull, we, d);
        }
        if ((lane & 7) == 0 && k < n_vec) {
          mw[k >> 3] = wm;
          ew[k >> 3] = we;
        }
      }
    }
  } else {
    const T* m = masks + base;
    const T* e = exps + base;
    const int nw = nr * g.ww;
    for (int i0 = warp; i0 < nw; i0 += kWarps * kIlp) {
      bool bm[kIlp], be[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int i = i0 + u * kWarps;
        const int y = i / g.ww;
        const int x = (i - y * g.ww) * 32 + lane;
        const bool ok = i < nw && x < w;
        bm[u] = ok && Px<T>::on(m[y * w + x]);
        be[u] = ok && Px<T>::on(e[y * w + x]);
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int i = i0 + u * kWarps;
        const uint32_t wm = __ballot_sync(kFull, bm[u]);
        const uint32_t we = __ballot_sync(kFull, be[u]);
        if (lane == 0 && i < nw) {
          M[r0 * g.ww + i] = wm;
          E[r0 * g.ww + i] = we;
        }
      }
    }
  }
  for (int i = tid; i < n_words; i += kBridgeThreads) A1[i] = A2[i] = 0u;
  cluster.sync();
  // The peers' rows, through distributed shared memory.
  for (int r = 0; r < csize; ++r) {
    if (r == rank) continue;
    const uint32_t* pm = cluster.map_shared_rank(M, r);
    const uint32_t* pe = cluster.map_shared_rank(E, r);
    const int end = min((r + 1) * rows_per, h) * g.ww;
    for (int i = r * rows_per * g.ww + tid; i < end; i += kBridgeThreads) {
      M[i] = pm[i];
      E[i] = pe[i];
    }
  }
  cluster.sync();  // no CTA leaves while a peer still reads its rows
  if (sched_out && rank == 0) {
    const int len = 4 * (probe_len + 1) + 2 * n_steps;
    for (int i = tid; i < len; i += kBridgeThreads) sched_out[(size_t)mi * len + i] = ray[i];
  }

#define FOR_WORDS(i, y, j)                                          \
  for (int i = tid, y = i / g.ww, j = i - y * g.ww; i < n_words;    \
       i += kBridgeThreads, y = i / g.ww, j = i - y * g.ww)

  // Endpoint ray counts, forward then backward: pows[1] = shift(m, -d(1)),
  // pows[2p] = pows[p] + shift(pows[p], -d(p)); the part of level p (a bit
  // of probe_len) is pows[p] shifted by -d(the bits of probe_len above p).
  for (int s = 0; s < 2; ++s) {
    const int* d = ray + 2 * s * (probe_len + 1);
    FOR_WORDS(i, y, j) {
      P1[i] = keep(shifted(Plane{M}, g, y, j, -d[2], -d[3], 0u), g, j);
      P2[i] = 0u;
    }
    __syncthreads();
    uint32_t *p1 = P1, *p2 = P2, *q1 = Q1, *q2 = Q2;
    for (int p = 1; p <= probe_len; p *= 2) {
      const bool grow = 2 * p <= probe_len;
      const bool part = (probe_len & p) != 0;
      const int off = probe_len & ~(2 * p - 1);
      const int gy = -d[2 * p], gx = -d[2 * p + 1];
      const int py = -d[2 * off], px = -d[2 * off + 1];
      FOR_WORDS(i, y, j) {
        uint32_t c1 = A1[i], c2 = A2[i];
        if (grow) {
          const uint32_t a1 = p1[i], a2 = p2[i];
          const uint32_t s1 = shifted(Plane{p1}, g, y, j, gy, gx, 0u);
          const uint32_t s2 = shifted(Plane{p2}, g, y, j, gy, gx, 0u);
          q1[i] = keep(a1 | s1, g, j);
          q2[i] = keep(a2 | s2 | (a1 & s1), g, j);
        }
        if (part) {
          const uint32_t t1 = shifted(Plane{p1}, g, y, j, py, px, 0u);
          const uint32_t t2 = shifted(Plane{p2}, g, y, j, py, px, 0u);
          c2 |= t2 | (c1 & t1);
          c1 |= t1;
        }
        if (grow) {
          A1[i] = c1;
          A2[i] = c2;
        } else if (s == 0) {  // the last level: forward count <= 1
          F[i] = E[i] & ~c2;
          A1[i] = A2[i] = 0u;
        } else {  // out = m * exp * (fwd <= 1 | bwd <= 1)
          F[i] = M[i] & (F[i] | (E[i] & ~c2));
        }
      }
      __syncthreads();
      uint32_t* t = p1;
      p1 = q1;
      q1 = t;
      t = p2;
      p2 = q2;
      q2 = t;
    }
  }

  // Oriented line dilation: out |= shift(out, d) | shift(out, -d) per step.
  uint32_t* x = F;
  uint32_t* xn = A1;
  for (int s = 0; s < n_steps; ++s) {
    const int dy = line[2 * s], dx = line[2 * s + 1];
    FOR_WORDS(i, y, j) {
      xn[i] = keep(x[i] | shifted(Plane{x}, g, y, j, dy, dx, 0u) |
                       shifted(Plane{x}, g, y, j, -dy, -dx, 0u), g, j);
    }
    __syncthreads();
    uint32_t* t = x;
    x = xn;
    xn = t;
  }

  // grown = 3x3 dilation (fill 0), x then y; e1 = x-erosion (fill 1) of
  // m | grown; then this CTA's rows of m | (y-erosion of e1 & grown).
  uint32_t* const G1 = P1;
  uint32_t* const grown = P2;
  uint32_t* const E1 = Q1;
  uint32_t* const R = Q2;
  FOR_WORDS(i, y, j) {
    G1[i] = keep(x[i] | shifted(Plane{x}, g, y, j, 0, 1, 0u) | shifted(Plane{x}, g, y, j, 0, -1, 0u),
                 g, j);
  }
  __syncthreads();
  FOR_WORDS(i, y, j) {
    grown[i] = keep(G1[i] | shifted(Plane{G1}, g, y, j, 1, 0, 0u) |
                        shifted(Plane{G1}, g, y, j, -1, 0, 0u), g, j);
  }
  __syncthreads();
  const Union u{M, grown};
  FOR_WORDS(i, y, j) {
    E1[i] = keep(u(i) & shifted(u, g, y, j, 0, 1, kFull) & shifted(u, g, y, j, 0, -1, kFull), g, j);
  }
  __syncthreads();
#undef FOR_WORDS
  for (int i = r0 * g.ww + tid; i < (r0 + nr) * g.ww; i += kBridgeThreads) {
    const int y = i / g.ww, j = i - y * g.ww;
    const uint32_t er = E1[i] & shifted(Plane{E1}, g, y, j, 1, 0, kFull) &
                        shifted(Plane{E1}, g, y, j, -1, 0, kFull);
    R[i] = keep(M[i] | (er & grown[i]), g, j);
  }
  __syncthreads();

  // Unpack this CTA's rows.
  T* o = out + base;
  const uint32_t* rw = R + r0 * g.ww;
  if (vec) {
    using Vec = typename Px<T>::Vec;
    Vec* ov = reinterpret_cast<Vec*>(o);
    for (int k = tid; k < n_px / 4; k += kBridgeThreads)
      ov[k] = Px<T>::vec((rw[k >> 3] >> (4 * (k & 7))) & 0xfu);
  } else {
    for (int i = tid; i < n_px; i += kBridgeThreads) {
      const int y = i / w, xx = i - y * w;
      o[i] = Px<T>::value((rw[y * g.ww + (xx >> 5)] >> (xx & 31)) & 1u);
    }
  }
}

template <typename T>
int launch_bridge(const void* masks, const void* exps, const float* angles, const float* klen,
                  int klen_group, void* out, int* sched, int n, int h, int w, int probe_len, int half,
                  int cluster, int rows_per, int smem, cudaStream_t stream) {
  const bool vec = w % 32 == 0 &&
                   ((reinterpret_cast<uintptr_t>(masks) | reinterpret_cast<uintptr_t>(exps) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return cpe::launch_clusters(bridge_cluster<T>, cluster, n, kBridgeThreads, smem, stream,
                              static_cast<const T*>(masks), static_cast<const T*>(exps), angles, klen,
                              klen_group, static_cast<T*>(out), sched, h, w, probe_len, half, rows_per,
                              vec);
}

// ---------------------------------------------------------------------------
// The large-frame route, for masks whose nine planes do not fit in one CTA's
// shared memory: the same bit passes on planes in device memory, one launch
// per pass (the schedule, the packing, 2 x (1 + levels) ray passes, the line
// steps, the four closing passes and the unpacking), one thread per word.
// ---------------------------------------------------------------------------

constexpr int kGThreads = 256;

__device__ __forceinline__ long long global_tid() { return (long long)blockIdx.x * kGThreads + threadIdx.x; }

// Thread t's word: mask mi, row y, word j; `o` is the mask's first word and
// `li` the word's index within the mask.
#define GLOBAL_WORD                                                 \
  const long long t = global_tid();                                 \
  const long long per = (long long)g.h * g.ww;                      \
  if (t >= per * n) return;                                         \
  const long long mi = t / per;                                     \
  const int li = (int)(t - mi * per);                               \
  const int y = li / g.ww;                                          \
  const int j = li - y * g.ww;                                      \
  const size_t o = (size_t)mi * per;

__global__ void __launch_bounds__(kGThreads) bridge_global_schedule(
    const float* __restrict__ angles, const float* __restrict__ klen, int klen_group, int* sched,
    int* __restrict__ sched_out, int n, int probe_len, int half, int n_steps) {
  const long long mi = global_tid() / 32;  // one warp per mask: warp-uniform
  if (mi >= n) return;
  const int lane = threadIdx.x & 31;
  int* ray = sched + mi * kScheduleInts;
  mask_schedule(ray, ray + 4 * (probe_len + 1), angles[mi], klen[mi / klen_group], probe_len, half, lane);
  __syncwarp();
  if (sched_out) {
    const int len = 4 * (probe_len + 1) + 2 * n_steps;
    for (int i = lane; i < len; i += 32) sched_out[mi * len + i] = ray[i];
  }
}

// One warp per word: lane b packs pixel 32 j + b.
template <typename T>
__global__ void __launch_bounds__(kGThreads) bridge_global_pack(const T* __restrict__ masks,
                                                                const T* __restrict__ exps, uint32_t* M,
                                                                uint32_t* E, Geo g, int n, int w) {
  const long long word = global_tid() / 32;  // warp-uniform
  const long long per = (long long)g.h * g.ww;
  if (word >= per * n) return;
  const int lane = threadIdx.x & 31;
  const long long mi = word / per;
  const int li = (int)(word - mi * per);
  const int y = li / g.ww;
  const int x = (li - y * g.ww) * 32 + lane;
  const size_t px = ((size_t)mi * g.h + y) * w + x;
  const bool ok = x < w;
  const uint32_t wm = __ballot_sync(kFull, ok && Px<T>::on(masks[px]));
  const uint32_t we = __ballot_sync(kFull, ok && Px<T>::on(exps[px]));
  if (lane == 0) {
    M[word] = wm;
    E[word] = we;
  }
}

// Level 0 of ray count s: pows[1] = shift(m, -d(1)); count s = 0 also clears
// the count planes.
__global__ void __launch_bounds__(kGThreads) bridge_global_ray_start(
    const uint32_t* M, uint32_t* P1, uint32_t* P2, uint32_t* A1, uint32_t* A2, const int* sched, int s,
    int probe_len, Geo g, int n) {
  GLOBAL_WORD
  const int* d = sched + mi * kScheduleInts + 2 * s * (probe_len + 1);
  P1[o + li] = keep(shifted(Plane{M + o}, g, y, j, -d[2], -d[3], 0u), g, j);
  P2[o + li] = 0u;
  if (s == 0) A1[o + li] = A2[o + li] = 0u;
}

// Level p of ray count s, as one step of bridge_cluster's level loop.
__global__ void __launch_bounds__(kGThreads) bridge_global_ray_level(
    const uint32_t* M, const uint32_t* E, uint32_t* F, uint32_t* A1, uint32_t* A2, const uint32_t* p1,
    const uint32_t* p2, uint32_t* q1, uint32_t* q2, const int* sched, int s, int p, int probe_len, Geo g,
    int n) {
  GLOBAL_WORD
  const int* d = sched + mi * kScheduleInts + 2 * s * (probe_len + 1);
  const bool grow = 2 * p <= probe_len;
  const bool part = (probe_len & p) != 0;
  const int off = probe_len & ~(2 * p - 1);
  const size_t i = o + li;
  uint32_t c1 = A1[i], c2 = A2[i];
  if (grow) {
    const uint32_t a1 = p1[i], a2 = p2[i];
    const uint32_t s1 = shifted(Plane{p1 + o}, g, y, j, -d[2 * p], -d[2 * p + 1], 0u);
    const uint32_t s2 = shifted(Plane{p2 + o}, g, y, j, -d[2 * p], -d[2 * p + 1], 0u);
    q1[i] = keep(a1 | s1, g, j);
    q2[i] = keep(a2 | s2 | (a1 & s1), g, j);
  }
  if (part) {
    const uint32_t t1 = shifted(Plane{p1 + o}, g, y, j, -d[2 * off], -d[2 * off + 1], 0u);
    const uint32_t t2 = shifted(Plane{p2 + o}, g, y, j, -d[2 * off], -d[2 * off + 1], 0u);
    c2 |= t2 | (c1 & t1);
    c1 |= t1;
  }
  if (grow) {
    A1[i] = c1;
    A2[i] = c2;
  } else if (s == 0) {  // the last level: forward count <= 1
    F[i] = E[i] & ~c2;
    A1[i] = A2[i] = 0u;
  } else {  // out = m * exp * (fwd <= 1 | bwd <= 1)
    F[i] = M[i] & (F[i] | (E[i] & ~c2));
  }
}

// Line step `step`: xn = x | shift(x, d) | shift(x, -d).
__global__ void __launch_bounds__(kGThreads) bridge_global_line(const uint32_t* x, uint32_t* xn,
                                                                const int* sched, int step, int probe_len,
                                                                Geo g, int n) {
  GLOBAL_WORD
  const int* line = sched + mi * kScheduleInts + 4 * (probe_len + 1);
  const int dy = line[2 * step], dx = line[2 * step + 1];
  xn[o + li] = keep(x[o + li] | shifted(Plane{x + o}, g, y, j, dy, dx, 0u) |
                        shifted(Plane{x + o}, g, y, j, -dy, -dx, 0u), g, j);
}

// The closing passes of bridge_cluster: stage 0, dst = x-dilation of src;
// 1, dst = y-dilation of src (grown); 2, dst = x-erosion (fill 1) of
// m | grown; 3, dst = m | (y-erosion of src & grown).
__global__ void __launch_bounds__(kGThreads) bridge_global_close(int stage, const uint32_t* M,
                                                                 const uint32_t* src, const uint32_t* grown,
                                                                 uint32_t* dst, Geo g, int n) {
  GLOBAL_WORD
  uint32_t v;
  if (stage == 0) {
    v = src[o + li] | shifted(Plane{src + o}, g, y, j, 0, 1, 0u) | shifted(Plane{src + o}, g, y, j, 0, -1, 0u);
  } else if (stage == 1) {
    v = src[o + li] | shifted(Plane{src + o}, g, y, j, 1, 0, 0u) | shifted(Plane{src + o}, g, y, j, -1, 0, 0u);
  } else if (stage == 2) {
    const Union u{M + o, grown + o};
    v = u(li) & shifted(u, g, y, j, 0, 1, kFull) & shifted(u, g, y, j, 0, -1, kFull);
  } else {
    const uint32_t er = src[o + li] & shifted(Plane{src + o}, g, y, j, 1, 0, kFull) &
                        shifted(Plane{src + o}, g, y, j, -1, 0, kFull);
    v = M[o + li] | (er & grown[o + li]);
  }
  dst[o + li] = keep(v, g, j);
}

template <typename T>
__global__ void __launch_bounds__(kGThreads) bridge_global_unpack(const uint32_t* __restrict__ R,
                                                                  T* __restrict__ out, Geo g, int n, int w) {
  const long long t = global_tid();
  const long long hw = (long long)g.h * w;
  if (t >= hw * n) return;
  const long long mi = t / hw;
  const int px = (int)(t - mi * hw);
  const int y = px / w, x = px - y * w;
  out[t] = Px<T>::value((R[((size_t)mi * g.h + y) * g.ww + (x >> 5)] >> (x & 31)) & 1u);
}

#undef GLOBAL_WORD

inline unsigned blocks_for(long long threads) { return (unsigned)((threads + kGThreads - 1) / kGThreads); }

// scratch: 9 planes of n * h * ceil(w / 32) words, then n * kScheduleInts ints.
template <typename T>
int launch_bridge_global(const void* masks, const void* exps, const float* angles, const float* klen,
                         int klen_group, void* out, int* sched_out, uint32_t* scratch, int n, int h, int w,
                         int probe_len, int half, cudaStream_t stream) {
  const Geo g{h, (w + 31) / 32, (w & 31) ? (1u << (w & 31)) - 1u : kFull};
  const long long pw = (long long)n * h * g.ww;
  uint32_t* const M = scratch;
  uint32_t* const E = M + pw;
  uint32_t* const F = E + pw;
  uint32_t* const A1 = F + pw;
  uint32_t* const A2 = A1 + pw;
  uint32_t* const P1 = A2 + pw;
  uint32_t* const P2 = P1 + pw;
  uint32_t* const Q1 = P2 + pw;
  uint32_t* const Q2 = Q1 + pw;
  int* const sched = reinterpret_cast<int*>(Q2 + pw);
  int n_steps = 0;
  for (int covered = 0, stride = 1; covered < half; stride *= 2, ++n_steps) covered += min(stride, half - covered);
  const unsigned wb = blocks_for(pw);

  bridge_global_schedule<<<blocks_for(32LL * n), kGThreads, 0, stream>>>(
      angles, klen, klen_group, sched, sched_out, n, probe_len, half, n_steps);
  CPE_CHECK_LAUNCH();
  bridge_global_pack<T><<<blocks_for(32 * pw), kGThreads, 0, stream>>>(
      static_cast<const T*>(masks), static_cast<const T*>(exps), M, E, g, n, w);
  CPE_CHECK_LAUNCH();
  for (int s = 0; s < 2; ++s) {
    bridge_global_ray_start<<<wb, kGThreads, 0, stream>>>(M, P1, P2, A1, A2, sched, s, probe_len, g, n);
    CPE_CHECK_LAUNCH();
    uint32_t *p1 = P1, *p2 = P2, *q1 = Q1, *q2 = Q2;
    for (int p = 1; p <= probe_len; p *= 2) {
      bridge_global_ray_level<<<wb, kGThreads, 0, stream>>>(M, E, F, A1, A2, p1, p2, q1, q2, sched, s, p,
                                                            probe_len, g, n);
      CPE_CHECK_LAUNCH();
      uint32_t* t = p1;
      p1 = q1;
      q1 = t;
      t = p2;
      p2 = q2;
      q2 = t;
    }
  }
  uint32_t* x = F;
  uint32_t* xn = A1;
  for (int s = 0; s < n_steps; ++s) {
    bridge_global_line<<<wb, kGThreads, 0, stream>>>(x, xn, sched, s, probe_len, g, n);
    CPE_CHECK_LAUNCH();
    uint32_t* t = x;
    x = xn;
    xn = t;
  }
  // G1 = P1, grown = P2, E1 = Q1, R = Q2 (as bridge_cluster).
  const uint32_t* srcs[4] = {x, P1, nullptr, Q1};
  uint32_t* dsts[4] = {P1, P2, Q1, Q2};
  for (int stage = 0; stage < 4; ++stage) {
    bridge_global_close<<<wb, kGThreads, 0, stream>>>(stage, M, srcs[stage], P2, dsts[stage], g, n);
    CPE_CHECK_LAUNCH();
  }
  bridge_global_unpack<T><<<blocks_for((long long)n * h * w), kGThreads, 0, stream>>>(Q2, static_cast<T*>(out),
                                                                                      g, n, w);
  CPE_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// masks, exps, out: (N, H, W) of one pixel type (elem_bytes 1: bool or
// uint8; 4: float32), 0/1.  angles: (N,) float32; klen: float32 kernel
// lengths, mask i reads klen[i / klen_group]; half = max(max_kernel / 2, 1).
// sched (may be null): (N, 4 (probe_len + 1) + 2 n_steps) int32, the ray
// offsets [sign][k][dy, dx] and line steps [step][dy, dx] the kernel used.
// The wrapper's plan (ops/frontend.bridge_plan) passes the cluster size, the
// rows per CTA and the shared bytes; they must agree with this kernel's
// layout, or nothing launches.
CPE_API int cpe_bridge_morphology(const void* masks, const void* exps, const float* angles,
                                  const float* klen, void* out, int* sched, int n, int h, int w,
                                  int elem_bytes, int probe_len, int half, int klen_group,
                                  int cluster, int rows_per, int smem_bytes, cudaStream_t stream) {
  const long long smem = 4LL * ((long long)kPlanes * h * ((w + 31) / 32) + kScheduleInts);
  if (!cpe::cluster_size_ok(cluster) || h < 1 || w < 1 || probe_len < 1 || probe_len > kMaxProbe ||
      half < 1 || half > kMaxHalf || klen_group < 1 || rows_per < 1 ||
      (long long)rows_per * cluster < h || (long long)rows_per * (cluster - 1) >= h ||
      smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (elem_bytes == 1)
    return launch_bridge<unsigned char>(masks, exps, angles, klen, klen_group, out, sched, n, h, w,
                                        probe_len, half, cluster, rows_per, smem_bytes, stream);
  if (elem_bytes == 4)
    return launch_bridge<float>(masks, exps, angles, klen, klen_group, out, sched, n, h, w, probe_len,
                                half, cluster, rows_per, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

// The large-frame route of cpe_bridge_morphology (bridge_plan's "global"
// plan): the same arguments without the plan's cluster, plus scratch, a
// buffer of 9 N H ceil(W / 32) + 324 N int32 (the planes, then the
// schedule).
CPE_API int cpe_bridge_morphology_global(const void* masks, const void* exps, const float* angles,
                                         const float* klen, void* out, int* sched, void* scratch, int n,
                                         int h, int w, int elem_bytes, int probe_len, int half,
                                         int klen_group, cudaStream_t stream) {
  if (h < 1 || w < 1 || probe_len < 1 || probe_len > kMaxProbe || half < 1 || half > kMaxHalf ||
      klen_group < 1 || 32LL * n * h * ((w + 31) / 32) >= (1LL << 31) || !scratch)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  uint32_t* buf = static_cast<uint32_t*>(scratch);
  if (elem_bytes == 1)
    return launch_bridge_global<unsigned char>(masks, exps, angles, klen, klen_group, out, sched, buf, n, h, w,
                                               probe_len, half, stream);
  if (elem_bytes == 4)
    return launch_bridge_global<float>(masks, exps, angles, klen, klen_group, out, sched, buf, n, h, w,
                                       probe_len, half, stream);
  return (int)cudaErrorInvalidValue;
}
