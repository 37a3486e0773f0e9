// Batched solve of small symmetric positive definite systems a x = b
// (order P <= 8, float32 or float64): the Jacobi-equilibrated, unrolled
// Cholesky of ops/linalg.solve_spd_plain with its one refinement step.
//
// Replaces no TPU kernel.  The JAX package (and solve_spd_plain) write the
// solve as Python loops over (B,) arrays: on the TPU XLA fuses them into a
// few ops, on the card each scalar of the factor is a kernel of its own
// (265 for one 6x6 solve, 22 solves in a B=16 batch step, 141 in the
// registration), which made the solve more than half of the replayed steps'
// kernel nodes.
//
// Bound: launch latency.  The bytes are a, b and x once (3,072 B for the
// batch step's (16, 6, 6) float32 systems: 0.9 ns at 3.35 TB/s) and the
// arithmetic a few hundred operations a system; the call sites hold 2 to
// 1,536 systems.
//
// Design: one thread per system, the whole factor in registers (no shared
// memory), two launches a call.  Launch A: the equilibration, the
// factorisation and the first solve x; it writes x, and the factor and the
// scaling to scratch.  Between the launches the wrapper computes the
// residual r = b - sum(a * x[..., None, :], -1) in PyTorch, as the plain
// version does (the one reduction of the solve, in PyTorch's own order on
// the card).  Launch B: the second solve with the stored factor, and
// x + dx.  Every other operation is the plain version's, in its order, each
// rounded on its own: the operations below are the correctly rounded
// intrinsics, which the compiler never contracts into multiply-adds, so on
// the card the result is the plain version's bit for bit.  A NaN passes the
// clamps as torch.clamp passes it.
//
// Scratch layout (the wrapper allocates it): entry k of system i at
// fac[k * n + i]; entries 0 .. P(P+1)/2 - 1 are the factor's lower triangle
// by rows, then the P scale factors s_inv.

#include "common.cuh"

namespace {

constexpr int kSpdThreads = 128;
constexpr int kSpdMaxOrder = 8;

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// torch.clamp(v, min=lo): NaN passes through.
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v != v ? v : (v < lo ? lo : v);
}

// 1.0 / v as PyTorch computes it for a tensor: reciprocal(v) * 1.0.
template <typename T>
__device__ __forceinline__ T reciprocal(T v) {
  return Ops<T>::mul(Ops<T>::div(T(1), v), T(1));
}

// _chol_solve(l, rhs * s_inv) * s_inv: the forward and the backward
// substitution of the equilibrated system, in the plain version's order.
template <typename T, int P>
__device__ __forceinline__ void solve_eq(const T (&l)[P * (P + 1) / 2], const T (&s_inv)[P], const T (&rhs)[P],
                                         T (&out)[P]) {
  using O = Ops<T>;
  T y[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    T s = O::mul(rhs[i], s_inv[i]);
#pragma unroll
    for (int k = 0; k < i; ++k) s = O::sub(s, O::mul(l[i * (i + 1) / 2 + k], y[k]));
    y[i] = O::div(s, l[i * (i + 1) / 2 + i]);
  }
  T x[P];
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s = O::sub(s, O::mul(l[k * (k + 1) / 2 + i], x[k]));
    x[i] = O::div(s, l[i * (i + 1) / 2 + i]);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) out[i] = O::mul(x[i], s_inv[i]);
}

// Launch A: a (n, P, P) and b (n, P) contiguous; x (n, P); fac scratch.
template <typename T, int P>
__global__ void __launch_bounds__(kSpdThreads) spd_factor(const T* __restrict__ a, const T* __restrict__ b,
                                                          T* __restrict__ x, T* __restrict__ fac, int n) {
  using O = Ops<T>;
  constexpr int kTri = P * (P + 1) / 2;
  const int i = blockIdx.x * kSpdThreads + threadIdx.x;
  if (i >= n) return;
  const T tiny = T(1e-30);
  const T* ai = a + (size_t)i * P * P;
  T s_inv[P];
#pragma unroll
  for (int j = 0; j < P; ++j) s_inv[j] = reciprocal(O::sqrt(clamp_min(ai[j * P + j], tiny)));
  // The factor of a * s_inv[:, None] * s_inv[None, :], column by column.
  T l[kTri];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    T s = O::mul(O::mul(ai[j * P + j], s_inv[j]), s_inv[j]);
#pragma unroll
    for (int k = 0; k < j; ++k) s = O::sub(s, O::mul(l[j * (j + 1) / 2 + k], l[j * (j + 1) / 2 + k]));
    const T d = O::sqrt(clamp_min(s, tiny));
    l[j * (j + 1) / 2 + j] = d;
    const T inv_d = reciprocal(d);
#pragma unroll
    for (int r = j + 1; r < P; ++r) {
      T t = O::mul(O::mul(ai[r * P + j], s_inv[r]), s_inv[j]);
#pragma unroll
      for (int k = 0; k < j; ++k) t = O::sub(t, O::mul(l[r * (r + 1) / 2 + k], l[j * (j + 1) / 2 + k]));
      l[r * (r + 1) / 2 + j] = O::mul(t, inv_d);
    }
  }
  T rhs[P], out[P];
#pragma unroll
  for (int k = 0; k < P; ++k) rhs[k] = b[(size_t)i * P + k];
  solve_eq<T, P>(l, s_inv, rhs, out);
#pragma unroll
  for (int k = 0; k < P; ++k) x[(size_t)i * P + k] = out[k];
#pragma unroll
  for (int k = 0; k < kTri; ++k) fac[(size_t)k * n + i] = l[k];
#pragma unroll
  for (int k = 0; k < P; ++k) fac[(size_t)(kTri + k) * n + i] = s_inv[k];
}

// Launch B: out = x + solve_eq(r), r (n, P) the residual of x.
template <typename T, int P>
__global__ void __launch_bounds__(kSpdThreads) spd_refine(const T* __restrict__ r, const T* __restrict__ fac,
                                                          const T* __restrict__ x, T* __restrict__ out, int n) {
  constexpr int kTri = P * (P + 1) / 2;
  const int i = blockIdx.x * kSpdThreads + threadIdx.x;
  if (i >= n) return;
  T l[kTri], s_inv[P], rhs[P], dx[P];
#pragma unroll
  for (int k = 0; k < kTri; ++k) l[k] = fac[(size_t)k * n + i];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    s_inv[k] = fac[(size_t)(kTri + k) * n + i];
    rhs[k] = r[(size_t)i * P + k];
  }
  solve_eq<T, P>(l, s_inv, rhs, dx);
#pragma unroll
  for (int k = 0; k < P; ++k) out[(size_t)i * P + k] = Ops<T>::add(x[(size_t)i * P + k], dx[k]);
}

template <typename T, int P>
int launch_spd(bool refine, const void* in0, const void* in1, const void* in2, void* out, int n,
               cudaStream_t stream) {
  const int blocks = (n + kSpdThreads - 1) / kSpdThreads;
  if (refine) {
    spd_refine<T, P><<<blocks, kSpdThreads, 0, stream>>>((const T*)in0, (const T*)in1, (const T*)in2, (T*)out, n);
  } else {
    spd_factor<T, P><<<blocks, kSpdThreads, 0, stream>>>((const T*)in0, (const T*)in1, (T*)in2, (T*)out, n);
  }
  CPE_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int dispatch_spd(bool refine, const void* in0, const void* in1, const void* in2, void* out, int n, int p,
                 cudaStream_t stream) {
  switch (p) {
    case 1: return launch_spd<T, 1>(refine, in0, in1, in2, out, n, stream);
    case 2: return launch_spd<T, 2>(refine, in0, in1, in2, out, n, stream);
    case 3: return launch_spd<T, 3>(refine, in0, in1, in2, out, n, stream);
    case 4: return launch_spd<T, 4>(refine, in0, in1, in2, out, n, stream);
    case 5: return launch_spd<T, 5>(refine, in0, in1, in2, out, n, stream);
    case 6: return launch_spd<T, 6>(refine, in0, in1, in2, out, n, stream);
    case 7: return launch_spd<T, 7>(refine, in0, in1, in2, out, n, stream);
    case 8: return launch_spd<T, 8>(refine, in0, in1, in2, out, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int solve_spd_launch(bool refine, const void* in0, const void* in1, const void* in2, void* out, int n, int p,
                     int elem_bytes, cudaStream_t stream) {
  if (n < 0 || p < 1 || p > kSpdMaxOrder) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (elem_bytes == 4) return dispatch_spd<float>(refine, in0, in1, in2, out, n, p, stream);
  if (elem_bytes == 8) return dispatch_spd<double>(refine, in0, in1, in2, out, n, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch A of a solve: n systems of order p, elem_bytes 4 (float32) or 8
// (float64).  a (n, p, p) and b (n, p) in; x (n, p) and fac (p (p + 1) / 2
// + p, n) out.
CPE_API int cpe_solve_spd_factor(const void* a, const void* b, void* x, void* fac, int n, int p, int elem_bytes,
                                 cudaStream_t stream) {
  return solve_spd_launch(false, a, b, x, fac, n, p, elem_bytes, stream);
}

// Launch B: r (n, p), the residual of x, and launch A's fac and x in;
// out (n, p) = x + the solve of r.
CPE_API int cpe_solve_spd_refine(const void* r, const void* fac, const void* x, void* out, int n, int p,
                                 int elem_bytes, cudaStream_t stream) {
  return solve_spd_launch(true, r, fac, x, out, n, p, elem_bytes, stream);
}
