"""Small closed-form linear algebra (port of the JAX package's ops/linalg.py).

``mm`` is a plain float32 matmul: the port's entry points switch TF32 off
(``exact_float32``), which is what the JAX code's ``Precision.HIGHEST`` asks
for.  ``solve_spd_plain`` keeps the equilibrated, unrolled Cholesky with one
step of iterative refinement exactly as written there: both guards are
needed in float32 on the worst-conditioned LM systems.  ``solve_spd`` runs
it on CPU tensors and launches its hand-written CUDA kernel
(``csrc/linalg.cu``) on CUDA tensors, bit for bit the plain version there.

Nothing here waits for the host on a CUDA device: ``eigh`` takes the place
of ``torch.linalg.eigh`` / ``eigvalsh`` (which read their solver's status
back to the host there) on every path a compiled step captures.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from cylinder_pose_estimation_tpu_torch.ops import kernels
from cylinder_pose_estimation_tpu_torch.ops.constants import device_constant

_EPS = 1e-12
# The largest order of system the CUDA solve (``csrc/linalg.cu``) takes.
SPD_MAX_ORDER = 8
# Cyclic Jacobi sweeps of ``eigh_jacobi`` by matrix order: the fewest that
# meet tests/test_torch_sync_free.py's bounds on all of its batches (random,
# graded 1e-6..1, repeated eigenvalues, diagonal, zero), which pin them.
JACOBI_SWEEPS = {3: 4, 6: 6}
# A rotation is skipped where 100 |a_pq| does not change |a_pp| or |a_qq| in
# float64 (Numerical Recipes' test): |a_pq| * 100 / (eps / 2) <= both.
_JACOBI_SKIP = 100.0 / 2.0 ** -53


def exact_float32() -> None:
    """Full-float32 matmuls and convolutions (no TF32) on CUDA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def masked_mean(pts: torch.Tensor, valid: torch.Tensor, dim: int = -2) -> torch.Tensor:
    w = valid.to(pts.dtype)[..., None]
    n = torch.sum(w, dim=dim)
    return torch.sum(pts * w, dim=dim) / torch.clamp(n, min=1.0)


def masked_cov(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sample covariance (divisor n-1) of (..., N, D) points under (..., N)."""
    w = valid.to(pts.dtype)[..., None]
    n = torch.sum(w, dim=-2, keepdim=True)
    mean = torch.sum(pts * w, dim=-2, keepdim=True) / torch.clamp(n, min=1.0)
    d = (pts - mean) * w
    cov = mm(d.transpose(-1, -2), d)
    return cov / torch.clamp(n[..., 0, :, None] - 1.0, min=1.0)


def pca_components(pts: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Principal axes (columns, descending variance) and variances."""
    cov = masked_cov(pts, valid)
    evals, evecs = eigh(cov)  # ascending
    return torch.flip(evecs, dims=(-1,)), torch.flip(evals, dims=(-1,))


def _lapack(a: torch.Tensor) -> bool:
    """Whether ``eigh`` solves ``a`` with LAPACK: on CPU tensors."""
    return a.device.type == "cpu"


def eigh(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh``'s (ascending eigenvalues, column eigenvectors)
    of symmetric (..., n, n) matrices, with no host synchronisation on a
    CUDA device: there ``eigh_jacobi``; on a CPU tensor LAPACK
    (``torch.linalg.eigh``), which the CPU has no reason to avoid.

    LAPACK on the CPU is the JAX package's own solver there, and the CPU
    tests hold the port to that package at tolerances only its rounding
    meets: the curvature-seeded fits of ill-conditioned frames are chaotic
    in their start, and a start 1e-7 away (any other solver's eigenvector)
    moves a frame's axis by up to 1.7e-3 rad or the registration's
    diagnostic by 0.2%; see ROADMAP section 3.  ``eigh_jacobi`` agrees with
    float64 LAPACK to the rounding of its input (tests/test_torch_sync_free.py)."""
    if _lapack(a):
        return torch.linalg.eigh(a)
    return eigh_jacobi(a)


@functools.lru_cache(maxsize=None)
def _rotation_planes(n: int, dtype, device) -> tuple:
    """(p, q, I, P, S) of every rotation of one sweep, pairs p < q in row
    order: J = I + (c - 1) P + s S is the Jacobi rotation in the (p, q)
    plane with cosine c and sine s."""
    eye = [[float(i == j) for j in range(n)] for i in range(n)]
    planes = []
    for p in range(n - 1):
        for q in range(p + 1, n):
            plane = [[float(i == j and i in (p, q)) for j in range(n)] for i in range(n)]
            sine = [[float((i, j) == (p, q)) - float((i, j) == (q, p)) for j in range(n)] for i in range(n)]
            planes.append((p, q, *(device_constant(m, dtype, device) for m in (eye, plane, sine))))
    return tuple(planes)


def eigh_jacobi(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (..., n), ascending, and column eigenvectors (..., n, n)
    of symmetric (..., n, n) matrices, as ``torch.linalg.eigh`` returns them
    (the upper triangle is read).

    Cyclic Jacobi: ``JACOBI_SWEEPS[n]`` passes over the
    pairs p < q in row order, each a rotation J = [[c, s], [-s, c]] in the
    (p, q) plane with t = s / c the smaller root of t^2 + 2 theta t - 1 = 0,
    theta = (a_qq - a_pp) / (2 a_pq), so that a <- J^T a J zeroes a_pq, and
    the vectors v <- v J.  The count is fixed, with no test of convergence,
    so no value goes back to the host and a CUDA graph can capture it.
    A zero a_pq gives J = I (no rotation).  Eigenvectors carry the sign the
    rotations give them, which may differ from LAPACK's.

    The sweeps run in float64 and the results are rounded once to ``a``'s
    type: the eigenpairs of the given matrix to its own rounding, whatever
    order the device sums in."""
    out_dtype = a.dtype
    a = a.to(torch.float64)
    n = a.shape[-1]
    v = None
    for _ in range(JACOBI_SWEEPS[n]):
        for p, q, eye, plane, sine in _rotation_planes(n, a.dtype, a.device):
            app, aqq, apq = a[..., p, p], a[..., q, q], a[..., p, q]
            theta = (aqq - app) / (2.0 * apq)
            # t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), written
            # so that theta = +-inf gives 0.
            t = 1.0 / (theta + torch.copysign(torch.sqrt(theta * theta + 1.0), theta))
            # No rotation where a_pq is below the rounding of both
            # diagonal entries (a_pq == 0 included, whose theta may be
            # nan): rotating rounding noise only loses orthogonality.
            negligible = torch.abs(apq) * _JACOBI_SKIP <= torch.minimum(torch.abs(app), torch.abs(aqq))
            t = torch.where(negligible, 0.0, t)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            j = eye + (c - 1.0)[..., None, None] * plane + s[..., None, None] * sine
            a = mm(mm(j.transpose(-1, -2), a), j)
            v = j if v is None else mm(v, j)
    evals, order = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1, stable=True)
    evecs = v.gather(-1, order[..., None, :].expand(v.shape))
    return evals.to(out_dtype), evecs.to(out_dtype)


def eigh2x2(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Closed-form eigendecomposition of symmetric [[a, b], [b, c]]:
    (eigenvalues (..., 2) ascending, eigenvectors (..., 2, 2) as columns)."""
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    root = torch.sqrt(half_diff * half_diff + b * b)
    lo = half_tr - root
    hi = half_tr + root
    v1 = torch.stack([b, hi - a], dim=-1)
    v2 = torch.stack([hi - c, b], dim=-1)
    use_v1 = (torch.abs(hi - a) > torch.abs(hi - c))[..., None]
    v_hi = torch.where(use_v1, v1, v2)
    norm = torch.linalg.vector_norm(v_hi, dim=-1, keepdim=True)
    ident = torch.stack([torch.ones_like(b), torch.zeros_like(b)], dim=-1)
    v_hi = torch.where(norm > 1e-20, v_hi / (norm + _EPS), ident)
    v_lo = torch.stack([-v_hi[..., 1], v_hi[..., 0]], dim=-1)
    return torch.stack([lo, hi], dim=-1), torch.stack([v_lo, v_hi], dim=-1)


def _chol_solve(l, b):
    p = len(l)
    y = [None] * p
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def solve_spd_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve a @ x = b: Jacobi-equilibrated unrolled Cholesky
    plus one refinement step against the original ``a``."""
    p = a.shape[-1]
    tiny = 1e-30
    s_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(a, dim1=-2, dim2=-1), min=tiny))
    a_eq = a * s_inv[..., :, None] * s_inv[..., None, :]
    l = [[None] * p for _ in range(p)]
    for j in range(p):
        s = a_eq[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        d = torch.sqrt(torch.clamp(s, min=tiny))
        l[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, p):
            s = a_eq[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d

    def solve_eq(rhs):
        return _chol_solve(l, rhs * s_inv) * s_inv

    x = solve_eq(b)
    r = b - torch.sum(a * x[..., None, :], dim=-1)
    return x + solve_eq(r)


def _check_spd(a: torch.Tensor, b: torch.Tensor) -> int:
    """The order p of (..., p, p) systems ``a`` with right-hand sides
    (..., p) ``b``; raises ValueError for what the CUDA solve does not take."""
    if a.device != b.device:
        raise ValueError(f"solve_spd: a on {a.device}, b on {b.device}")
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
        raise ValueError(f"solve_spd: expected float32 or float64 for both, got {a.dtype} and {b.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"solve_spd: a must be (..., p, p), got shape {tuple(a.shape)}")
    p = a.shape[-1]
    if not 1 <= p <= SPD_MAX_ORDER:
        raise ValueError(f"solve_spd: order {p} outside 1..{SPD_MAX_ORDER}")
    if b.shape != a.shape[:-1]:
        raise ValueError(f"solve_spd: b must be {tuple(a.shape[:-1])}, got {tuple(b.shape)}")
    return p


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``solve_spd_plain`` of (..., p, p) ``a`` and (..., p) ``b`` (the same
    lead shape, p <= ``SPD_MAX_ORDER``, float32 or float64).  A CPU tensor
    runs the plain version; a CUDA tensor launches ``csrc/linalg.cu`` twice
    (the factor and the first solve; the refinement) around the plain
    version's residual in PyTorch, and raises if it cannot."""
    if not kernels.route(a):
        return solve_spd_plain(a, b)
    p = _check_spd(a, b)
    n = a.numel() // (p * p)
    ac, bc = a.contiguous(), b.contiguous()
    x = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    fac = torch.empty((p * (p + 1) // 2 + p, n), dtype=b.dtype, device=b.device)
    kernels.launch("cpe_solve_spd_factor", [ac, bc, x, fac], [n, p, a.element_size()], [])
    r = (b - torch.sum(a * x[..., None, :], dim=-1)).contiguous()
    out = torch.empty_like(x)
    kernels.launch("cpe_solve_spd_refine", [r, fac, x, out], [n, p, a.element_size()], [])
    kernels.count("solve_spd")
    return out


def solve_normal_equations(
    a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, ridge: float = 1e-9
) -> torch.Tensor:
    """argmin ||w (A x - b)|| via ridge-regularised normal equations."""
    aw = a * w[..., None]
    ata = mm(aw.transpose(-1, -2), aw)
    atb = mm(aw.transpose(-1, -2), (b * w)[..., None])
    p = a.shape[-1]
    ata = ata + ridge * torch.eye(p, dtype=a.dtype, device=a.device)
    return solve_spd(ata, atb[..., 0])
