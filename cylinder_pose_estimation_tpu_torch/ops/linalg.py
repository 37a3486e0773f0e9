"""Small closed-form linear algebra (port of the JAX package's ops/linalg.py).

``mm`` is a plain float32 matmul: the port's entry points switch TF32 off
(``exact_float32``), which is what the JAX code's ``Precision.HIGHEST`` asks
for.  ``solve_spd`` keeps the equilibrated, unrolled Cholesky with one step
of iterative refinement exactly as written there: both guards are needed in
float32 on the worst-conditioned LM systems.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


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
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    return torch.flip(evecs, dims=(-1,)), torch.flip(evals, dims=(-1,))


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


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
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
