"""Batched masked polynomial fitting, evaluation and curve intersection
(port of the JAX package's ops/polyfit.py).  Coefficients are highest
degree first, as in ``np.polyfit``."""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.linalg import mm, solve_spd


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x) + coeffs[..., 0]
    for i in range(1, coeffs.shape[-1]):
        out = out * x + coeffs[..., i]
    return out


def polyder(coeffs: torch.Tensor) -> torch.Tensor:
    d = coeffs.shape[-1] - 1
    if d == 0:
        return torch.zeros_like(coeffs[..., :1])
    powers = torch.arange(d, 0, -1, dtype=coeffs.dtype, device=coeffs.device)
    return coeffs[..., :-1] * powers


def masked_polyfit(
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, degree: int
) -> torch.Tensor:
    """Weighted least-squares polyfit in a centred/scaled basis, mapped back
    to raw-x coefficients; x, y, w: (..., N) -> (..., D+1)."""
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mu = torch.sum(x * w, dim=-1, keepdim=True) / n
    var = torch.sum(w * (x - mu) ** 2, dim=-1, keepdim=True) / n
    sigma = torch.sqrt(torch.clamp(var, min=1e-12))
    xs = (x - mu) / sigma
    a = torch.stack([xs ** d for d in range(degree, -1, -1)], dim=-1)
    aw = a * w[..., None]
    ata = mm(aw.transpose(-1, -2), aw)
    atb = mm(aw.transpose(-1, -2), (y * w)[..., None])
    ata = ata + 1e-8 * torch.eye(degree + 1, dtype=x.dtype, device=x.device)
    cs = solve_spd(ata, atb[..., 0])

    cols = [torch.zeros_like(cs[..., 0]) for _ in range(degree + 1)]
    for k in range(degree + 1):
        d = degree - k
        for j in range(d + 1):
            comb = 1.0
            for t in range(j):
                comb = comb * (d - t) / (t + 1)
            term = cs[..., k] * comb * (-mu[..., 0]) ** (d - j) / sigma[..., 0] ** d
            cols[degree - j] = cols[degree - j] + term
    return torch.stack(cols, dim=-1)


def poly_domain(x: torch.Tensor, w: torch.Tensor, margin: float) -> torch.Tensor:
    big = torch.finfo(x.dtype).max
    lo = torch.amin(torch.where(w > 0, x, big), dim=-1) - margin
    hi = torch.amax(torch.where(w > 0, x, -big), dim=-1) + margin
    return torch.stack([lo, hi], dim=-1)


def poly_intersection(
    row_coeffs: torch.Tensor,
    col_coeffs: torch.Tensor,
    x0: torch.Tensor,
    iters: int = 12,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Newton on h(x) = x - g(f(x)) for y = f(x) (row), x = g(y) (col)."""
    row_d = polyder(row_coeffs)
    col_d = polyder(col_coeffs)
    x = x0
    for _ in range(iters):
        y = polyval(row_coeffs, x)
        gx = polyval(col_coeffs, y)
        h = x - gx
        dh = 1.0 - polyval(col_d, y) * polyval(row_d, x)
        dh = torch.where(torch.abs(dh) < 1e-8, torch.sign(dh) * 1e-8 + 1e-12, dh)
        x_new = x - h / dh
        x = torch.where(torch.isfinite(x_new), x_new, x)
    return x, polyval(row_coeffs, x)
