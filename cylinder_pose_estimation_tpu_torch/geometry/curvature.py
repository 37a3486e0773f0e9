"""Principal-curvature estimation at one point of a masked cloud (the part of
the JAX package's geometry/curvature.py that the cylinder fit calls), over a
leading frame axis.

kNN ties take the lower index, as ``lax.top_k`` does: the neighbours come
from a stable ascending argsort of the squared distances.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cylinder_pose_estimation_tpu_torch.ops.linalg import eigh, eigh2x2, mm, solve_normal_equations


class CurvatureResult(NamedTuple):
    directions: torch.Tensor      # (..., 3, 2)
    curvatures: torch.Tensor      # (..., 2)
    flat_direction: torch.Tensor  # (..., 3)


def _local_frame(normal: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
    x0 = eye[0].expand(normal.shape)
    x1 = eye[1].expand(normal.shape)
    use_alt = (torch.abs(normal[..., 0]) > 0.9)[..., None]
    xs = torch.where(use_alt, x1, x0)
    y = torch.linalg.cross(normal, xs)
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-12)
    x = torch.linalg.cross(y, normal)
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    return torch.stack([x, y, normal], dim=-1)


def _curvature_from_neighborhood(nbr: torch.Tensor, nbr_valid: torch.Tensor) -> CurvatureResult:
    dtype = nbr.dtype
    w = nbr_valid.to(dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1.0)
    mean = torch.sum(nbr * w, dim=-2, keepdim=True) / cnt
    cd = (nbr - mean) * w
    cov = mm(cd.transpose(-1, -2), cd) / torch.clamp(cnt[..., 0, :, None] - 1.0, min=1.0)
    _, vecs = eigh(cov)
    normal = vecs[..., :, 0]
    frame = _local_frame(normal)
    local = mm(nbr - mean, frame)
    x, y, z = local[..., 0], local[..., 1], local[..., 2]
    a = torch.stack([x * x, x * y, y * y, x, y], dim=-1)
    coeffs = solve_normal_equations(a, z, nbr_valid.to(dtype))
    evals, evecs2 = eigh2x2(2.0 * coeffs[..., 0], coeffs[..., 1], 2.0 * coeffs[..., 2])
    directions = mm(frame[..., :2], evecs2)
    flat = torch.argmin(torch.abs(evals), dim=-1)
    hot = (torch.arange(2, device=flat.device) == flat[..., None]).to(dtype)
    flat_dir = torch.sum(directions * hot[..., None, :], dim=-1)
    return CurvatureResult(directions=directions, curvatures=evals, flat_direction=flat_dir)


def estimate_curvatures(pts: torch.Tensor, valid: torch.Tensor, k: int = 20) -> CurvatureResult:
    """Curvature frame at every point of (..., N, 3) points."""
    n = pts.shape[-2]
    diff = pts[..., :, None, :] - pts[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(valid[..., None, :], d2, 1e30)
    k = min(k, n)
    nbr_idx = torch.argsort(d2, dim=-1, stable=True)[..., :k]  # (..., N, k)
    lead = nbr_idx.shape[:-2]
    flat = nbr_idx.reshape(lead + (n * k,))
    nbr = pts.gather(-2, flat[..., None].expand(lead + (n * k, 3))).reshape(lead + (n, k, 3))
    nbr_valid = valid.gather(-1, flat).reshape(lead + (n, k))
    return _curvature_from_neighborhood(nbr, nbr_valid)


def estimate_curvature_at(
    pts: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor, k: int = 20
) -> CurvatureResult:
    """Curvature frame at point ``idx`` (...,) of pts (..., N, 3)."""
    n = pts.shape[-2]
    p0 = pts.gather(-2, idx[..., None, None].expand(idx.shape + (1, 3)))
    diff = pts - p0
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(valid, d2, 1e30)
    k = min(k, n)
    nbr_idx = torch.argsort(d2, dim=-1, stable=True)[..., :k]
    nbr = pts.gather(-2, nbr_idx[..., None].expand(nbr_idx.shape + (3,)))
    nbr_valid = valid.gather(-1, nbr_idx)
    return _curvature_from_neighborhood(nbr, nbr_valid)
