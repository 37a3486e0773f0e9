"""Cylinder fitting: residuals, closed-form Jacobian, curvature-seeded init,
fixed-iteration LM and the axis prior (port of the JAX package's
geometry/cylinder.py) over a leading frame axis."""

from __future__ import annotations

from typing import NamedTuple

import torch

from cylinder_pose_estimation_tpu_torch.geometry.curvature import estimate_curvature_at
from cylinder_pose_estimation_tpu_torch.ops.linalg import masked_mean, mm, pca_components
from cylinder_pose_estimation_tpu_torch.ops.lm import levenberg_marquardt

_EPS = 1e-12


def dist_points_to_line(pts: torch.Tensor, p1: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    v = direction
    nv2 = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=_EPS)
    rel = pts - p1[..., None, :]
    alpha = mm(rel, v[..., :, None])[..., 0] / nv2
    proj = p1[..., None, :] + alpha[..., None] * v[..., None, :]
    return torch.linalg.vector_norm(pts - proj, dim=-1)


def cylinder_residuals(params: torch.Tensor, pts: torch.Tensor, radius: float) -> torch.Tensor:
    return dist_points_to_line(pts, params[..., :3], params[..., 3:6]) - radius


def cylinder_residuals_jac(params: torch.Tensor, pts: torch.Tensor, radius: float) -> torch.Tensor:
    """dr/do = -u_hat, dr/dv = -alpha u_hat (u the radial component)."""
    o = params[..., :3]
    v = params[..., 3:6]
    nv2 = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=_EPS)
    rel = pts - o[..., None, :]
    alpha = mm(rel, v[..., :, None])[..., 0] / nv2
    u = rel - alpha[..., None] * v[..., None, :]
    t = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    uhat = u / torch.clamp(t, min=_EPS)
    return torch.cat([-uhat, -alpha[..., None] * uhat], dim=-1)


class CylinderInit(NamedTuple):
    params0: torch.Tensor
    ok: torch.Tensor


def init_cylinder(pts: torch.Tensor, valid: torch.Tensor, radius: float, knn_k: int = 20) -> CylinderInit:
    ctr = masked_mean(pts, valid)
    comps, _ = pca_components(pts, valid)
    rdir = comps[..., :, 2]
    rdir = torch.where(rdir[..., 2:3] < 0, -rdir, rdir)
    ok = rdir[..., 2] > 0
    d = dist_points_to_line(pts, ctr, rdir)
    d = torch.where(valid, d, float("inf"))
    i = torch.argmin(d, dim=-1)
    closest = pts.gather(-2, i[..., None, None].expand(i.shape + (1, 3)))[..., 0, :]
    d2surface = torch.linalg.vector_norm(ctr - closest, dim=-1)
    cyldir = estimate_curvature_at(pts, valid, i, k=knn_k).flat_direction
    cylorg = ctr + rdir * (radius - d2surface)[..., None]
    return CylinderInit(params0=torch.cat([cylorg, cyldir], dim=-1), ok=ok)


class CylinderFit(NamedTuple):
    params0: torch.Tensor
    params: torch.Tensor
    fvals: torch.Tensor
    init_ok: torch.Tensor


def fit_cylinder(
    pts: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    knn_k: int = 20,
    lm_iters: int = 60,
    lm_lambda0: float = 1e-3,
) -> CylinderFit:
    init = init_cylinder(pts, valid, radius, knn_k=knn_k)
    res = levenberg_marquardt(
        lambda p: cylinder_residuals(p, pts, radius),
        init.params0,
        jac_fn=lambda p: cylinder_residuals_jac(p, pts, radius),
        weights=valid.to(pts.dtype),
        iters=lm_iters,
        lambda0=lm_lambda0,
    )
    return CylinderFit(
        params0=init.params0,
        params=res.params,
        fvals=torch.stack([res.cost0, res.cost], dim=-1),
        init_ok=init.ok,
    )


def apply_prior(params: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Flip the axis so dir_y >= 0, slide the origin to the minimum point y."""
    origin = params[..., :3]
    direction = params[..., 3:6]
    direction = torch.where(direction[..., 1:2] < 0, -direction, direction)
    big = torch.finfo(pts.dtype).max
    y_min = torch.amin(torch.where(valid, pts[..., 1], big), dim=-1)
    dy = direction[..., 1]
    small = torch.abs(dy) < 1e-12
    t = torch.where(small, 0.0, (y_min - origin[..., 1]) / torch.where(small, 1.0, dy))
    return torch.cat([origin + t[..., None] * direction, direction], dim=-1)


def mean_sq_residual(params: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
                     radius: float) -> torch.Tensor:
    """Mean over valid points of the squared residuals."""
    r = cylinder_residuals(params, pts, radius)
    w = valid.to(pts.dtype)
    return torch.sum(w * r * r, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)
