"""Rigid transforms, rotation parametrisations and projection (port of the
JAX package's geometry/transforms.py).  Every function broadcasts over
leading axes."""

from __future__ import annotations

import torch

from cylinder_pose_estimation_tpu_torch.ops.linalg import mm

_EPS = 1e-12


def _bottom_row(shape_lead, like: torch.Tensor) -> torch.Tensor:
    row = torch.eye(4, dtype=like.dtype, device=like.device)[3]
    return row.expand(tuple(shape_lead) + (1, 4))


def rotvec_to_matrix(rv: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3)."""
    t2 = torch.sum(rv * rv, dim=-1)[..., None, None]
    t = torch.sqrt(t2)
    small = t < 1e-4
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / torch.where(small, 1.0, t))
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.where(small, 1.0, t2))
    kx, ky, kz = rv[..., 0], rv[..., 1], rv[..., 2]
    z = torch.zeros_like(kx)
    khat = torch.stack(
        [
            torch.stack([z, -kz, ky], dim=-1),
            torch.stack([kz, z, -kx], dim=-1),
            torch.stack([-ky, kx, z], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device).expand(khat.shape)
    return eye + a * khat + b * mm(khat, khat)


def matrix_to_rotvec(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]],
        dim=-1,
    )
    sin_t = torch.linalg.vector_norm(w, dim=-1) * 0.5
    th = theta[..., None]
    small = th < 1e-4
    scale = torch.where(
        small, 0.5 + th ** 2 / 12.0,
        th / torch.where(small, 1.0, 2.0 * sin_t[..., None] + _EPS),
    )
    rv_generic = scale * w
    m = (r + r.transpose(-1, -2)) * 0.5 + torch.eye(3, dtype=r.dtype, device=r.device)
    diag = torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    axis = torch.take_along_dim(m, k[..., None, None].expand(m.shape[:-1] + (1,)), dim=-1)[..., 0]
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + _EPS)
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    rv_pi = th * axis * sign
    near_pi = (torch.pi - th) < 1e-3
    return torch.where(near_pi, rv_pi, rv_generic)


def vec_to_transform(v: torch.Tensor) -> torch.Tensor:
    """[rotvec(3), t(3)] -> (..., 4, 4)."""
    r = rotvec_to_matrix(v[..., :3])
    top = torch.cat([r, v[..., 3:6, None]], dim=-1)
    return torch.cat([top, _bottom_row(top.shape[:-2], v)], dim=-2)


def transform_to_vec(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([matrix_to_rotvec(t[..., :3, :3]), t[..., :3, 3]], dim=-1)


def cyl_params_to_transform(cyl_params: torch.Tensor) -> torch.Tensor:
    """Cylinder [origin, direction] -> (..., 4, 4) pose with y = axis."""
    org = cyl_params[..., :3]
    y = cyl_params[..., 3:6]
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + _EPS)
    x0 = torch.eye(3, dtype=y.dtype, device=y.device)[0].expand(y.shape)
    z = torch.linalg.cross(x0, y)
    z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + _EPS)
    x = torch.linalg.cross(y, z)
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _EPS)
    r = torch.stack([x, y, z, org], dim=-1)
    return torch.cat([r, _bottom_row(r.shape[:-2], r)], dim=-2)


def transform_points(t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3)."""
    return mm(pts, t[..., :3, :3].transpose(-1, -2)) + t[..., None, :3, 3]


def project_points(pts3: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    h = mm(pts3, k.transpose(-1, -2))
    return h[..., :2] / (h[..., 2:3] + _EPS)


def invert_transform(t: torch.Tensor) -> torch.Tensor:
    r = t[..., :3, :3]
    tr = t[..., :3, 3]
    rt = r.transpose(-1, -2)
    ti = -mm(rt, tr[..., None])[..., 0]
    top = torch.cat([rt, ti[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top.shape[:-2], t)], dim=-2)
