"""Batched two-view DLT triangulation with reprojection errors (port of the
JAX package's geometry/triangulate.py).  Leading axes broadcast; the stereo
rig is shared by the batch."""

from __future__ import annotations

from typing import Tuple

import torch

from cylinder_pose_estimation_tpu_torch.ops.linalg import mm
from cylinder_pose_estimation_tpu_torch.types import StereoParams, TriangulationResult


def camera_matrices(stereo: StereoParams) -> Tuple[torch.Tensor, torch.Tensor]:
    k1 = stereo.cam1.k
    k2 = stereo.cam2.k
    p1 = torch.cat([k1, torch.zeros((3, 1), dtype=k1.dtype, device=k1.device)], dim=1)
    p2 = mm(k2, stereo.t_c2_c1[:3, :4])
    return p1, p2


def _normalize_pixels(xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    s = k[0, 1]
    yn = (xy[..., 1] - cy) / fy
    xn = (xy[..., 0] - cx - s * yn) / fx
    return torch.stack([xn, yn], dim=-1)


def triangulate(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    stereo: StereoParams,
    valid: torch.Tensor | None = None,
) -> TriangulationResult:
    """K-normalised inhomogeneous DLT of (..., M, 2) pairs; invalid slots
    return zero points."""
    dtype, dev = xy1.dtype, xy1.device
    rt1 = torch.cat([torch.eye(3, dtype=dtype, device=dev),
                     torch.zeros((3, 1), dtype=dtype, device=dev)], dim=1)
    rt2 = stereo.t_c2_c1[:3, :4]
    xn1 = _normalize_pixels(xy1, stereo.cam1.k)
    xn2 = _normalize_pixels(xy2, stereo.cam2.k)

    def rows(xn, p):
        return xn[..., :, :, None] * p[2][None, :] - p[:2]

    a = torch.cat([rows(xn1, rt1), rows(xn2, rt2)], dim=-2)  # (..., M, 4, 4)
    b = a[..., :, :3]
    c = a[..., :, 3]
    btb = mm(b.transpose(-1, -2), b)
    btc = torch.sum(b * c[..., :, None], dim=-2)
    if valid is not None:
        eye = torch.eye(3, dtype=dtype, device=dev)
        btb = torch.where(valid[..., None, None], btb, eye)
        btc = torch.where(valid[..., None], btc, 0.0)
    m00, m01, m02 = btb[..., 0, 0], btb[..., 0, 1], btb[..., 0, 2]
    m11, m12, m22 = btb[..., 1, 1], btb[..., 1, 2], btb[..., 2, 2]
    c0 = m11 * m22 - m12 * m12
    c1 = m02 * m12 - m01 * m22
    c2 = m01 * m12 - m02 * m11
    det = m00 * c0 + m01 * c1 + m02 * c2
    a11 = m00 * m22 - m02 * m02
    a12 = m01 * m02 - m00 * m12
    a22 = m00 * m11 - m01 * m01
    r0, r1, r2 = -btc[..., 0], -btc[..., 1], -btc[..., 2]
    safe_det = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    pts3 = torch.stack(
        [
            (c0 * r0 + c1 * r1 + c2 * r2) / safe_det,
            (c1 * r0 + a11 * r1 + a12 * r2) / safe_det,
            (c2 * r0 + a12 * r1 + a22 * r2) / safe_det,
        ],
        dim=-1,
    )
    err = reprojection_errors(pts3, xy1, xy2, stereo)
    ok = torch.isfinite(err) & (torch.abs(det) > 1e-20)
    if valid is not None:
        ok = ok & valid
    ok = ok & torch.all(torch.isfinite(pts3), dim=-1)
    pts3 = torch.where(ok[..., None], pts3, 0.0)
    err = torch.where(ok, err, 0.0)
    return TriangulationResult(points3=pts3, reproj_error=err, valid=ok)


def reprojection_errors(
    pts3: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor, stereo: StereoParams
) -> torch.Tensor:
    p1, p2 = camera_matrices(stereo)
    ph = torch.cat([pts3, torch.ones_like(pts3[..., :1])], dim=-1)

    def proj(p):
        h = mm(ph, p.T)
        return h[..., :2] / (h[..., 2:3] + 1e-12)

    e1 = torch.linalg.vector_norm(proj(p1) - xy1, dim=-1)
    e2 = torch.linalg.vector_norm(proj(p2) - xy2, dim=-1)
    return 0.5 * (e1 + e2)


def triangulate_with_threshold(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    stereo: StereoParams,
    error_threshold: float,
    valid: torch.Tensor | None = None,
) -> TriangulationResult:
    """Keep points under the reprojection threshold; if none passes, keep the
    unfiltered set (per leading batch element)."""
    res = triangulate(xy1, xy2, stereo, valid=valid)
    passed = res.valid & (res.reproj_error < error_threshold)
    any_passed = torch.any(passed, dim=-1, keepdim=True)
    return TriangulationResult(res.points3, res.reproj_error,
                               torch.where(any_passed, passed, res.valid))
