"""Multi-frame camera <-> AGV registration (port of the JAX package's
geometry/registration.py; ref utils/fitCylinderWPts3sAngs.m).

Given F frames of triangulated cylinder-surface points and the AGV's pan/tilt
angles, solve for T_Cam_AGV such that the kinematically predicted cylinder
axis of every frame (T @ T_AGV_cyl(pan, tilt), axis = its y column) explains
the frame's points at the known radius.  As in the JAX package: a closed-form
triad init from the first two valid frames, a multi-start of both triad axis
signs plus the 24 rotations of the cube, one LM over the 26 candidates as a
batch, and the observability diagnostic at the solution.

The LM's Jacobian is forward-mode AD of the residual,
``torch.func.vmap(torch.func.jacfwd(...))`` over the candidates, as the JAX
package takes ``jax.jacfwd``.  At the identity candidate (rotvec 0) the
Rodrigues ``sqrt(0)`` has a non-finite tangent only on the branch that
``torch.where`` does not select, so the Jacobian stays finite.

Host synchronisation on a CUDA device: ``torch.linalg.inv`` of the 3x3 triad
basis and ``torch.linalg.eigvalsh`` of the 6x6 JtJ check their results on the
host (one each per call); the per-frame init fits' ``eigh`` adds its own.
"""

from __future__ import annotations

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.config import KinematicsConfig, RegistrationConfig
from cylinder_pose_estimation_tpu_torch.geometry import transforms
from cylinder_pose_estimation_tpu_torch.geometry.cylinder import (
    apply_prior,
    dist_points_to_line,
    fit_cylinder,
)
from cylinder_pose_estimation_tpu_torch.geometry.kinematics import t_agv_cyl
from cylinder_pose_estimation_tpu_torch.ops.linalg import mm
from cylinder_pose_estimation_tpu_torch.ops.lm import levenberg_marquardt
from cylinder_pose_estimation_tpu_torch.types import RegistrationResult

_EPS = 1e-12


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)


def _triad_init(t_agv_cyls: torch.Tensor, cyl_params_f0: torch.Tensor) -> torch.Tensor:
    """Closed-form T0 from frames 0 & 1 (ref utils/fitCylinderWPts3sAngs.m:51-69).

    Aligns the frame-0 cylinder axis and the origin-displacement direction
    between the AGV-kinematic and the camera-estimated systems.
    ``t_agv_cyls`` (..., 2, 4, 4) and ``cyl_params_f0`` (..., 2, 6) hold
    frames 0 and 1; the leading axes broadcast -> (..., 4, 4)."""
    p1 = t_agv_cyls[..., 0, :3, 3]
    p2 = t_agv_cyls[..., 1, :3, 3]
    ep1 = cyl_params_f0[..., 0, :3]
    ep2 = cyl_params_f0[..., 1, :3]

    d12 = p2 - p1
    y_agv = t_agv_cyls[..., 0, :3, 1]
    nd = _normalize(torch.linalg.cross(y_agv, d12))

    ed12 = ep2 - ep1
    # Normalising keeps the triad R orthonormal (ref :62 feeds the raw
    # direction, whose norm drifts).
    dir_cam = _normalize(cyl_params_f0[..., 0, 3:6])
    end = _normalize(torch.linalg.cross(dir_cam, ed12))

    basis_cam = torch.stack([dir_cam, end, torch.linalg.cross(dir_cam, end)], dim=-1)
    basis_agv = torch.stack([y_agv, nd, torch.linalg.cross(y_agv, nd)], dim=-1)
    # MATLAB: R = basis_cam / basis_agv == basis_cam @ inv(basis_agv)
    r = mm(basis_cam, torch.linalg.inv(basis_agv))
    t = ep1 - mm(r, p1[..., None])[..., 0]
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=r.dtype, device=r.device)[3].expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def registration_residuals(
    pose6: torch.Tensor,
    t_agv_cyls: torch.Tensor,
    pts3s: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
) -> torch.Tensor:
    """Masked residuals (..., F*N) of poses (..., 6): distance to the predicted
    axis minus the radius, weighted by 1/sqrt(n_f) per frame so that the SSE
    is the reference's sum over frames of the mean squared residual (ref
    utils/fitCylinderWPts3sAngs.m:82-94).  Invalid entries are exactly 0."""
    t = transforms.vec_to_transform(pose6)
    t_cam_cyl = mm(t[..., None, :, :], t_agv_cyls)       # (..., F, 4, 4)
    origins = t_cam_cyl[..., :3, 3]
    dirs = t_cam_cyl[..., :3, 1]                          # y column = axis
    d = dist_points_to_line(pts3s, origins, dirs)         # (..., F, N)
    r = d - radius
    n = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1)
    w = torch.where(valid, 1.0 / torch.sqrt(n.to(r.dtype)), 0.0)
    return (r * w).flatten(-2)


def fit_cylinders_with_angles(
    pts3s: torch.Tensor,
    valid: torch.Tensor,
    angles: torch.Tensor,
    config: RegistrationConfig = RegistrationConfig(),
    frame_valid: torch.Tensor | None = None,
) -> RegistrationResult:
    """Full multi-frame registration (ref utils/fitCylinderWPts3sAngs.m:1-94).

    pts3s (F, N, 3) per-frame points in the camera-1 frame under valid
    (F, N); angles (F, 2) [pan, tilt] in radians; F >= 2.  ``frame_valid``
    (F,) drops whole frames from the objective, and the init is built from
    the first two valid frames; with fewer than 2 valid frames the mask is
    ignored.  Runs on the device of ``pts3s``."""
    if pts3s.shape[0] < 2:
        raise ValueError("registration needs >= 2 frames (ref :18)")
    # Inference tensors (from estimate_poses_batch) cannot enter forward AD.
    pts3s = pts3s.clone()
    valid = valid.clone()
    angles = angles.clone()
    dev = pts3s.device
    radius = config.cyl_radius
    f_total = pts3s.shape[0]

    if frame_valid is None:
        frame_valid = torch.ones((f_total,), dtype=torch.bool, device=dev)
    enough = torch.sum(frame_valid) >= 2
    frame_valid = frame_valid | ~enough
    valid = valid & frame_valid[:, None]

    t_agv_cyls = t_agv_cyl(angles[:, 0], angles[:, 1], config.kinematics)

    # The first two valid frames feed the init (ref :51 hardcodes 0 and 1).
    rank = torch.where(frame_valid, 0, f_total) + torch.arange(f_total, device=dev)
    order = torch.argsort(rank)[:2]
    init_pts = pts3s[order]
    init_val = valid[order]
    init_kin = t_agv_cyls[order]

    fit = fit_cylinder(init_pts, init_val, radius)
    cyl_params = apply_prior(fit.params, init_pts, init_val)   # (2, 6)

    def residual_fn(pose6):
        return registration_residuals(pose6, t_agv_cyls, pts3s, valid, radius)

    # Multi-start: both triad axis signs, then the 24-element cube rotation
    # group with the translation aligned through the frame-0 origins.
    signs = torch.tensor([1.0, -1.0], dtype=pts3s.dtype, device=dev)
    flip = torch.ones((2, 1, 6), dtype=pts3s.dtype, device=dev)
    flip[:, :, 3:6] = signs[:, None, None]
    triad_poses = transforms.transform_to_vec(_triad_init(init_kin, cyl_params * flip))

    cube = _cube_group_rotvecs(pts3s.dtype, dev)            # (24, 3)
    r_cube = transforms.rotvec_to_matrix(cube)              # (24, 3, 3)
    p1 = init_kin[0, :3, 3]
    ep1 = cyl_params[0, :3]
    t_cube = ep1[None, :] - mm(r_cube, p1[:, None])[..., 0]
    cube_poses = torch.cat([cube, t_cube], dim=-1)

    candidates = torch.cat([triad_poses, cube_poses], dim=0)   # (26, 6)
    jac_one = torch.func.jacfwd(residual_fn)
    res = levenberg_marquardt(
        residual_fn, candidates, jac_fn=torch.func.vmap(jac_one),
        iters=config.lm_iters, lambda0=config.lm_lambda0,
    )
    best = torch.argmin(res.cost)
    pose = res.params[best]

    r0 = residual_fn(triad_poses[0])

    # Observability diagnostic: min eigenvalue of the 6-dof JtJ at the
    # solution, rotation block scaled by the RMS point radius about the
    # centroid (dimensionless columns), per contributing frame.
    jac = jac_one(pose)                                     # (F*N, 6)
    w_all = valid.to(pts3s.dtype)
    n_all = torch.clamp(torch.sum(w_all), min=1.0)
    ctr = torch.sum(pts3s * w_all[..., None], dim=(0, 1)) / n_all
    lever = torch.sqrt(torch.sum(w_all * torch.sum((pts3s - ctr) ** 2, dim=-1)) / n_all)
    jac = torch.cat([jac[:, :3] / torch.clamp(lever, min=1e-6), jac[:, 3:]], dim=-1)
    jtj = mm(jac.T, jac)
    f_used = torch.clamp(torch.sum(torch.any(valid, dim=-1)).to(jtj.dtype), min=1.0)
    min_eig = torch.linalg.eigvalsh(jtj)[0] / f_used

    return RegistrationResult(
        t_cam_agv=transforms.vec_to_transform(pose),
        fval0=torch.sum(r0 * r0),
        fval=res.cost[best],
        jtj_min_eig=min_eig,
        well_posed=min_eig >= config.min_observability,
    )


def _cube_group_rotvecs(dtype, device) -> torch.Tensor:
    """Rotation vectors of the 24 rotational symmetries of the cube, a fixed
    covering of SO(3) used as multi-start seeds."""
    mats = []
    # All signed permutation matrices with determinant +1.
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)):
        for sx in (1, -1):
            for sy in (1, -1):
                for sz in (1, -1):
                    m = np.zeros((3, 3))
                    m[0, perm[0]] = sx
                    m[1, perm[1]] = sy
                    m[2, perm[2]] = sz
                    if np.linalg.det(m) > 0.5:
                        mats.append(m)
    mats = torch.as_tensor(np.stack(mats), dtype=dtype, device=device)
    return transforms.matrix_to_rotvec(mats)


def predicted_cylinder_poses(
    t_cam_agv: torch.Tensor,
    angles: torch.Tensor,
    config: RegistrationConfig = RegistrationConfig(),
) -> torch.Tensor:
    """T_Cam_cyl per frame = T_Cam_AGV @ T_AGV_cyl(pan, tilt) (ref exp_gridDetection.m:90-94)."""
    return mm(t_cam_agv, t_agv_cyl(angles[:, 0], angles[:, 1], config.kinematics))


def axis_errors(t_a, t_b, angles, kinematics: KinematicsConfig = KinematicsConfig()):
    """Per-frame angle (deg) and perpendicular origin offset (mm) between the
    cylinder axes that two T_Cam_AGV predict at ``angles`` (F, 2): the lines
    the registration objective sees, so poses that tie in the objective
    compare equal.  Host arrays in, float64 numpy (F,) arrays out."""
    a64 = torch.as_tensor(np.asarray(angles), dtype=torch.float64)
    kin = t_agv_cyl(a64[:, 0], a64[:, 1], kinematics).numpy()
    pa = np.asarray(t_a, np.float64) @ kin
    pb = np.asarray(t_b, np.float64) @ kin
    da = pa[:, :3, 1] / np.linalg.norm(pa[:, :3, 1], axis=-1, keepdims=True)
    db = pb[:, :3, 1] / np.linalg.norm(pb[:, :3, 1], axis=-1, keepdims=True)
    ang = np.degrees(np.arccos(np.clip(np.abs(np.sum(da * db, -1)), 0.0, 1.0)))
    rel = pb[:, :3, 3] - pa[:, :3, 3]
    perp = np.linalg.norm(rel - np.sum(rel * da, -1, keepdims=True) * da, axis=-1)
    return ang, perp
