"""The camera <-> AGV registration of a pan/tilt sweep, in float64 NumPy and
SciPy, written from the specification (upstream fitCylinderWPts3sAngs.m,
getTAGVcyl.m; the port's documented multi-start and diagnostic), not from
the program's code.

T_Cam_AGV minimises sum over frames f of mean over f's points of
(distance to the axis of T_Cam_AGV T_AGV_cyl(pan_f, tilt_f) - radius)^2,
the axis through that transform's origin along its y column.  The starts:
the closed-form triad of the first two usable frames' single-frame fits
(with the first frame's axis as fitted and reversed), and the 24 rotations
of the cube, each with its translation putting the first frame's
kinematic origin on its fitted origin.  Each start takes ``lm_iters``
Levenberg-Marquardt steps (the schedule of ``fit.levenberg_marquardt``,
central-difference Jacobian); the lowest cost wins.  ``well_posed``: the
least eigenvalue of JtJ at the solution, its rotation columns scaled by the
RMS distance of the points from their centroid, over the frames used, is
at least ``min_observability``.
"""

from __future__ import annotations

import itertools

import numpy as np
from scipy.spatial.transform import Rotation

from bench_h100.reference import fit as F


def t_agv_cyl(pan: float, tilt: float, l1: float, l2: float, h: float) -> np.ndarray:
    """Pan about z, [-l2, 0, 0] to the tilt joint, -tan(tilt) |l2| along z,
    the tilt about y by -tilt, then the tool transform."""
    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1.0]])

    def move(x, y, z):
        t = np.eye(4)
        t[:3, 3] = (x, y, z)
        return t

    tool = np.array([[0, -1, 0, l1], [-1, 0, 0, 0], [0, 0, -1, h], [0, 0, 0, 1.0]])
    return rz(pan) @ move(-l2, 0, 0) @ move(0, 0, -np.tan(tilt) * abs(l2)) @ ry(-tilt) @ tool


def to_matrix(v: np.ndarray) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = Rotation.from_rotvec(v[:3]).as_matrix()
    t[:3, 3] = v[3:]
    return t


def to_vector(t: np.ndarray) -> np.ndarray:
    return np.concatenate([Rotation.from_matrix(t[:3, :3]).as_rotvec(), t[:3, 3]])


class Objective:
    """Residuals (one per used point, weighted 1/sqrt(n_f)) of a pose."""

    def __init__(self, kin: np.ndarray, pts: list, radius: float):
        self.kin, self.radius = kin, radius
        self.frame = np.concatenate([np.full(len(p), f) for f, p in enumerate(pts)])
        self.pts = np.concatenate(pts)
        self.w = np.concatenate([np.full(len(p), 1.0 / np.sqrt(len(p))) for p in pts])

    def __call__(self, v: np.ndarray) -> np.ndarray:
        t = to_matrix(v) @ self.kin                      # (F, 4, 4)
        org, axis = t[self.frame, :3, 3], t[self.frame, :3, 1]
        rel = self.pts - org
        along = np.sum(rel * axis, axis=1) / np.sum(axis * axis, axis=1)
        d = np.linalg.norm(rel - along[:, None] * axis, axis=1)
        return (d - self.radius) * self.w

    def jacobian(self, v: np.ndarray, h: float = 1e-6) -> np.ndarray:
        cols = []
        for i in range(6):
            e = np.zeros(6)
            e[i] = h * max(1.0, abs(v[i]))
            cols.append((self(v + e) - self(v - e)) / (2 * e[i]))
        return np.stack(cols, axis=1)


def triad(kin0: np.ndarray, kin1: np.ndarray, cyl0: np.ndarray, cyl1: np.ndarray) -> np.ndarray:
    """The rotation taking the AGV's triad (frame 0's kinematic axis, its
    normal with the origins' displacement) onto the camera's (the fitted
    axis, its normal with the fitted origins' displacement)."""
    def unit(x):
        return x / np.linalg.norm(x)

    y_agv = kin0[:3, 1]
    n_agv = unit(np.cross(y_agv, kin1[:3, 3] - kin0[:3, 3]))
    y_cam = unit(cyl0[3:])
    n_cam = unit(np.cross(y_cam, cyl1[:3] - cyl0[:3]))
    cam = np.stack([y_cam, n_cam, np.cross(y_cam, n_cam)], axis=1)
    agv = np.stack([y_agv, n_agv, np.cross(y_agv, n_agv)], axis=1)
    t = np.eye(4)
    t[:3, :3] = cam @ np.linalg.inv(agv)
    t[:3, 3] = cyl0[:3] - t[:3, :3] @ kin0[:3, 3]
    return t


def cube_rotations() -> list:
    out = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            m = np.zeros((3, 3))
            for r, (c, s) in enumerate(zip(perm, signs)):
                m[r, c] = s
            if np.linalg.det(m) > 0:
                out.append(m)
    return out


def register(pts3: np.ndarray, valid: np.ndarray, angles: np.ndarray, healthy: np.ndarray, reg: dict) -> dict:
    """pts3 (F, N, 3), valid (F, N), angles (F, 2), healthy (F,) -> the
    fields of the program's ``RegistrationResult``."""
    kinc = reg["kinematics"]
    radius = reg["cyl_radius"]
    use = healthy if healthy.sum() >= 2 else np.ones_like(healthy)
    frames = [f for f in range(len(pts3)) if use[f] and valid[f].any()]
    kin = np.stack([t_agv_cyl(a[0], a[1], kinc["l1"], kinc["l2"], kinc["h"]) for a in angles[frames]])
    pts = [pts3[f][valid[f]] for f in frames]
    obj = Objective(kin, pts, radius)

    firsts = []
    for f in frames[:2]:
        p = pts3[f][valid[f]]
        _, q, _, _ = F.fit_cylinder(p, radius, 20, 60, 1e-3)
        firsts.append(F.prior(q, p))
    starts = []
    for sign in (1.0, -1.0):
        c0 = np.concatenate([firsts[0][:3], sign * firsts[0][3:]])
        c1 = np.concatenate([firsts[1][:3], sign * firsts[1][3:]])
        starts.append(to_vector(triad(kin[0], kin[1], c0, c1)))
    for m in cube_rotations():
        starts.append(np.concatenate([Rotation.from_matrix(m).as_rotvec(), firsts[0][:3] - m @ kin[0][:3, 3]]))

    best = None
    for s in starts:
        v, _, cost = F.levenberg_marquardt(obj, obj.jacobian, s, reg["lm_iters"], reg["lm_lambda0"])
        if best is None or cost < best[1]:
            best = (v, cost)
    v, cost = best
    r0 = obj(starts[0])

    allp = np.concatenate(pts)
    lever = np.sqrt(np.mean(np.sum((allp - allp.mean(axis=0)) ** 2, axis=1)))
    j = obj.jacobian(v)
    j[:, :3] /= max(lever, 1e-6)
    min_eig = np.linalg.eigvalsh(j.T @ j)[0] / max(len(frames), 1)
    return {"t_cam_agv": to_matrix(v), "fval0": float(r0 @ r0), "fval": cost, "jtj_min_eig": min_eig,
            "well_posed": bool(min_eig >= reg["min_observability"])}
