"""The stereo fit of one frame, in float64 NumPy, written from the
specification and not from the program's code: correspondences by grid id,
patch-consensus selection, triangulation, the curvature-seeded start, the
fixed-step Levenberg-Marquardt cylinder fit, the axis prior and the pose.

What each step computes (the upstream MATLAB of cv3vpl-lab/cylinder-pose-
estimation and the port's documented deviations from it):

- correspondences: the ids present in both views, on a ``extent`` x
  ``extent`` raster placed at the least id of either view (ids past it
  are dropped); the raster's row-major order is the layout of
  ``points_valid`` (chooseIdx.m);
- selection: patches of ``patch_size`` x ``patch_size`` consecutive ids
  of view 1's present rows and columns, every cell in both views, whose
  mean reprojection error is under ``error_threshold``; a point is kept if
  any accepted patch covers it, and every correspondence if none does;
- triangulation: the linear least-squares point of the four DLT rows in
  normalised camera coordinates (x = K^-1 u), the reprojection error the
  mean of the two views' pixel distances;
- start: the points' centroid, the axis of least variance towards +z, the
  point nearest that line, the flattest principal direction of the
  quadric fitted to its ``knn_k`` nearest neighbours (estCurvatures.m); the
  origin sits ``radius`` behind the surface along the least-variance axis;
- fit: ``iters`` Levenberg-Marquardt steps on sum (|p - axis| - r)^2 with
  damping lambda * diag(JtJ), lambda from 1e-3, / 3 on an accepted step
  and x 2 on a refused one, clamped to [1e-12, 1e12];
- prior: the axis with y >= 0 and the origin slid along it to the least y
  of the points (applyCylParamsPrior.m); the pose's y column is the axis,
  z = x0 x y, x = y x z;
- settled: whether ``SETTLE_ITERS`` more steps lower the cost by under a
  relative ``SETTLE_TOL``.  Where they do not, the fixed-step fit has not
  reached its minimum, and where it stops there follows the rounding of
  every step before: on such a frame a float32 and a float64 fit end
  apart (one stream frame: costs 33.27 and 33.75 after 20 steps, 15.62
  after 40), so its end point is not compared (``common/compare.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SETTLE_ITERS, SETTLE_TOL = 80, 1e-6


def normalised(xy: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Pixel coordinates (n, 2) -> normalised camera coordinates (n, 2)."""
    h = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    return np.linalg.solve(k, h.T).T[:, :2]


def triangulate(xy1: np.ndarray, xy2: np.ndarray, k1: np.ndarray, k2: np.ndarray,
                t21: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 3) points in camera 1 and their (n,) reprojection errors."""
    n1, n2 = normalised(xy1, k1), normalised(xy2, k2)
    p1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    p2 = t21[:3, :4]
    pts = np.zeros((len(xy1), 3))
    for i in range(len(xy1)):
        rows = np.stack([n1[i, 0] * p1[2] - p1[0], n1[i, 1] * p1[2] - p1[1],
                         n2[i, 0] * p2[2] - p2[0], n2[i, 1] * p2[2] - p2[1]])
        pts[i] = np.linalg.lstsq(rows[:, :3], -rows[:, 3], rcond=None)[0]
    return pts, reprojection(pts, xy1, xy2, k1, k2, t21)


def reprojection(pts, xy1, xy2, k1, k2, t21) -> np.ndarray:
    def proj(p, k):
        h = p @ k.T
        return h[:, :2] / h[:, 2:3]

    in2 = pts @ t21[:3, :3].T + t21[:3, 3]
    return 0.5 * (np.linalg.norm(proj(pts, k1) - xy1, axis=1) + np.linalg.norm(proj(in2, k2) - xy2, axis=1))


def select(ids1: Dict[tuple, np.ndarray], ids2: Dict[tuple, np.ndarray], rig, patch: int,
           threshold: float, extent: int):
    """The raster: (offset, per-cell xy of both views, both-present mask,
    selected mask), each cell (i, j) the id offset + (i, j)."""
    if not ids1 and not ids2:
        off = np.zeros(2, int)
    else:
        off = np.min(np.array(list(ids1) + list(ids2)), axis=0)
    xy = np.zeros((2, extent, extent, 2))
    have = np.zeros((2, extent, extent), bool)
    for v, ids in enumerate((ids1, ids2)):
        for key, p in ids.items():
            i, j = key[0] - off[0], key[1] - off[1]
            if 0 <= i < extent and 0 <= j < extent:
                xy[v, i, j], have[v, i, j] = p, True
    both = have[0] & have[1]
    err = np.zeros((extent, extent))
    cells = np.argwhere(both)
    if len(cells):
        k1, k2, t21 = rig
        _, e = triangulate(xy[0][both], xy[1][both], k1, k2, t21)
        err[both] = np.where(np.isfinite(e), e, 1e6)
    rows = np.flatnonzero(have[0].any(axis=1))
    cols = np.flatnonzero(have[0].any(axis=0))
    chosen = np.zeros_like(both)
    for a in range(len(rows) - patch + 1):
        for b in range(len(cols) - patch + 1):
            rr, cc = np.ix_(rows[a:a + patch], cols[b:b + patch])
            if both[rr, cc].all() and err[rr, cc].sum() / (patch * patch) < threshold:
                chosen[rr, cc] = True
    chosen &= both
    if not chosen.any():
        chosen = both
    return off, xy, both, chosen


def knn(pts: np.ndarray, i: int, k: int) -> np.ndarray:
    d2 = np.sum((pts - pts[i]) ** 2, axis=1)
    return np.argsort(d2, kind="stable")[:min(k, len(pts))]


def flattest_direction(nbr: np.ndarray) -> np.ndarray:
    """The principal direction of least |curvature| of a quadric fitted in
    the neighbourhood's tangent frame."""
    ctr = nbr.mean(axis=0)
    cov = np.cov((nbr - ctr).T)
    normal = np.linalg.eigh(cov)[1][:, 0]
    ref = np.array([0.0, 1.0, 0.0]) if abs(normal[0]) > 0.9 else np.array([1.0, 0.0, 0.0])
    y = np.cross(normal, ref)
    y /= np.linalg.norm(y)
    x = np.cross(y, normal)
    x /= np.linalg.norm(x)
    loc = (nbr - ctr) @ np.stack([x, y, normal], axis=1)
    u, v, w = loc[:, 0], loc[:, 1], loc[:, 2]
    c = np.linalg.lstsq(np.stack([u * u, u * v, v * v, u, v], axis=1), w, rcond=None)[0]
    evals, evecs = np.linalg.eigh(np.array([[2 * c[0], c[1]], [c[1], 2 * c[2]]]))
    d = evecs[:, np.argmin(np.abs(evals))]
    return d[0] * x + d[1] * y


def axis_distance(pts: np.ndarray, org: np.ndarray, direction: np.ndarray) -> np.ndarray:
    rel = pts - org
    along = rel @ direction / (direction @ direction)
    return np.linalg.norm(rel - along[:, None] * direction, axis=1)


def start(pts: np.ndarray, radius: float, k: int) -> np.ndarray:
    ctr = pts.mean(axis=0)
    normal = np.linalg.eigh(np.cov((pts - ctr).T))[1][:, 0]
    if normal[2] < 0:
        normal = -normal
    i = int(np.argmin(axis_distance(pts, ctr, normal)))
    to_surface = np.linalg.norm(ctr - pts[i])
    return np.concatenate([ctr + normal * (radius - to_surface), flattest_direction(pts[knn(pts, i, k)])])


def residuals(p: np.ndarray, pts: np.ndarray, radius: float) -> np.ndarray:
    return axis_distance(pts, p[:3], p[3:]) - radius


def jacobian(p: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """d r / d (origin, direction): -u and -a u, with u the unit radial
    vector and a the point's coordinate along the axis."""
    rel = pts - p[:3]
    a = rel @ p[3:] / (p[3:] @ p[3:])
    radial = rel - a[:, None] * p[3:]
    u = radial / np.maximum(np.linalg.norm(radial, axis=1, keepdims=True), 1e-12)
    return np.concatenate([-u, -a[:, None] * u], axis=1)


def levenberg_marquardt(f, jac, p0: np.ndarray, iters: int, lam0: float):
    """(params, cost at the start, cost at the end) of ``iters`` steps."""
    p, r = p0, f(p0)
    cost0 = cost = float(r @ r)
    lam = lam0
    for _ in range(iters):
        j = jac(p)
        jtj = j.T @ j
        step = np.linalg.solve(jtj + np.diag(lam * (np.diag(jtj) + 1e-12)), -(j.T @ r))
        q = p + step
        rq = f(q)
        cq = float(rq @ rq)
        if cq < cost and np.all(np.isfinite(q)):
            p, r, cost, lam = q, rq, cq, lam / 3.0
        else:
            lam = lam * 2.0
        lam = min(max(lam, 1e-12), 1e12)
    return p, cost0, cost


def fit_cylinder(pts: np.ndarray, radius: float, knn_k: int, iters: int, lam0: float):
    p0 = start(pts, radius, knn_k)
    p, c0, c = levenberg_marquardt(lambda q: residuals(q, pts, radius), lambda q: jacobian(q, pts), p0, iters, lam0)
    return p0, p, c0, c


def settled(p: np.ndarray, cost: float, pts: np.ndarray, radius: float, lam0: float) -> bool:
    """Whether ``SETTLE_ITERS`` more steps from ``p`` leave ``cost`` as it is."""
    _, _, more = levenberg_marquardt(lambda q: residuals(q, pts, radius), lambda q: jacobian(q, pts), p,
                                     SETTLE_ITERS, lam0)
    return cost - more <= SETTLE_TOL * cost + 1e-12


def prior(p: np.ndarray, pts: np.ndarray) -> np.ndarray:
    org, d = p[:3], p[3:]
    if d[1] < 0:
        d = -d
    t = 0.0 if abs(d[1]) < 1e-12 else (pts[:, 1].min() - org[1]) / d[1]
    return np.concatenate([org + t * d, d])


def pose(p: np.ndarray) -> np.ndarray:
    y = p[3:] / np.linalg.norm(p[3:])
    z = np.cross([1.0, 0.0, 0.0], y)
    z /= np.linalg.norm(z)
    x = np.cross(y, z)
    x /= np.linalg.norm(x)
    t = np.eye(4)
    t[:3, 0], t[:3, 1], t[:3, 2], t[:3, 3] = x, y, z, p[:3]
    return t


def fit_frame(ids1: Dict[tuple, np.ndarray], ids2: Dict[tuple, np.ndarray], rig, fit: dict) -> dict:
    """One frame's fit from both views' {id: xy}: the fields the program's
    ``CylinderFitResult`` has for it, ``points_valid`` in raster layout."""
    extent = fit["grid_extent"]
    off, xy, both, chosen = select(ids1, ids2, rig, fit["patch_size"], fit["error_threshold"], extent)
    k1, k2, t21 = rig
    pts3 = np.zeros((extent, extent, 3))
    valid = np.zeros((extent, extent), bool)
    err = np.zeros((extent, extent))
    if chosen.any():
        p, e = triangulate(xy[0][chosen], xy[1][chosen], k1, k2, t21)
        ok = np.isfinite(e) & np.all(np.isfinite(p), axis=1)
        pts3[chosen], err[chosen] = np.where(ok[:, None], p, 0.0), np.where(ok, e, 0.0)
        valid[chosen] = ok
    pts = pts3[valid]
    nan6 = np.full(6, np.nan)
    if len(pts) >= 3:
        p0, p, c0, c = fit_cylinder(pts, fit["cyl_radius"], fit["knn_k"], fit["lm_iters"], fit["lm_lambda0"])
        params0, params = prior(p0, pts), prior(p, pts)
        done = settled(p, c, pts, fit["cyl_radius"], fit["lm_lambda0"])
    else:
        params0, params, c0, c, done = nan6, nan6, np.nan, np.nan, False
    return {
        "params0": params0, "params": params, "fvals": np.array([c0, c]), "t_cam_cyl": pose(params), "settled": done,
        "mean_reproj_error": float(err[valid].mean()) if valid.any() else 0.0,
        "points3": pts3.reshape(-1, 3), "points_valid": valid.reshape(-1), "offset": off,
    }
