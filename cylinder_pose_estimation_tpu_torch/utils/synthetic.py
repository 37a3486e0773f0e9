"""Synthetic stereo laser-grid scenes, in numpy (the part of the JAX package's
utils/synthetic.py, plus the bench scene family of ``__graft_entry__``, that
the port needs to run without JAX): cylinder and plane grids, the laser
image renderer, the registration experiment's kinematically consistent
sequence, the bench family through a distorting lens, and the tiled frame
source of the stream benchmark.

``example_pair`` draws its noise from ``np.random.default_rng(seed)`` in the
same order as ``__graft_entry__._example_pair``, and renders in float32 as the
JAX code does; the scenes agree with the JAX ones up to one grey level on a
few pixels (float32 ``exp``/``sin`` may round differently across libraries
before the uint8 truncation).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

F32 = np.float32

# Dropout band of the bridged golden scene (tests/make_golden.py): y0, y1,
# x0, x1 -- crosses one horizontal and one vertical laser line of scene 0.
GAP = (232, 250, 290, 320)


class Stereo(NamedTuple):
    """Stereo rig as numpy arrays (feed to ``types.stereo_from_numpy``)."""

    cam1_k: np.ndarray
    cam1_radial: np.ndarray
    cam1_tangential: np.ndarray
    cam2_k: np.ndarray
    cam2_radial: np.ndarray
    cam2_tangential: np.ndarray
    t_c2_c1: np.ndarray


def _rotvec_to_matrix(rv: np.ndarray) -> np.ndarray:
    t2 = F32(np.sum(rv * rv))
    t = np.sqrt(t2)
    if t < 1e-4:
        a, b = F32(1.0) - t2 / F32(6.0), F32(0.5) - t2 / F32(24.0)
    else:
        a, b = np.sin(t) / t, (F32(1.0) - np.cos(t)) / t2
    kx, ky, kz = rv
    khat = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]], F32)
    return (np.eye(3, dtype=F32) + a * khat + b * (khat @ khat)).astype(F32)


def default_stereo(f: float = 900.0, cx: float = 320.0, cy: float = 240.0,
                   baseline: float = 120.0) -> Stereo:
    """A forward-looking rig with a pure-x baseline and a 2 degree toe-in."""
    k = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]], F32)
    t = np.eye(4, dtype=F32)
    t[:3, :3] = _rotvec_to_matrix(np.array([0.0, np.deg2rad(2.0), 0.0], F32))
    t[:3, 3] = np.array([-baseline, 0.0, 8.0], F32)
    z3, z2 = np.zeros(3, F32), np.zeros(2, F32)
    return Stereo(k, z3, z2, k.copy(), z3.copy(), z2.copy(), t)


def _cyl_frame(params: np.ndarray) -> np.ndarray:
    y = params[3:6] / (np.linalg.norm(params[3:6]) + F32(1e-12))
    z = np.cross(np.array([1.0, 0.0, 0.0], F32), y)
    z = z / (np.linalg.norm(z) + F32(1e-12))
    x = np.cross(y, z)
    x = x / (np.linalg.norm(x) + F32(1e-12))
    return np.stack([x, y, z], axis=-1).astype(F32)


class CylinderScene(NamedTuple):
    xy1: np.ndarray         # (R*C, 2) view-1 projections, row-major (row, col)
    xy2: np.ndarray
    idx: np.ndarray         # (R*C, 2) int32 (col, row) grid indices
    pts3: np.ndarray        # (R*C, 3)
    cyl_params: np.ndarray  # (6,)


def cylinder_grid_points(
    stereo: Stereo,
    origin=(0.0, -60.0, 650.0),
    direction=(0.05, 1.0, 0.02),
    radius: float = 45.0,
    n_rows: int = 9,
    n_cols: int = 9,
    row_spacing: float = 14.0,
    theta_span: float = 1.5,
    center_rc: Tuple[int, int] | None = None,
) -> CylinderScene:
    """Noise-free laser grid on a cylinder (rows = constant height, cols =
    constant angle), projected into both views."""
    origin = np.asarray(origin, F32)
    direction = np.asarray(direction, F32)
    direction = direction / np.linalg.norm(direction)
    params = np.concatenate([origin, direction]).astype(F32)
    frame = _cyl_frame(params)
    x_ax, y_ax, z_ax = frame[:, 0], frame[:, 1], frame[:, 2]
    phi = np.arctan2(-x_ax[2], -z_ax[2])
    if center_rc is None:
        center_rc = (n_rows // 2, n_cols // 2)
    hs = (np.arange(n_rows, dtype=F32) - F32(center_rc[0])) * F32(row_spacing)
    thetas = phi + (np.arange(n_cols, dtype=F32) / F32(max(n_cols - 1, 1)) - F32(0.5)) * F32(theta_span)
    h_grid, t_grid = np.meshgrid(hs, thetas, indexing="ij")
    surf = (
        origin
        + h_grid[..., None] * y_ax
        + F32(radius) * (np.cos(t_grid)[..., None] * z_ax + np.sin(t_grid)[..., None] * x_ax)
    ).astype(F32)
    pts3 = surf.reshape(-1, 3)

    def view(cam_t, k):
        p = pts3 @ cam_t[:3, :3].T + cam_t[:3, 3]
        hh = p @ k.T
        return (hh[:, :2] / (hh[:, 2:3] + F32(1e-12))).astype(F32)

    xy1 = view(np.eye(4, dtype=F32), stereo.cam1_k)
    xy2 = view(stereo.t_c2_c1, stereo.cam2_k)
    g1 = xy1.reshape(n_rows, n_cols, 2)
    col_sign = 1 if np.mean(g1[:, -1, 0] - g1[:, 0, 0]) >= 0 else -1
    row_sign = 1 if np.mean(g1[-1, :, 1] - g1[0, :, 1]) >= 0 else -1
    ridx = (np.arange(n_rows) - center_rc[0]) * row_sign
    cidx = (np.arange(n_cols) - center_rc[1]) * col_sign
    r_grid, c_grid = np.meshgrid(ridx, cidx, indexing="ij")
    idx = np.stack([c_grid, r_grid], -1).reshape(-1, 2).astype(np.int32)
    return CylinderScene(xy1, xy2, idx, pts3, params)


class PlaneScene(NamedTuple):
    xy1: np.ndarray     # (R*C, 2) view-1 projections, row-major (row, col)
    xy2: np.ndarray
    idx: np.ndarray     # (R*C, 2) int32 (row, col) grid indices
    pts3: np.ndarray    # (R*C, 3)
    plane: np.ndarray   # (4,) [n, d] with n . x + d = 0


def plane_grid_points(
    stereo: Stereo,
    origin=(0.0, 0.0, 700.0),
    normal=(0.05, -0.08, -1.0),
    n_rows: int = 9,
    n_cols: int = 11,
    spacing: float = 18.0,
) -> PlaneScene:
    """Noise-free regular grid on a tilted plane, projected into both views
    (``plane_grid_points`` of the JAX package without its noise option)."""
    origin = np.asarray(origin, F32)
    normal = np.asarray(normal, F32)
    normal = normal / np.linalg.norm(normal)
    # In-plane frame: u = normal x x_hat is ~vertical (rows), v ~horizontal.
    u = np.cross(normal, np.array([1.0, 0.0, 0.0], F32))
    u = u / np.linalg.norm(u)
    v = np.cross(normal, u)
    r0, c0 = n_rows // 2, n_cols // 2
    rr = (np.arange(n_rows, dtype=F32) - F32(r0)) * F32(spacing)
    cc = (np.arange(n_cols, dtype=F32) - F32(c0)) * F32(spacing)
    rg, cg = np.meshgrid(rr, cc, indexing="ij")
    pts3 = (origin + rg[..., None] * u + cg[..., None] * v).reshape(-1, 3).astype(F32)

    def view(cam_t, k):
        p = pts3 @ cam_t[:3, :3].T + cam_t[:3, 3]
        hh = p @ k.T
        return (hh[:, :2] / (hh[:, 2:3] + F32(1e-12))).astype(F32)

    xy1 = view(np.eye(4, dtype=F32), stereo.cam1_k)
    xy2 = view(stereo.t_c2_c1, stereo.cam2_k)
    g1 = xy1.reshape(n_rows, n_cols, 2)
    col_sign = 1 if np.mean(g1[:, -1, 0] - g1[:, 0, 0]) >= 0 else -1
    row_sign = 1 if np.mean(g1[-1, :, 1] - g1[0, :, 1]) >= 0 else -1
    ridx = (np.arange(n_rows) - r0) * row_sign
    cidx = (np.arange(n_cols) - c0) * col_sign
    r_grid, c_grid = np.meshgrid(ridx, cidx, indexing="ij")
    idx = np.stack([r_grid, c_grid], -1).reshape(-1, 2).astype(np.int32)
    plane = np.concatenate([normal, [-np.dot(normal, origin)]]).astype(F32)
    return PlaneScene(xy1, xy2, idx, pts3, plane)


def plane_view(
    height: int,
    width: int,
    origin,
    normal,
    n_rows: int,
    n_cols: int,
    spacing: float,
    seed: int,
    saturate_center: bool = False,
    gap_col: int | None = None,
) -> np.ndarray:
    """One rendered (H, W) float32 view of a plane grid seen by
    ``default_stereo``'s camera 1, with N(0, 2) grey-level noise from
    ``seed``.  ``gap_col`` damps a 12 px band of that column between grid
    rows 1 and 2 to 5%, fragmenting it."""
    stereo = default_stereo(cx=width / 2.0, cy=height / 2.0)
    sc = plane_grid_points(stereo, origin, normal, n_rows, n_cols, spacing)
    img = render_grid_image(sc.xy1, n_rows, n_cols, height, width,
                            saturate_center=saturate_center).astype(F32)
    img = img + np.random.default_rng(seed).normal(0, 2.0, (height, width)).astype(F32)
    if gap_col is not None:
        xa, ya = sc.xy1[n_cols + gap_col]
        _, yb = sc.xy1[2 * n_cols + gap_col]
        yc, xc = int(0.5 * (ya + yb)), int(xa)
        img[yc - 6:yc + 6, xc - 4:xc + 5] *= F32(0.05)
    return np.clip(img, 0, 255).astype(F32)


def cylinder_view(
    height: int,
    width: int,
    origin,
    radius: float,
    row_spacing: float,
    theta_span: float,
    seed: int,
    band=None,
) -> np.ndarray:
    """One rendered (H, W) float32 view of a 9x9 cylinder grid seen by
    ``default_stereo``'s camera 1, with N(0, 2) grey-level noise from
    ``seed``; ``band`` (y0, y1, x0, x1) is a laser dropout (``apply_gap``)."""
    stereo = default_stereo(cx=width / 2.0, cy=height / 2.0)
    sc = cylinder_grid_points(stereo, origin=tuple(origin), radius=radius,
                              row_spacing=row_spacing, theta_span=theta_span)
    img = render_grid_image(sc.xy1, 9, 9, height, width).astype(F32)
    img = np.clip(img + np.random.default_rng(seed).normal(0, 2.0, (height, width)).astype(F32), 0, 255)
    return img if band is None else apply_gap(img, band)


def tilted_grid_view(height: int, width: int, angle_deg: float, seed: int = 0) -> np.ndarray:
    """One (H, W) float32 view of a planar 9x9 lattice of 22 px rotated by
    ``angle_deg`` in image space about the image centre, with N(0, 2)
    grey-level noise from ``seed``: the stability fence's scenes (from 26
    degrees on the detector's labels turn chaotic)."""
    n = 9
    t = np.radians(angle_deg)
    r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    ij = np.mgrid[0:n, 0:n].astype(np.float64) - (n - 1) / 2.0
    local = np.stack([ij[1], ij[0]], axis=-1).reshape(-1, 2) * 22.0
    xy = (local @ r.T + np.array([width / 2.0, height / 2.0])).astype(F32)
    img = render_grid_image(xy, n, n, height, width).astype(F32)
    img = img + np.random.default_rng(seed).normal(0, 2.0, (height, width)).astype(F32)
    return np.clip(img, 0, 255).astype(F32)


def render_grid_image(
    xy: np.ndarray,
    n_rows: int,
    n_cols: int,
    height: int,
    width: int,
    line_sigma: float = 1.6,
    line_gain: float = 170.0,
    center_flat: int | None = None,
    center_gain: float = 70.0,
    background: float = 18.0,
    saturate_center: bool = False,
) -> np.ndarray:
    """(H, W) uint8 laser image: Gaussian tubes along the grid polylines and
    a brighter centre blob (``render_grid_image`` of the JAX package);
    ``saturate_center`` adds a saturated disk of radius 8 sigma there.

    Each segment's response is evaluated in a window 32 px around it: beyond
    that exp(-d^2 / 2 sigma^2) is 0 in float32, so the max over segments is
    the same as over the whole image."""
    pts = np.asarray(xy, F32)[: n_rows * n_cols].reshape(n_rows, n_cols, 2)
    a_r = pts[:, :-1].reshape(-1, 2)
    b_r = pts[:, 1:].reshape(-1, 2)
    a_c = pts[:-1].transpose(1, 0, 2).reshape(-1, 2)
    b_c = pts[1:].transpose(1, 0, 2).reshape(-1, 2)
    segs_a = np.concatenate([a_r, a_c])
    segs_b = np.concatenate([b_r, b_c])
    resp = np.zeros((height, width), F32)
    # Python-float constants fold in double before the float32 cast, as in
    # the JAX code.
    two_s2 = F32(2.0 * line_sigma ** 2)
    pad = 32
    for a, b in zip(segs_a, segs_b):
        x0 = max(int(np.floor(min(a[0], b[0]))) - pad, 0)
        x1 = min(int(np.ceil(max(a[0], b[0]))) + pad, width)
        y0 = max(int(np.floor(min(a[1], b[1]))) - pad, 0)
        y1 = min(int(np.ceil(max(a[1], b[1]))) + pad, height)
        if x0 >= x1 or y0 >= y1:
            continue
        yy = np.arange(y0, y1, dtype=F32)[:, None]
        xx = np.arange(x0, x1, dtype=F32)[None, :]
        ab = b - a
        ab2 = max(F32(np.sum(ab * ab)), F32(1e-6))
        px = xx - a[0]
        py = yy - a[1]
        t = np.clip((px * ab[0] + py * ab[1]) / ab2, F32(0.0), F32(1.0))
        dx = px - t * ab[0]
        dy = py - t * ab[1]
        d2 = dx * dx + dy * dy
        win = resp[y0:y1, x0:x1]
        np.maximum(win, np.exp(-d2 / two_s2), out=win)
    img = F32(background) + F32(line_gain) * resp
    if center_flat is None:
        center_flat = (n_rows // 2) * n_cols + (n_cols // 2)
    c = np.asarray(xy, F32)[center_flat]
    yy = np.arange(height, dtype=F32)[:, None]
    xx = np.arange(width, dtype=F32)[None, :]
    d2c = (xx - c[0]) ** 2 + (yy - c[1]) ** 2
    img = img + F32(center_gain) * np.exp(-d2c / F32(2.0 * (2.5 * line_sigma) ** 2))
    if saturate_center:
        img = np.where(d2c < F32((8.0 * line_sigma) ** 2), F32(255.0), img)
    return np.clip(img, 0.0, 255.0).astype(np.uint8)


def example_pair(height: int = 480, width: int = 640, n_frames: int | None = None,
                 seed: int = 0, pans=None):
    """The bench scene family: (stereo, (img1, img2)) with float32 images of
    shape (n_frames, H, W) (or one (H, W) pair when n_frames is None).
    Frame i puts the cylinder at pan ``pans[i]`` (default i)."""
    rng = np.random.default_rng(seed)
    stereo = default_stereo(cx=width / 2.0, cy=height / 2.0)

    def one(pan):
        scene = cylinder_grid_points(
            stereo, origin=(10.0 * pan, -40.0, 560.0), radius=70.0,
            row_spacing=18.0, theta_span=2.0,
        )
        imgs = []
        for xy in (scene.xy1, scene.xy2):
            img = render_grid_image(xy, 9, 9, height, width).astype(F32)
            img = np.clip(img + rng.normal(0, 2.0, (height, width)).astype(F32), 0, 255)
            imgs.append(img)
        return imgs[0], imgs[1]

    if n_frames is None:
        return stereo, one(0.0)
    if pans is None:
        pans = [float(i) for i in range(n_frames)]
    pairs = [one(float(pans[i])) for i in range(n_frames)]
    return stereo, (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def apply_gap(img: np.ndarray, band=GAP) -> np.ndarray:
    """Attenuate a (y0, y1, x0, x1) band, by default ``GAP``, to 3% with
    smooth edges (tests/make_golden.py)."""
    y0, y1, x0, x1 = band
    yy = np.arange(img.shape[0], dtype=np.float32)[:, None]
    xx = np.arange(img.shape[1], dtype=np.float32)[None, :]

    def edge(v, lo, hi):
        return 1.0 / (1.0 + np.exp(-(v - lo) / 1.5)) * 1.0 / (1.0 + np.exp((v - hi) / 1.5))

    with np.errstate(over="ignore"):
        atten = 1.0 - 0.97 * edge(yy, y0, y1) * edge(xx, x0, x1)
    return np.clip(np.asarray(img, np.float32) * atten, 0, 255)


# Ground truth of ``registration_sequence``: T_Cam_AGV with the camera looking
# along the AGV's +y axis, so that the cylinder axis (the arm, AGV -x at pan
# 0) is the image's +y axis; the cylinder origin sits at (0, -40, 560) mm in
# the camera frame at pan = tilt = 0.  Pan then moves the cylinder in depth
# (+-53 mm at +-0.3 rad) and inclines its axis towards the camera; tilt turns
# it in the image plane.
T_CAM_AGV = np.array([
    [0.0, 0.0, -1.0, 110.0],
    [-1.0, 0.0, 0.0, 138.0],
    [0.0, 1.0, 0.0, 560.0],
    [0.0, 0.0, 0.0, 1.0],
])


def registration_angles(n_frames: int, pan: float = 0.3, tilt: float = 0.08) -> np.ndarray:
    """(F, 2) float32 [pan, tilt] in radians: a linear pan sweep over
    [-pan, pan] with the tilt swinging 1.5 periods of a cosine within
    [-tilt, tilt].

    The default swing keeps the 100-frame registration of
    ``registration_sequence`` at 480x640 well posed (minimum JtJ eigenvalue
    2.0e-3 against the 1.5e-3 gate).  The detector marks frames unstable
    once pan and tilt together tilt its lines too far, so only about a
    third of these frames are healthy; narrower swings keep more frames but
    leave the problem flat along one direction (+-0.2/+-0.04: 1.2e-3 to
    1.5e-3, depending on where the LM stops in the valley)."""
    s = np.linspace(0.0, 1.0, n_frames)
    return np.stack([pan * (2.0 * s - 1.0), tilt * np.cos(3.0 * np.pi * s)], axis=-1).astype(F32)


def registration_sequence(
    n_frames: int = 100,
    height: int = 480,
    width: int = 640,
    seed: int = 0,
    angles: np.ndarray | None = None,
    radius: float = 45.0,
    row_spacing: float = 18.0,
):
    """F kinematically consistent stereo frames of the camera<->AGV
    registration experiment: the cylinder of frame f sits at
    ``T_CAM_AGV @ t_agv_cyl(pan_f, tilt_f)`` (default kinematics), rendered
    as a 9x9 grid (``row_spacing`` mm rows, 2 rad of arc) into both views of
    ``default_stereo`` with N(0, 2) grey-level noise from ``seed``.

    At other sizes than 480x640 the focal length scales with the width, so
    the scene covers the same share of the image.  Returns (stereo, angles
    (F, 2), (img1, img2) as (F, H, W) float32, t_cam_agv (4, 4) float64)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.geometry.kinematics import t_agv_cyl

    if angles is None:
        angles = registration_angles(n_frames)
    angles = np.asarray(angles, F32)
    stereo = default_stereo(f=900.0 * width / 640.0, cx=width / 2.0, cy=height / 2.0)
    a64 = torch.as_tensor(angles, dtype=torch.float64)
    t_cam_cyl = T_CAM_AGV @ t_agv_cyl(a64[:, 0], a64[:, 1]).numpy()
    rng = np.random.default_rng(seed)
    views1, views2 = [], []
    for f in range(len(angles)):
        scene = cylinder_grid_points(
            stereo, origin=tuple(t_cam_cyl[f, :3, 3]), direction=tuple(t_cam_cyl[f, :3, 1]),
            radius=radius, row_spacing=row_spacing, theta_span=2.0,
        )
        for out, xy in ((views1, scene.xy1), (views2, scene.xy2)):
            img = render_grid_image(xy, 9, 9, height, width).astype(F32)
            out.append(np.clip(img + rng.normal(0, 2.0, (height, width)).astype(F32), 0, 255))
    return stereo, angles, (np.stack(views1), np.stack(views2)), T_CAM_AGV.copy()


def integer_degree_angles(n_frames: int) -> np.ndarray:
    """(F, 2) int [pan, tilt] in degrees: ``registration_angles``'s default
    swing rounded to whole degrees (pan -17..17, tilt -5..5)."""
    s = np.linspace(0.0, 1.0, n_frames)
    pan = np.round(np.degrees(0.3) * (2.0 * s - 1.0))
    tilt = np.round(np.degrees(0.08) * np.cos(3.0 * np.pi * s))
    return np.stack([pan, tilt], -1).astype(int)


def write_registration_folder(folder: str, n_frames: int, height: int = 480, width: int = 640) -> list:
    """The command-line experiment's input: ``registration_sequence`` at
    ``integer_degree_angles``, each stereo pair written as
    '<pan><tilt>L.png' / 'R.png' (single-digit tilts, so the names parse
    back exactly) with the rig's ``cameras.json``.  Returns the names in
    frame order."""
    import os

    from cylinder_pose_estimation_tpu_torch.cli import save_image
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.io import save_stereo_json

    deg = integer_degree_angles(n_frames)
    names = [f"{pan}{tilt}" for pan, tilt in deg]
    if len(set(names)) != n_frames:
        raise ValueError(f"{n_frames} frames repeat a pan/tilt name")
    st, _, (i1, i2), _ = registration_sequence(n_frames, height, width,
                                               angles=np.radians(deg).astype(F32))
    os.makedirs(folder, exist_ok=True)
    save_stereo_json(os.path.join(folder, "cameras.json"), stereo_from_numpy(*st, device="cpu"))
    for name, a, b in zip(names, i1, i2):
        save_image(os.path.join(folder, f"{name}L.png"), a)
        save_image(os.path.join(folder, f"{name}R.png"), b)
    return names


# Lens of ``distorted_example_pair``: a strong but plausible barrel lens
# (the realistic coefficients of tests/test_distortion_e2e.py).
DISTORTION = ((-0.3, 0.08, 0.0), (1e-3, -5e-4))


def distort_pixels(xy: np.ndarray, k: np.ndarray, radial, tangential) -> np.ndarray:
    """Ideal pixel coords (..., 2) -> distorted sensor coords through the
    OpenCV radial/tangential model (float32)."""
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    x = (xy[..., 0] - cx) / fx
    y = (xy[..., 1] - cy) / fy
    k1, k2, k3 = (F32(v) for v in radial)
    p1, p2 = (F32(v) for v in tangential)
    r2 = x * x + y * y
    rad = F32(1.0) + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + F32(2.0) * p1 * x * y + p2 * (r2 + F32(2.0) * x * x)
    yd = y * rad + p1 * (r2 + F32(2.0) * y * y) + F32(2.0) * p2 * x * y
    return np.stack([xd * fx + cx, yd * fy + cy], axis=-1).astype(F32)


def distorted_example_pair(height: int = 480, width: int = 640, n_frames: int = 1,
                           seed: int = 0, pans=None, distortion=DISTORTION):
    """The bench scene family seen through a distorting lens: each view's grid
    points are pushed through the forward distortion model before rendering
    (as tests/test_distortion_e2e.py warps its views), so undistorting the
    images recovers ``example_pair``'s geometry.  Returns (stereo with the
    lens coefficients on both cameras, (img1, img2) as (F, H, W) float32)."""
    radial, tangential = distortion
    rng = np.random.default_rng(seed)
    stereo = default_stereo(cx=width / 2.0, cy=height / 2.0)
    if pans is None:
        pans = [float(i) for i in range(n_frames)]
    views1, views2 = [], []
    for f in range(n_frames):
        scene = cylinder_grid_points(
            stereo, origin=(10.0 * pans[f], -40.0, 560.0), radius=70.0,
            row_spacing=18.0, theta_span=2.0,
        )
        for out, xy, k in ((views1, scene.xy1, stereo.cam1_k), (views2, scene.xy2, stereo.cam2_k)):
            img = render_grid_image(distort_pixels(xy, k, radial, tangential), 9, 9,
                                    height, width).astype(F32)
            out.append(np.clip(img + rng.normal(0, 2.0, (height, width)).astype(F32), 0, 255))
    stereo = stereo._replace(
        cam1_radial=np.asarray(radial, F32), cam1_tangential=np.asarray(tangential, F32),
        cam2_radial=np.asarray(radial, F32), cam2_tangential=np.asarray(tangential, F32),
    )
    return stereo, (np.stack(views1), np.stack(views2))


class TiledFrames:
    """Virtual (N, H, W) uint8 frame array: a pool of P scenes tiled to N
    frames, frame i = pool[i % P] + (i % 7) grey levels (saturating), so that
    no two neighbouring frames are byte-identical (``bench_stream.py``'s
    scheme).  One period of lcm(P, 7) frames is precomputed and chunks are
    served as views of it."""

    N_OFFSETS = 7

    def __init__(self, pool: np.ndarray, n: int):
        self.n = n
        p = len(pool)
        period = p * self.N_OFFSETS // math.gcd(p, self.N_OFFSETS)
        idx = np.arange(period)
        wide = pool[idx % p].astype(np.int16) + (idx % self.N_OFFSETS)[:, None, None].astype(np.int16)
        self.arrangement = np.clip(wide, 0, 255).astype(np.uint8)

    @property
    def shape(self):
        return (self.n,) + self.arrangement.shape[1:]

    def __getitem__(self, sl):
        start, stop, _ = sl.indices(self.n)
        per = len(self.arrangement)
        s0 = start % per
        if s0 + stop - start <= per:
            return self.arrangement[s0:s0 + stop - start]
        return np.take(self.arrangement, np.arange(s0, s0 + stop - start) % per, axis=0)
