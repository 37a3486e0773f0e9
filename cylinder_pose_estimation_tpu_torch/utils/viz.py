"""Host-side visualisation (port of the JAX package's utils/viz.py).

Every function of the JAX module, on the port's types; matplotlib is
imported only inside the functions that draw figures, so the device
pipeline never depends on it.  One deliberate difference:
``overlay_detection`` rasterises the drivers' "<name>_arc.png" overlay in
numpy (grey frame -> RGB, one dot per grid point in the HSV hue of its
column index, a white cross on the centre) and writes it with the package's
own PNG writer, so ``detect-folder`` runs where neither matplotlib nor
Pillow is installed; the JAX package draws it with matplotlib.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.types import GridPoints


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _save(plt, fig, path: Optional[str], dpi: int = 110):
    if path:
        fig.savefig(path, dpi=dpi)
        plt.close(fig)
    return fig


def cylinder_mesh(
    params,
    radius: float,
    half_length: float = 100.0,
    n_theta: int = 32,
    n_h: int = 9,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cylinder surface mesh around the axis (ref utils/getCylinder.m).
    params: [origin(3), direction(3)].  Returns X, Y, Z of shape
    (n_h, n_theta)."""
    from cylinder_pose_estimation_tpu_torch.geometry.transforms import cyl_params_to_transform

    t = _np(cyl_params_to_transform(torch.as_tensor(_np(params), dtype=torch.float32)))
    org, x_ax, y_ax, z_ax = t[:3, 3], t[:3, 0], t[:3, 1], t[:3, 2]
    theta = np.linspace(0, 2 * np.pi, n_theta)
    hs = np.linspace(-half_length, half_length, n_h)
    pts = (
        org[None, None]
        + hs[:, None, None] * y_ax
        + radius * (np.cos(theta)[None, :, None] * z_ax + np.sin(theta)[None, :, None] * x_ax)
    )
    return pts[..., 0], pts[..., 1], pts[..., 2]


def draw_grid_points(ax, gp: GridPoints, marker_size: float = 12.0) -> None:
    """Scatter one view's grid points coloured by column index
    (ref utils/drawGridPoints.m)."""
    xy, idx, v = _np(gp.xy), _np(gp.idx), _np(gp.valid)
    ax.scatter(xy[v, 0], xy[v, 1], c=idx[v, 0], cmap="hsv", s=marker_size)
    center = _np(gp.center)
    ax.plot(center[0], center[1], "w+", markersize=12, markeredgewidth=2)


def _project(pts: np.ndarray, k) -> np.ndarray:
    from cylinder_pose_estimation_tpu_torch.geometry.transforms import project_points

    return _np(project_points(torch.as_tensor(pts, dtype=torch.float32),
                              torch.as_tensor(_np(k), dtype=torch.float32)))


def draw_cylinder(ax, params, radius: float, k, half_length: float = 100.0,
                  color: str = "lime") -> None:
    """Project a 3-ring wireframe and the axis segment into the image
    (ref utils/drawCylinder.m:8-23)."""
    xs, ys, zs = cylinder_mesh(params, radius, half_length, n_theta=48, n_h=3)
    for i in range(3):
        uv = _project(np.stack([xs[i], ys[i], zs[i]], axis=-1), k)
        ax.plot(uv[:, 0], uv[:, 1], color=color, linewidth=1.0)
    p = _np(params).astype(np.float64)
    d = p[3:6] / np.linalg.norm(p[3:6])
    uv = _project(np.stack([p[:3] - half_length * d, p[:3] + half_length * d]), k)
    ax.plot(uv[:, 0], uv[:, 1], color=color, linewidth=1.5, linestyle="--")


def plot_reprojection_errors(errors, valid, path: Optional[str] = None):
    """Per-point reprojection errors with mean and max in the title
    (ref utils/plotReprojectionErrors.m:13-27)."""
    plt = _plt()
    e = _np(errors)[_np(valid)]
    fig, ax = plt.subplots(figsize=(7, 3.5))
    ax.stem(np.arange(e.shape[0]), e)
    ax.set_xlabel("point")
    ax.set_ylabel("reprojection error [px]")
    ax.set_title(f"mean={e.mean():.4f}px  max={e.max():.4f}px  n={e.shape[0]}")
    fig.tight_layout()
    return _save(plt, fig, path)


def visualize_cylinder_fitting(pts3, valid, params0, params, radius: float,
                               path: Optional[str] = None):
    """3D points with the initial and final cylinder surfaces
    (ref utils/visualizeCylinderFitting.m)."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    p = _np(pts3)[_np(valid)]
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=4, c="k", label="points")
    for prm, color, label in ((params0, "tab:orange", "init"), (params, "tab:green", "final")):
        xs, ys, zs = cylinder_mesh(prm, radius)
        ax.plot_surface(xs, ys, zs, alpha=0.25, color=color, label=label)
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    return _save(plt, fig, path)


def plot_fvals(fvals, path: Optional[str] = None):
    """Initial and final per-frame errors as sqrt(fval) curves
    (ref utils/drawFvals.m:14-49)."""
    plt = _plt()
    f = np.sqrt(np.maximum(_np(fvals), 0.0))  # (F, 2)
    fig, ax = plt.subplots(figsize=(7, 3.5))
    ax.plot(f[:, 0], "o-", label="init")
    ax.plot(f[:, 1], "s-", label="optimized")
    ax.set_xlabel("frame")
    ax.set_ylabel("sqrt(fval) [mm]")
    ax.legend()
    fig.tight_layout()
    return _save(plt, fig, path)


def plot_cylinders_3d(params_list, radius: float, pts3=None, valid=None,
                      path: Optional[str] = None):
    """Several cylinders in 3D (ref utils/plotCylinders3D.m, drawMultiCyl.m)."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    if pts3 is not None:
        for f in range(len(pts3)):
            p = _np(pts3[f])[_np(valid[f])]
            ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=3)
    for prm in params_list:
        xs, ys, zs = cylinder_mesh(prm, radius)
        ax.plot_surface(xs, ys, zs, alpha=0.2)
    return _save(plt, fig, path)


def animate_orbit(pts3, valid, params, radius: float, path: str, n_frames: int = 12) -> None:
    """Orbiting 3D views as one horizontal strip of ``n_frames`` azimuth
    steps (ref utils/animateOrbit.m)."""
    plt = _plt()
    fig = plt.figure(figsize=(2.2 * n_frames, 2.4))
    p = _np(pts3)[_np(valid)]
    xs, ys, zs = cylinder_mesh(params, radius)
    for i in range(n_frames):
        ax = fig.add_subplot(1, n_frames, i + 1, projection="3d")
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=1, c="k")
        ax.plot_surface(xs, ys, zs, alpha=0.2, color="tab:green")
        ax.view_init(elev=20.0, azim=360.0 * i / n_frames)
        ax.set_axis_off()
    fig.tight_layout()
    _save(plt, fig, path, dpi=80)


def figresize(fig, size: Tuple[float, float] = (1000, 700)) -> None:
    """Resize a figure to ``size`` pixels (ref utils/figresize.m)."""
    fig.set_size_inches(size[0] / fig.dpi, size[1] / fig.dpi)


def visualize_3d_points(points, path: Optional[str] = None):
    """3D scatter with the z-axis reversed (ref utils/visualize_3D_points.m)."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    p = _np(points)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=8)
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    ax.set_title("3D Reconstruction")
    ax.invert_zaxis()
    return _save(plt, fig, path)


def plot_transformed_data(pts3, line, t_cam_agv, radius: float = 45.0, path: Optional[str] = None):
    """Point cloud and axis line in the camera frame and mapped through a
    camera -> AGV transform, each line extended 3x beyond both ends inside a
    translucent cylinder (ref utils/plotTransformedData.m, whose hardcoded
    transform is an argument here, normally ``RegistrationResult.t_cam_agv``).
    pts3: (N, 3); line: (2, 3) two points on the axis."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    t = _np(t_cam_agv).astype(np.float64)
    p = _np(pts3).astype(np.float64)
    ln = _np(line).astype(np.float64)
    p_t = p @ t[:3, :3].T + t[:3, 3]
    ln_t = ln @ t[:3, :3].T + t[:3, 3]
    for pts, l2, color, tag in ((p, ln, "tab:red", "original"), (p_t, ln_t, "tab:green", "transformed")):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=6, c=color, label=f"{tag} points")
        ext = l2[1] - l2[0]
        a, b = l2[0] - 3.0 * ext, l2[1] + 3.0 * ext
        ax.plot(*np.stack([a, b]).T, color=color, linewidth=2, label=f"{tag} line")
        axis_dir = ext / max(np.linalg.norm(ext), 1e-12)
        xs, ys, zs = cylinder_mesh(np.concatenate([0.5 * (a + b), axis_dir]), radius,
                                   half_length=0.5 * float(np.linalg.norm(b - a)))
        ax.plot_surface(xs, ys, zs, alpha=0.25, color=color)
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    ax.legend(loc="upper left", fontsize=7)
    return _save(plt, fig, path)


def structure_cyl_info(idx, xs, ys, zs):
    """Per-frame cylinder meshes picked by frame index, as a list of
    {"X", "Y", "Z"} dicts (ref utils/structureCylInfo.m)."""
    return [{"X": xs[i], "Y": ys[i], "Z": zs[i]} for i in idx]


def find_matching_idx(img_paths, names):
    """Indices of the paths whose file stem is in ``names``
    (ref utils/findMatchingIdx.m)."""
    return [i for i, p in enumerate(img_paths)
            if os.path.splitext(os.path.basename(p))[0] in names]


def _hsv_rgb(hue: np.ndarray) -> np.ndarray:
    """Fully saturated, full-value colours of hues in [0, 1) -> (N, 3) uint8."""
    h6 = (hue % 1.0) * 6.0
    x = 1.0 - np.abs(h6 % 2.0 - 1.0)
    sector = h6.astype(np.int64) % 6
    one, zero = np.ones_like(x), np.zeros_like(x)
    table = np.stack([
        np.stack([one, x, zero], -1), np.stack([x, one, zero], -1), np.stack([zero, one, x], -1),
        np.stack([zero, x, one], -1), np.stack([x, zero, one], -1), np.stack([one, zero, x], -1),
    ], 1)
    rgb = table[np.arange(len(hue)), sector]
    return np.round(255.0 * rgb).astype(np.uint8)


# The overlay's marks: dot radius and centre-cross arm, in pixels.
_DOT, _CROSS = 2, 6


def overlay_detection(image, gp: GridPoints, path: Optional[str] = None) -> np.ndarray:
    """The drivers' detection overlay "<name>_arc.png"
    (ref python_grid_detection_cylinder.py:54-56), rasterised in numpy: the
    grey frame as RGB, each valid grid point a dot in the HSV hue of its
    column index (``idx[:, 0]``), a white cross on the centre point.
    Returns the (H, W, 3) uint8 image and writes it as a PNG to ``path``."""
    img = np.clip(_np(image), 0, 255).astype(np.uint8)
    rgb = np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img[..., :3].copy()
    h, w = rgb.shape[:2]
    xy, idx, v = _np(gp.xy), _np(gp.idx), _np(gp.valid).astype(bool)
    pts, cols = xy[v], idx[v, 0].astype(np.float64)
    if len(pts):
        span = cols.max() - cols.min()
        colours = _hsv_rgb((cols - cols.min()) / (span + 1.0))
        yy, xx = np.mgrid[-_DOT:_DOT + 1, -_DOT:_DOT + 1]
        disk = yy * yy + xx * xx <= _DOT * _DOT
        dy, dx = yy[disk], xx[disk]
        py = np.round(pts[:, 1]).astype(np.int64)[:, None] + dy
        px = np.round(pts[:, 0]).astype(np.int64)[:, None] + dx
        inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
        rgb[py[inside], px[inside]] = np.broadcast_to(colours[:, None], py.shape + (3,))[inside]
    cx, cy = (int(round(float(c))) for c in _np(gp.center))
    arm = np.arange(-_CROSS, _CROSS + 1)
    for ys, xs in ((np.full(arm.shape, cy), cx + arm), (cy + arm, np.full(arm.shape, cx))):
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        rgb[ys[keep], xs[keep]] = 255
    if path:
        from cylinder_pose_estimation_tpu_torch.utils.png import write_png

        write_png(path, rgb)
    return rgb
