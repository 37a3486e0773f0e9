"""Image undistortion by inverse mapping (port of the JAX package's
ops/remap.py; replaces cv2.undistort / MATLAB undistortImage).

For every destination (undistorted) pixel, its normalised coordinates go
through the forward OpenCV distortion model to the source pixel of the
distorted image, which is then sampled: one dense coordinate map shared by
every frame of a camera, and one gather per tap.
"""

from __future__ import annotations

import torch

from cylinder_pose_estimation_tpu_torch.ops.image import bilinear_sample, cubic_sample
from cylinder_pose_estimation_tpu_torch.types import CameraModel


def distort_points(xy_norm: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """Forward distortion of normalised camera coords (..., 2): radial k1,
    k2, k3 and tangential p1, p2 (ref utils/iotool.py:33-35)."""
    x = xy_norm[..., 0]
    y = xy_norm[..., 1]
    k1, k2, k3 = cam.radial[0], cam.radial[1], cam.radial[2]
    p1, p2 = cam.tangential[0], cam.tangential[1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_image(img: torch.Tensor, cam: CameraModel, interp: str = "bilinear") -> torch.Tensor:
    """Undistort (..., H, W) grey images (cv2.undistort with the identity new
    camera matrix) on their own device.

    ``interp``: 'bilinear' as the Python reference path (cv2.undistort);
    'cubic' (Catmull-Rom) as the MATLAB experiment path's
    undistortImage(..., 'cubic') (ref utils/preProcessing.m:12-13)."""
    sample = {"bilinear": bilinear_sample, "cubic": cubic_sample}[interp]
    h, w = img.shape[-2:]
    k = cam.k
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    ys = (torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy) / fy
    xs = (torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx) / fx
    grid = torch.stack(torch.broadcast_tensors(xs, ys), dim=-1)  # (H, W, 2) normalised
    d = distort_points(grid, cam)
    src_x = d[..., 0] * fx + cx
    src_y = d[..., 1] * fy + cy
    return sample(img.to(torch.float32), src_x, src_y)


def undistort_points(xy: torch.Tensor, cam: CameraModel, iters: int = 8) -> torch.Tensor:
    """Invert the distortion of pixel coordinates (..., 2) by fixed-point
    iteration (the cv2.undistortPoints scheme, ``iters`` steps)."""
    k = cam.k
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    x, y = xn, yn
    for _ in range(iters):
        d = distort_points(torch.stack([x, y], dim=-1), cam)
        x = x + (xn - d[..., 0])
        y = y + (yn - d[..., 1])
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)
