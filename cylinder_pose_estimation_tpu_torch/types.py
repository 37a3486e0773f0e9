"""Data types of the port: NamedTuples of tensors with the JAX package's fields.

Every field keeps the JAX package's layout, with an explicit leading batch
axis wherever the JAX code would ``vmap`` (frames, or views of frames).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class CameraModel(NamedTuple):
    k: torch.Tensor           # (3, 3) intrinsics
    radial: torch.Tensor      # (3,)
    tangential: torch.Tensor  # (2,)


class StereoParams(NamedTuple):
    cam1: CameraModel
    cam2: CameraModel
    t_c2_c1: torch.Tensor     # (4, 4) camera-1 -> camera-2
    t_c1_patterns: Optional[torch.Tensor] = None
    t_c2_patterns: Optional[torch.Tensor] = None
    calib_points: Optional[torch.Tensor] = None


class GridPoints(NamedTuple):
    xy: torch.Tensor          # (..., N, 2) float pixel coords
    idx: torch.Tensor         # (..., N, 2) int32 grid indices
    valid: torch.Tensor       # (..., N) bool
    center: torch.Tensor      # (..., 2)


class Correspondences(NamedTuple):
    xy1: torch.Tensor
    xy2: torch.Tensor
    idx: torch.Tensor
    valid: torch.Tensor
    used_fallback: torch.Tensor


class TriangulationResult(NamedTuple):
    points3: torch.Tensor
    reproj_error: torch.Tensor
    valid: torch.Tensor


class CylinderFitResult(NamedTuple):
    params0: torch.Tensor
    params: torch.Tensor
    fvals: torch.Tensor
    t_cam_cyl: torch.Tensor
    mean_reproj_error: torch.Tensor
    points3: torch.Tensor
    points_valid: torch.Tensor


class DetectResult(NamedTuple):
    grid: GridPoints
    ok: torch.Tensor
    roi_bbox: torch.Tensor
    circle_radius0: torch.Tensor
    labels_converged: torch.Tensor
    max_line_tilt: torch.Tensor
    stable: torch.Tensor
    bridged_components: torch.Tensor


class RegistrationResult(NamedTuple):
    """Multi-frame camera<->AGV registration (ref utils/fitCylinderWPts3sAngs.m)."""

    t_cam_agv: torch.Tensor    # (4, 4)
    fval0: torch.Tensor        # () objective at the triad init
    fval: torch.Tensor         # () objective at the solution
    jtj_min_eig: torch.Tensor  # () min eigenvalue of the 6-dof JtJ at the
                               # solution, per contributing frame, rotation
                               # block scaled by the RMS point radius
    well_posed: torch.Tensor   # () bool: jtj_min_eig >= min_observability


def stereo_from_numpy(
    cam1_k,
    cam1_radial,
    cam1_tangential,
    cam2_k,
    cam2_radial,
    cam2_tangential,
    t_c2_c1,
    device="cpu",
    dtype=torch.float32,
) -> StereoParams:
    """StereoParams on ``device`` from numpy arrays (e.g. ``np.asarray`` of
    each leaf of a JAX ``StereoParams``)."""

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return StereoParams(
        cam1=CameraModel(t(cam1_k), t(cam1_radial), t(cam1_tangential)),
        cam2=CameraModel(t(cam2_k), t(cam2_radial), t(cam2_tangential)),
        t_c2_c1=t(t_c2_c1),
    )
