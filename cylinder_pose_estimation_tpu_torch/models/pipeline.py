"""End-to-end pipelines: stereo images in, cylinder poses out (port of the JAX
package's models/pipeline.py entry points ``estimate_pose_stereo`` and
``estimate_poses_batch``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from cylinder_pose_estimation_tpu_torch.config import DetectConfig, FitConfig
from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
from cylinder_pose_estimation_tpu_torch.models.pose import fit_single_cylinder
from cylinder_pose_estimation_tpu_torch.ops.linalg import exact_float32
from cylinder_pose_estimation_tpu_torch.types import (
    CylinderFitResult,
    DetectResult,
    GridPoints,
    StereoParams,
)


class StereoPoseResult(NamedTuple):
    detect1: DetectResult
    detect2: DetectResult
    fit: CylinderFitResult


def _split(det: DetectResult, f: int):
    first = type(det)(*[_slice(x, slice(0, f)) for x in det])
    second = type(det)(*[_slice(x, slice(f, None)) for x in det])
    return first, second


def _slice(x, sl):
    if isinstance(x, GridPoints):
        return GridPoints(*[t[sl] for t in x])
    return x[sl]


@torch.inference_mode()
def estimate_poses_batch(
    images1: torch.Tensor,
    images2: torch.Tensor,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    probe: str | None = None,
):
    """Detect both views of F frames as one (2F,) batch, then fit each frame.

    images1/images2: (F, H, W) or (F, H, W, 3) on the device the work should
    run on.  ``probe="detect"`` returns the stacked (2F,) DetectResult right
    after detection (the detect-only split of the timing)."""
    exact_float32()
    f = images1.shape[0]
    det = detect_grid(torch.cat([images1, images2], dim=0), detect_cfg)
    if probe == "detect":
        return det
    d1, d2 = _split(det, f)
    fit = fit_single_cylinder(d1.grid, d2.grid, stereo, fit_cfg)
    return StereoPoseResult(detect1=d1, detect2=d2, fit=fit)


def estimate_pose_stereo(
    image1: torch.Tensor,
    image2: torch.Tensor,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
) -> StereoPoseResult:
    """One stereo frame (H, W) -> StereoPoseResult without a frame axis."""
    res = estimate_poses_batch(image1[None], image2[None], stereo, detect_cfg, fit_cfg)

    def first(x):
        return _slice(x, 0)

    return StereoPoseResult(
        detect1=type(res.detect1)(*[first(x) for x in res.detect1]),
        detect2=type(res.detect2)(*[first(x) for x in res.detect2]),
        fit=type(res.fit)(*[x[0] for x in res.fit]),
    )
