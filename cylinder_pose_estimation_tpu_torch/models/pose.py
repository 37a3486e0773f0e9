"""Per-frame stereo pose estimation over a leading frame axis (port of the JAX
package's models/pose.py):
choose_idx -> triangulate -> fit_cylinder -> prior -> transform."""

from __future__ import annotations

import torch

from cylinder_pose_estimation_tpu_torch.config import FitConfig
from cylinder_pose_estimation_tpu_torch.geometry import transforms
from cylinder_pose_estimation_tpu_torch.geometry.correspond import (
    choose_idx,
    find_grid_correspondences,
)
from cylinder_pose_estimation_tpu_torch.geometry.cylinder import apply_prior, fit_cylinder
from cylinder_pose_estimation_tpu_torch.geometry.triangulate import triangulate
from cylinder_pose_estimation_tpu_torch.types import CylinderFitResult, GridPoints, StereoParams
from cylinder_pose_estimation_tpu_torch.utils import profiling


def fit_single_cylinder(
    gp1: GridPoints,
    gp2: GridPoints,
    stereo: StereoParams,
    config: FitConfig = FitConfig(),
) -> CylinderFitResult:
    """Cylinder pose of each frame of (F, P) stereo grid-point pairs.

    Spans (``utils.profiling``), each timed on the device on a card:
    ``fit.correspond`` (correspondences, triangulation, mean reprojection
    error) and ``fit.lm`` (the curvature start and LM fit, the axis prior,
    the transform)."""
    like = gp1.xy
    with profiling.span("fit.correspond", like=like):
        corr = choose_idx(
            gp1, gp2, stereo,
            patch_size=config.patch_size,
            error_threshold=config.error_threshold,
            extent=config.grid_extent,
        )
        tri = triangulate(corr.xy1, corr.xy2, stereo, valid=corr.valid)
        w = tri.valid
        mean_error = torch.sum(torch.where(w, tri.reproj_error, 0.0), dim=-1) / torch.clamp(
            torch.sum(w.to(tri.reproj_error.dtype), dim=-1), min=1.0
        )
    with profiling.span("fit.lm", like=like):
        fit = fit_cylinder(
            tri.points3, w, config.cyl_radius,
            knn_k=config.knn_k, lm_iters=config.lm_iters, lm_lambda0=config.lm_lambda0,
        )
        params0 = apply_prior(fit.params0, tri.points3, w)
        params = apply_prior(fit.params, tri.points3, w)
        t_cam_cyl = transforms.cyl_params_to_transform(params)
    return CylinderFitResult(
        params0=params0,
        params=params,
        fvals=fit.fvals,
        t_cam_cyl=t_cam_cyl,
        mean_reproj_error=mean_error,
        points3=tri.points3,
        points_valid=w,
    )


def cylinder_axis_info(
    gp1: GridPoints,
    gp2: GridPoints,
    stereo: StereoParams,
    config: FitConfig = FitConfig(),
):
    """Exact-index correspondences -> points -> fit -> the axis segment
    spanning the points' projections: (points3, valid, axis_p1, axis_p2,
    params), each with the leading frame axis."""
    corr = find_grid_correspondences(gp1, gp2, extent=config.grid_extent)
    tri = triangulate(corr.xy1, corr.xy2, stereo, valid=corr.valid)
    fit = fit_cylinder(tri.points3, tri.valid, config.cyl_radius,
                       knn_k=config.knn_k, lm_iters=config.lm_iters)
    params = apply_prior(fit.params, tri.points3, tri.valid)
    org = params[..., :3]
    d = params[..., 3:6] / torch.linalg.vector_norm(params[..., 3:6], dim=-1, keepdim=True)
    t = torch.sum((tri.points3 - org[..., None, :]) * d[..., None, :], dim=-1)
    big = torch.finfo(t.dtype).max
    t_lo = torch.amin(torch.where(tri.valid, t, big), dim=-1, keepdim=True)
    t_hi = torch.amax(torch.where(tri.valid, t, -big), dim=-1, keepdim=True)
    return tri.points3, tri.valid, org + t_lo * d, org + t_hi * d, params
