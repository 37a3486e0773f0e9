"""A tour of the port's public API on its own synthetic scenes:

  1. the camera and grid-point JSON contracts (ref utils/iotool.py,
     utils/createCameraDataJSON.m, make_json utils/util_cylinder.py:1674),
  2. stereo grid points -> cylinder pose (ref utils/fitSingleCylinder.m),
  3. grid detection on a rendered scene, with sub-pixel refinement
     (ref python_grid_detection_cylinder.py:68-112),
  4. multi-frame pan/tilt camera <-> AGV registration
     (ref utils/fitCylinderWPts3sAngs.m).

Run:  python -m cylinder_pose_estimation_tpu_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch import (
    CylinderDetectConfig,
    FitConfig,
    GridPoints,
    detect_grid,
    fit_single_cylinder,
    io,
)
from cylinder_pose_estimation_tpu_torch.geometry import transforms as tf
from cylinder_pose_estimation_tpu_torch.geometry.kinematics import t_agv_cyl
from cylinder_pose_estimation_tpu_torch.geometry.registration import fit_cylinders_with_angles
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)


def _grid_points(xy, idx, capacity, noise_px, rng, device) -> GridPoints:
    """One view's points as a (1, capacity) GridPoints batch, with N(0,
    noise_px) pixel noise; the centre is the (0, 0) point."""
    n = len(xy)
    pts = np.zeros((capacity, 2), np.float32)
    ids = np.zeros((capacity, 2), np.int32)
    valid = np.zeros(capacity, bool)
    pts[:n] = xy + rng.normal(0.0, noise_px, xy.shape).astype(np.float32)
    ids[:n] = idx
    valid[:n] = True
    center = pts[int(np.flatnonzero((idx == 0).all(-1))[0])]

    def t(a):
        return torch.as_tensor(a, device=device)[None]

    return GridPoints(xy=t(pts), idx=t(ids), valid=t(valid), center=t(center))


def main(device: str) -> None:
    # --- 1. camera JSON contract (reference schema) ------------------------
    st_np = default_stereo()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cameras.json")
        io.save_stereo_json(path, stereo_from_numpy(*st_np, device=device))
        stereo = io.load_stereo_json(path, device=device)
    print("loaded stereo rig, K1 diag:", torch.diagonal(stereo.cam1.k).tolist())

    # --- 2. stereo grid points -> cylinder pose ----------------------------
    rng = np.random.default_rng(0)
    scene = cylinder_grid_points(st_np)
    gp1 = _grid_points(scene.xy1, scene.idx, 128, 0.2, rng, device)
    gp2 = _grid_points(scene.xy2, scene.idx, 128, 0.2, rng, device)
    with torch.inference_mode():
        fit = fit_single_cylinder(gp1, gp2, stereo, FitConfig())
    axis = fit.params[0, 3:6].cpu().numpy().astype(np.float64)
    axis /= np.linalg.norm(axis)
    axis_gt = scene.cyl_params[3:6].astype(np.float64)
    err = np.degrees(np.arccos(np.clip(abs(axis_gt @ axis), 0, 1)))
    fv = torch.sqrt(fit.fvals[0]).tolist()
    print(f"cylinder fit: axis error {err:.3f} deg, mean reproj "
          f"{float(fit.mean_reproj_error[0]):.3f} px, rms(dist-R) {fv[0]:.3f} -> {fv[1]:.3f} mm")

    # grid-point JSON round trip (the detect -> geometry hand-off)
    js = io.grid_points_to_json(GridPoints(*(x[0] for x in gp1)))
    back = io.grid_points_from_json(js, capacity=128, device=device)
    print("grid JSON round trip:", int(back.valid.sum()), "points")

    # --- 3. detection on a rendered scene -----------------------------------
    h, w = 240, 320
    st_small = default_stereo(cx=w / 2.0, cy=h / 2.0)
    sc = cylinder_grid_points(st_small, origin=(0.0, -15.0, 560.0), radius=52.0,
                              row_spacing=12.0, theta_span=2.2)
    img = torch.as_tensor(render_grid_image(sc.xy1, 9, 9, h, w), dtype=torch.float32, device=device)
    for refine in (False, True):
        cfg = CylinderDetectConfig(height=h, width=w, use_pallas=True, subpixel_refine=refine)
        res = detect_grid(img[None], cfg)
        print(f"detect_grid (subpixel_refine={refine}):", int(res.grid.valid.sum()),
              "grid points, ok =", bool(res.ok[0]))

    # --- 4. multi-frame pan/tilt AGV registration --------------------------
    gt_pose = torch.tensor([0.2, -1.6, 0.15, 120.0, -40.0, 900.0])
    t_gt = tf.vec_to_transform(gt_pose).numpy()
    angles = np.asarray([[-0.3, 0.1], [0.0, 0.0], [0.35, -0.12], [0.6, 0.2]], np.float32)
    t_acs = t_gt @ t_agv_cyl(torch.as_tensor(angles[:, 0]), torch.as_tensor(angles[:, 1])).numpy()
    frames = np.zeros((len(angles), 128, 3), np.float32)
    valids = np.zeros((len(angles), 128), bool)
    for f in range(len(angles)):
        org, x, y, z = t_acs[f, :3, 3], t_acs[f, :3, 0], t_acs[f, :3, 1], t_acs[f, :3, 2]
        hs = (np.arange(8) - 4) * 13.0
        thetas = np.arctan2(-x[2], -z[2]) + np.linspace(-0.7, 0.7, 9)
        pts = np.asarray([org + hh * y + 45.0 * (np.cos(t) * z + np.sin(t) * x)
                          for hh in hs for t in thetas], np.float32)
        frames[f, :len(pts)] = pts + rng.normal(0, 0.1, pts.shape).astype(np.float32)
        valids[f, :len(pts)] = True
    reg = fit_cylinders_with_angles(torch.as_tensor(frames, device=device),
                                    torch.as_tensor(valids, device=device),
                                    torch.as_tensor(angles, device=device))
    t_err = np.linalg.norm(reg.t_cam_agv.cpu().numpy()[:3, 3] - t_gt[:3, 3])
    print(f"registration: translation error {t_err:.4f} mm")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)
