"""Streaming pose serving: a long sequence through bounded device memory.

The 10k-frame serving configuration (BASELINE.md config 5) as a recipe:
frames arrive as an (N, H, W) uint8 source, and ``estimate_poses_stream``
pushes fixed-size chunks through the detect -> fit step with a three-deep
pipeline (an uploader thread stages chunk k+1 while chunk k computes and
chunk k-1 is read back), and ``compact=True`` reduces each chunk on the
device to a ~200 B/frame StreamPoseSummary before the readback.

Run:  python -m cylinder_pose_estimation_tpu_torch.examples.streaming_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from cylinder_pose_estimation_tpu_torch import CylinderDetectConfig, FitConfig, estimate_poses_stream
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)

H, W = 192, 256
N_FRAMES = 12
CHUNK = 4


def feed():
    """A synthetic camera feed: unique scenes rendered to uint8 frames (the
    cylinder stays fully visible in both small views)."""
    st = default_stereo(cx=W / 2.0, cy=H / 2.0, baseline=30.0)
    rng = np.random.default_rng(0)
    frames1, frames2 = [], []
    for k in range(N_FRAMES):
        scene = cylinder_grid_points(st, origin=(3.0 * (k % 5) - 6.0, -8.0, 360.0), radius=55.0,
                                     row_spacing=7.0, theta_span=1.1)
        for xy, out in ((scene.xy1, frames1), (scene.xy2, frames2)):
            img = render_grid_image(xy, 9, 9, H, W).astype(np.float32)
            img += rng.normal(0, 2.0, (H, W)).astype(np.float32)
            out.append(np.clip(img, 0, 255).astype(np.uint8))
    return st, np.stack(frames1), np.stack(frames2)


def main(device: str) -> None:
    st, imgs1, imgs2 = feed()
    stereo = stereo_from_numpy(*st, device=device)
    print(f"feed: {N_FRAMES} stereo frames, {imgs1.nbytes * 2 / 1e6:.1f} MB uint8")
    cfg = CylinderDetectConfig(height=H, width=W, cc_iters=8, min_ok_points=5, use_pallas=True)
    fit_cfg = FitConfig(cyl_radius=55.0)

    t0 = time.perf_counter()
    summary = estimate_poses_stream(imgs1, imgs2, stereo, cfg, fit_cfg, chunk=CHUNK, compact=True,
                                    overlap=True, device=device)
    dt = time.perf_counter() - t0
    ok, err = summary.ok, summary.mean_reproj_error
    print(f"streamed {N_FRAMES} frames in {dt:.2f} s (the first chunk builds the kernels on a card)")
    print(f"ok {int(ok.sum())}/{N_FRAMES}, healthy {int(summary.healthy.sum())}, "
          f"median reproj {np.median(err[ok]):.3f} px")
    for i in range(N_FRAMES):
        org = summary.params[i, :3]
        print(f"  frame {i:2d}: ok={bool(ok[i])!s:5} origin=({org[0]:7.1f}, {org[1]:7.1f}, "
              f"{org[2]:7.1f}) mm reproj={err[i]:.3f} px")

    t0 = time.perf_counter()
    estimate_poses_stream(imgs1[:CHUNK], imgs2[:CHUNK], stereo, cfg, fit_cfg, chunk=CHUNK,
                          compact=True, overlap=True, device=device)
    print(f"second stream of one chunk: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)
