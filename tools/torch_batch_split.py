#!/usr/bin/env python3
"""Which stages of the PyTorch port's main path depend on the batch size.

    python3 tools/torch_batch_split.py [--frames 16] [--parts 2] [--device cuda]

For ``estimate_poses_batch`` on ``--frames`` frames of the bench scene
family (480x640, ``CylinderDetectConfig(use_pallas=True)``, ``FitConfig()``)
each stage runs once on the inputs of all the views (two per frame) and once
on each of ``--parts`` equal blocks of them, as the ranks of a frame mesh
run it.  Every stage gets the whole run's inputs of that stage, so a stage
answers only for its own arithmetic.  Stages: the smoothing
(``detector._smooth``: a stencil on the card), the preprocess kernel on its
output, the statistic images (``stencils.stats_images``: a stencil on the
card), the front stage as a whole, the ROI,
bridge and grid stages, and the fit (``fit_single_cylinder`` on the grid
points, blocks of frames).  Per stage it prints each output leaf whose
blocks differ from the whole run's slice: the views (or frames) that differ
and the largest absolute difference.  Ends with one JSON line of the same.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--parts", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    a = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import detector as det
    from cylinder_pose_estimation_tpu_torch.models.pipeline import _split
    from cylinder_pose_estimation_tpu_torch.models.pose import fit_single_cylinder
    from cylinder_pose_estimation_tpu_torch.ops import frontend, stencils
    from cylinder_pose_estimation_tpu_torch.ops.linalg import exact_float32
    from cylinder_pose_estimation_tpu_torch.parallel.dryrun import _leaves
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    dev = torch.device(a.device)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    else:
        smi = "cpu"
    exact_float32()
    st_np, (i1, i2) = example_pair(a.height, a.width, n_frames=a.frames)
    stereo = stereo_from_numpy(*st_np, device=dev)
    cfg = CylinderDetectConfig(height=a.height, width=a.width, use_pallas=True)
    fit_cfg = FitConfig()
    gray = det._to_gray(torch.cat([torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev)]))

    def tmap(fn, x):
        if isinstance(x, tuple):
            out = [tmap(fn, y) for y in x]
            return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
        return fn(x)

    def blocks(tree, n):
        """The tree's ``parts`` blocks along a leading axis of length n."""
        size = n // a.parts
        return [tmap(lambda x, s=s: x[s * size:(s + 1) * size]
                     if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == n else x, tree)
                for s in range(a.parts)]

    report = {}

    def stage(name, fn, args, n):
        """fn(*args) on all n rows against fn on each block of the args."""
        with torch.inference_mode():
            whole = fn(*args)
            parts = [fn(*blk) for blk in zip(*[blocks(x, n) for x in args])]
        diff = {}
        for want, got in zip(blocks(whole, n), parts):
            for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
                if w.dtype == np.bool_ or not np.issubdtype(w.dtype, np.number):
                    w, g = w.astype(np.int64), g.astype(np.int64)
                bad = ~(np.equal(g, w) | (np.isnan(g.astype(np.float64)) & np.isnan(w.astype(np.float64))))
                rows = int((bad.reshape(bad.shape[0], -1).any(-1)).sum()) if bad.ndim else int(bad)
                if rows:
                    d = np.abs(g.astype(np.float64) - w.astype(np.float64))
                    d = float(np.nanmax(np.where(np.isfinite(d), d, np.nan))) if np.isfinite(d).any() else None
                    prev = diff.get(path or "out", (0, 0.0))
                    diff[path or "out"] = (prev[0] + rows, max(prev[1], d or 0.0))
        report[name] = {p: {"rows": r, "max_abs": m} for p, (r, m) in diff.items()}
        txt = "; ".join(f"{p}: {r} rows, max |d| {m:.3e}" for p, (r, m) in diff.items()) or "equal"
        print(f"{name} ({n} rows, {a.parts} blocks): {txt}", flush=True)
        return whole

    v = gray.shape[0]
    smooth = stage("smooth", lambda g: det._smooth(g, cfg), (gray,), v)
    pre = stage("preprocess kernel", lambda s: frontend.preprocess_binarize(
        s, sauvola_window=cfg.sauvola_window, sauvola_k=cfg.sauvola_k, sauvola_r=cfg.sauvola_r,
        min_contrast=0.05, line_len=cfg.line_kernel_len, margin=det._border_margin(cfg),
        joint_peak_iters=cfg.joint_peak_iters, pre_smoothed=True), (smooth,), v)
    stage("statistic images", lambda g, j, c: stencils.stats_images(g, j, c, **det._stats_args(cfg)),
          (gray, pre[3], pre[4]), v)
    front = stage("front stage", lambda g: det.front_stage(g, cfg), (gray,), v)
    roi = stage("roi stage", lambda f: det.roi_stage(f, cfg), (front,), v)
    br = stage("bridge stage", lambda mh, mv, r0: det.bridge_stage(mh, mv, r0, cfg),
               (roi.mh, roi.mv, roi.circle_radius0), v)
    st = det.GridState(
        cents=front.cents, inside=roi.inside, bbox=roi.bbox, h_exp=br.h_exp, v_exp=br.v_exp,
        circle_radius0=roi.circle_radius0, gray=front.gray, bright_blur=front.bright_blur,
        warm_labels=br.warm_labels, bridge_angles=br.angles, n_pre=br.n_pre,
        binary=front.binary, mh=roi.mh, mv=roi.mv, carve_domain=roi.carve_domain)
    result = stage("grid stage", lambda s: det.grid_stage(s, cfg)[0], (st,), v)
    d1, d2 = _split(result, a.frames)
    stage("fit", lambda g1, g2: fit_single_cylinder(g1, g2, stereo, fit_cfg), (d1.grid, d2.grid), a.frames)
    print(json.dumps({"frames": a.frames, "parts": a.parts, "device": str(dev), "card": smi, "stages": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
