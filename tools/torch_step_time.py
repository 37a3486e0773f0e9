#!/usr/bin/env python3
"""Time the PyTorch port's B=16 step on one CUDA card.

    python3 tools/torch_step_time.py [--root DIR] [--reps 10] [--branch kernels|xla]

Prints, for ``estimate_poses_batch`` on 16 frames of the bench scene family
(480x640, ``CylinderDetectConfig(use_pallas=True)`` or, with ``--branch
xla``, ``CylinderDetectConfig()``, and ``FitConfig()``):
e2e and detect-only (``probe="detect"``) ms/frame (CUDA events, medians,
each call on freshly perturbed frames), the preprocess and CC kernels' device
ms per detect call, and the detect stage's device busy share: the union of
its CUDA kernels' intervals in a torch.profiler window over the host wall
time of that window (the profiler's own host cost is inside the wall).
Then the bridge stage's ms (``detector.bridge_stage`` on the same front and
ROI stages, CUDA events) with ``CylinderDetectConfig(use_pallas=True)`` and
with ``bridge_endpoint_stats=True`` (kernel branch); for either branch the
ms of each detector stage (front, ROI, bridge, grid; CUDA events) and the
ten device operations that take the most device time in the detect step
(torch.profiler ``key_averages``).

``--root`` picks the checkout whose ``cylinder_pose_estimation_tpu_torch``
is imported (default: this one), so that two trees can be timed in turns in
one run on one card.  Ends with one JSON line of the numbers.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time


# Kernel function names of 2.1-2.3, before and after their redesign.
FAMILIES = {
    "preprocess": ("binarize_tiles", "mask_tiles", "hessian_minima", "box_rows", "sauvola_binarize",
                   "line_minmax", "joints_of", "joint_count", "peak_pass", "peak_final"),
    "cc": ("cc_cluster", "cc_init", "cc_pool", "cc_run_min"),
    "bridge": ("bridge_cluster", "bridge_kernel"),
}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def busy_share(fn, calls: int = 3) -> dict:
    """Device busy time (union of kernel intervals) over host wall time of
    ``calls`` profiled calls, the device ms per call by kernel family, and
    the ten device operations with the most device ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        key = next((fam for fam, names in FAMILIES.items() if any(n + "(" in e.name or n + "<" in e.name
                                                                for n in names)), "other")
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(((e.key, e.device_time_total / calls / 1e3, e.count / calls) for e in prof.key_averages()
                  if e.device_time_total > 0), key=lambda t: -t[1])[:10]
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"busy_share": busy / wall_us if wall_us else None, "kernels_per_call": len(spans) / calls,
            "device_ms_per_call": busy / calls / 1e3, "wall_ms_per_call": wall_us / calls / 1e3,
            "family_ms_per_call": {k: v / calls / 1e3 for k, v in by_name.items()},
            "top_ops": [{"op": k[:80], "device_ms_per_call": ms, "calls_per_call": n} for k, ms, n in top]}


def stage_ms(det, views, cfg, reps: int) -> dict:
    """CUDA-event ms of each detector stage on (V, H, W) views, each fed the
    previous stage's output."""
    kernels = cfg.use_pallas
    gray = det._to_gray(views)
    front_fn = det.front_stage if kernels else det.front_stage_xla
    bridge_fn = det.bridge_stage if kernels else det.bridge_stage_xla
    front = front_fn(gray, cfg)
    roi = det.roi_stage(front, cfg)
    br = bridge_fn(roi.mh, roi.mv, roi.circle_radius0, cfg)
    st = det.GridState(
        cents=front.cents, inside=roi.inside, bbox=roi.bbox, h_exp=br.h_exp, v_exp=br.v_exp,
        circle_radius0=roi.circle_radius0, gray=front.gray, bright_blur=front.bright_blur,
        warm_labels=br.warm_labels,
        bridge_angles=br.angles, n_pre=br.n_pre, binary=front.binary, mh=roi.mh, mv=roi.mv,
        carve_domain=roi.carve_domain)
    return {
        "front": cuda_ms(lambda: front_fn(gray, cfg), reps),
        "roi": cuda_ms(lambda: det.roi_stage(front, cfg), reps),
        "bridge": cuda_ms(lambda: bridge_fn(roi.mh, roi.mv, roi.circle_radius0, cfg), reps),
        "grid": cuda_ms(lambda: det.grid_stage(st, cfg), reps),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--branch", choices=("kernels", "xla"), default="kernels")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_step_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import detector as det
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.ops import kernels
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels.build()
    dev = torch.device("cuda:0")
    batch = 16
    st, (i1, i2) = example_pair(480, 640, n_frames=batch)
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=480, width=640, use_pallas=args.branch == "kernels")
    fit_cfg = FitConfig()
    d1 = torch.as_tensor(i1, device=dev)
    d2 = torch.as_tensor(i2, device=dev)
    rep = itertools.count(1)

    def e2e():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg, fit_cfg).fit.params

    def detect():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg, fit_cfg, probe="detect").grid.xy

    with torch.inference_mode():
        ms_e2e = cuda_ms(e2e, args.reps)
        ms_det = cuda_ms(detect, args.reps)
        busy = busy_share(detect)
        views = torch.cat([d1, d2])
        stages = stage_ms(det, views, cfg, args.reps)
        bridge_ms = {}
        if args.branch == "kernels":
            roi = det.roi_stage(det.front_stage(det._to_gray(views), cfg), cfg)
            for label, c in (("main", cfg), ("endpoint", CylinderDetectConfig(
                    height=480, width=640, use_pallas=True, bridge_endpoint_stats=True))):
                bridge_ms[label] = cuda_ms(lambda c=c: det.bridge_stage(roi.mh, roi.mv, roi.circle_radius0, c),
                                           args.reps)
    out = {"root": os.path.abspath(args.root), "card": smi, "batch": batch, "branch": args.branch,
           "e2e_ms_per_frame": ms_e2e / batch, "detect_ms_per_frame": ms_det / batch,
           "detect_ms_per_step": ms_det, "detect_profile": busy, "stage_ms": stages,
           "bridge_stage_ms": bridge_ms}
    print(f"{args.root}: e2e {ms_e2e / batch:.4f} ms/frame, detect {ms_det / batch:.4f} ms/frame "
          f"({ms_det:.3f} ms/step); detect busy share {busy['busy_share']:.3f}, device "
          f"{busy['device_ms_per_call']:.3f} ms of {busy['wall_ms_per_call']:.3f} ms wall per step "
          f"(profiled), kernels {busy['kernels_per_call']:.0f}, by family "
          f"{ {k: round(v, 4) for k, v in busy['family_ms_per_call'].items()} }; stages at V={2 * batch} "
          f"{ {k: round(v, 4) for k, v in stages.items()} } ms; bridge stage {bridge_ms}; {smi}", flush=True)
    for op in busy["top_ops"]:
        print(f"  {op['device_ms_per_call']:9.4f} device ms in {op['calls_per_call']:6.0f} calls: {op['op']}",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
