#!/usr/bin/env python3
"""Time the four front-end kernels on one CUDA card at the detector's call
sites.

    python3 tools/torch_kernel_time.py [--root DIR] [--reps 20]

Runs ``estimate_poses_batch`` once on 16 frames of the bench scene family
(480x640, ``CylinderDetectConfig(use_pallas=True)``, and again with
``bridge_endpoint_stats=True`` for the payload kernel 2.4) to capture the
kernel wrappers' arguments, then for each call site of the preprocess (2.1),
CC (2.2), bridge (2.3) and payload (2.4) kernels prints three times:
``call`` (CUDA events around one wrapper call, median of ``reps``; the
host's launch path is inside), ``run`` (CUDA events around ``reps``
back-to-back calls, over ``reps``: the device's rate once the host keeps
ahead) and ``device`` (torch.profiler: the call's CUDA kernels' summed
durations, by kernel name).

Then the large-mask sites of the CC family (2.2 and 2.4 past the cluster
kernels' shared memory) and of the bridge (2.3), captured the same way: the
kernel branch with ``label_downsample=1`` and with its endpoint bridge on
the same 16 frames ((64, 480, 640): CC 2x2 cold and warm, 3x2 cold, payload
2x4, bridge probe 9 max kernel 251), plane mode at ``label_downsample=1`` on
the eight views of ``tests/fixtures/torch_plane_scenes.json`` (bridge
(16, 480, 640) 9/361), and the main and endpoint configs on 2 frames of
720x1280 ((8, 360, 640)) and 1080x1920 ((8, 544, 1024)).  ``--sites``
picks the main path's sites, the large ones, both, or the bridge's alone
(``bridge``: its main-path site and its large ones, each large one also
with kernel length 0, where every line step has offset (0, 0), and with
kernel length 0 at probe 1: the differences price the line steps and the
ray counts, the rest is the loads, the stores, the closing and the
barriers).

``--sites knobs`` times the kernel branches of the detector's knobs on the
same 16 frames, captured from their configurations' steps: 2.1's own
smoothing (``smooth_mxu=False``) at (32, 480, 640) and on grey frames at
(4, 720, 1280); 2.2's capped scans (``pallas_cc_cross_cap=16``) along H and
along W at (32, 240, 384) and, at ``label_downsample=1``, at
(32, 480, 640); and, as a yardstick that is not the same
function, the main path's own smoothing (``detector._smooth``'s banded
matmuls, TF32 off) followed by the pre-smoothed kernel at (32, 480, 640).
``--sites reach`` times the capped scans past the column pass's streamed
reach: ``pallas_cc_cross_cap`` 64 and 256 (reach 63 and 255) at
``label_downsample=1``, along H and along W at (32, 480, 640).  Each of
these sites adds ``graph_ms``: the device ms of a CUDA graph replay of one
call (``utils.profiling.graph_kernels``) and its kernel count.

``--root`` picks the checkout whose ``cylinder_pose_estimation_tpu_torch``
is imported (default: this one), so two trees can be timed in turns in one
run on one card.  ``--against DIR --pairs N`` does that itself: it runs this
script on DIR (the parent) and on ``--root`` in N alternating pairs
(parent, change, change, parent, ...), each in its own process, and prints
per site the median of each tree's readings.  Ends with one JSON line of
the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def event_ms(fn, reps: int, per_event: int) -> float:
    """Median ms per call over ``reps`` event pairs, each around
    ``per_event`` back-to-back calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps if per_event == 1 else 5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_event):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_event)
    return statistics.median(times)


def device_ms(fn, calls: int = 5) -> tuple:
    """Summed CUDA kernel durations per call, by kernel name (ms), and the
    device kernels per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by, count = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
            by[name] = by.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
            count += 1
    return by, count / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sites", choices=("main", "global", "all", "bridge", "knobs", "reach"), default="all")
    ap.add_argument("--against", default=None, help="a second tree (the parent) to time in turns with --root")
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_time: no CUDA device", file=sys.stderr)
        return 2
    if args.against:
        return alternate(args)
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)
    from chip_smoke import Capture
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.ops import frontend, kernels
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels.build()
    dev = torch.device("cuda:0")
    st, (i1, i2) = example_pair(480, 640, n_frames=16)
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=480, width=640, use_pallas=True)
    cfg_ep = CylinderDetectConfig(height=480, width=640, use_pallas=True, bridge_endpoint_stats=True)
    d1, d2 = torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev)
    with Capture(frontend) as cap, torch.inference_mode():
        estimate_poses_batch(d1, d2, stereo, cfg, FitConfig())
    with Capture(frontend) as cap_ep, torch.inference_mode():
        estimate_poses_batch(d1, d2, stereo, cfg_ep, FitConfig())
    if args.sites == "knobs":
        sites = knob_sites(frontend, Capture, (d1, d2, stereo))
    elif args.sites == "reach":
        sites = []
        for c in (64, 256):
            over = {"pallas_cc_cross_cap": c, "label_downsample": 1}
            sites += capped_sites(frontend, Capture, (d1, d2, stereo), over, f" cap {c}")
    else:
        sites = main_sites(frontend, cap, cap_ep) if args.sites != "global" else []
    if args.sites not in ("main", "knobs", "reach"):
        sites += global_sites(frontend, Capture, (d1, d2, stereo), args.sites == "bridge")
    if args.sites == "bridge":
        sites = [(label, fn) for label, fn in sites if label.startswith("bridge_morphology")]
    from cylinder_pose_estimation_tpu_torch.utils.profiling import graph_kernels

    out = []
    with torch.inference_mode():
        for label, fn in sites:
            by_name, per_call = device_ms(fn)
            row = {"site": label, "call_ms": event_ms(fn, args.reps, 1),
                   "run_ms": event_ms(fn, args.reps, args.reps), "device_ms": by_name,
                   "kernels_per_call": per_call}
            if args.sites in ("knobs", "reach"):
                row["graph_kernels"], row["graph_ms"] = graph_kernels(fn, reps=args.reps)
            out.append(row)
            dev_total = sum(row["device_ms"].values())
            graph = f", graph {row['graph_ms']:.4f} ms in {row['graph_kernels']} kernels" if "graph_ms" in row else ""
            print(f"{args.root} {label}: call {row['call_ms']:.4f} ms, run {row['run_ms']:.4f} ms, "
                  f"device {dev_total:.4f} ms in {per_call:g} kernels{graph} "
                  f"{({k: round(v, 4) for k, v in sorted(row['device_ms'].items(), key=lambda kv: -kv[1])[:4]})}; "
                  f"{smi}", flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi, "sites": out}))
    return 0


def alternate(args) -> int:
    """Time ``--against`` (the parent) and ``--root`` in ``--pairs``
    alternating pairs, one process per reading, and print per site each
    tree's median ``graph_ms`` (or summed profiler device ms) and
    ``call_ms``."""
    roots = [os.path.abspath(args.against), os.path.abspath(args.root)]
    order = []
    for i in range(args.pairs):
        order += roots if i % 2 == 0 else roots[::-1]
    readings = {r: [] for r in roots}
    for root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root, "--sites", args.sites, "--reps",
               str(args.reps)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        readings[root].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"reading {len(readings[root])} of {root} done", flush=True)
    card = readings[roots[1]][0]["card"]
    summary = []
    for i, row in enumerate(readings[roots[1]][0]["sites"]):
        entry = {"site": row["site"]}
        for name, root in (("parent", roots[0]), ("change", roots[1])):
            rows = [rd["sites"][i] for rd in readings[root]]
            if any(r["site"] != row["site"] for r in rows):
                raise SystemExit(f"site {row['site']} is not timed at the same place in every reading")
            dev = [r.get("graph_ms", sum(r["device_ms"].values())) for r in rows]
            names = sorted({k for r in rows for k in r["device_ms"]})
            entry[name] = {"device_ms": statistics.median(dev), "device_ms_all": dev,
                           "call_ms": statistics.median(r["call_ms"] for r in rows),
                           "kernels_per_call": rows[0].get("graph_kernels", rows[0]["kernels_per_call"]),
                           "profiler_ms_by_kernel": {k: statistics.median(r["device_ms"].get(k, 0.0) for r in rows)
                                                     for k in names}}
        summary.append(entry)
        by = {n: {k: round(v, 4) for k, v in entry[n]["profiler_ms_by_kernel"].items()} for n in ("parent", "change")}
        print(f"{row['site']}: parent {entry['parent']['device_ms']:.4f} device ms "
              f"({entry['parent']['kernels_per_call']} kernels, call {entry['parent']['call_ms']:.4f}), change "
              f"{entry['change']['device_ms']:.4f} ({entry['change']['kernels_per_call']} kernels, call "
              f"{entry['change']['call_ms']:.4f}); medians of {args.pairs}; profiler ms by kernel {by}; {card}",
              flush=True)
    print(json.dumps({"parent": roots[0], "change": roots[1], "card": card, "pairs": args.pairs,
                      "sites": summary}))
    return 0


def knob_sites(frontend, capture, batch) -> list:
    """(label, call) of the knob branches' sites (see the module docstring)
    and the yardstick, captured from each knob configuration's step on the
    B=16 frames ``batch``; each tree's own wrappers."""
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import detector
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sites = []
    calls = {}
    cfg = CylinderDetectConfig(height=480, width=640, use_pallas=True, smooth_mxu=False)
    with capture(frontend) as cap, torch.inference_mode():
        estimate_poses_batch(*batch, cfg, FitConfig())
    calls["smoothing"] = cap.calls
    args_, kw = calls["smoothing"]["preprocess_binarize"][0]
    if kw.get("pre_smoothed", False):
        raise SystemExit("the smoothing configuration called the preprocess kernel on a smoothed image")
    x = args_[0]
    sites.append((f"smoothing {tuple(x.shape)}", lambda x=x, kw=kw: frontend.preprocess_binarize(x, **kw)))
    _, (g1, g2) = example_pair(720, 1280, n_frames=2)
    grey = torch.as_tensor(np.concatenate([g1, g2]), device=x.device)
    sites.append((f"smoothing {tuple(grey.shape)}", lambda x=grey, kw=kw: frontend.preprocess_binarize(x, **kw)))
    for over in ({"pallas_cc_cross_cap": 16}, {"pallas_cc_cross_cap": 16, "label_downsample": 1}):
        sites += capped_sites(frontend, capture, batch, over)
    cfg = CylinderDetectConfig(height=480, width=640, use_pallas=True)
    sm_kw = dict(calls["smoothing"]["preprocess_binarize"][0][1], pre_smoothed=True)

    def yardstick(x=x, cfg=cfg, kw=sm_kw):
        return frontend.preprocess_binarize(detector._smooth(x, cfg), **kw)

    sites.append((f"yardstick _smooth + pre-smoothed {tuple(x.shape)}", yardstick))
    return sites


def capped_sites(frontend, capture, batch, over: dict, suffix: str = "") -> list:
    """(label, call) of the capped CC calls of one step of the 480x640
    kernel-branch configuration with ``over`` on the frames ``batch``."""
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch

    cfg = CylinderDetectConfig(height=480, width=640, use_pallas=True, **over)
    with capture(frontend) as cap, torch.inference_mode():
        estimate_poses_batch(*batch, cfg, FitConfig())
    return [(f"capped {tuple(args_[0].shape)} cap_axis {kw['cap_axis']}{suffix}",
             lambda m=args_[0], kw=kw: frontend.connected_components(m, **kw))
            for args_, kw in cap.calls["connected_components"] if kw.get("cap", 0) > 0]


def main_sites(frontend, cap, cap_ep) -> list:
    """(label, call) of each kernel call site of the B=16 main path, and the
    payload kernel's of the endpoint path."""
    sites = []
    for args_, kw in cap.calls["preprocess_binarize"]:
        x = args_[0]
        sites.append((f"preprocess_binarize {tuple(x.shape)}",
                      lambda x=x, kw=kw: frontend.preprocess_binarize(x, **kw)))
    for args_, kw in cap.calls["connected_components"]:
        m, init = args_[0], kw.get("init_labels")
        label = (f"connected_components {tuple(m.shape)} {kw['rounds']}x{kw['pools_per_round']} "
                 f"{'warm' if init is not None else 'cold'}")
        sites.append((label, lambda m=m, kw=kw: frontend.connected_components(m, **kw)))
    # The bridge as the detector calls it, and the payload kernel as the
    # endpoint path calls it (each tree's own arguments).
    for name, calls in (("bridge_morphology", cap.calls), ("component_payload_minmax", cap_ep.calls)):
        for args_, kw in calls[name]:
            label = f"{name} {tuple(args_[0].shape)} {args_[0].dtype} {kw}"
            sites.append((label, lambda a=args_, kw=kw, f=getattr(frontend, name): f(*a, **kw)))
    return sites


# The canvases of the CC family's global route at the captured sites.
GLOBAL_CANVASES = ((480, 640), (360, 640), (544, 1024))


def global_sites(frontend, capture, batch, breakdown=False) -> list:
    """(label, call) of each distinct CC, payload and bridge call on a
    large-mask canvas: the ds=1 kernel branch and its endpoint bridge on the
    B=16 frames ``batch``, plane mode at ds=1 on the plane fixture's views,
    the main and endpoint configs at 720x1280 and 1080x1920 on 2 frames;
    ``breakdown``: each bridge site also with kernel length 0, and with
    kernel length 0 at probe 1."""
    import json

    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair, plane_view

    dev = batch[0].device
    runs = [(480, 640, batch, {"label_downsample": 1}),
            (480, 640, batch, {"label_downsample": 1, "bridge_endpoint_stats": True})]
    with open(os.path.join(HERE, "tests", "fixtures", "torch_plane_scenes.json")) as f:
        specs = [v["spec"] for v in json.load(f)["views"]]
    runs.append((480, 640, torch.as_tensor(np.stack([plane_view(480, 640, **sp) for sp in specs]), device=dev),
                 {"label_downsample": 1, "roi_threshold": 30.0}))
    for h, w in ((720, 1280), (1080, 1920)):
        st, (i1, i2) = example_pair(h, w, n_frames=2)
        frames = (torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev), stereo_from_numpy(*st, device=dev))
        runs += [(h, w, frames, {}), (h, w, frames, {"bridge_endpoint_stats": True})]
    sites, seen = [], set()
    for h, w, inputs, overrides in runs:
        with capture(frontend) as cap, torch.inference_mode():
            if isinstance(inputs, tuple):
                cfg = CylinderDetectConfig(height=h, width=w, use_pallas=True, **overrides)
                estimate_poses_batch(*inputs, cfg, FitConfig())
            else:
                detect_grid(inputs, PlaneDetectConfig(height=h, width=w, use_pallas=True, **overrides))
        for name in ("connected_components", "component_payload_minmax", "bridge_morphology"):
            for args_, kw in cap.calls[name]:
                shape = tuple(args_[0].shape)
                if shape[-2:] not in GLOBAL_CANVASES:
                    continue
                if name == "bridge_morphology":
                    label = f"{name} {shape} probe {kw['probe_len']} max_kernel {kw['max_kernel']}"
                else:
                    label = f"{name} {shape} {kw['rounds']}x{kw['pools_per_round']}"
                if name == "connected_components":
                    label += " warm" if kw.get("init_labels") is not None else " cold"
                if label not in seen:
                    seen.add(label)
                    sites.append((label, lambda a=args_, kw=kw, f=getattr(frontend, name): f(*a, **kw)))
                    if name == "bridge_morphology" and breakdown:
                        zero = (*args_[:3], torch.zeros_like(args_[3]))
                        sites.append((label + " kernel_len 0",
                                      lambda a=zero, kw=kw: frontend.bridge_morphology(*a, **kw)))
                        sites.append((label + " kernel_len 0 probe 1",
                                      lambda a=zero, kw=kw: frontend.bridge_morphology(*a, **{**kw, "probe_len": 1})))
    return sites


if __name__ == "__main__":
    sys.exit(main())
