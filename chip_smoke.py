#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs a CUDA device and ``nvcc``; exits non-zero without them, and when any
phase fails.  Phases:

1. Build the CUDA kernels from ``cylinder_pose_estimation_tpu_torch/csrc``
   (first use; the library lands in the package's ``_build/``).
2. Main path: ``estimate_poses_batch`` on the bench scene family's six golden
   scenes plus the bridged gap scene (480x640), with every kernel launch
   counter reset just before and read just after; each scene is held against
   ``tests/fixtures/golden_scenes.json`` (ids identical, xy within 0.05 px,
   fit params within 0.05, reprojection within 0.01 px).
3. Endpoint path: the same seven scenes with
   ``CylinderDetectConfig(bridge_endpoint_stats=True)``, counters reset just
   before and read just after (the payload min/max kernel replaces the
   pre-bridge CC: ``connected_components`` runs twice), held to
   ``tests/fixtures/torch_endpoint_scenes.json`` by the same contract.
4. Plane path: ``detect_grid`` with ``PlaneDetectConfig(roi_threshold=30)``
   on the eight views that ``tests/fixtures/torch_plane_scenes.json``
   specifies, rendered here, counters reset just before and read just after;
   ids identical, xy within 0.05 px, ``ok`` and ``stable`` equal.
5. Numerics: each path's bridge on the card and on the CPU from the same
   carved masks; the angle difference and the differing bridged pixels are
   printed (the fixtures above are the gate).
6. Kernels: each CUDA kernel against its plain PyTorch version on the same
   device, on the intermediates of B=16 runs (production shapes) and on
   seeded random inputs; every output must be ``torch.equal``.  Median times
   of both, with CUDA events around one call after warm-up; torch.profiler's
   device kernels per call (at most 3 for 2.1, exactly 1 for the others) and
   their summed device ms; the byte bound of each site (``frontend.min_bytes``
   at 3.35 TB/s).  The bridge is timed on the detector's bool masks and, off
   the report, as float32; its in-kernel schedule must equal
   ``bridge_schedule`` on the card for 10^5 angles.  The build's
   ``-Xptxas -v`` lines and the launch plans are printed first.
7. End to end: ms/frame of B=16 frames and the detect-only split, for the
   main and the endpoint path; their bridge and grid stage ms; plane detect
   ms/view.
8. Registration: ``fit_cylinders_with_angles`` on the points of
   ``tests/fixtures/torch_registration.json`` (100 frames, one poisoned
   frame masked) against the JAX result recorded there; then the experiment
   path, ``full_experiment`` on 100 frames of ``registration_sequence``
   (480x640), counters reset just before and read just after, whose
   registration is recomputed on the CPU from the card's own points and
   must agree.  Both comparisons: predicted cylinder axes within 0.05 deg
   and 0.1 mm perpendicular offset, fval and the minimum JtJ eigenvalue
   within rel 1e-2, ``well_posed`` equal (the sequence's default swing is
   well posed).  Prints
   the healthy-frame count, fval0/fval, the minimum eigenvalue and the
   errors against the ground-truth T_Cam_AGV, and the ms of detect+fit and
   of the registration.
9. Preprocessing path: ``full_experiment(preprocess=True)`` on 16 distorted
   frames, counters reset just before and read just after;
   ``preprocess_stereo_batch`` on the card against the CPU port (max |d| <=
   1e-2 grey levels, pixels over 1e-3 counted), and detection of 2 of the
   preprocessed frames card vs CPU (ids identical, xy within 0.05 px);
   preprocessing ms/frame.
10. Stream path: ``estimate_poses_stream(chunk=64, compact=True,
   overlap=True)`` over 2,000 uint8 frames (16 scenes tiled with brightness
   offsets), counters reset just before and read just after; every chunk's
   summary must equal ``_summarize_batch(estimate_poses_batch(...))`` of
   the same 64 frames on the card, the padded tail included.  Prints
   frames/s, the ok count, the median reprojection and the peak device
   memory; then frames/s of the same stream with ``overlap=False``, whose
   output must equal the overlapped one.
11. XLA path (the default ``use_pallas=False``, run after phase 4):
   ``estimate_poses_batch`` with ``CylinderDetectConfig()`` on the seven
   scenes of phase 2 with ``gap0`` (the XLA record) in place of
   ``gap0_pallas``, held to ``golden_scenes.json`` by the phase-2 contract
   (direction at the fixture's norm), then ``detect_grid`` with
   ``PlaneDetectConfig(roi_threshold=30)`` on the phase-4 views, held to
   their points, ``ok`` and ``stable_xla``; counters reset just before and
   read just after must show none of the four kernels.  Timed at B=16 in
   phase 7 (e2e and detect ms/frame, device kernels per detect step).
12. Large path (run after phase 6): the main and endpoint configs at
   720x1280 and 1080x1920 on ``LARGE_BATCH`` frames each, counters reset
   just before and read just after (the CC family's global route and the
   bridge's split route); every kernel call there is captured and held
   ``torch.equal`` to its plain version on the card, with its ms, device
   ms and device ms by kernel name, device kernels per call (at most the
   global route's count, ``frontend.cc_global_launches``, and 1 for the
   bridge; "not measured" where torch.profiler reads nothing) and byte
   bound; the card's
   grids are held to the CPU port's (ids identical, xy within 0.05 px,
   ``ok`` and ``stable`` equal); ms/frame of each config and size.
13. Variants (run after phase 12): the configurations of
   ``tests/fixtures/torch_variant_scenes.json``'s 480x640 record
   (``subpixel_refine``, ``label_downsample=1`` and ``bridge_half_res=False``
   on both branches, the endpoint bridge at ``label_downsample=1``, plane
   mode at ``label_downsample=1`` on both branches) on B=16 frames of
   ``example_pair`` or the plane fixture's views; the kernel-branch and the
   XLA-branch configurations each a path with counters reset just before
   and read just after.  Every view is held to the JAX record (ids
   identical, xy within 0.05 px), 2 frames card against the CPU port; every
   kernel call at a full-resolution shape (the CC family's global route and
   the bridge's split route at (64, 480, 640) and (16, 480, 640)) is held
   ``torch.equal`` to its plain version and each site timed once; e2e and
   detect ms/frame per configuration.
14. CLI (run after phase 7's timing): ``cli.main`` with ``--device cuda`` for
   ``detect-folder``, ``experiment`` (the record's arguments) and
   ``undistort-folder`` on PNG frames of ``write_registration_folder`` in a
   temporary directory, counters reset just before and read just after (the
   drivers' default config launches no kernel); held to
   ``tests/fixtures/torch_cli.json`` (the JAX CLI on the same files) and the
   undistortion to the port on the CPU within one grey level.

15. Bridge routes (run after phase 13): ``frontend.bridge_morphology`` on
   line masks at one shape of each route of ``bridge_plan`` (cluster
   (64, 240, 384), split (2, 720, 1280) at full resolution, global
   (2, 2160, 3840): the 4K frame's full-resolution masks, past what 8 CTAs
   hold), counters reset just before and read just after: each route must
   launch; each call ``torch.equal`` to plain, its schedule equal to
   ``bridge_schedule``, timed.

The second-to-last line is the kernel report as JSON: one row per kernel
(the 480x640 sites; ``large_sites`` and ``variant_sites`` hold phases 12's
and 13's), the bridge's cluster route in its own row and its split and
global routes in rows of their own (``bridge_morphology.split``,
``bridge_morphology.global``: their timed sites of phases 12, 13 and 15).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "fixtures", "golden_scenes.json")
ENDPOINT = os.path.join(HERE, "tests", "fixtures", "torch_endpoint_scenes.json")
PLANE = os.path.join(HERE, "tests", "fixtures", "torch_plane_scenes.json")
REGISTRATION = os.path.join(HERE, "tests", "fixtures", "torch_registration.json")
VARIANTS = os.path.join(HERE, "tests", "fixtures", "torch_variant_scenes.json")
CLI_RECORD = os.path.join(HERE, "tests", "fixtures", "torch_cli.json")
KERNELS = ("preprocess_binarize", "connected_components", "bridge_morphology",
           "component_payload_minmax")
# Kernels each path must launch: None, at least once; a number, exactly
# that often (0: never).
PATH_KERNELS = {
    "main": {"preprocess_binarize": None, "connected_components": None, "bridge_morphology": None},
    "endpoint": {"preprocess_binarize": None, "connected_components": 2, "bridge_morphology": None,
                 "component_payload_minmax": None},
    "plane": {"preprocess_binarize": None, "connected_components": None, "bridge_morphology": None},
    "xla": dict.fromkeys(KERNELS, 0),
    "large": dict.fromkeys(KERNELS, None),
}
for _path in ("experiment", "preprocess", "stream"):
    PATH_KERNELS[_path] = dict(PATH_KERNELS["main"])
# The variants: the kernel-branch configurations launch all four kernels, the
# XLA-branch ones and the command-line drivers (the default config) none.
PATH_KERNELS["variants"] = dict.fromkeys(KERNELS, None)
PATH_KERNELS["variants_xla"] = dict.fromkeys(KERNELS, 0)
PATH_KERNELS["cli"] = dict.fromkeys(KERNELS, 0)
# The bridge's routes (frontend.bridge_plan): the cluster kernel at the
# 480x640 paths' half-res canvases, the split kernel at the large frames'
# canvases and the full-resolution variants, and each route once in phase 15.
BRIDGE_ROUTES = ("bridge_morphology.cluster", "bridge_morphology.split", "bridge_morphology.global")
for _path in ("main", "endpoint", "plane", "experiment", "preprocess", "stream"):
    PATH_KERNELS[_path]["bridge_morphology.cluster"] = None
PATH_KERNELS["large"]["bridge_morphology.split"] = None
PATH_KERNELS["variants"]["bridge_morphology.split"] = None
PATH_KERNELS["routes"] = dict.fromkeys(BRIDGE_ROUTES, None)
# Rows of the kernels line: the kernels, the bridge's cluster route in its
# own row, then the bridge's other routes.
ROWS = KERNELS + BRIDGE_ROUTES[1:]
# The shape of each bridge route in phase 15.
ROUTE_SHAPES = {"bridge_morphology.cluster": (64, 240, 384), "bridge_morphology.split": (2, 720, 1280),
                "bridge_morphology.global": (2, 2160, 3840)}
# Frames of the variants phase (the fixture's 480x640 record) and of its
# card-versus-CPU checks.
VARIANT_FRAMES, VARIANT_CPU_FRAMES = 16, 2
# The large path: frame sizes past the cluster kernels, frames per batch.
LARGE_SIZES = ((720, 1280), (1080, 1920))
LARGE_BATCH = 2
# The H100 SXM's HBM rate (NVIDIA data sheet) for the kernels' byte bounds.
HBM_BYTES_PER_S = 3.35e12
# Each kernel's design: redesigned for Hopper, or still the first port.
DESIGN = {"preprocess_binarize": "redesigned", "connected_components": "redesigned",
          "bridge_morphology": "redesigned", "component_payload_minmax": "redesigned",
          "bridge_morphology.split": "redesigned", "bridge_morphology.global": "first port"}
# Device kernels one wrapper call may launch at the timed sites (the
# bridge's global route: frontend.bridge_global_launches).
DEVICE_LAUNCHES_MAX = {"preprocess_binarize": 3, "connected_components": 1, "bridge_morphology": 1,
                       "component_payload_minmax": 1, "bridge_morphology.split": 1}
# Angles of the bridge's in-kernel schedule check.
SCHEDULE_ANGLES = 100_000
# Sizes of the experiment, preprocessing and stream paths.
EXPERIMENT_FRAMES = 100
PREPROCESS_BATCH = 16
STREAM_FRAMES, STREAM_CHUNK, STREAM_POOL = 2000, 64, 16


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of fn() by CUDA events, after warm-up."""
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


def bound_ms(nbytes: int) -> float:
    """The least time for moving ``nbytes`` at the H100 SXM's 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_name(e) -> str:
    """A profiler event's kernel name without its arguments and namespace."""
    return e.name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")


def device_launches(fn, attempts: int = 3):
    """(CUDA kernels that one fn() call launches, their summed device ms,
    device ms by kernel name), by torch.profiler; (None, None, None) if no
    session of ``attempts`` records them.  Late in a long process a session
    may record nothing, or lose the first kernels it sees: each session runs
    fn() twice with a spin kernel (``torch.cuda._sleep``) between the two
    and counts the kernels after the spin, the second call's.  Where nothing
    follows the spin but the session holds two identical calls' kernels (the
    spin's place in the trace lost), the second of them counts.  After a
    session that recorded no whole call it waits half a second."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def summary(evs):
        by_name = {}
        for e in evs:
            name = kernel_name(e)
            by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        return len(evs), sum(by_name.values()), by_name

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                         and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()),
                        key=lambda e: e.time_range.start)
        spins = [i for i, e in enumerate(events) if "spin" in e.name.lower()]
        tail = events[spins[-1] + 1:] if spins else []
        if tail:
            return summary(tail)
        calls = [e for e in events if "spin" not in e.name.lower()]
        half = len(calls) // 2
        if calls and len(calls) % 2 == 0 and [e.name for e in calls[:half]] == [e.name for e in calls[half:]]:
            return summary(calls[half:])
        seen.append([kernel_name(e) for e in events])
        time.sleep(0.5)
    print(f"device_launches: no profiler session recorded a whole call; kernels seen per session: {seen}",
          flush=True)
    return None, None, None


def ptxas_report(build_dir) -> list:
    """The ``-Xptxas -v`` lines (registers, stack, spills) of each kernel in
    build.log, one line per kernel."""
    import re

    log = os.path.join(build_dir, "build.log")
    lines = open(log).read().splitlines() if os.path.exists(log) else []
    out, name = [], None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            parts = [name]
        elif name and ("spill" in ln or "registers" in ln):
            parts.append(ln.split(":", 1)[-1].strip() if "registers" in ln else ln.strip())
            if "registers" in ln:
                out.append(" | ".join(parts))
                name = None
    return out


def points_check(grid, i: int, records: list, label: str):
    """View i of a GridPoints against fixture point records: ids identical,
    xy within 0.05 px.  Returns (number of points, max |dxy|)."""
    import numpy as np

    xy = grid.xy[i].cpu().numpy().astype(np.float64)
    idx = grid.idx[i].cpu().numpy()
    valid = grid.valid[i].cpu().numpy()
    if not np.all(np.isfinite(xy)):
        raise AssertionError(f"{label}: non-finite grid coordinates")
    got = {(int(idx[k, 0]), int(idx[k, 1])): xy[k] for k in range(len(valid)) if valid[k]}
    want = {tuple(r["id"]): (r["x"], r["y"]) for r in records}
    if set(got) != set(want):
        raise AssertionError(f"{label} id set differs: +{set(got) - set(want)} -{set(want) - set(got)}")
    max_d = 0.0
    for k, (x, y) in want.items():
        d = max(abs(got[k][0] - x), abs(got[k][1] - y))
        max_d = max(max_d, d)
        if d >= 0.05:
            raise AssertionError(f"{label} point {k}: {got[k]} vs fixture ({x}, {y})")
    return len(got), max_d


def golden_check(res, want: dict, s: int, gauge: bool = False) -> dict:
    """The golden-fixture contract for frame s of a StereoPoseResult.

    ``gauge``: compare the axis direction rescaled to the fixture's norm.
    The fit's objective does not see |direction|, so after 20 float32 LM
    steps its norm is noise-driven (ROADMAP section 3, fit gauge); the raw
    difference is reported beside it."""
    import numpy as np

    out = {"max_dxy": 0.0}
    for view, det in (("view1", res.detect1), ("view2", res.detect2)):
        out[f"n_{view}"], d = points_check(det.grid, s, want[view], view)
        out["max_dxy"] = max(out["max_dxy"], d)
    params = res.fit.params[s].cpu().numpy().astype(np.float64)
    if not np.all(np.isfinite(params)):
        raise AssertionError("non-finite fit params")
    ref = np.asarray(want["fit_params"])
    out["max_dparams_raw"] = float(np.max(np.abs(params - ref)))
    if gauge:
        params[3:] *= np.linalg.norm(ref[3:]) / np.linalg.norm(params[3:])
    dp = float(np.max(np.abs(params - ref)))
    if dp >= 0.05:
        raise AssertionError(f"fit params {params} vs golden {want['fit_params']}")
    dr = abs(float(res.fit.mean_reproj_error[s]) - want["mean_reproj_px"])
    if dr >= 0.01:
        raise AssertionError(f"reprojection {float(res.fit.mean_reproj_error[s])} vs {want['mean_reproj_px']}")
    out["max_dparams"] = dp
    out["d_reproj"] = dr
    out["bridged_components"] = int(res.detect1.bridged_components[s]) + int(
        res.detect2.bridged_components[s]
    )
    return out


def grid_records(det, i: int) -> list:
    """View i of a DetectResult as fixture point records."""
    return [{"id": [int(det.grid.idx[i, k, 0]), int(det.grid.idx[i, k, 1])],
             "x": float(det.grid.xy[i, k, 0]), "y": float(det.grid.xy[i, k, 1])}
            for k in range(det.grid.valid.shape[1]) if bool(det.grid.valid[i, k])]


def plane_check(det, views) -> dict:
    """The plane fixture's contract for a (V,) DetectResult: points as
    ``points_check``, ``ok`` and ``stable`` equal."""
    out = {"max_dxy": 0.0, "points": []}
    for i, want in enumerate(views):
        n, d = points_check(det.grid, i, want["points"], f"plane view {i}")
        out["max_dxy"] = max(out["max_dxy"], d)
        for flag in ("ok", "stable"):
            if bool(getattr(det, flag)[i]) != want[flag]:
                raise AssertionError(f"plane view {i}: {flag} {bool(getattr(det, flag)[i])} vs {want[flag]}")
        out["points"].append(n)
    return out


def run_path(name, frontend, fn):
    """Drive one path with every launch counter reset just before and read
    just after; fail if it skipped a kernel it must launch."""
    import torch

    torch.cuda.synchronize()
    frontend.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    launches = frontend.launch_counts()
    print(f"{name} path launches: {launches}", flush=True)
    for k, want in PATH_KERNELS[name].items():
        if want is None and launches[k] < 1:
            raise AssertionError(f"the {name} path never launched {k}")
        if want is not None and launches[k] != want:
            raise AssertionError(f"the {name} path launched {k} {launches[k]} times, not {want}")
    return res, launches


def bridge_flips(views, cfg) -> tuple:
    """Card vs CPU through ``bridge_stage`` on the same carved masks (the
    card's): the median angles come from float32 atan2/sin/cos, whose last
    bit may differ between the two devices and move a bridge offset.
    Returns (max |d angle| in rad, differing bridged pixels)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.models import detector as det

    with torch.inference_mode():
        roi = det.roi_stage(det.front_stage(det._to_gray(views), cfg), cfg)
        card = det.bridge_stage(roi.mh, roi.mv, roi.circle_radius0, cfg)
        host = det.bridge_stage(roi.mh.cpu(), roi.mv.cpu(), roi.circle_radius0.cpu(), cfg)
    d_ang = float((card.angles.cpu() - host.angles).abs().max())
    flips = int((card.h_exp.cpu() != host.h_exp).sum() + (card.v_exp.cpu() != host.v_exp).sum())
    return d_ang, flips


def stage_split(views, cfgs) -> None:
    """Bridge and grid stage ms of each config on the same front and ROI
    stages (the configs differ only after them)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.models import detector as det

    with torch.inference_mode():
        front = det.front_stage(det._to_gray(views), cfgs[0][1])
        roi = det.roi_stage(front, cfgs[0][1])
        for label, cfg in cfgs:
            def bridge():
                return det.bridge_stage(roi.mh, roi.mv, roi.circle_radius0, cfg)

            br = bridge()
            st = det.GridState(
                cents=front.cents, inside=roi.inside, bbox=roi.bbox, h_exp=br.h_exp,
                v_exp=br.v_exp, circle_radius0=roi.circle_radius0, gray=front.gray, bright_blur=front.bright_blur,
                warm_labels=br.warm_labels, bridge_angles=br.angles, n_pre=br.n_pre,
                binary=front.binary, mh=roi.mh, mv=roi.mv, carve_domain=roi.carve_domain,
            )
            ms_b = cuda_ms(bridge, reps=10, warmup=2)
            ms_g = cuda_ms(lambda: det.grid_stage(st, cfg), reps=10, warmup=2)
            print(f"{label} stages at V={views.shape[0]}: bridge {ms_b:.4f} ms, grid {ms_g:.4f} ms",
                  flush=True)


class Capture:
    """Record the arguments of every kernel-wrapper call the detector makes
    (the wrappers are looked up on the module at call time)."""

    def __init__(self, frontend):
        self.frontend = frontend
        self.calls = {k: [] for k in KERNELS}
        self.saved = {}

    def __enter__(self):
        for name in KERNELS:
            orig = getattr(self.frontend, name)
            self.saved[name] = orig

            def wrapped(*args, _orig=orig, _name=name, **kwargs):
                self.calls[_name].append((args, dict(kwargs)))
                return _orig(*args, **kwargs)

            setattr(self.frontend, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self.saved.items():
            setattr(self.frontend, name, orig)


def line_masks(n, h, w, angles, seed, device):
    """(n, h, w) masks of broken 2-px lines at the given angles (radians)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    out = torch.zeros((n, h, w), dtype=torch.bool)
    for i in range(n):
        a = float(angles[i % len(angles)])
        ca, sa = math.cos(a), math.sin(a)
        for off in range(-w, w, 23):
            d = (xx - w / 2) * sa - (yy - h / 2) * ca - off
            along = (xx - w / 2) * ca + (yy - h / 2) * sa
            gap = (torch.rand(1, generator=g).item() * 200) - 100
            out[i] |= (d.abs() < 1.0) & ((along - gap).abs() > 4)
    ring = torch.zeros((h, w), dtype=torch.bool)
    ring[24:h - 24, 24:w - 24] = True
    return (out & ring).to(device)


def new_report() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "device_ms": 0.0, "sites": [],
            "device_launches": None, "large_sites": [], "variant_sites": [], "route_sites": []}


def bridge_route(frontend, shape, kw):
    """(report row, most device kernels per call) of a bridge call of
    ``shape``: the plan's route picks the row; ``max_dev`` for ``compare``."""
    route = frontend.bridge_plan(*shape).get("route", "cluster")
    if route == "cluster":
        return "bridge_morphology", None
    if route == "global":
        return "bridge_morphology.global", frontend.bridge_global_launches(kw["probe_len"], kw["max_kernel"])
    return "bridge_morphology.split", DEVICE_LAUNCHES_MAX["bridge_morphology.split"]


def compare(report, name, kernel_fn, plain_fn, label, timed, nbytes=0, site=True, max_dev=None,
            into=None):
    """Hold a kernel call to its plain version (``torch.equal``) and add its
    largest error to ``report[name]``.  ``timed``: time both and count the
    kernel's device kernels per call, which must not pass ``max_dev``
    (default ``DEVICE_LAUNCHES_MAX``); ``site``: add the times to the
    kernel's 480x640 main-path sites, or with ``into`` to the site list of
    that name (``large_sites``, ``variant_sites``)."""
    import torch

    out_k = kernel_fn()
    out_p = plain_fn()
    torch.cuda.synchronize()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    err = 0.0
    for a, b in zip(outs_k, outs_p):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name} [{label}]: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not torch.equal(a, b):
            n_bad = int((a != b).sum())
            raise AssertionError(f"{name} [{label}]: kernel != plain on {n_bad} elements")
    rep = report.setdefault(name, new_report())
    rep["max_abs_err"] = max(rep["max_abs_err"], err)
    line = f"kernel {name} [{label}] equal"
    if timed:
        max_dev = DEVICE_LAUNCHES_MAX[name] if max_dev is None else max_dev
        ms_k = cuda_ms(kernel_fn)
        ms_p = cuda_ms(plain_fn, reps=5, warmup=1)
        n_dev, dev_ms, by_name = device_launches(kernel_fn)
        if (n_dev is None and into is None) or (n_dev is not None and n_dev > max_dev):
            raise AssertionError(f"{name} [{label}]: {n_dev} device kernels in a call (at most {max_dev})")
        if site and into is not None:
            rep[into].append({"site": label, "ms": ms_k, "device_ms": dev_ms, "plain_ms": ms_p,
                              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
                              "device_kernels_per_call": n_dev, "device_ms_by_kernel": by_name})
        elif site:
            rep["device_ms"] += dev_ms
            rep["ms"] += ms_k
            rep["plain_ms"] += ms_p
            rep["bytes"] += nbytes
            rep["sites"].append((label, ms_k, ms_p, nbytes, n_dev))
            rep["device_launches"] = max(rep["device_launches"] or 0, n_dev)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        line += (f"; kernel {ms_k:.4f} ms (device {dev_txt}), plain {ms_p:.4f} ms, bound "
                 f"{bound_ms(nbytes):.4f} ms ({nbytes} B), device kernels per call {n_dev}")
        if by_name and len(by_name) > 1:
            line += f", device ms by kernel {({k: round(v, 4) for k, v in by_name.items()})}"
    print(line, flush=True)


def kernel_phase(frontend, calls, device, seed: int = 0) -> dict:
    """Every kernel vs its plain version on the captured production
    intermediates plus seeded random inputs; returns per-kernel reports."""
    import functools

    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import _smooth

    g = torch.Generator(device="cpu").manual_seed(seed)
    report = {}
    compare_ = functools.partial(compare, report)

    # 2.1 preprocess: the B=16 run's smoothed views + smoothed noise images.
    for i, (args, kw) in enumerate(calls["preprocess_binarize"]):
        x = args[0]
        compare_("preprocess_binarize", lambda: frontend.preprocess_binarize(x, **kw),
                lambda: frontend.preprocess_binarize_plain(x, **kw),
                f"captured {tuple(x.shape)}", timed=(i == 0),
                nbytes=frontend.min_bytes("preprocess_binarize", *x.shape))
        noise = torch.rand(x.shape, generator=g).mul(255.0).to(device)
        xs = _smooth(noise, CylinderDetectConfig())
        compare_("preprocess_binarize", lambda: frontend.preprocess_binarize(xs, **kw),
                lambda: frontend.preprocess_binarize_plain(xs, **kw),
                f"random {tuple(xs.shape)}", timed=False)

    # 2.2 connected components: the three call sites + random masks.
    for args, kw in calls["connected_components"]:
        m = args[0]
        init = kw.get("init_labels")
        label = (f"captured {tuple(m.shape)} {kw['rounds']}x{kw['pools_per_round']} "
                 f"{'warm' if init is not None else 'cold'}")
        compare_("connected_components",
                lambda: frontend.connected_components(m, kw["rounds"], kw["pools_per_round"], init),
                lambda: frontend.connected_components_plain(m, kw["rounds"], kw["pools_per_round"], init),
                label, timed=True,
                nbytes=frontend.min_bytes("connected_components", *m.shape, warm=init is not None))
        rnd = (torch.rand(m.shape, generator=g) < 0.45).to(torch.float32).to(device)
        rinit = None
        if init is not None:
            rinit = torch.randint(0, 2 * m.shape[1] * m.shape[2], m.shape, generator=g,
                                  dtype=torch.int32).to(device)
        compare_("connected_components",
                lambda: frontend.connected_components(rnd, kw["rounds"], kw["pools_per_round"], rinit),
                lambda: frontend.connected_components_plain(rnd, kw["rounds"], kw["pools_per_round"], rinit),
                f"random {tuple(m.shape)}", timed=False)

    # 2.4 payload min/max: the endpoint path's call + random masks with
    # random payloads (a permutation of [0, H*W) per image).
    for args, kw in calls["component_payload_minmax"]:
        m, pay = args
        rounds, pools = kw["rounds"], kw["pools_per_round"]
        compare_("component_payload_minmax",
                lambda: frontend.component_payload_minmax(m, pay, rounds, pools),
                lambda: frontend.component_payload_minmax_plain(m, pay, rounds, pools),
                f"captured {tuple(m.shape)} {rounds}x{pools}", timed=True,
                nbytes=frontend.min_bytes("component_payload_minmax", *m.shape))
        n, h, w = m.shape
        rnd = (torch.rand(m.shape, generator=g) < 0.45).to(torch.float32).to(device)
        rpay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(n)])
        rpay = rpay.reshape(n, h, w).to(torch.int32).to(device)
        for r, p in ((rounds, pools), (1, 2), (3, 1)):
            compare_("component_payload_minmax",
                    lambda: frontend.component_payload_minmax(rnd, rpay, r, p),
                    lambda: frontend.component_payload_minmax_plain(rnd, rpay, r, p),
                    f"random {tuple(m.shape)} {r}x{p}", timed=False)

    # 2.3 bridge: the captured call (bool, the detector's interface), the
    # same as float32, line masks at non-axis angles with kernel lengths from
    # 0 past the cap (both types), and the kernel's own schedule against
    # bridge_schedule on the card.
    for args, kw in calls["bridge_morphology"]:
        masks, exps, angles, klen = args
        compare_("bridge_morphology",
                lambda: frontend.bridge_morphology(masks, exps, angles, klen, **kw),
                lambda: frontend.bridge_morphology_plain(masks, exps, angles, klen, **kw),
                f"captured {tuple(masks.shape)} {masks.dtype}", timed=True,
                nbytes=frontend.min_bytes("bridge_morphology", *masks.shape, itemsize=masks.element_size()))
        mf, ef = masks.to(torch.float32), exps.to(torch.float32)
        compare_("bridge_morphology",
                lambda: frontend.bridge_morphology(mf, ef, angles, klen, **kw),
                lambda: frontend.bridge_morphology_plain(mf, ef, angles, klen, **kw),
                f"captured {tuple(mf.shape)} {mf.dtype}", timed=True, site=False,
                nbytes=frontend.min_bytes("bridge_morphology", *mf.shape))
        n, h, w = masks.shape
        ang_list = [0.0, math.pi / 2, 0.35, 1.2, -0.6, 2.5]
        lm = line_masks(n, h, w, ang_list, seed + 1, device)
        ex = (torch.rand(lm.shape, generator=g) < 0.7).to(device)
        ang = torch.tensor([ang_list[i % len(ang_list)] for i in range(n)], dtype=torch.float32,
                           device=device)
        kl = torch.linspace(0.0, 260.0, n, device=device)
        for dtype in (torch.bool, torch.float32):
            lmt, ext = lm.to(dtype), ex.to(dtype)
            compare_("bridge_morphology",
                    lambda: frontend.bridge_morphology(lmt, ext, ang, kl, **kw),
                    lambda: frontend.bridge_morphology_plain(lmt, ext, ang, kl, **kw),
                    f"line masks {tuple(lm.shape)} {dtype}", timed=False)
        schedule_check(frontend, device, g, **kw)
    return report


def schedule_check(frontend, device, g, probe_len, max_kernel) -> None:
    """The bridge kernel's in-kernel schedule (sinf, cosf, rintf) must equal
    ``bridge_schedule`` by torch on the card for SCHEDULE_ANGLES angles and
    a kernel length per mask pair; prints how many masks' schedules differ
    from the CPU's."""
    import torch

    n = SCHEDULE_ANGLES
    ang = (torch.rand(n, generator=g) * 2 - 1) * math.pi
    kl = torch.rand(n // 2, generator=g) * 320.0
    m = torch.zeros((n, 2, 32), dtype=torch.bool, device=device)
    sched = torch.zeros((n, frontend.bridge_schedule_size(probe_len, max_kernel)), dtype=torch.int32,
                        device=device)
    frontend.bridge_morphology(m, m, ang.to(device), kl.to(device), probe_len, max_kernel, schedule_out=sched)

    def flat(ang, kl):
        ray, line = frontend.bridge_schedule(ang, kl, probe_len, max_kernel)
        return torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1)

    card = flat(ang.to(device), kl.to(device))
    bad = int((sched != card).any(1).sum())
    if bad:
        raise AssertionError(f"bridge schedule: {bad} of {n} masks differ from bridge_schedule on the card")
    host = int((sched.cpu() != flat(ang, kl)).any(1).sum())
    print(f"kernel bridge_morphology schedule equal to bridge_schedule on the card for {n} angles; "
          f"{host} of them differ from the CPU's schedule", flush=True)


def load_registration_fixture(device):
    """The registration fixture's inputs as tensors on ``device``:
    (fixture dict, pts3s (F, C, 3), valid (F, C), angles (F, 2),
    frame_valid (F,))."""
    import numpy as np
    import torch

    with open(REGISTRATION) as f:
        fx = json.load(f)
    n, cap = len(fx["n_valid"]), fx["capacity"]
    pts = np.zeros((n, cap, 3), np.float32)
    valid = np.zeros((n, cap), bool)
    for i, (k, flat) in enumerate(zip(fx["n_valid"], fx["pts"])):
        pts[i, :k] = np.asarray(flat, np.float32).reshape(k, 3)
        valid[i, :k] = True
    angles = np.asarray(fx["angles"], np.float32)
    frame_valid = np.asarray(fx["frame_valid"], bool)
    return fx, *(torch.as_tensor(x, device=device) for x in (pts, valid, angles, frame_valid))


def registration_check(got, want: dict, angles, label: str) -> dict:
    """A RegistrationResult against a reference (a dict of floats and the
    4x4 t_cam_agv): predicted axes within 0.05 deg and 0.1 mm perpendicular
    offset, fval (atol 1e-6) and jtj_min_eig within rel 1e-2, well_posed
    equal."""
    import numpy as np

    from cylinder_pose_estimation_tpu_torch.geometry.registration import axis_errors

    t = got.t_cam_agv.detach().cpu().numpy()
    if not np.all(np.isfinite(t)):
        raise AssertionError(f"{label}: non-finite T_Cam_AGV")
    ang, perp = axis_errors(want["t_cam_agv"], t, angles)
    out = {"axis_deg": float(ang.max()), "perp_mm": float(perp.max())}
    for name in ("fval0", "fval", "jtj_min_eig"):
        out[name] = float(getattr(got, name))
        out[f"{name}_rel"] = abs(out[name] - want[name]) / max(abs(want[name]), 1e-12)
    out["well_posed"] = bool(got.well_posed)
    if out["axis_deg"] >= 0.05 or out["perp_mm"] >= 0.1:
        raise AssertionError(f"{label}: axes {out['axis_deg']} deg, perpendicular {out['perp_mm']} mm")
    if abs(out["fval"] - want["fval"]) > 1e-6 + 1e-2 * abs(want["fval"]):
        raise AssertionError(f"{label}: fval {out['fval']} vs {want['fval']}")
    if out["jtj_min_eig_rel"] > 1e-2:
        raise AssertionError(f"{label}: jtj_min_eig {out['jtj_min_eig']} vs {want['jtj_min_eig']}")
    if out["well_posed"] != want["well_posed"]:
        raise AssertionError(f"{label}: well_posed {out['well_posed']} vs {want['well_posed']}")
    return out


def reg_dict(res) -> dict:
    return {"t_cam_agv": res.t_cam_agv.detach().cpu().numpy(), "fval0": float(res.fval0),
            "fval": float(res.fval), "jtj_min_eig": float(res.jtj_min_eig),
            "well_posed": bool(res.well_posed)}


def sync_sites(fn) -> dict:
    """Run fn() once under ``torch.cuda.set_sync_debug_mode("warn")`` and
    count the host synchronisations by the source line that caused them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def registration_phase(device, stereo_fn, cfg, fit_cfg, frontend, smi) -> dict:
    """Phase 8: the registration fixture on the card, then the experiment
    path with its CPU recomputation."""
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.geometry.registration import (
        axis_errors,
        fit_cylinders_with_angles,
    )
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import registration_sequence

    fx, pts, valid, angles, frame_valid = load_registration_fixture(device)
    res = fit_cylinders_with_angles(pts, valid, angles, frame_valid=frame_valid)
    sites = sync_sites(lambda: fit_cylinders_with_angles(pts, valid, angles, frame_valid=frame_valid))
    print(f"registration host syncs per call: {sum(sites.values())} at {sites}", flush=True)
    chk = registration_check(res, fx["result"], fx["angles"], "registration fixture")
    ms_fix = cuda_ms(lambda: fit_cylinders_with_angles(pts, valid, angles, frame_valid=frame_valid),
                     reps=3, warmup=1)
    print(f"registration fixture ({pts.shape[0]} frames x {pts.shape[1]}), card vs JAX: axes "
          f"{chk['axis_deg']:.3e} deg, perp {chk['perp_mm']:.3e} mm, fval {chk['fval']:.6g} "
          f"(rel {chk['fval_rel']:.2e}), fval0 rel {chk['fval0_rel']:.2e}, min_eig "
          f"{chk['jtj_min_eig']:.6g} (rel {chk['jtj_min_eig_rel']:.2e}), well_posed "
          f"{chk['well_posed']}; {ms_fix:.2f} ms", flush=True)

    n_frames = EXPERIMENT_FRAMES
    st_np, ang_np, (i1, i2), t_gt = registration_sequence(n_frames, 480, 640)
    stereo = stereo_fn(st_np)
    a = torch.as_tensor(i1, device=device)
    b = torch.as_tensor(i2, device=device)
    ang = torch.as_tensor(ang_np, device=device)
    (batch, reg), launches = run_path(
        "experiment", frontend, lambda: pipeline.full_experiment(a, b, ang, stereo, cfg, fit_cfg))
    if not all(bool(torch.isfinite(x).all()) for x in (reg.t_cam_agv, reg.fval, reg.fval0)):
        raise AssertionError("experiment: non-finite registration")
    healthy = int(pipeline.frame_health(batch).sum())
    gt_ang, gt_perp = axis_errors(t_gt, reg.t_cam_agv.cpu().numpy(), ang_np)
    print(f"experiment F={n_frames} 480x640: healthy {healthy}/{n_frames}, ok "
          f"{int((batch.detect1.ok & batch.detect2.ok).sum())}, points3 {tuple(batch.fit.points3.shape)}, "
          f"fval0 {float(reg.fval0):.6g}, fval {float(reg.fval):.6g}, min_eig "
          f"{float(reg.jtj_min_eig):.6g}, well_posed {bool(reg.well_posed)}; vs ground truth: axes "
          f"{gt_ang.max():.4f} deg, perp {gt_perp.max():.4f} mm", flush=True)
    t0 = time.perf_counter()
    host = pipeline.register_sequence(pipeline._tree_map(lambda x: x.cpu(), batch), ang.cpu())
    t_cpu = time.perf_counter() - t0
    card = reg_dict(reg)
    print(f"experiment registration recomputed on the CPU ({t_cpu:.1f} s): fval {float(host.fval):.6g}, "
          f"min_eig {float(host.jtj_min_eig):.6g}, well_posed {bool(host.well_posed)} (card: "
          f"{card['jtj_min_eig']:.6g}, {card['well_posed']})", flush=True)
    chk = registration_check(host, card, ang_np, "experiment registration, CPU vs card")
    print(f"experiment registration, CPU vs card: axes {chk['axis_deg']:.3e} deg, perp "
          f"{chk['perp_mm']:.3e} mm, fval rel {chk['fval_rel']:.2e}, min_eig rel "
          f"{chk['jtj_min_eig_rel']:.2e}", flush=True)

    # Timing: detect+fit and the registration, CUDA events.
    rep = itertools.count(1)

    def detect_fit():
        eps = 1e-4 * next(rep)
        return pipeline.estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg)

    ms_df = cuda_ms(detect_fit, reps=3, warmup=1)
    ms_reg = cuda_ms(lambda: pipeline.register_sequence(batch, ang), reps=3, warmup=1)
    print(f"experiment F={n_frames}: detect+fit {ms_df:.2f} ms, registration {ms_reg:.2f} ms, "
          f"total {ms_df + ms_reg:.2f} ms; {smi}", flush=True)
    return launches


def preprocess_phase(device, stereo_fn, cfg, fit_cfg, frontend, smi) -> dict:
    """Phase 9: the preprocessing path at B=16 and its card-vs-CPU checks."""
    import torch

    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
        distorted_example_pair,
        registration_angles,
    )

    n = PREPROCESS_BATCH
    st_np, (i1, i2) = distorted_example_pair(480, 640, n_frames=n)
    stereo = stereo_fn(st_np)
    a = torch.as_tensor(i1, device=device)
    b = torch.as_tensor(i2, device=device)
    ang = torch.as_tensor(registration_angles(n), device=device)
    (batch, reg), launches = run_path(
        "preprocess", frontend,
        lambda: pipeline.full_experiment(a, b, ang, stereo, cfg, fit_cfg, preprocess=True))
    if not bool(torch.isfinite(reg.t_cam_agv).all()):
        raise AssertionError("preprocess path: non-finite registration")
    ok = int((batch.detect1.ok & batch.detect2.ok).sum())
    host_stereo = pipeline._stereo_to(stereo, torch.device("cpu"))
    card = pipeline.preprocess_stereo_batch(a, b, stereo)
    host = pipeline.preprocess_stereo_batch(a.cpu(), b.cpu(), host_stereo)
    d_max, n_over = 0.0, 0
    for c, h in zip(card, host):
        d = (c.cpu() - h).abs()
        d_max = max(d_max, float(d.max()))
        n_over += int((d > 1e-3).sum())
    print(f"preprocess B={n} 480x640, card vs CPU: max |d| {d_max:.3e} grey levels, {n_over} pixels "
          f"over 1e-3; ok frames {ok}/{n}", flush=True)
    if d_max > 1e-2:
        raise AssertionError(f"preprocess card vs CPU: {d_max} grey levels")
    det_card = pipeline.estimate_poses_batch(card[0][:2], card[1][:2], stereo, cfg, fit_cfg)
    det_host = pipeline.estimate_poses_batch(host[0][:2], host[1][:2], host_stereo, cfg, fit_cfg)
    max_d = 0.0
    for dc, dh in ((det_card.detect1, det_host.detect1), (det_card.detect2, det_host.detect2)):
        for i in range(2):
            _, d = points_check(dc.grid, i, grid_records(dh, i), f"preprocessed frame {i}")
            max_d = max(max_d, d)
    print(f"preprocessed detect, 2 frames card vs CPU: ids identical, max |dxy| {max_d:.6f} px",
          flush=True)
    ms = cuda_ms(lambda: pipeline.preprocess_stereo_batch(a, b, stereo), reps=10, warmup=2)
    print(f"preprocess_stereo_batch B={n} 480x640: {ms / n:.4f} ms/frame; {smi}", flush=True)
    return launches


def stream_phase(device, stereo, cfg, fit_cfg, frontend, smi) -> dict:
    """Phase 10: the stream path over 2,000 frames and its chunk-by-chunk
    equality with the batch call."""
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import RegistrationConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import TiledFrames, example_pair

    n, chunk, pool = STREAM_FRAMES, STREAM_CHUNK, STREAM_POOL
    _, (p1, p2) = example_pair(480, 640, n_frames=pool, pans=[i % 13 for i in range(pool)])
    f1 = TiledFrames(np.clip(p1, 0, 255).astype(np.uint8), n)
    f2 = TiledFrames(np.clip(p2, 0, 255).astype(np.uint8), n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out, launches = run_path("stream", frontend, lambda: pipeline.estimate_poses_stream(
        f1, f2, stereo, cfg, fit_cfg, chunk=chunk, compact=True, overlap=True, device=device))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    # The same stream without the overlap: one chunk at a time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = pipeline.estimate_poses_stream(f1, f2, stereo, cfg, fit_cfg, chunk=chunk, compact=True,
                                            overlap=False, device=device)
    wall_serial = time.perf_counter() - t0
    got = pipeline._tree_leaves(out)
    for s in range(0, n, chunk):
        live = min(chunk, n - s)
        idx = np.minimum(np.arange(s, s + chunk), n - 1)
        a = torch.as_tensor(np.stack([f1[i:i + 1][0] for i in idx]), device=device)
        b = torch.as_tensor(np.stack([f2[i:i + 1][0] for i in idx]), device=device)
        want = pipeline._tree_leaves(pipeline._summarize_batch(
            pipeline.estimate_poses_batch(a, b, stereo, cfg, fit_cfg), RegistrationConfig()))
        for leaf, (g, w) in enumerate(zip(got, want)):
            w = w[:live].cpu().numpy()
            if not np.array_equal(g[s:s + live], w, equal_nan=np.issubdtype(w.dtype, np.floating)):
                raise AssertionError(f"stream chunk at {s}: leaf {leaf} differs from the batch call")
    for leaf, (g, w) in enumerate(zip(got, pipeline._tree_leaves(serial))):
        if not np.array_equal(g, w, equal_nan=np.issubdtype(w.dtype, np.floating)):
            raise AssertionError(f"stream: leaf {leaf} differs between overlap and serial")
    ok = int(out.ok.sum())
    reproj = float(np.median(out.mean_reproj_error[out.ok]))
    print(f"stream N={n} chunk={chunk} compact overlap: {n / wall:.2f} frames/s ({wall:.2f} s wall), "
          f"ok {ok}/{n}, healthy {int(out.healthy.sum())}, median reprojection {reproj:.4f} px, peak "
          f"device memory {peak / 2**20:.1f} MiB; every chunk equal to the batch call "
          f"({(n + chunk - 1) // chunk} chunks, tail {n % chunk or chunk} live); {smi}", flush=True)
    print(f"stream N={n} chunk={chunk} compact serial (overlap=False): {n / wall_serial:.2f} frames/s "
          f"({wall_serial:.2f} s wall), equal to the overlapped run", flush=True)
    return launches


def xla_phase(frontend, a, b, stereo, pviews, golden, plane_views, fit_cfg) -> dict:
    """Phase 11: the default configuration (the XLA branch) on the phase-2
    scenes and the phase-4 views, against the XLA records; none of the four
    kernels may launch."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch

    h, w = a.shape[-2:]
    cfg = CylinderDetectConfig(height=h, width=w)
    cfg_plane = PlaneDetectConfig(height=h, width=w, roi_threshold=30.0)
    if cfg.use_pallas or cfg_plane.use_pallas:
        raise AssertionError("the default configuration must be the XLA branch")
    (res, det), launches = run_path("xla", frontend, lambda: (
        estimate_poses_batch(a, b, stereo, cfg, fit_cfg), detect_grid(pviews, cfg_plane)))
    for s, name in enumerate(list(range(6)) + ["gap0"]):
        want = next(g for g in golden if g["scene"] == name)
        chk = golden_check(res, want, s, gauge=True)
        if chk["bridged_components"] != want.get("bridged_components", 0):
            raise AssertionError(f"xla scene {name} bridged {chk['bridged_components']}")
        print(f"xla scene {name}: points {chk['n_view1']}/{chk['n_view2']}, max|dxy| {chk['max_dxy']:.6f} px, "
              f"max|dparams| {chk['max_dparams']:.6f} (raw {chk['max_dparams_raw']:.6f}), "
              f"|dreproj| {chk['d_reproj']:.6f} px, bridged_components {chk['bridged_components']}", flush=True)
    chk = plane_check(det, [dict(v, stable=v["stable_xla"]) for v in plane_views])
    print(f"xla plane views: points {chk['points']}, max|dxy| {chk['max_dxy']:.6f} px, stable "
          f"{det.stable.tolist()} (the XLA record)", flush=True)
    return launches


def large_phase(frontend, device, fit_cfg, smi):
    """Phase 12: the main and endpoint configs at LARGE_SIZES; returns (the
    launches, a kernel report whose ``large_sites`` hold the timed calls)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    def cfg_of(h, w, label):
        return CylinderDetectConfig(height=h, width=w, use_pallas=True,
                                    bridge_endpoint_stats=label == "endpoint")

    inputs = {hw: example_pair(*hw, n_frames=LARGE_BATCH) for hw in LARGE_SIZES}
    calls = {}

    def drive():
        out = {}
        for (h, w), (st_np, (i1, i2)) in inputs.items():
            stereo = stereo_from_numpy(*st_np, device=device)
            a = torch.as_tensor(i1, device=device)
            b = torch.as_tensor(i2, device=device)
            for label in ("main", "endpoint"):
                with Capture(frontend) as cap:
                    out[(h, w, label)] = estimate_poses_batch(a, b, stereo, cfg_of(h, w, label), fit_cfg)
                calls[(h, w, label)] = cap.calls
        return out

    out, launches = run_path("large", frontend, drive)
    for (h, w, label), res in out.items():
        st_np, (i1, i2) = inputs[(h, w)]
        t0 = time.perf_counter()
        host = estimate_poses_batch(torch.as_tensor(i1), torch.as_tensor(i2),
                                    stereo_from_numpy(*st_np, device="cpu"), cfg_of(h, w, label), fit_cfg)
        t_cpu = time.perf_counter() - t0
        max_d, pts = 0.0, []
        for dc, dh in ((res.detect1, host.detect1), (res.detect2, host.detect2)):
            for i in range(LARGE_BATCH):
                n, d = points_check(dc.grid, i, grid_records(dh, i), f"{h}x{w} {label} frame {i}")
                pts.append(n)
                max_d = max(max_d, d)
                for flag in ("ok", "stable"):
                    if bool(getattr(dc, flag)[i]) != bool(getattr(dh, flag)[i]):
                        raise AssertionError(f"{h}x{w} {label} frame {i}: {flag} differs card vs CPU")
        print(f"large {h}x{w} {label}, card vs CPU ({t_cpu:.1f} s on the CPU): ids identical, points {pts}, "
              f"max |dxy| {max_d:.6f} px, ok {res.detect1.ok.tolist()}/{res.detect2.ok.tolist()}, stable "
              f"{res.detect1.stable.tolist()}/{res.detect2.stable.tolist()}", flush=True)

    report = {}
    with torch.inference_mode():
        for (h, w, label), cap in calls.items():
            timed = label == "main"
            tag = f"{h}x{w} {label}"
            for args, kw in cap["preprocess_binarize"]:
                x = args[0]
                compare(report, "preprocess_binarize", lambda: frontend.preprocess_binarize(x, **kw),
                        lambda: frontend.preprocess_binarize_plain(x, **kw), f"{tag} {tuple(x.shape)}", timed,
                        nbytes=frontend.min_bytes("preprocess_binarize", *x.shape), into="large_sites")
            for args, kw in cap["connected_components"]:
                m, init = args[0], kw.get("init_labels")
                r, p = kw["rounds"], kw["pools_per_round"]
                plan = frontend.cc_plan(*m.shape, pools_per_round=p)
                glob = plan.get("route") == "global"
                compare(report, "connected_components",
                        lambda: frontend.connected_components(m, r, p, init),
                        lambda: frontend.connected_components_plain(m, r, p, init),
                        f"{tag} {tuple(m.shape)} {r}x{p} {'warm' if init is not None else 'cold'}"
                        f"{' global' if glob else ''}", timed,
                        nbytes=frontend.min_bytes("connected_components", *m.shape, warm=init is not None),
                        max_dev=frontend.cc_global_launches(r, p, plan["fused"]) if glob else None,
                        into="large_sites")
            for args, kw in cap["component_payload_minmax"]:
                m, pay = args
                r, p = kw["rounds"], kw["pools_per_round"]
                plan = frontend.cc_plan(*m.shape, channels=2, pools_per_round=p)
                glob = plan.get("route") == "global"
                compare(report, "component_payload_minmax",
                        lambda: frontend.component_payload_minmax(m, pay, r, p),
                        lambda: frontend.component_payload_minmax_plain(m, pay, r, p),
                        f"{tag} {tuple(m.shape)} {r}x{p}{' global' if glob else ''}", True,
                        nbytes=frontend.min_bytes("component_payload_minmax", *m.shape),
                        max_dev=frontend.cc_global_launches(r, p, plan["fused"]) if glob else None,
                        into="large_sites")
            for args, kw in cap["bridge_morphology"]:
                masks, exps, angles, klen = args
                row, max_dev = bridge_route(frontend, masks.shape, kw)
                for mk, ek, site in ((masks, exps, True), (masks.float(), exps.float(), False)):
                    compare(report, row,
                            lambda: frontend.bridge_morphology(mk, ek, angles, klen, **kw),
                            lambda: frontend.bridge_morphology_plain(mk, ek, angles, klen, **kw),
                            f"{tag} {tuple(mk.shape)} {mk.dtype} {row}", timed and site,
                            nbytes=frontend.min_bytes("bridge_morphology", *mk.shape, itemsize=mk.element_size()),
                            max_dev=max_dev, into="large_sites")

    rep = itertools.count(1)
    for (h, w), (st_np, (i1, i2)) in inputs.items():
        stereo = stereo_from_numpy(*st_np, device=device)
        a = torch.as_tensor(i1, device=device)
        b = torch.as_tensor(i2, device=device)
        for label in ("main", "endpoint"):
            cfg = cfg_of(h, w, label)

            def e2e():
                eps = 1e-4 * next(rep)
                return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg).fit.params

            def detect():
                eps = 1e-4 * next(rep)
                return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg, probe="detect").grid.xy

            ms_e2e = cuda_ms(e2e, reps=5, warmup=1)
            ms_det = cuda_ms(detect, reps=5, warmup=1)
            print(f"large {label} B={LARGE_BATCH} {h}x{w}: {ms_e2e / LARGE_BATCH:.4f} ms/frame (detect "
                  f"{ms_det / LARGE_BATCH:.4f} ms/frame); {smi}", flush=True)
    return launches, report


def variants_phase(frontend, device, fit_cfg, smi):
    """Phase 13: the full-resolution variants and sub-pixel refinement at
    480x640 (``torch_variant_scenes.json``'s configurations: B=16 frames of
    ``example_pair``, or the plane fixture's eight views), the kernel-branch
    and the XLA-branch configurations each as a path, counters reset just
    before and read just after.  Every view is held to the JAX record (ids
    identical, xy within 0.05 px); the first VARIANT_CPU_FRAMES frames are
    held card against the CPU port (ids, xy within 0.05 px, ``ok`` and
    ``stable``); every kernel call at a full-resolution shape is held
    ``torch.equal`` to its plain version, the first of each site timed.
    Returns (launches by path, kernel report with ``variant_sites``)."""
    import contextlib

    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import _tree_map, estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair, plane_view

    h, w = 480, 640
    with open(VARIANTS) as f:
        configs = json.load(f)["records"][f"{h}x{w}"]["configs"]
    with open(PLANE) as f:
        pspecs = [v["spec"] for v in json.load(f)["views"]]
    st_np, (i1, i2) = example_pair(h, w, n_frames=VARIANT_FRAMES)
    stereo = stereo_from_numpy(*st_np, device=device)
    host_stereo = stereo_from_numpy(*st_np, device="cpu")
    a = torch.as_tensor(i1, device=device)
    b = torch.as_tensor(i2, device=device)
    planes = np.stack([plane_view(h, w, **sp) for sp in pspecs])
    pviews = torch.as_tensor(planes, device=device)

    def cfg_of(c):
        cls = PlaneDetectConfig if c["mode"] == "plane" else CylinderDetectConfig
        return cls(height=h, width=w, use_pallas=c["use_pallas"], **c["overrides"])

    def run(c, imgs=None):
        """The configuration's entry point: detect_grid on the plane views,
        estimate_poses_batch on the frames; returns the (V,) DetectResult."""
        cfg = cfg_of(c)
        if c["mode"] == "plane":
            return detect_grid(pviews if imgs is None else imgs, cfg)
        x, y, st = (a, b, stereo) if imgs is None else imgs
        res = estimate_poses_batch(x, y, st, cfg, fit_cfg)
        if not bool(torch.isfinite(res.fit.params).all()):
            raise AssertionError(f"variant {c['name']}: non-finite fit")
        return _tree_map(lambda p, q: torch.cat([p, q]), res.detect1, res.detect2)

    calls, results = {}, {}

    def drive(group, capture):
        for c in group:
            with Capture(frontend) if capture else contextlib.nullcontext() as cap:
                results[c["name"]] = run(c)
            if capture:
                calls[c["name"]] = cap.calls
        return results

    kern = [c for c in configs if c["use_pallas"]]
    xla = [c for c in configs if not c["use_pallas"]]
    _, launches = run_path("variants", frontend, lambda: drive(kern, True))
    _, launches_xla = run_path("variants_xla", frontend, lambda: drive(xla, False))

    for c in configs:
        det = results[c["name"]]
        max_d, n_ok, n_stable, n_bridged = 0.0, 0, 0, 0
        for i, want in enumerate(c["views"]):
            _, d = points_check(det.grid, i, want["points"], f"variant {c['name']} view {i}")
            max_d = max(max_d, d)
            n_ok += bool(det.ok[i]) == want["ok"]
            n_stable += bool(det.stable[i]) == want["stable"]
            n_bridged += int(det.bridged_components[i]) == want["bridged_components"]
        n = len(c["views"])
        # Card vs CPU on the first frames (both views of each).
        k = VARIANT_CPU_FRAMES
        t0 = time.perf_counter()
        if c["mode"] == "plane":
            host = run(c, torch.as_tensor(planes[:k]))
            pairs = [(i, i) for i in range(k)]
        else:
            host = run(c, (torch.as_tensor(i1[:k]), torch.as_tensor(i2[:k]), host_stereo))
            pairs = [(i, i) for i in range(k)] + [(VARIANT_FRAMES + i, k + i) for i in range(k)]
        t_cpu = time.perf_counter() - t0
        max_dc = 0.0
        for ic, ih in pairs:
            _, d = points_check(det.grid, ic, grid_records(host, ih), f"variant {c['name']} view {ic} vs CPU")
            max_dc = max(max_dc, d)
            for flag in ("ok", "stable"):
                if bool(getattr(det, flag)[ic]) != bool(getattr(host, flag)[ih]):
                    raise AssertionError(f"variant {c['name']} view {ic}: {flag} differs card vs CPU")
        print(f"variant {c['name']} ({c['mode']}, {n} views): ids identical to the JAX record, max |dxy| "
              f"{max_d:.6f} px; ok {n_ok}/{n}, stable {n_stable}/{n}, bridged {n_bridged}/{n} as recorded; "
              f"card vs CPU ({len(pairs)} views, {t_cpu:.1f} s on the CPU): ids identical, max |dxy| "
              f"{max_dc:.6f} px", flush=True)

    # Kernel calls at full-resolution shapes (the new sites) against plain.
    report, timed_sites = {}, set()
    with torch.inference_mode():
        for name, cap in calls.items():
            for kname in ("connected_components", "component_payload_minmax", "bridge_morphology"):
                for args, kw in cap[kname]:
                    m = args[0]
                    if tuple(m.shape[-2:]) != (h, w):
                        continue
                    row = kname
                    if kname == "bridge_morphology":
                        masks, exps, angles, klen = args
                        key = (kname, tuple(masks.shape), kw["probe_len"], kw["max_kernel"])
                        row, max_dev = bridge_route(frontend, masks.shape, kw)
                        label = (f"{name} {tuple(masks.shape)} probe {kw['probe_len']} max_kernel "
                                 f"{kw['max_kernel']} {row}")
                        kfn = functools.partial(frontend.bridge_morphology, masks, exps, angles, klen, **kw)
                        pfn = functools.partial(frontend.bridge_morphology_plain, masks, exps, angles, klen,
                                                **kw)
                        nbytes = frontend.min_bytes(kname, *masks.shape, itemsize=masks.element_size())
                    else:
                        r, p = kw["rounds"], kw["pools_per_round"]
                        if kname == "connected_components":
                            init = kw.get("init_labels")
                            key = (kname, tuple(m.shape), r, p, init is not None)
                            plan = frontend.cc_plan(*m.shape, pools_per_round=p)
                            label = f"{name} {tuple(m.shape)} {r}x{p} {'warm' if init is not None else 'cold'}"
                            kfn = functools.partial(frontend.connected_components, m, r, p, init)
                            pfn = functools.partial(frontend.connected_components_plain, m, r, p, init)
                            nbytes = frontend.min_bytes(kname, *m.shape, warm=init is not None)
                        else:
                            pay = args[1]
                            key = (kname, tuple(m.shape), r, p)
                            plan = frontend.cc_plan(*m.shape, channels=2, pools_per_round=p)
                            label = f"{name} {tuple(m.shape)} {r}x{p}"
                            kfn = functools.partial(frontend.component_payload_minmax, m, pay, r, p)
                            pfn = functools.partial(frontend.component_payload_minmax_plain, m, pay, r, p)
                            nbytes = frontend.min_bytes(kname, *m.shape)
                        glob = plan.get("route") == "global"
                        max_dev = frontend.cc_global_launches(r, p, plan["fused"]) if glob else None
                        label += " global" if glob else ""
                    timed = key not in timed_sites
                    timed_sites.add(key)
                    compare(report, row, kfn, pfn, label, timed, nbytes=nbytes, max_dev=max_dev,
                            into="variant_sites")

    rep = itertools.count(1)
    for c in configs:
        cfg = cfg_of(c)
        if c["mode"] == "plane":
            ms = cuda_ms(lambda: detect_grid(pviews + 1e-4 * next(rep), cfg).grid.xy, reps=5, warmup=1)
            print(f"variant {c['name']} V={len(pspecs)} {h}x{w}: detect {ms / len(pspecs):.4f} ms/view; {smi}",
                  flush=True)
            continue

        def e2e():
            eps = 1e-4 * next(rep)
            return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg).fit.params

        def detect():
            eps = 1e-4 * next(rep)
            return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg, probe="detect").grid.xy

        ms_e2e = cuda_ms(e2e, reps=5, warmup=1)
        ms_det = cuda_ms(detect, reps=5, warmup=1)
        print(f"variant {c['name']} B={VARIANT_FRAMES} {h}x{w}: {ms_e2e / VARIANT_FRAMES:.4f} ms/frame "
              f"(detect {ms_det / VARIANT_FRAMES:.4f} ms/frame); {smi}", flush=True)
    return {"variants": launches, "variants_xla": launches_xla}, report


def routes_phase(frontend, device):
    """Phase 15: ``bridge_morphology`` at ROUTE_SHAPES, one call per route
    of ``bridge_plan``, counters reset just before and read just after; then
    each call held to plain (``torch.equal``) and timed, its schedule to
    ``bridge_schedule``.  Returns (the launches, a report whose
    ``route_sites`` hold the calls)."""
    import torch

    kw = {"probe_len": 9, "max_kernel": 251}
    angs = torch.tensor([math.pi / 2, 1.45, 0.35, -0.6, 2.5, 0.0], device=device)
    inputs = {}
    for row, (n, h, w) in ROUTE_SHAPES.items():
        # Broken 2-px lines every 23 px at near-vertical and other angles,
        # pixels on every border, made on the card.
        a = angs[torch.arange(n, device=device) % len(angs)][:, None, None]
        yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None] - h / 2
        xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :] - w / 2
        d = xx * torch.sin(a) - yy * torch.cos(a)
        along = xx * torch.cos(a) + yy * torch.sin(a)
        m = ((torch.remainder(d, 23.0) - 11.5).abs() < 1.0) & ((torch.remainder(along, 41.0) - 20.5).abs() > 4)
        m[:, 0, ::3] = True
        m[:, -1, 1::4] = True
        m[:, ::5, 0] = True
        m[:, 2::3, -1] = True
        ex = torch.remainder(xx * 7 + yy * 13, 10.0).expand(n, h, w) < 8
        inputs[row] = (m, ex, angs[torch.arange(n, device=device) % len(angs)],
                       torch.linspace(20.0, 300.0, n, device=device))

    def drive():
        return {row: frontend.bridge_morphology(*args, **kw) for row, args in inputs.items()}

    _, launches = run_path("routes", frontend, drive)
    report = {}
    with torch.inference_mode():
        for want, (m, ex, ang, kl) in inputs.items():
            n = m.shape[0]
            row, max_dev = bridge_route(frontend, m.shape, kw)
            if (row if row != "bridge_morphology" else "bridge_morphology.cluster") != want:
                raise AssertionError(f"bridge {tuple(m.shape)}: plan route {row}, not {want}")
            sched = torch.zeros((n, frontend.bridge_schedule_size(**kw)), dtype=torch.int32, device=device)
            compare(report, row, lambda: frontend.bridge_morphology(m, ex, ang, kl, schedule_out=sched, **kw),
                    lambda: frontend.bridge_morphology_plain(m, ex, ang, kl, **kw),
                    f"routes {tuple(m.shape)} {m.dtype} probe 9 max_kernel 251 {want}", True,
                    nbytes=frontend.min_bytes("bridge_morphology", *m.shape, itemsize=1), max_dev=max_dev,
                    into="route_sites")
            ray, line = frontend.bridge_schedule(ang, kl, **kw)
            if not torch.equal(sched, torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1)):
                raise AssertionError(f"bridge {want} {tuple(m.shape)}: schedule differs from bridge_schedule")
            print(f"bridge {want} {tuple(m.shape)}: schedule equal to bridge_schedule", flush=True)
    return launches, report


_FLOAT = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"


def parse_experiment(text: str) -> dict:
    """The printed output of ``cylpose-torch experiment``: per-frame
    errors, the registration's fvals, healthy frames, observability and
    T_Cam_AGV."""
    import re

    import numpy as np

    frames = re.findall(rf"average error = ({_FLOAT}) -> ({_FLOAT}) mm", text)
    fval0, fval = re.search(rf"registration fval: ({_FLOAT}) -> ({_FLOAT})", text).groups()
    obs = re.search(rf"registration: (\d+) of \d+ frames healthy, min eigenvalue ({_FLOAT}), "
                    r"well posed (True|False)", text)
    t = [float(v) for v in re.findall(_FLOAT, text.split("T_Cam_AGV =")[1])[:16]]
    return {"frames": [(float(x), float(y)) for x, y in frames], "fval0": float(fval0), "fval": float(fval),
            "healthy": int(obs.group(1)), "jtj_min_eig": float(obs.group(2)),
            "well_posed": obs.group(3) == "True", "t_cam_agv": np.asarray(t).reshape(4, 4)}


def cli_phase(frontend, smi) -> dict:
    """Phase 14: the ``cylpose-torch`` drivers on the card
    (``cli.main([..., "--device", "cuda"])``) over PNG frames of
    ``write_registration_folder`` in a temporary directory, counters reset
    just before and read just after (the drivers' default config launches
    none of the four kernels); ``detect-folder`` and ``experiment`` held to
    ``torch_cli.json`` (the JAX CLI on the same files: ids identical, xy
    within 0.05 px, no image in error; T_Cam_AGV within 0.05 deg and 0.1 mm,
    fval rel 1e-2, healthy frames and well_posed equal), ``undistort-folder``
    within one grey level of the port on the CPU."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from cylinder_pose_estimation_tpu_torch import cli
    from cylinder_pose_estimation_tpu_torch.geometry.registration import axis_errors
    from cylinder_pose_estimation_tpu_torch.utils import png
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import write_registration_folder

    h, w = 480, 640
    with open(CLI_RECORD) as f:
        rec = json.load(f)["records"][f"{h}x{w}"]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        if write_registration_folder(src, rec["frames"], h, w) != rec["names"]:
            raise AssertionError("the CLI frames' names differ from the record")
        cam = os.path.join(src, "cameras.json")
        wall = {}

        def run(cmd, *argv, device="cuda"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main([cmd, "--camera-json", cam, "--input", src, *argv, "--device", device])
            wall[f"{cmd} {device}"] = time.perf_counter() - t0
            return buf.getvalue()

        def drive():
            return {
                "detect": run("detect-folder", "--output", os.path.join(tmp, "detect")),
                "experiment": run("experiment", *rec["experiment_args"]),
                "undistort": run("undistort-folder", "--output", os.path.join(tmp, "und")),
            }

        out, launches = run_path("cli", frontend, drive)
        with open(os.path.join(tmp, "detect", "processed_images_data.json")) as f:
            data = json.load(f)
        errors = {k: v["error"] for k, v in data.items() if "error" in v}
        if errors:
            raise AssertionError(f"detect-folder recorded errors: {errors}")
        if set(data) != set(rec["detect_folder"]):
            raise AssertionError(f"detect-folder files {sorted(data)} vs {sorted(rec['detect_folder'])}")
        max_d, n_pts = 0.0, 0
        for name, want in rec["detect_folder"].items():
            got = {p["id"]: (p["x"], p["y"]) for p in data[name]["points"]}
            ref = {p["id"]: (p["x"], p["y"]) for p in want["points"]}
            if set(got) != set(ref):
                raise AssertionError(f"detect-folder {name}: ids {sorted(got)} vs {sorted(ref)}")
            for k, (x, y) in ref.items():
                max_d = max(max_d, abs(got[k][0] - x), abs(got[k][1] - y))
            n_pts += len(ref)
            if not os.path.exists(os.path.join(tmp, "detect", os.path.splitext(name)[0] + "_arc.png")):
                raise AssertionError(f"detect-folder wrote no overlay for {name}")
        if max_d >= 0.05:
            raise AssertionError(f"detect-folder: max |dxy| {max_d} px against the JAX CLI")
        print(f"cli detect-folder ({len(data)} images, {wall['detect-folder cuda']:.1f} s): ids identical to "
              f"the JAX CLI, {n_pts} points, max |dxy| {max_d:.6f} px", flush=True)

        got = parse_experiment(out["experiment"])
        want = rec["experiment"]
        ang, perp = axis_errors(np.asarray(want["t_cam_agv"]), got["t_cam_agv"],
                                np.radians(np.asarray(rec["angles_deg"], np.float64)))
        fval_rel = abs(got["fval"] - want["fval"]) / abs(want["fval"])
        if ang.max() >= 0.05 or perp.max() >= 0.1 or fval_rel > 1e-2:
            raise AssertionError(f"experiment: axes {ang.max()} deg, perp {perp.max()} mm, fval rel {fval_rel}")
        if (got["healthy"], got["well_posed"]) != (want["healthy"], want["well_posed"]):
            raise AssertionError(f"experiment: healthy {got['healthy']}, well_posed {got['well_posed']} vs "
                                 f"{want['healthy']}, {want['well_posed']}")
        print(f"cli experiment {' '.join(rec['experiment_args'])} ({rec['frames']} frames, "
              f"{wall['experiment cuda']:.1f} s): vs the JAX CLI axes {ang.max():.3e} deg, perp {perp.max():.3e} "
              f"mm, fval {got['fval']:.6g} (rel {fval_rel:.2e}), healthy {got['healthy']}, min_eig "
              f"{got['jtj_min_eig']:.6g}, well_posed {got['well_posed']}", flush=True)

        run("undistort-folder", "--output", os.path.join(tmp, "und_cpu"), device="cpu")
        names = sorted(os.listdir(os.path.join(tmp, "und_cpu")))
        if sorted(os.listdir(os.path.join(tmp, "und"))) != names or len(names) != 2 * rec["frames"]:
            raise AssertionError("undistort-folder wrote other files on the card than on the CPU")
        max_g, n_diff = 0, 0
        for name in names:
            card = png.read_png(os.path.join(tmp, "und", name)).astype(np.int64)
            host = png.read_png(os.path.join(tmp, "und_cpu", name)).astype(np.int64)
            max_g = max(max_g, int(np.abs(card - host).max()))
            n_diff += int((card != host).sum())
        if max_g > 1:
            raise AssertionError(f"undistort-folder card vs CPU: {max_g} grey levels")
        print(f"cli undistort-folder ({len(names)} images, {wall['undistort-folder cuda']:.1f} s): card vs CPU "
              f"max {max_g} grey level, {n_diff} pixels differ; {smi}", flush=True)
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from cylinder_pose_estimation_tpu_torch.config import (
        CylinderDetectConfig,
        FitConfig,
        PlaneDetectConfig,
    )
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.ops import frontend, kernels
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
        apply_gap,
        example_pair,
        plane_view,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    kernels.build()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({kernels.BUILD_DIR})", flush=True)
    for ln in ptxas_report(kernels.BUILD_DIR):
        print(f"ptxas: {ln}", flush=True)

    height, width, batch = 480, 640, 16
    stereo_np, (i1, i2) = example_pair(height, width, n_frames=batch)
    stereo = stereo_from_numpy(*stereo_np, device=device)
    cfg = CylinderDetectConfig(height=height, width=width, use_pallas=True)
    cfg_ep = CylinderDetectConfig(height=height, width=width, use_pallas=True,
                                  bridge_endpoint_stats=True)
    cfg_plane = PlaneDetectConfig(height=height, width=width, use_pallas=True, roi_threshold=30.0)
    fit_cfg = FitConfig()
    print(f"plan preprocess_binarize (2B, {height}, {width}): "
          f"{frontend.preprocess_plan(2 * batch, height, width, joint_peak_iters=cfg.joint_peak_iters)}",
          flush=True)
    for shape in ((2 * 2 * batch, 128, 256), (2 * 2 * batch, 240, 384)):
        print(f"plan connected_components {shape}: {frontend.cc_plan(*shape)}", flush=True)
    print(f"plan component_payload_minmax (4B, 240, 384): {frontend.cc_plan(4 * batch, 240, 384, channels=2)}",
          flush=True)
    print(f"plan bridge_morphology (4B, 240, 384): {frontend.bridge_plan(4 * batch, 240, 384)}", flush=True)
    for shape in ((4 * batch, 480, 640), (batch, 480, 640), (4 * LARGE_BATCH, 360, 640),
                  (4 * LARGE_BATCH, 544, 1024), *ROUTE_SHAPES.values()):
        print(f"plan bridge_morphology {shape}: {frontend.bridge_plan(*shape)}", flush=True)
    for shape, ch, pools in (((4 * batch, 480, 640), 1, 2), ((4 * batch, 480, 640), 2, 4),
                             ((4 * LARGE_BATCH, 360, 640), 1, 2), ((4 * LARGE_BATCH, 544, 1024), 2, 4)):
        print(f"plan global route {shape} channels {ch} pools {pools}: "
              f"{frontend.cc_plan(*shape, channels=ch, pools_per_round=pools)}", flush=True)
    with open(GOLDEN) as f:
        golden = json.load(f)["scenes"]
    with open(ENDPOINT) as f:
        endpoint_fix = json.load(f)["scenes"]
    with open(PLANE) as f:
        plane_views = json.load(f)["views"]

    # --- main path: the golden scenes, counters reset just before ---------
    names = list(range(6)) + ["gap0_pallas"]
    a = np.concatenate([i1[:6], apply_gap(i1[0])[None]])
    b = np.concatenate([i2[:6], apply_gap(i2[0])[None]])
    a = torch.as_tensor(a, device=device)
    b = torch.as_tensor(b, device=device)
    res, main_launches = run_path("main", frontend,
                                  lambda: estimate_poses_batch(a, b, stereo, cfg, fit_cfg))
    for s, name in enumerate(names):
        want = next(g for g in golden if g["scene"] == name)
        chk = golden_check(res, want, s)
        if name == "gap0_pallas" and chk["bridged_components"] != want["bridged_components"]:
            raise AssertionError(f"gap scene bridged {chk['bridged_components']} vs {want['bridged_components']}")
        print(f"scene {name}: points {chk['n_view1']}/{chk['n_view2']}, max|dxy| {chk['max_dxy']:.6f} px, "
              f"max|dparams| {chk['max_dparams']:.6f}, |dreproj| {chk['d_reproj']:.6f} px, "
              f"bridged_components {chk['bridged_components']}", flush=True)

    # --- endpoint path: the same scenes, counters reset just before -------
    res, ep_launches = run_path("endpoint", frontend,
                                lambda: estimate_poses_batch(a, b, stereo, cfg_ep, fit_cfg))
    for s, name in enumerate(names):
        want = next(g for g in endpoint_fix if g["scene"] == name)
        chk = golden_check(res, want, s, gauge=True)
        if chk["bridged_components"] != want["bridged_components"]:
            raise AssertionError(f"endpoint scene {name} bridged {chk['bridged_components']} "
                                 f"vs {want['bridged_components']}")
        print(f"endpoint scene {name}: points {chk['n_view1']}/{chk['n_view2']}, "
              f"max|dxy| {chk['max_dxy']:.6f} px, max|dparams| {chk['max_dparams']:.6f} "
              f"(direction at the fixture's norm; raw {chk['max_dparams_raw']:.6f}), "
              f"|dreproj| {chk['d_reproj']:.6f} px, bridged_components {chk['bridged_components']}",
              flush=True)

    # --- plane path: the fixture's views, counters reset just before ------
    pviews = torch.as_tensor(np.stack([plane_view(height, width, **v["spec"]) for v in plane_views]),
                             device=device)
    det, plane_launches = run_path("plane", frontend, lambda: detect_grid(pviews, cfg_plane))
    chk = plane_check(det, plane_views)
    print(f"plane views: points {chk['points']}, max|dxy| {chk['max_dxy']:.6f} px", flush=True)

    # --- the XLA branch (the default config): no kernel may launch -------
    xla_launches = xla_phase(frontend, a, b, stereo, pviews, golden, plane_views, fit_cfg)

    # --- the experiment, preprocessing and stream paths ---------------------
    def stereo_fn(st):
        return stereo_from_numpy(*st, device=device)

    exp_launches = registration_phase(device, stereo_fn, cfg, fit_cfg, frontend, smi)
    pre_launches = preprocess_phase(device, stereo_fn, cfg, fit_cfg, frontend, smi)
    stream_launches = stream_phase(device, stereo, cfg, fit_cfg, frontend, smi)

    # --- numerics: the bridge on the card vs on the CPU --------------------
    for label, views, c in (("main", torch.cat([a, b]), cfg), ("endpoint", torch.cat([a, b]), cfg_ep),
                            ("plane", pviews, cfg_plane)):
        d_ang, flips = bridge_flips(views, c)
        print(f"{label} bridge, card vs CPU on the same carved masks ({views.shape[0]} views): "
              f"max |d angle| {d_ang:.3e} rad, {flips} differing bridged pixels", flush=True)

    # --- kernels vs plain on the B=16 intermediates -----------------------
    d1 = torch.as_tensor(i1, device=device)
    d2 = torch.as_tensor(i2, device=device)
    with Capture(frontend) as cap:
        estimate_poses_batch(d1, d2, stereo, cfg, fit_cfg)
    with Capture(frontend) as cap_ep:
        estimate_poses_batch(d1, d2, stereo, cfg_ep, fit_cfg)
    cap.calls["component_payload_minmax"] = cap_ep.calls["component_payload_minmax"]
    with torch.inference_mode():
        report = kernel_phase(frontend, cap.calls, device)

    # --- large frames: the CC family's global route, the bridge's split ---
    # (after the kernel phase: torch.profiler read no device activity in its
    # first session when the registration and stream phases ran between two
    # of its uses)
    large_launches, large_report = large_phase(frontend, device, fit_cfg, smi)

    # --- the full-resolution variants and refinement (profiled as well) ---
    variant_launches, variant_report = variants_phase(frontend, device, fit_cfg, smi)

    # --- each route of the bridge once (profiled as well) -----------------
    route_launches, route_report = routes_phase(frontend, device)

    # --- end to end timing at B=16 ----------------------------------------
    # Every call perturbs the frames anew, as bench.py does.
    rep = itertools.count(1)

    def e2e():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg, fit_cfg).fit.params

    def detect():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg, fit_cfg, probe="detect").grid.xy

    def e2e_ep():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg_ep, fit_cfg).fit.params

    def detect_ep():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg_ep, fit_cfg, probe="detect").grid.xy

    def detect_plane():
        eps = 1e-4 * next(rep)
        return detect_grid(pviews + eps, cfg_plane).grid.xy

    cfg_xla = CylinderDetectConfig(height=height, width=width)

    def e2e_xla():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg_xla, fit_cfg).fit.params

    def detect_xla():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg_xla, fit_cfg, probe="detect").grid.xy

    for label, fn_e2e, fn_det in (("e2e", e2e, detect), ("endpoint e2e", e2e_ep, detect_ep),
                                  ("xla e2e", e2e_xla, detect_xla)):
        ms_e2e = cuda_ms(fn_e2e, reps=10, warmup=2)
        ms_det = cuda_ms(fn_det, reps=10, warmup=2)
        n_dev, dev_ms, _ = device_launches(fn_det)
        dev_txt = "not measured" if n_dev is None else f"{n_dev} device kernels, {dev_ms:.4f} device ms"
        print(f"{label} B={batch} {height}x{width}: {ms_e2e / batch:.4f} ms/frame "
              f"(detect {ms_det / batch:.4f} ms/frame, fit {(ms_e2e - ms_det) / batch:.4f} ms/frame); "
              f"detect step: {dev_txt}; {smi}", flush=True)
    stage_split(torch.cat([d1, d2]), (("main", cfg), ("endpoint", cfg_ep)))
    n_views = pviews.shape[0]
    ms_plane = cuda_ms(detect_plane, reps=10, warmup=2)
    print(f"plane detect V={n_views} {height}x{width}: {ms_plane / n_views:.4f} ms/view; {smi}",
          flush=True)

    # --- the command-line drivers on the card ------------------------------
    cli_launches = cli_phase(frontend, smi)

    # Launches per kernel: summed over the six path runs (each counted
    # from zero), with the split by path beside it.
    by_path = {"main": main_launches, "endpoint": ep_launches, "plane": plane_launches,
               "experiment": exp_launches, "preprocess": pre_launches, "stream": stream_launches,
               "xla": xla_launches, "large": large_launches, **variant_launches, "cli": cli_launches,
               "routes": route_launches}
    rows = []
    for k in ROWS:
        r = report.get(k, new_report())
        large = large_report.get(k, new_report())
        variant = variant_report.get(k, new_report())
        route = route_report.get(k, new_report())
        extra = large["large_sites"] + variant["variant_sites"] + route["route_sites"]
        for label, ms_k, ms_p, nbytes, n_dev in r["sites"]:
            print(f"timing {k} [{label}]: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
                  f"{bound_ms(nbytes):.4f} ms ({nbytes} B, {bound_ms(nbytes) / ms_k:.1%} of it), "
                  f"device kernels per call {n_dev}", flush=True)
        for site in extra:
            dev = site["device_ms"]
            by_name = {n: round(v, 4) for n, v in (site["device_ms_by_kernel"] or {}).items()}
            print(f"timing {k} [{site['site']}]: kernel {site['ms']:.4f} ms (device "
                  f"{'not measured' if dev is None else f'{dev:.4f} ms'}), plain {site['plain_ms']:.4f} ms, "
                  f"bound {site['bound_ms']:.4f} ms ({site['bytes']} B), device kernels per call "
                  f"{site['device_kernels_per_call']} {by_name}", flush=True)
        if k in KERNELS:  # the 480x640 sites
            ms, dev_ms, plain_ms, nbytes, n_dev = r["ms"], r["device_ms"], r["plain_ms"], r["bytes"], r["device_launches"]
        else:  # a bridge route: its timed sites of phases 12, 13 and 15
            ms, plain_ms = sum(x["ms"] for x in extra), sum(x["plain_ms"] for x in extra)
            nbytes = sum(x["bytes"] for x in extra)
            devs = [x["device_ms"] for x in extra]
            dev_ms = None if None in devs else sum(devs)
            ns = [x["device_kernels_per_call"] for x in extra if x["device_kernels_per_call"] is not None]
            n_dev = max(ns) if ns else None  # measured sites only
        count = "bridge_morphology.cluster" if k == "bridge_morphology" else k
        rows.append({
            "name": k, "route": "cuda", "source": frontend.SOURCES["bridge_morphology" if k in ROWS[4:] else k],
            "replaces": frontend.REPLACES["bridge_morphology" if k in ROWS[4:] else k],
            "launches": sum(c[count] for c in by_path.values()),
            "launches_by_path": {p: c[count] for p, c in by_path.items()},
            "launches_per_step": main_launches[count],
            "max_abs_err": max(r["max_abs_err"], large["max_abs_err"], variant["max_abs_err"], route["max_abs_err"]),
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "bytes": nbytes,
            "bound_share": bound_ms(nbytes) / ms if ms else None, "library_ms": None,
            "device_kernels_per_call": n_dev, "design": DESIGN[k],
            "large_sites": large["large_sites"], "variant_sites": variant["variant_sites"],
            "route_sites": route["route_sites"],
        })
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
