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

The second-to-last line is the kernel report as JSON, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
KERNELS = ("preprocess_binarize", "connected_components", "bridge_morphology",
           "component_payload_minmax")
# Kernels each path must launch (counts per batch call where exact).
PATH_KERNELS = {
    "main": {"preprocess_binarize": None, "connected_components": None, "bridge_morphology": None},
    "endpoint": {"preprocess_binarize": None, "connected_components": 2, "bridge_morphology": None,
                 "component_payload_minmax": None},
    "plane": {"preprocess_binarize": None, "connected_components": None, "bridge_morphology": None},
}
for _path in ("experiment", "preprocess", "stream"):
    PATH_KERNELS[_path] = dict(PATH_KERNELS["main"])
# The H100 SXM's HBM rate (NVIDIA data sheet) for the kernels' byte bounds.
HBM_BYTES_PER_S = 3.35e12
# Each kernel's design: redesigned for Hopper, or still the first port.
DESIGN = {"preprocess_binarize": "redesigned", "connected_components": "redesigned",
          "bridge_morphology": "redesigned", "component_payload_minmax": "redesigned"}
# Device kernels one wrapper call may launch at the timed sites.
DEVICE_LAUNCHES_MAX = {"preprocess_binarize": 3, "connected_components": 1, "bridge_morphology": 1,
                       "component_payload_minmax": 1}
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


def device_launches(fn):
    """(CUDA kernels that one fn() call launches, their summed device ms),
    by torch.profiler; (None, None) if it records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    return (len(spans), sum(spans)) if spans else (None, None)


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
        if launches[k] < 1:
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
                v_exp=br.v_exp, circle_radius0=roi.circle_radius0, bright_blur=front.bright_blur,
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


def kernel_phase(frontend, calls, device, seed: int = 0) -> dict:
    """Every kernel vs its plain version on the captured production
    intermediates plus seeded random inputs; returns per-kernel reports."""
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import _smooth

    g = torch.Generator(device="cpu").manual_seed(seed)
    report = {}

    def compare(name, kernel_fn, plain_fn, label, timed, nbytes=0, site=True):
        """``timed``: time the call; ``site``: add it to the kernel's
        report (a main-path call site)."""
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
        rep = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0,
                                       "device_ms": 0.0, "sites": [], "device_launches": None})
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        line = f"kernel {name} [{label}] equal"
        if timed:
            ms_k = cuda_ms(kernel_fn)
            ms_p = cuda_ms(plain_fn, reps=5, warmup=1)
            n_dev, dev_ms = device_launches(kernel_fn)
            if n_dev is None or n_dev > DEVICE_LAUNCHES_MAX[name]:
                raise AssertionError(f"{name} [{label}]: {n_dev} device kernels in a call "
                                     f"(at most {DEVICE_LAUNCHES_MAX[name]})")
            if site:
                rep["device_ms"] += dev_ms
                rep["ms"] += ms_k
                rep["plain_ms"] += ms_p
                rep["bytes"] += nbytes
                rep["sites"].append((label, ms_k, ms_p, nbytes, n_dev))
                rep["device_launches"] = max(rep["device_launches"] or 0, n_dev)
            dev_txt = f"{dev_ms:.4f} ms"
            line += (f"; kernel {ms_k:.4f} ms (device {dev_txt}), plain {ms_p:.4f} ms, bound "
                     f"{bound_ms(nbytes):.4f} ms ({nbytes} B), device kernels per call {n_dev}")
        print(line, flush=True)

    # 2.1 preprocess: the B=16 run's smoothed views + smoothed noise images.
    for i, (args, kw) in enumerate(calls["preprocess_binarize"]):
        x = args[0]
        compare("preprocess_binarize", lambda: frontend.preprocess_binarize(x, **kw),
                lambda: frontend.preprocess_binarize_plain(x, **kw),
                f"captured {tuple(x.shape)}", timed=(i == 0),
                nbytes=frontend.min_bytes("preprocess_binarize", *x.shape))
        noise = torch.rand(x.shape, generator=g).mul(255.0).to(device)
        xs = _smooth(noise, CylinderDetectConfig())
        compare("preprocess_binarize", lambda: frontend.preprocess_binarize(xs, **kw),
                lambda: frontend.preprocess_binarize_plain(xs, **kw),
                f"random {tuple(xs.shape)}", timed=False)

    # 2.2 connected components: the three call sites + random masks.
    for args, kw in calls["connected_components"]:
        m = args[0]
        init = kw.get("init_labels")
        label = (f"captured {tuple(m.shape)} {kw['rounds']}x{kw['pools_per_round']} "
                 f"{'warm' if init is not None else 'cold'}")
        compare("connected_components",
                lambda: frontend.connected_components(m, kw["rounds"], kw["pools_per_round"], init),
                lambda: frontend.connected_components_plain(m, kw["rounds"], kw["pools_per_round"], init),
                label, timed=True,
                nbytes=frontend.min_bytes("connected_components", *m.shape, warm=init is not None))
        rnd = (torch.rand(m.shape, generator=g) < 0.45).to(torch.float32).to(device)
        rinit = None
        if init is not None:
            rinit = torch.randint(0, 2 * m.shape[1] * m.shape[2], m.shape, generator=g,
                                  dtype=torch.int32).to(device)
        compare("connected_components",
                lambda: frontend.connected_components(rnd, kw["rounds"], kw["pools_per_round"], rinit),
                lambda: frontend.connected_components_plain(rnd, kw["rounds"], kw["pools_per_round"], rinit),
                f"random {tuple(m.shape)}", timed=False)

    # 2.4 payload min/max: the endpoint path's call + random masks with
    # random payloads (a permutation of [0, H*W) per image).
    for args, kw in calls["component_payload_minmax"]:
        m, pay = args
        rounds, pools = kw["rounds"], kw["pools_per_round"]
        compare("component_payload_minmax",
                lambda: frontend.component_payload_minmax(m, pay, rounds, pools),
                lambda: frontend.component_payload_minmax_plain(m, pay, rounds, pools),
                f"captured {tuple(m.shape)} {rounds}x{pools}", timed=True,
                nbytes=frontend.min_bytes("component_payload_minmax", *m.shape))
        n, h, w = m.shape
        rnd = (torch.rand(m.shape, generator=g) < 0.45).to(torch.float32).to(device)
        rpay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(n)])
        rpay = rpay.reshape(n, h, w).to(torch.int32).to(device)
        for r, p in ((rounds, pools), (1, 2), (3, 1)):
            compare("component_payload_minmax",
                    lambda: frontend.component_payload_minmax(rnd, rpay, r, p),
                    lambda: frontend.component_payload_minmax_plain(rnd, rpay, r, p),
                    f"random {tuple(m.shape)} {r}x{p}", timed=False)

    # 2.3 bridge: the captured call (bool, the detector's interface), the
    # same as float32, line masks at non-axis angles with kernel lengths from
    # 0 past the cap (both types), and the kernel's own schedule against
    # bridge_schedule on the card.
    for args, kw in calls["bridge_morphology"]:
        masks, exps, angles, klen = args
        compare("bridge_morphology",
                lambda: frontend.bridge_morphology(masks, exps, angles, klen, **kw),
                lambda: frontend.bridge_morphology_plain(masks, exps, angles, klen, **kw),
                f"captured {tuple(masks.shape)} {masks.dtype}", timed=True,
                nbytes=frontend.min_bytes("bridge_morphology", *masks.shape, itemsize=masks.element_size()))
        mf, ef = masks.to(torch.float32), exps.to(torch.float32)
        compare("bridge_morphology",
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
            compare("bridge_morphology",
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
            recs = [{"id": [int(dh.grid.idx[i, k, 0]), int(dh.grid.idx[i, k, 1])],
                     "x": float(dh.grid.xy[i, k, 0]), "y": float(dh.grid.xy[i, k, 1])}
                    for k in range(dh.grid.valid.shape[1]) if bool(dh.grid.valid[i, k])]
            _, d = points_check(dc.grid, i, recs, f"preprocessed frame {i}")
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

    for label, fn_e2e, fn_det in (("e2e", e2e, detect), ("endpoint e2e", e2e_ep, detect_ep)):
        ms_e2e = cuda_ms(fn_e2e, reps=10, warmup=2)
        ms_det = cuda_ms(fn_det, reps=10, warmup=2)
        print(f"{label} B={batch} {height}x{width}: {ms_e2e / batch:.4f} ms/frame "
              f"(detect {ms_det / batch:.4f} ms/frame, fit {(ms_e2e - ms_det) / batch:.4f} ms/frame); "
              f"{smi}", flush=True)
    stage_split(torch.cat([d1, d2]), (("main", cfg), ("endpoint", cfg_ep)))
    n_views = pviews.shape[0]
    ms_plane = cuda_ms(detect_plane, reps=10, warmup=2)
    print(f"plane detect V={n_views} {height}x{width}: {ms_plane / n_views:.4f} ms/view; {smi}",
          flush=True)

    # Launches per kernel: summed over the six path runs (each counted
    # from zero), with the split by path beside it.
    by_path = {"main": main_launches, "endpoint": ep_launches, "plane": plane_launches,
               "experiment": exp_launches, "preprocess": pre_launches, "stream": stream_launches}
    rows = []
    for k in KERNELS:
        r = report[k]
        for label, ms_k, ms_p, nbytes, n_dev in r["sites"]:
            print(f"timing {k} [{label}]: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
                  f"{bound_ms(nbytes):.4f} ms ({nbytes} B, {bound_ms(nbytes) / ms_k:.1%} of it), "
                  f"device kernels per call {n_dev}", flush=True)
        rows.append({
            "name": k, "route": "cuda", "source": frontend.SOURCES[k],
            "replaces": frontend.REPLACES[k], "launches": sum(c[k] for c in by_path.values()),
            "launches_by_path": {p: c[k] for p, c in by_path.items()},
            "launches_per_step": main_launches[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms(r["bytes"]), "bound_by": "bytes", "bytes": r["bytes"],
            "bound_share": bound_ms(r["bytes"]) / r["ms"], "library_ms": None,
            "device_kernels_per_call": r["device_launches"], "design": DESIGN[k],
        })
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
