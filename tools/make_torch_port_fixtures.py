"""Write the PyTorch port's fixtures from the JAX package.

    python tools/make_torch_port_fixtures.py [endpoint] [plane] [registration] [variants] [cli] [corpus] [knobs]

(all seven without arguments).

* ``tests/fixtures/torch_endpoint_scenes.json``: ``estimate_pose_stereo``
  with ``CylinderDetectConfig(bridge_endpoint_stats=True)`` and
  ``FitConfig()`` at 480x640, through the Pallas path in interpret mode (the
  endpoint-stats bridge exists only there), on the seven golden scene
  inputs: frames 0-5 of the port's numpy ``example_pair`` and frame 0 with
  the golden dropout band (``apply_gap``).
* ``tests/fixtures/torch_plane_scenes.json``: plane-mode ``detect_grid``
  (``PlaneDetectConfig(height=480, width=640, roi_threshold=30.0)``) on
  eight views rendered by the port's numpy ``plane_view`` from the specs
  below (one with a fragmented column).  Points, ``ok`` and the bridged
  count come from the XLA path, and the script checks that the Pallas path
  (interpret mode) gives the same; ``stable`` is the Pallas path's, which
  the port runs: its warm final CC stops after 2 rounds, unconverged on the
  plane's full-length lines, where the XLA path's CC converges
  (``stable_xla``).

* ``tests/fixtures/torch_registration.json``: ``fit_cylinders_with_angles``
  with ``RegistrationConfig()`` on 100 frames of cylinder-surface points
  from the generator of tests/test_registration.py (8x9 points per frame in
  a capacity of 576, on the cylinders that a ground-truth T_Cam_AGV and the
  default kinematics place at each frame's pan/tilt), with N(0, 0.3 mm)
  noise from a recorded seed and frame 7 replaced by uniform garbage and
  masked out through ``frame_valid``.  The points are stored (rounded to
  1e-3 mm, the JAX result computed on the rounded values), so the port
  reads the very same float32 inputs.

* ``tests/fixtures/torch_variant_scenes.json``: ``detect_grid`` with the
  full-resolution variants and sub-pixel refinement (``VARIANT_CONFIGS``)
  on both branches (the kernel branch in interpret mode), at 240x320 (two
  ``cylinder_view`` scenes, one with a dropout the bridge closes, and one
  plane view with a fragmented column; with SHA-256 digests of the JAX
  bridged masks and final labels, and the full-resolution ``_bridge`` case
  of tests/test_detector_hardening.py) and at 480x640 (the 16 frames of
  ``example_pair`` and the plane fixture's eight views; grids only).
* ``tests/fixtures/torch_cli.json``: the JAX package's ``cylpose``
  ``detect-folder`` and ``experiment`` on PNG frames of
  ``registration_sequence`` at integer-degree pan/tilt names, written by
  the port's PNG writer, with the camera JSON of ``save_stereo_json``; at
  240x320 and 480x640, each with the fewest frames (from ``CLI_MIN_FRAMES``
  up) whose registration reads well posed on two or more healthy frames in
  the JAX package and in the port on the CPU (``experiment --no-clahe``).

* ``tests/fixtures/torch_corpus_scenes.npz``: the frames of the JAX
  package's detection corpora that only JAX renders, as float32 arrays
  (``chip_smoke.py`` phase 17 runs them on the card and on the CPU port):
  the rendered gap scene of tests/test_detector_hardening.py (seed 3, the
  control and the dropout across the middle row, placed from the JAX XLA
  branch's control grid), the double gap of tests/test_torch_xla_corpus.py,
  the half-resolution k1=-1.2 stereo pair of tests/test_distortion_e2e.py
  and its zero-distortion control (with the distorted rig's arrays and the
  cylinder radius), and two views of tests/_scene_family2.py's
  ``indep_scene`` (seed 1 at 480x640, seed 2 at 240x320; the first view).

* ``tests/fixtures/torch_knob_scenes.json``: ``detect_grid`` with the
  knobs ``smooth_mxu=False`` (the preprocess kernel's own smoothing),
  ``pallas_cc_cross_cap=16`` (the final labels' capped scans, also at
  ``label_downsample=1``) and ``bright_at_points=False`` (on both branches),
  and the three together (``KNOB_CONFIGS``; the kernel branch in interpret
  mode): at 480x640 the grids, flags and bridged counts of the 16 frames of
  ``example_pair`` (bench.py's scene family), at 240x320 those of the two
  ``cylinder_view`` scenes of the variants record with SHA-256 digests of
  the binary mask and the final labels.

The detection files record their scene specs and configs; ``chip_smoke.py``
renders the same inputs without JAX and holds the port to the files.  Run on
the CPU; the interpret-mode endpoint scenes dominate the run time.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HEIGHT, WIDTH = 480, 640
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ENDPOINT_FIXTURE = os.path.join(FIXTURES, "torch_endpoint_scenes.json")
PLANE_FIXTURE = os.path.join(FIXTURES, "torch_plane_scenes.json")
REGISTRATION_FIXTURE = os.path.join(FIXTURES, "torch_registration.json")

# Endpoint scenes: frame indices of example_pair(480, 640, n_frames=6, seed=0),
# and the gapped frame 0 (named as in golden_scenes.json).
ENDPOINT_SCENES = [0, 1, 2, 3, 4, 5, "gap0_pallas"]

PLANE_SPECS = [
    dict(origin=[0.0, 0.0, 700.0], normal=[0.05, -0.08, -1.0], n_rows=9, n_cols=11,
         spacing=30.0, seed=10),
    dict(origin=[20.0, -10.0, 720.0], normal=[-0.1, 0.05, -1.0], n_rows=9, n_cols=9,
         spacing=32.0, seed=11),
    dict(origin=[-25.0, 15.0, 680.0], normal=[0.12, 0.1, -1.0], n_rows=11, n_cols=11,
         spacing=26.0, seed=12, saturate_center=True),
    dict(origin=[0.0, 0.0, 650.0], normal=[0.0, 0.0, -1.0], n_rows=9, n_cols=11,
         spacing=28.0, seed=13),
    dict(origin=[10.0, 5.0, 760.0], normal=[0.2, -0.05, -1.0], n_rows=9, n_cols=9,
         spacing=34.0, seed=14, saturate_center=True),
    dict(origin=[-10.0, -20.0, 700.0], normal=[-0.15, -0.12, -1.0], n_rows=9, n_cols=11,
         spacing=30.0, seed=15),
    dict(origin=[5.0, 0.0, 700.0], normal=[0.05, -0.08, -1.0], n_rows=9, n_cols=9,
         spacing=30.0, seed=16, gap_col=2),
    dict(origin=[0.0, 10.0, 640.0], normal=[0.08, 0.15, -1.0], n_rows=9, n_cols=11,
         spacing=24.0, seed=17, saturate_center=True),
]


def grid_records(grid) -> list:
    xy = np.asarray(grid.xy, np.float64)
    idx = np.asarray(grid.idx)
    valid = np.asarray(grid.valid)
    recs = [{"id": [int(idx[i, 0]), int(idx[i, 1])],
             "x": round(float(xy[i, 0]), 4), "y": round(float(xy[i, 1]), 4)}
            for i in range(len(valid)) if valid[i]]
    recs.sort(key=lambda r: tuple(r["id"]))
    return recs


def endpoint_images():
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import apply_gap, example_pair

    _, (i1, i2) = example_pair(HEIGHT, WIDTH, n_frames=6)
    a = list(i1) + [apply_gap(i1[0])]
    b = list(i2) + [apply_gap(i2[0])]
    return a, b


def endpoint_record(name, res) -> dict:
    return {
        "scene": name,
        "view1": grid_records(res.detect1.grid),
        "view2": grid_records(res.detect2.grid),
        "center1": [round(float(v), 4) for v in np.asarray(res.detect1.grid.center)],
        "fit_params": [round(float(v), 5) for v in np.asarray(res.fit.params)],
        "fvals": [round(float(v), 4) for v in np.asarray(res.fit.fvals)],
        "mean_reproj_px": round(float(res.fit.mean_reproj_error), 5),
        "bridged_components": int(res.detect1.bridged_components)
        + int(res.detect2.bridged_components),
    }


def endpoint_fn():
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu.models.pipeline import estimate_pose_stereo
    from cylinder_pose_estimation_tpu.utils.synthetic import default_stereo

    stereo = default_stereo(cx=WIDTH / 2.0, cy=HEIGHT / 2.0)
    cfg = CylinderDetectConfig(height=HEIGHT, width=WIDTH, use_pallas=True,
                               pallas_interpret=True, bridge_endpoint_stats=True)
    return jax.jit(lambda a, b: estimate_pose_stereo(a, b, stereo, cfg, FitConfig()))


def plane_record(spec, res, res_pallas) -> dict:
    rec = {
        "spec": spec,
        "points": grid_records(res.grid),
        "center": [round(float(v), 4) for v in np.asarray(res.grid.center)],
        "ok": bool(res.ok),
        "stable": bool(res_pallas.stable),
        "stable_xla": bool(res.stable),
        "bridged_components": int(res.bridged_components),
    }
    pallas = plane_record_fields(res_pallas)
    if pallas != {k: rec[k] for k in pallas}:
        raise AssertionError(f"plane view {spec}: the XLA and Pallas paths disagree")
    return rec


def plane_record_fields(res) -> dict:
    return {"points": grid_records(res.grid), "ok": bool(res.ok),
            "bridged_components": int(res.bridged_components)}


def plane_fns():
    from cylinder_pose_estimation_tpu.config import PlaneDetectConfig
    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    cfg = PlaneDetectConfig(height=HEIGHT, width=WIDTH, roi_threshold=30.0)
    cfg_p = PlaneDetectConfig(height=HEIGHT, width=WIDTH, roi_threshold=30.0,
                              use_pallas=True, pallas_interpret=True)
    return (jax.jit(lambda im: detect_grid(im, cfg)),
            jax.jit(lambda im: detect_grid(im, cfg_p)))


def plane_image(spec):
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import plane_view

    return plane_view(HEIGHT, WIDTH, **spec)


REG_SEED = 2024
REG_FRAMES = 100
REG_CAPACITY = 576
REG_NOISE_MM = 0.3
REG_POISONED = 7
REG_GT_POSE = [0.1, -1.4, 0.05, 80.0, -20.0, 800.0]


def registration_fixture() -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_registration import _make_frames

    from cylinder_pose_estimation_tpu.config import RegistrationConfig
    from cylinder_pose_estimation_tpu.geometry import transforms
    from cylinder_pose_estimation_tpu.geometry.registration import fit_cylinders_with_angles

    t0 = time.perf_counter()
    s = np.linspace(0.0, 1.0, REG_FRAMES)
    angles = np.stack([0.5 * (2.0 * s - 1.0), 0.15 * np.sin(2.0 * np.pi * s)], -1).astype(np.float32)
    t_gt = transforms.vec_to_transform(jnp.asarray(REG_GT_POSE, jnp.float32))
    pts, valid = _make_frames(t_gt, angles, capacity=REG_CAPACITY)
    rng = np.random.default_rng(REG_SEED)
    pts = np.asarray(pts) + rng.normal(0.0, REG_NOISE_MM, pts.shape).astype(np.float32)
    pts[REG_POISONED] = rng.uniform(-1e4, 1e4, pts.shape[1:]).astype(np.float32)
    valid = np.asarray(valid)
    pts = np.where(valid[..., None], np.round(pts, 3), 0.0).astype(np.float32)
    frame_valid = np.ones(REG_FRAMES, bool)
    frame_valid[REG_POISONED] = False
    res = jax.jit(lambda p, v, a, fv: fit_cylinders_with_angles(p, v, a, RegistrationConfig(),
                                                                 frame_valid=fv))(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(angles), jnp.asarray(frame_valid))
    n_valid = valid.sum(-1)
    fixture = {
        "generator": "tools/make_torch_port_fixtures.py",
        "path": "JAX package, CPU, float32: geometry.registration.fit_cylinders_with_angles("
                "pts3s, valid, angles, RegistrationConfig(), frame_valid=frame_valid)",
        "points": f"tests/test_registration.py::_make_frames(T(gt_pose), angles, capacity="
                  f"{REG_CAPACITY}) + N(0, {REG_NOISE_MM} mm) from default_rng(seed), frame "
                  f"{REG_POISONED} replaced by uniform(-1e4, 1e4) and masked, rounded to 1e-3 mm; "
                  "each frame's valid points are its first n_valid slots",
        "seed": REG_SEED,
        "gt_pose": REG_GT_POSE,
        "capacity": REG_CAPACITY,
        "angles": angles.tolist(),
        "frame_valid": frame_valid.tolist(),
        "n_valid": n_valid.tolist(),
        "pts": [[round(float(v), 3) for v in pts[f, :n_valid[f]].reshape(-1)]
                for f in range(REG_FRAMES)],
        "result": {
            "t_cam_agv": np.asarray(res.t_cam_agv, np.float64).tolist(),
            "fval0": float(res.fval0),
            "fval": float(res.fval),
            "jtj_min_eig": float(res.jtj_min_eig),
            "well_posed": bool(res.well_posed),
        },
    }
    with open(REGISTRATION_FIXTURE, "w") as f:
        json.dump(fixture, f)
    print(f"registration: fval0 {float(res.fval0):.6g}, fval {float(res.fval):.6g}, min_eig "
          f"{float(res.jtj_min_eig):.6g}, well_posed {bool(res.well_posed)}; wrote "
          f"{REGISTRATION_FIXTURE} ({time.perf_counter() - t0:.0f} s)")


def endpoint_fixture() -> None:
    t0 = time.perf_counter()
    fn = endpoint_fn()
    a, b = endpoint_images()
    scenes = []
    for name, x, y in zip(ENDPOINT_SCENES, a, b):
        scenes.append(endpoint_record(name, fn(jnp.asarray(x), jnp.asarray(y))))
        print(f"endpoint scene {name}: {len(scenes[-1]['view1'])}/{len(scenes[-1]['view2'])} "
              f"points, bridged {scenes[-1]['bridged_components']}", flush=True)
    t_ep = time.perf_counter() - t0
    with open(ENDPOINT_FIXTURE, "w") as f:
        json.dump({
            "generator": "tools/make_torch_port_fixtures.py",
            "path": "JAX Pallas path in interpret mode, CPU, float32: estimate_pose_stereo, "
                    "CylinderDetectConfig(height=480, width=640, use_pallas=True, "
                    "bridge_endpoint_stats=True), FitConfig()",
            "scene_family": "cylinder_pose_estimation_tpu_torch.utils.synthetic.example_pair"
                            "(480, 640, n_frames=6, seed=0) frames 0-5; gap0_pallas = "
                            "apply_gap(frame 0)",
            "scenes": scenes,
        }, f, indent=1)
    print(f"wrote {ENDPOINT_FIXTURE} ({t_ep:.0f} s)")


def plane_fixture() -> None:
    t1 = time.perf_counter()
    fn, fn_p = plane_fns()
    views = []
    for spec in PLANE_SPECS:
        img = jnp.asarray(plane_image(spec))
        views.append(plane_record(spec, fn(img), fn_p(img)))
        print(f"plane view {spec}: {len(views[-1]['points'])} points, ok {views[-1]['ok']}, "
              f"bridged {views[-1]['bridged_components']}", flush=True)
    t_pl = time.perf_counter() - t1
    with open(PLANE_FIXTURE, "w") as f:
        json.dump({
            "generator": "tools/make_torch_port_fixtures.py",
            "path": "JAX XLA path (use_pallas=False), CPU, float32: detect_grid, "
                    "PlaneDetectConfig(height=480, width=640, roi_threshold=30.0); equal on "
                    "points, ok and bridged_components to the Pallas path in interpret mode, "
                    "whose stable flag is recorded (the XLA path's as stable_xla)",
            "scene_family": "cylinder_pose_estimation_tpu_torch.utils.synthetic.plane_view"
                            "(480, 640, **spec)",
            "views": views,
        }, f, indent=1)
    print(f"wrote {PLANE_FIXTURE} ({t_pl:.0f} s)")


VARIANT_FIXTURE = os.path.join(FIXTURES, "torch_variant_scenes.json")
CLI_FIXTURE = os.path.join(FIXTURES, "torch_cli.json")

# (name, use_pallas, overrides): the configurations of the variants record;
# "sizes" limits a configuration to some of the records.
VARIANT_CONFIGS = [
    {"name": f"{name}_{branch}", "use_pallas": branch == "kernel", "overrides": ov, "sizes": sizes}
    for name, ov, sizes in (
        ("refine", {"subpixel_refine": True}, ("240x320", "480x640")),
        ("ds1", {"label_downsample": 1}, ("240x320", "480x640")),
        ("halfres_off", {"bridge_half_res": False}, ("240x320", "480x640")),
        ("ds1_halfres_off", {"label_downsample": 1, "bridge_half_res": False}, ("240x320",)),
    )
    for branch in ("kernel", "xla")
] + [{"name": "endpoint_ds1_kernel", "use_pallas": True, "sizes": ("240x320", "480x640"),
      "overrides": {"bridge_endpoint_stats": True, "label_downsample": 1}}]
PLANE_VARIANT_CONFIGS = [
    {"name": f"plane_ds1_{branch}", "use_pallas": branch == "kernel",
     "overrides": {"label_downsample": 1, "roi_threshold": 30.0}}
    for branch in ("kernel", "xla")
]
SMALL_CYLINDER = dict(origin=[0.0, -15.0, 560.0], radius=52.0, row_spacing=12.0, theta_span=2.2, seed=0)
SMALL_CYLINDER_SPECS = [SMALL_CYLINDER, dict(SMALL_CYLINDER, band=[112, 122, 130, 140])]
SMALL_PLANE_SPECS = [dict(origin=[5.0, 0.0, 700.0], normal=[0.05, -0.08, -1.0], n_rows=9, n_cols=9,
                          spacing=15.0, seed=16, gap_col=2)]
VARIANT_FRAMES = 16
# tests/test_detector_hardening.py's full-resolution _bridge case: masks,
# and the circle radius that gives its 60 px kernel (91 + r0).
BRIDGE_CASE_R0 = -31.0


def digest(x) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(x)).tobytes()).hexdigest()


def bridge_case_mask(h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), bool)
    m[60:62, 40:280] = True     # long unbroken line (sets the maximum extent)
    m[120:122, 40:140] = True   # a broken line: two fragments, 20 px gap
    m[120:122, 160:280] = True
    return m


def variant_cfg(spec: dict, plane: bool, h: int, w: int, jax_side: bool = True):
    if jax_side:
        from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, PlaneDetectConfig
    else:
        from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    cls = PlaneDetectConfig if plane else CylinderDetectConfig
    extra = {"pallas_interpret": True} if jax_side else {}
    return cls(height=h, width=w, use_pallas=spec["use_pallas"], **extra, **spec["overrides"])


def jax_variant_fn(cfg, with_stages: bool):
    """jit(image -> (DetectResult, stage digests inputs)): with_stages adds
    the bridged masks and the final labels, computed from the JAX
    detector's own bridge inputs by its own stages (detector.py:1434-1545)."""
    from cylinder_pose_estimation_tpu.models import detector as jd
    from cylinder_pose_estimation_tpu.ops.pallas.frontend import connected_components as cc_pallas

    def fn(img):
        res, dbg = jd.detect_grid(img, cfg, return_debug=True)
        if not with_stages:
            return res, ()
        kernel_len = jnp.asarray(cfg.bridge_kernel_base, jnp.float32) + res.circle_radius0
        h_exp, v_exp, warm, _, _, _ = jd._bridge_pair(dbg.h_mask, dbg.v_mask, kernel_len,
                                                     cfg.bridge_kernel_base + 160, cfg)
        ds = cfg.label_downsample
        if ds == 2 and not cfg.bridge_half_res:
            hv = jnp.stack([jd._pool2_pad(h_exp), jd._pool2_pad(v_exp)])
        else:
            hv = jnp.stack([h_exp, v_exp])
        if cfg.use_pallas:
            use_warm = cfg.cc_warm_start and warm is not None and warm.shape == hv.shape
            rounds = max(1, int(cfg.pallas_cc_rounds_warm if use_warm else cfg.pallas_cc_rounds))
            init = warm if use_warm else None
            cap = int(cfg.pallas_cc_cross_cap)
            if cap > 0:  # detector.py's two capped launches: h along axis 0, v along axis 1
                labels = jnp.stack([
                    cc_pallas(hv[i], rounds=rounds, pools_per_round=cfg.pallas_cc_pools, cap_axis=i, cap=cap,
                              interpret=True, init_labels=None if init is None else init[i])
                    for i in (0, 1)])
            else:
                labels = cc_pallas(hv, rounds=rounds, pools_per_round=cfg.pallas_cc_pools, interpret=True,
                                   init_labels=init)
        else:
            labels = jnp.stack([jd._cc(hv[0], cfg.cc_iters, cfg), jd._cc(hv[1], cfg.cc_iters, cfg)])
        same = jnp.array_equal(h_exp, dbg.h_expanded) & jnp.array_equal(v_exp, dbg.v_expanded)
        return res, (h_exp, v_exp, labels.astype(jnp.int32), same, dbg.binary)

    return jax.jit(fn)


def variant_view_record(res, stages) -> dict:
    rec = {"points": grid_records(res.grid), "ok": bool(res.ok), "stable": bool(res.stable),
           "bridged_components": int(res.bridged_components)}
    if stages:
        h_exp, v_exp, labels, same = stages[:4]
        if not bool(same):
            raise AssertionError("the JAX bridge stage disagrees with detect_grid's debug masks")
        rec.update(h_exp=digest(h_exp), v_exp=digest(v_exp), labels=digest(labels),
                   canvas=list(np.asarray(labels).shape[-2:]))
    return rec


def variant_images(size: str):
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
        cylinder_view,
        example_pair,
        plane_view,
    )

    h, w = (int(v) for v in size.split("x"))
    if size == "240x320":
        cyl = [cylinder_view(h, w, **spec) for spec in SMALL_CYLINDER_SPECS]
        plane = [plane_view(h, w, **spec) for spec in SMALL_PLANE_SPECS]
        return cyl, plane, {"cylinder_views": SMALL_CYLINDER_SPECS, "plane_views": SMALL_PLANE_SPECS}
    _, (i1, i2) = example_pair(h, w, n_frames=VARIANT_FRAMES)
    plane = [plane_view(h, w, **spec) for spec in PLANE_SPECS]
    return list(np.concatenate([i1, i2])), plane, {
        "cylinder_views": f"example_pair({h}, {w}, n_frames={VARIANT_FRAMES}, seed=0): the img1 frames, "
                          "then the img2 frames",
        "plane_views": "the specs of torch_plane_scenes.json"}


def bridge_case_record() -> dict:
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu.models.detector import _bridge

    cfg = CylinderDetectConfig(height=240, width=320)
    m = bridge_case_mask(240, 320)
    out, angle, n_pre = jax.jit(lambda x: _bridge(
        x, 0.0, jnp.float32(cfg.bridge_kernel_base + BRIDGE_CASE_R0), cfg.bridge_kernel_base + 160, cfg))(
        jnp.asarray(m))
    out = np.asarray(out)
    if not out[118:124, 140:160].any():
        raise AssertionError("the full-resolution _bridge case did not bridge")
    return {"circle_radius0": BRIDGE_CASE_R0, "h_exp": digest(out), "pixels": int(out.sum()),
            "angle": float(angle), "n_pre": int(n_pre)}


def variants_fixture() -> None:
    t0 = time.perf_counter()
    records = {}
    for size in ("240x320", "480x640"):
        h, w = (int(v) for v in size.split("x"))
        small = size == "240x320"
        cyl, plane, scenes = variant_images(size)
        rec = {"scenes": scenes, "configs": []}
        for spec, views, is_plane in ([(c, cyl, False) for c in VARIANT_CONFIGS if size in c["sizes"]]
                                      + [(c, plane, True) for c in PLANE_VARIANT_CONFIGS]):
            t1 = time.perf_counter()
            fn = jax_variant_fn(variant_cfg(spec, is_plane, h, w), with_stages=small)
            out = [variant_view_record(*fn(jnp.asarray(v))) for v in views]
            rec["configs"].append({"name": spec["name"], "mode": "plane" if is_plane else "cylinder",
                                   "use_pallas": spec["use_pallas"], "overrides": spec["overrides"],
                                   "views": out})
            print(f"variants {size} {spec['name']}: points {[len(v['points']) for v in out]}, bridged "
                  f"{[v['bridged_components'] for v in out]} ({time.perf_counter() - t1:.0f} s)", flush=True)
        if small:
            rec["bridge_case"] = bridge_case_record()
        records[size] = rec
    with open(VARIANT_FIXTURE, "w") as f:
        json.dump({
            "generator": "tools/make_torch_port_fixtures.py",
            "path": "JAX package, CPU, float32: detect_grid with CylinderDetectConfig / "
                    "PlaneDetectConfig(height, width, use_pallas, **overrides), the kernel branch in "
                    "interpret mode; digests: SHA-256 of the bool bridged masks and the int32 final "
                    "labels (2, h, w) as C-order bytes",
            "records": records,
        }, f)
    print(f"wrote {VARIANT_FIXTURE} ({time.perf_counter() - t0:.0f} s)")


# The CLI record: frames of registration_sequence at integer-degree angles
# (the default swing, rounded), the fewest from CLI_MIN_FRAMES up whose
# registration is well posed on two or more healthy frames in both packages.
# The experiment runs with --no-clahe: on these synthetic frames adapthisteq
# lifts the noise floor until no frame detects a stable grid, and the
# registration then fits every frame's few points.
CLI_EXPERIMENT_ARGS = ("--no-clahe",)
CLI_MIN_FRAMES = 4
CLI_MAX_FRAMES = 30


def port_cli_well_posed(folder: str) -> bool:
    """The port's experiment on the CPU: well posed, on two or more healthy
    frames (so the health mask is in force)."""
    import contextlib
    import io
    import re

    from cylinder_pose_estimation_tpu_torch import cli as tcli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(["experiment", "--camera-json", os.path.join(folder, "cameras.json"),
                   "--input", folder, "--device", "cpu", *CLI_EXPERIMENT_ARGS])
    m = re.search(r"registration: (\d+) of \d+ frames healthy.*well posed (True|False)", buf.getvalue())
    return int(m.group(1)) >= 2 and m.group(2) == "True"


def jax_cli_record(folder: str, out_dir: str) -> dict:
    """The JAX CLI's detect-folder and experiment on ``folder``; the
    experiment's jitted step is recorded by wrapping ``jax.jit``."""
    import contextlib
    import io

    from cylinder_pose_estimation_tpu import cli as jcli
    from cylinder_pose_estimation_tpu.models.pipeline import frame_health

    cam = os.path.join(folder, "cameras.json")
    jcli.main(["detect-folder", "--camera-json", cam, "--input", folder,
               "--output", os.path.join(out_dir, "detect")])
    with open(os.path.join(out_dir, "detect", "processed_images_data.json")) as f:
        detect = json.load(f)
    outs, real_jit = [], jax.jit

    def recording_jit(fn, *a, **k):
        compiled = real_jit(fn, *a, **k)

        def call(*args, **kw):
            out = compiled(*args, **kw)
            outs.append(out)
            return out

        return call

    buf = io.StringIO()
    jax.jit = recording_jit
    try:
        with contextlib.redirect_stdout(buf):
            jcli.main(["experiment", "--camera-json", cam, "--input", folder,
                       "--output", os.path.join(out_dir, "experiment"), *CLI_EXPERIMENT_ARGS])
    finally:
        jax.jit = real_jit
    batch, reg = outs[-1]
    t = np.load(os.path.join(out_dir, "experiment", "T_cam_agv.npy"))
    return {
        "detect_folder": detect,
        "experiment": {
            "stdout": buf.getvalue().splitlines()[:-1],
            "fvals": np.asarray(batch.fit.fvals, np.float64).tolist(),
            "healthy": int(np.asarray(frame_health(batch)).sum()),
            "healthy_frames": np.asarray(frame_health(batch)).tolist(),
            "t_cam_agv": np.asarray(t, np.float64).tolist(),
            "fval0": float(reg.fval0), "fval": float(reg.fval),
            "jtj_min_eig": float(reg.jtj_min_eig), "well_posed": bool(reg.well_posed),
        },
    }


def cli_fixture() -> None:
    import tempfile

    from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
        integer_degree_angles,
        write_registration_folder,
    )

    t0 = time.perf_counter()
    records = {}
    for size in ("240x320", "480x640"):
        h, w = (int(v) for v in size.split("x"))
        with tempfile.TemporaryDirectory() as tmp:
            for n in range(CLI_MIN_FRAMES, CLI_MAX_FRAMES + 1):
                folder = os.path.join(tmp, f"in{n}")
                names = write_registration_folder(folder, n, h, w)
                if not port_cli_well_posed(folder):
                    continue
                rec = jax_cli_record(folder, os.path.join(tmp, f"out{n}"))
                print(f"cli {size} F={n}: JAX well_posed {rec['experiment']['well_posed']}, healthy "
                      f"{rec['experiment']['healthy']} ({time.perf_counter() - t0:.0f} s)", flush=True)
                if rec["experiment"]["well_posed"] and rec["experiment"]["healthy"] >= 2:
                    records[size] = {"frames": n, "names": names,
                                     "experiment_args": list(CLI_EXPERIMENT_ARGS),
                                     "angles_deg": integer_degree_angles(n).tolist(), **rec}
                    break
            else:
                raise AssertionError(f"no frame count up to {CLI_MAX_FRAMES} is well posed at {size}")
    with open(CLI_FIXTURE, "w") as f:
        json.dump({
            "generator": "tools/make_torch_port_fixtures.py",
            "path": "JAX package's cli.main on the CPU, defaults (use_pallas=False), experiment with "
                    "experiment_args: detect-folder's processed_images_data.json and experiment's "
                    "per-frame fvals and registration",
            "inputs": "cylinder_pose_estimation_tpu_torch.utils.synthetic.write_registration_folder"
                      "(folder, frames, H, W)",
            "records": records,
        }, f)
    print(f"wrote {CLI_FIXTURE} ({time.perf_counter() - t0:.0f} s)")


CORPUS_FIXTURE = os.path.join(FIXTURES, "torch_corpus_scenes.npz")


def corpus_frames() -> dict:
    """The corpus frames of ``torch_corpus_scenes.npz`` by name."""
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu.models.detector import detect_grid
    from cylinder_pose_estimation_tpu.utils.synthetic import cylinder_grid_points, default_stereo
    from tests import _scene_family2 as sf2
    from tests.test_detector_hardening import _gapped_scene
    from tests.test_distortion_e2e import _HALF_RES, _distorted_stereo, _render_views
    from tests.test_torch_xla_corpus import _double_gap

    h, w = 240, 320
    out = {}
    img0, _ = _gapped_scene(gap=None, seed=3)
    ctl = jax.jit(lambda im: detect_grid(im, CylinderDetectConfig(height=h, width=w)))(jnp.asarray(img0))
    v = np.asarray(ctl.grid.valid)
    ys = sorted({round(float(y)) for y in np.asarray(ctl.grid.xy)[v, 1]})
    y_mid = ys[len(ys) // 2]
    out["gap3_control"] = img0
    out["gap3_gapped"] = _gapped_scene(gap=(y_mid - 9, y_mid + 9, 150, 168), seed=3)[0]
    out["double_gap"] = _double_gap()
    stereo = _distorted_stereo(h, w)
    scene = cylinder_grid_points(stereo, capacity=256, n_rows=9, n_cols=9, **_HALF_RES)
    for tag, distorted in (("distorted", True), ("control", False)):
        views = _render_views(scene, stereo, 9, 9, h, w, 1, distorted)
        out[f"dist_{tag}_1"], out[f"dist_{tag}_2"] = views
    leaves = (stereo.cam1.k, stereo.cam1.radial, stereo.cam1.tangential, stereo.cam2.k, stereo.cam2.radial,
              stereo.cam2.tangential, stereo.t_c2_c1)
    for i, leaf in enumerate(leaves):
        out[f"dist_stereo_{i}"] = np.asarray(leaf, np.float32)
    out["dist_radius"] = np.float32(_HALF_RES["radius"])
    _, out["indep1_480x640"], _ = sf2.indep_scene(default_stereo(cx=320.0, cy=240.0), 1, profile="lorentz")
    _, out["indep2_240x320"], _ = sf2.indep_scene(default_stereo(cx=160.0, cy=120.0), 2, h, w, profile="lorentz")
    return {k: np.asarray(a, np.float32) for k, a in out.items()}


def corpus_fixture() -> None:
    t0 = time.perf_counter()
    np.savez_compressed(CORPUS_FIXTURE, **corpus_frames())
    print(f"wrote {CORPUS_FIXTURE} ({os.path.getsize(CORPUS_FIXTURE)} B, {time.perf_counter() - t0:.0f} s)")


KNOB_FIXTURE = os.path.join(FIXTURES, "torch_knob_scenes.json")
# The knobs: (name, use_pallas, overrides), each at both sizes.
KNOB_CONFIGS = [
    {"name": "smoothing_kernel", "use_pallas": True, "overrides": {"smooth_mxu": False}},
    {"name": "cross_cap_kernel", "use_pallas": True, "overrides": {"pallas_cc_cross_cap": 16}},
    {"name": "cross_cap_ds1_kernel", "use_pallas": True,
     "overrides": {"pallas_cc_cross_cap": 16, "label_downsample": 1}},
    {"name": "bright_kernel", "use_pallas": True, "overrides": {"bright_at_points": False}},
    {"name": "bright_xla", "use_pallas": False, "overrides": {"bright_at_points": False}},
    {"name": "all_knobs_kernel", "use_pallas": True,
     "overrides": {"smooth_mxu": False, "pallas_cc_cross_cap": 16, "bright_at_points": False}},
]


def knobs_fixture() -> None:
    t0 = time.perf_counter()
    records = {}
    for size in ("240x320", "480x640"):
        h, w = (int(v) for v in size.split("x"))
        small = size == "240x320"
        cyl, _, scenes = variant_images(size)
        rec = {"scenes": {"cylinder_views": scenes["cylinder_views"]}, "configs": []}
        for spec in KNOB_CONFIGS:
            t1 = time.perf_counter()
            fn = jax_variant_fn(variant_cfg(spec, False, h, w), with_stages=small)
            out = []
            for v in cyl:
                res, stages = fn(jnp.asarray(v))
                out.append(variant_view_record(res, stages))
                if stages:
                    out[-1]["binary"] = digest(stages[4])
            rec["configs"].append({"name": spec["name"], "use_pallas": spec["use_pallas"],
                                   "overrides": spec["overrides"], "views": out})
            print(f"knobs {size} {spec['name']}: points {[len(v['points']) for v in out]}, ok "
                  f"{sum(v['ok'] for v in out)}/{len(out)} ({time.perf_counter() - t1:.0f} s)", flush=True)
        records[size] = rec
    with open(KNOB_FIXTURE, "w") as f:
        json.dump({
            "generator": "tools/make_torch_port_fixtures.py knobs",
            "path": "JAX package, CPU, float32: detect_grid with CylinderDetectConfig(height, width, "
                    "use_pallas, **overrides), the kernel branch in interpret mode; digests: SHA-256 of "
                    "the bool binary mask (h, w), the bool bridged masks and the int32 final labels "
                    "(2, h, w) as C-order bytes",
            "records": records,
        }, f)
    print(f"wrote {KNOB_FIXTURE} ({time.perf_counter() - t0:.0f} s)")


FIXTURE_WRITERS = {"endpoint": endpoint_fixture, "plane": plane_fixture,
                   "registration": registration_fixture, "variants": variants_fixture,
                   "cli": cli_fixture, "corpus": corpus_fixture, "knobs": knobs_fixture}


if __name__ == "__main__":
    for name in sys.argv[1:] or list(FIXTURE_WRITERS):
        FIXTURE_WRITERS[name]()
