"""Write the PyTorch port's fixtures from the JAX package.

    python tools/make_torch_port_fixtures.py [endpoint] [plane] [registration]

(all three without arguments).

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

The detection files record their scene specs and configs; ``chip_smoke.py``
renders the same inputs without JAX and holds the port to the files.  Run on
the CPU; the interpret-mode endpoint scenes dominate the run time.
"""

from __future__ import annotations

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


FIXTURE_WRITERS = {"endpoint": endpoint_fixture, "plane": plane_fixture,
                   "registration": registration_fixture}


if __name__ == "__main__":
    for name in sys.argv[1:] or list(FIXTURE_WRITERS):
        FIXTURE_WRITERS[name]()
