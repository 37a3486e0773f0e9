"""The plain reference of the benchmark, on the CPU: frames in; grid points,
poses, stream summaries and the camera <-> AGV registration out.

Its parts, and what each shares with the program:

- detection is a frozen copy, ``port/``, of the port's plain CPU code of
  the configuration's branch: for the kernel branch the hand-written CUDA
  kernels' plain PyTorch versions, for the default XLA branch the same
  PyTorch code as the program's, run on the CPU;
- the fit (correspondence, selection, triangulation, start, LM, prior,
  pose) and the registration are float64 NumPy and SciPy written from the
  specification (``fit.py``, ``registration.py``), not from the program.

It imports NumPy, SciPy, PyTorch (for the copy) and its own modules:
nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
from typing import Dict, List

import numpy as np
import torch

from bench_h100.reference import fit as F
from bench_h100.reference import registration as R
from bench_h100.reference.port import config as C
from bench_h100.reference.port.models import detector as D
from bench_h100.reference.port.ops.linalg import exact_float32

FIT_DEFAULTS = {"cyl_radius": 45.0, "patch_size": 3, "error_threshold": 0.3, "grid_extent": 24, "knn_k": 20,
                "lm_iters": 20, "lm_lambda0": 1e-3}
REG_DEFAULTS = {"cyl_radius": 45.0, "lm_iters": 80, "lm_lambda0": 1e-3, "min_frame_points": 8,
                "max_frame_reproj_px": 2.0, "min_observability": 1.5e-3,
                "kinematics": {"l1": 321.1, "l2": 143.1, "h": 110.0}}


def detect_config(fields: dict):
    names = {f.name for f in dataclasses.fields(C.CylinderDetectConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"CylinderDetectConfig: unknown fields {sorted(unknown)}")
    return C.CylinderDetectConfig(**fields)


def fit_fields(fields: dict) -> dict:
    return {**FIT_DEFAULTS, **fields}


def registration_fields(fields: dict) -> dict:
    out = {**REG_DEFAULTS, **fields}
    out["kinematics"] = {**REG_DEFAULTS["kinematics"], **fields.get("kinematics", {})}
    return out


def _stages(gray, cfg):
    kernels = cfg.use_pallas
    front = (D.front_stage if kernels else D.front_stage_xla)(gray, cfg)
    roi = D.roi_stage(front, cfg)
    br = (D.bridge_stage if kernels else D.bridge_stage_xla)(roi.mh, roi.mv, roi.circle_radius0, cfg)
    st = D.GridState(
        cents=front.cents, inside=roi.inside, bbox=roi.bbox, h_exp=br.h_exp, v_exp=br.v_exp,
        circle_radius0=roi.circle_radius0, gray=front.gray, bright_blur=front.bright_blur,
        warm_labels=br.warm_labels, bridge_angles=br.angles, n_pre=br.n_pre,
        binary=front.binary, mh=roi.mh, mv=roi.mv, carve_domain=roi.carve_domain)
    return st


def _copy_grid(res) -> dict:
    g = res.grid
    xy, idx, valid = g.xy[0].numpy(), g.idx[0].numpy(), g.valid[0].numpy()
    return {"ids": {(int(idx[i, 0]), int(idx[i, 1])): xy[i].astype(np.float64) for i in np.flatnonzero(valid)},
            "center": g.center[0].numpy().astype(np.float64)}


def detect_view(img: np.ndarray, detect: dict) -> dict:
    """One view: {"ids": {id: xy}, "center", "ok", "stable",
    "bridged_components"}."""
    cfg = detect_config(detect)
    gray = D._to_gray(torch.as_tensor(np.ascontiguousarray(img))[None])
    res, _ = D.grid_stage(_stages(gray, cfg), cfg)
    out = _copy_grid(res)
    out["ok"] = bool(res.ok[0])
    out["stable"] = bool(res.stable[0])
    out["bridged_components"] = int(res.bridged_components[0])
    return out


def rig(stereo) -> tuple:
    """(K1, K2, T_C2_C1) in float64 from the inputs' ``Stereo`` (K1, radial,
    tangential of camera 1, the same of camera 2, T_C2_C1; no distortion)."""
    k1, r1, t1, k2, r2, t2, t = stereo
    if any(np.any(np.asarray(d) != 0) for d in (r1, t1, r2, t2)):
        raise ValueError("the reference's rig has no lens distortion")
    return (np.asarray(k1, np.float64), np.asarray(k2, np.float64), np.asarray(t, np.float64))


def healthy(frame: dict, reg: dict) -> bool:
    d1, d2, fit = frame["detect1"], frame["detect2"], frame["fit"]
    return bool(d1["ok"] and d2["ok"] and d1["stable"] and d2["stable"]
                and fit["points_valid"].sum() >= reg["min_frame_points"]
                and np.all(np.isfinite(fit["params"]))
                and fit["mean_reproj_error"] <= reg["max_frame_reproj_px"])


def _frame(job) -> dict:
    a, b, stereo, detect, fit, registration = job
    exact_float32()
    with torch.inference_mode():
        d1, d2 = detect_view(a, detect), detect_view(b, detect)
    frame = {"detect1": d1, "detect2": d2, "fit": F.fit_frame(d1["ids"], d2["ids"], rig(stereo), fit_fields(fit))}
    frame["healthy"] = healthy(frame, registration_fields(registration))
    return frame


def _worker() -> None:
    torch.set_num_threads(1)


def poses(images1: np.ndarray, images2: np.ndarray, stereo, detect: dict, fit: dict, registration: dict,
          workers: int | None = None) -> List[dict]:
    """(F, H, W) frames of both views -> one {"detect1", "detect2", "fit",
    "healthy"} per frame, the frames shared among ``workers`` processes
    (default: one per core, at most 8), each started afresh and ended
    before this returns."""
    jobs = [(a, b, stereo, detect, fit, registration) for a, b in zip(images1, images2)]
    n = min(len(jobs), workers or min(os.cpu_count() or 1, 8))
    if n <= 1:
        return [_frame(j) for j in jobs]
    pool = multiprocessing.get_context("spawn").Pool(n, initializer=_worker)
    try:
        out = pool.map(_frame, jobs, chunksize=1)
        pool.close()
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
    return out


def summary(frame: dict) -> dict:
    """The stream's compact result of one frame (``StreamPoseSummary``)."""
    fit, d1, d2 = frame["fit"], frame["detect1"], frame["detect2"]
    return {
        "params0": fit["params0"], "params": fit["params"], "fvals": fit["fvals"], "t_cam_cyl": fit["t_cam_cyl"],
        "mean_reproj_error": fit["mean_reproj_error"], "n_points": int(fit["points_valid"].sum()),
        "ok": d1["ok"] and d2["ok"], "stable": d1["stable"] and d2["stable"],
        "bridged_components": d1["bridged_components"] + d2["bridged_components"],
        "healthy": frame["healthy"], "settled": fit["settled"], "center1": d1["center"], "center2": d2["center"],
    }


def registration(frames: List[dict], angles: np.ndarray, registration: dict) -> Dict[str, object]:
    """The multi-frame camera <-> AGV registration over the healthy frames."""
    pts = np.stack([f["fit"]["points3"] for f in frames])
    valid = np.stack([f["fit"]["points_valid"] for f in frames])
    ok = np.array([f["healthy"] for f in frames])
    return R.register(pts, valid, np.asarray(angles, np.float64), ok, registration_fields(registration))
