"""Host-side I/O of the reference's JSON contracts (port of the JAX package's
utils/io.py).

* camera JSON ``{"LeftCamera": {...}, "RightCamera": {...}}`` with the
  3x3 IntrinsicMatrix (or FocalLength/PrincipalPoint), RadialDistortion and
  TangentialDistortion, plus this package's optional ``PoseCamera2`` and
  calibration artifacts (ref utils/createCameraDataJSON.m:7-12,
  utils/iotool.py:8-20);
* grid-point JSON ``{"center_point": [x, y], "points": [{"id": "(i,j)",
  "x": ..., "y": ...}, ...]}`` (ref utils/util_cylinder.py:1674-1727).

For the same rig and points the text written here equals the JAX package's
byte for byte: the same key order and the same floats, taken from float32
values.  The loaders build tensors on ``device`` (the card unless the
caller asks for the CPU) in ``dtype``.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Tuple

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.types import CameraModel, GridPoints, StereoParams


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def camera_from_dict(d: Dict, device="cuda", dtype=torch.float32) -> CameraModel:
    """One camera's JSON dict -> CameraModel.  Reads the reference's
    ``IntrinsicMatrix`` (standard row-major) or the older
    FocalLength/PrincipalPoint pair."""
    if "IntrinsicMatrix" in d:
        k = np.asarray(d["IntrinsicMatrix"], np.float32)
    else:
        fx, fy = d["FocalLength"]
        cx, cy = d["PrincipalPoint"]
        k = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)
    radial = np.zeros(3, np.float32)
    rd = np.asarray(d.get("RadialDistortion", []), np.float32).ravel()
    radial[: rd.shape[0]] = rd[:3]
    tang = np.zeros(2, np.float32)
    tg = np.asarray(d.get("TangentialDistortion", []), np.float32).ravel()
    tang[: tg.shape[0]] = tg[:2]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return CameraModel(k=t(k), radial=t(radial), tangential=t(tang))


def load_camera_json(path: str, device="cuda", dtype=torch.float32) -> Tuple[CameraModel, CameraModel]:
    """Load the Left/Right camera JSON (ref utils/iotool.py:8-20)."""
    with open(path) as f:
        data = json.load(f)
    return (camera_from_dict(data["LeftCamera"], device, dtype),
            camera_from_dict(data["RightCamera"], device, dtype))


def load_stereo_json(path: str, device="cuda", dtype=torch.float32) -> StereoParams:
    """Camera JSON with the stereo extrinsics: ``PoseCamera2`` (4x4
    row-major camera-1 -> camera-2, identity when absent) and the optional
    calibration artifacts PatternExtrinsics1/2 and WorldPoints."""
    with open(path) as f:
        data = json.load(f)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype, device=device)

    def opt(key):
        v = data.get(key)
        return None if v is None else t(v)

    return StereoParams(
        cam1=camera_from_dict(data["LeftCamera"], device, dtype),
        cam2=camera_from_dict(data["RightCamera"], device, dtype),
        t_c2_c1=t(data.get("PoseCamera2", np.eye(4).tolist())),
        t_c1_patterns=opt("PatternExtrinsics1"),
        t_c2_patterns=opt("PatternExtrinsics2"),
        calib_points=opt("WorldPoints"),
    )


def save_stereo_json(path: str, stereo: StereoParams) -> None:
    """Inverse of ``load_stereo_json``, with the reference's field names."""

    def cam_dict(cam: CameraModel) -> Dict:
        k = _host(cam.k)
        return {
            "IntrinsicMatrix": k.tolist(),
            # Duplicates for older readers.
            "FocalLength": [float(k[0, 0]), float(k[1, 1])],
            "PrincipalPoint": [float(k[0, 2]), float(k[1, 2])],
            "RadialDistortion": _host(cam.radial).tolist(),
            "TangentialDistortion": _host(cam.tangential).tolist(),
            "ImageSize": [],
        }

    data = {
        "LeftCamera": cam_dict(stereo.cam1),
        "RightCamera": cam_dict(stereo.cam2),
        "PoseCamera2": _host(stereo.t_c2_c1).tolist(),
    }
    for key, val in (
        ("PatternExtrinsics1", stereo.t_c1_patterns),
        ("PatternExtrinsics2", stereo.t_c2_patterns),
        ("WorldPoints", stereo.calib_points),
    ):
        if val is not None:
            data[key] = _host(val).tolist()
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def grid_points_to_json(gp: GridPoints) -> str:
    """One view's grid points (no batch axis) in the reference's JSON: points
    sorted by (id_x, id_y), ids as "(i,j)", the centre point first
    (ref utils/util_cylinder.py:1674-1727 make_json)."""
    xy = _host(gp.xy)
    idx = _host(gp.idx)
    valid = _host(gp.valid)
    if xy.ndim != 2:
        raise ValueError(f"grid_points_to_json takes one view, got xy of shape {xy.shape}")
    entries = [
        (int(idx[i, 0]), int(idx[i, 1]), float(xy[i, 0]), float(xy[i, 1]))
        for i in range(xy.shape[0])
        if valid[i]
    ]
    entries.sort(key=lambda e: (e[0], e[1]))
    center = _host(gp.center)
    return json.dumps(
        {
            "center_point": [float(center[0]), float(center[1])],
            "points": [{"id": f"({ix},{iy})", "x": x, "y": y} for ix, iy, x, y in entries],
        }
    )


_ID_RE = re.compile(r"\(?\[?\s*(-?\d+)\s*,\s*(-?\d+)\s*\]?\)?")


def grid_points_from_json(text: str, capacity: int = 512, device="cuda",
                          dtype=torch.float32) -> GridPoints:
    """The grid-point JSON as a dense GridPoints of ``capacity`` slots.
    Accepts both the "(i,j)" and the "[i,j]" id spellings (the reference
    writes both across versions; ref utils/pointsStruct2mat.m:20-30)."""
    data = json.loads(text)
    pts = data.get("points", [])
    n = min(len(pts), capacity)
    xy = np.zeros((capacity, 2), np.float32)
    idx = np.zeros((capacity, 2), np.int32)
    valid = np.zeros((capacity,), bool)
    for i, p in enumerate(pts[:n]):
        m = _ID_RE.match(str(p["id"]))
        if not m:
            continue
        idx[i] = (int(m.group(1)), int(m.group(2)))
        xy[i] = (float(p["x"]), float(p["y"]))
        valid[i] = True
    center = np.asarray(data.get("center_point", [0.0, 0.0]), np.float32)
    return GridPoints(
        xy=torch.as_tensor(xy, dtype=dtype, device=device),
        idx=torch.as_tensor(idx, device=device),
        valid=torch.as_tensor(valid, device=device),
        center=torch.as_tensor(center, dtype=dtype, device=device),
    )
