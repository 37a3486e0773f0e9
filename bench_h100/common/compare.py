"""The comparison that decides ``correct``: the program's answers against
the plain reference's, as numbers, each judged against its limit.

An answer is one frame's detection and fit (the batch cells), one frame's
stream summary (the stream cell) or one experiment's poses and
registration.  Its readings:

- ``ids``: views whose set of valid grid ids differs (a count);
- ``flags``: differing ``ok``, ``stable``, ``bridged_components`` of a
  view, and frames whose health (``frame_health``) differs (a count);
- ``points``: frames whose points used in the fit differ (a count);
- ``xy_px``: the widest gap of a grid point (same id) or grid centre, px;
- ``tcyl``: the widest gap of an entry of T_Cam_cyl, the fitted cylinder
  (its origin in mm, its unit axis and the frame built on it);
- ``params0``: the widest gap of the initial cylinder parameters (the
  curvature initialisation);
- ``reproj_px``: the widest gap of the mean reprojection error, px;
- ``fval_rel``, ``fval0_rel``: the widest gap of the fit's objective at
  the solution, and at the initialisation, over the reference's;
- ``reg_rot``, ``reg_mm``, ``reg_fval_rel``, ``reg_flags``: the
  registration's T_Cam_AGV rotation entries and translation (mm), its
  objective, and a differing ``well_posed``.

The fit's numbers (``tcyl``, ``params0``, ``reproj_px`` and the
objectives) are compared on the frames that the reference finds healthy,
the end point of the fit (``tcyl``, ``fval_rel``) on those where the
reference's fixed-step fit has settled (``reference/fit.py``):
the fit of a frame that fails ``frame_health`` (few points, unstable
lines) is ill-posed, the registration leaves it out, and its parameters
swing by metres between two roundings; that a frame's health agrees is
in ``flags``.  The fitted axis is compared through T_Cam_cyl and not as
the raw parameters, whose direction vector has a free scale.  Where the
traffic says so (``"compare_detection": "healthy"``: the pan/tilt sweep,
two thirds of whose frames fail ``frame_health``), ``ids``, ``xy_px`` and
``points`` too are read on healthy frames only: on a sweep frame that both
sides found unhealthy, one view's ids read 61 px apart between the card
and the CPU on one of twelve seeds.  Counts add
up over answers, gaps take the widest; a value that is NaN on one side
only is an infinite gap.  Each number's limit is in
``limits/<cell>.json``, with the readings it was set from.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

COUNTS = ("ids", "flags", "points", "reg_flags")


def gap(a, b) -> float:
    """Widest |a - b|; equal NaNs count as equal, a NaN on one side as inf."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    na, nb = np.isnan(a), np.isnan(b)
    if np.any(na != nb):
        return float("inf")
    d = np.abs(np.where(na, 0.0, a) - np.where(nb, 0.0, b))
    return float(d.max())


def rel_gap(a, b, floor: float = 1e-6) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.maximum(np.abs(np.where(np.isnan(b), 0.0, b)), floor)
    return gap(a / scale, b / scale)


def _flags(p: dict, r: dict) -> int:
    return sum(int(np.any(np.asarray(p[f]) != np.asarray(r[f]))) for f in ("ok", "stable", "bridged_components"))


def _view(p: dict, r: dict) -> Dict[str, float]:
    """One view's grid: the program's ``DetectResult`` of it (NumPy)
    against the reference's ({"ids": {id: xy}, "center", flags})."""
    pg = p["grid"]
    pids = {tuple(int(v) for v in i): xy for i, xy, v in zip(pg["idx"].tolist(), pg["xy"], pg["valid"]) if v}
    rids = r["ids"]
    common = sorted(set(pids) & set(rids))
    xy = max([gap(pids[k], rids[k]) for k in common] + [gap(pg["center"], r["center"])])
    return {"ids": int(set(pids) != set(rids)), "xy_px": xy}


def _fit(p: dict, r: dict, healthy: bool) -> Dict[str, float]:
    """The fit's numbers of one frame, if the reference finds it healthy;
    its end point (``tcyl``, ``fval_rel``) only where the reference's fit
    has settled within its steps."""
    if not healthy:
        return {}
    out = {
        "params0": gap(p["params0"], r["params0"]),
        "reproj_px": gap(p["mean_reproj_error"], r["mean_reproj_error"]),
        "fval0_rel": rel_gap(p["fvals"][..., 0], r["fvals"][..., 0]),
    }
    if r["settled"]:
        out["tcyl"] = gap(p["t_cam_cyl"], r["t_cam_cyl"])
        out["fval_rel"] = rel_gap(p["fvals"][..., 1], r["fvals"][..., 1])
    return out


def healthy(res: dict, registration: dict) -> bool:
    """``frame_health`` of one frame of the program's pose result (no frame
    axis)."""
    fit, d1, d2 = res["fit"], res["detect1"], res["detect2"]
    return bool(d1["ok"] and d2["ok"] and d1["stable"] and d2["stable"]
                and fit["points_valid"].sum() >= registration["min_frame_points"]
                and np.all(np.isfinite(fit["params"]))
                and fit["mean_reproj_error"] <= registration["max_frame_reproj_px"])


def frame(p: dict, r: dict, registration: dict, detection: str = "all") -> Dict[str, float]:
    """One frame: the program's pose result ({"detect1", "detect2", "fit"},
    no frame axis) against the reference's (``reference.pipeline.poses``);
    ``registration``: the configuration's fields, for the health gate;
    ``detection``: "all" or "healthy", the frames whose grids and points
    are compared."""
    h = bool(r["healthy"])
    out = [{"flags": int(healthy(p, registration) != h) + _flags(p["detect1"], r["detect1"])
            + _flags(p["detect2"], r["detect2"])}, _fit(p["fit"], r["fit"], h)]
    if detection == "all" or h:
        out += [_view(p["detect1"], r["detect1"]), _view(p["detect2"], r["detect2"]),
                {"points": int(np.any(p["fit"]["points_valid"] != r["fit"]["points_valid"]))}]
    return merge(out)


def summary(p: dict, r: dict) -> Dict[str, float]:
    """One frame of the stream's summary (no frame axis)."""
    flags = sum(int(np.any(np.asarray(p[f]) != np.asarray(r[f])))
                for f in ("ok", "stable", "bridged_components", "healthy"))
    out = {
        "flags": flags,
        "points": int(p["n_points"] != r["n_points"]),
        "xy_px": max(gap(p["center1"], r["center1"]), gap(p["center2"], r["center2"])),
    }
    out.update(_fit(p, r, bool(r["healthy"])))
    return out


def registration(p: dict, r: dict) -> Dict[str, float]:
    pt, rt = np.asarray(p["t_cam_agv"]), np.asarray(r["t_cam_agv"])
    return {
        "reg_rot": gap(pt[:3, :3], rt[:3, :3]),
        "reg_mm": gap(pt[:3, 3], rt[:3, 3]),
        "reg_fval_rel": rel_gap(p["fval"], r["fval"]),
        "reg_flags": int(bool(p["well_posed"]) != bool(r["well_posed"])),
    }


def merge(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for rd in readings:
        for k, v in rd.items():
            if k in COUNTS:
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


def over(readings: Dict[str, float], limits: Dict[str, dict]) -> List[str]:
    """Names of the numbers above their limit, or with no limit set."""
    return [k for k, v in readings.items()
            if k not in limits or not (v <= limits[k]["limit"])]


def table(readings: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} in a fixed order, for the result line."""
    return {k: {"value": readings[k], "limit": limits.get(k, {}).get("limit")} for k in sorted(readings)}
