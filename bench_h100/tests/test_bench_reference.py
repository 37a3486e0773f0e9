"""The plain reference on the CPU, at small sizes: its own fit and
registration recover known answers, and the whole reference agrees with the
port's CPU path on the same frames within the cells' limits."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100.common import compare
from bench_h100.common.drivers import take
from bench_h100.common.program import configs, port, rig, to_host
from bench_h100.inputs import scenes
from bench_h100.reference import fit as F
from bench_h100.reference import pipeline as ref
from bench_h100.reference import registration as R

BENCH = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def limits(cell):
    return {k: v for k, v in json.loads((BENCH / "limits" / f"{cell}.json").read_text()).items()
            if not k.startswith("_")}


def cylinder_points(org, axis, radius, n=60, seed=0):
    rng = np.random.default_rng(seed)
    """Points on the side of a cylinder that faces a camera at the origin
    looking along +z."""
    axis = axis / np.linalg.norm(axis)
    w = np.array([0.0, 0.0, -1.0]) + axis[2] * axis
    w /= np.linalg.norm(w)
    u = np.cross(axis, w)
    t, th = rng.uniform(-60, 60, n), rng.uniform(-1.0, 1.0, n)
    return org + t[:, None] * axis + radius * (np.cos(th)[:, None] * w + np.sin(th)[:, None] * u)


def test_fit_recovers_a_known_cylinder():
    org, axis = np.array([10.0, -40.0, 600.0]), np.array([0.05, 1.0, 0.1])
    pts = cylinder_points(org, axis, 45.0)
    p0, p, c0, c = F.fit_cylinder(pts, 45.0, 20, 20, 1e-3)
    assert c < 1e-12 < c0
    d = p[3:] / np.linalg.norm(p[3:])
    assert abs(abs(d @ axis / np.linalg.norm(axis)) - 1.0) < 1e-10
    assert np.abs(F.axis_distance(org[None], p[:3], p[3:])).max() < 1e-6


def test_an_unfinished_fit_is_not_settled():
    org, axis = np.array([10.0, -40.0, 600.0]), np.array([0.05, 1.0, 0.1])
    pts = cylinder_points(org, axis, 45.0)
    p0 = F.start(pts, 45.0, 20)
    f, j = (lambda q: F.residuals(q, pts, 45.0)), (lambda q: F.jacobian(q, pts))
    p1, _, c1 = F.levenberg_marquardt(f, j, p0, 1, 1e-3)
    p20, _, c20 = F.levenberg_marquardt(f, j, p0, 20, 1e-3)
    assert not F.settled(p1, c1, pts, 45.0, 1e-3)
    assert F.settled(p20, c20, pts, 45.0, 1e-3)


def test_triangulation_inverts_the_projection():
    stereo = scenes.default_stereo()
    k1, k2, t21 = ref.rig(stereo)
    pts = cylinder_points(np.array([0.0, -40.0, 560.0]), np.array([0.0, 1.0, 0.0]), 45.0)
    def proj(p, k):
        h = p @ k.T
        return h[:, :2] / h[:, 2:3]
    xy1, xy2 = proj(pts, k1), proj(pts @ t21[:3, :3].T + t21[:3, 3], k2)
    got, err = F.triangulate(xy1, xy2, k1, k2, t21)
    np.testing.assert_allclose(got, pts, atol=1e-8)
    assert err.max() < 1e-8


def test_registration_recovers_the_rig():
    angles = scenes.registration_angles(12).astype(np.float64)
    kin = [R.t_agv_cyl(a[0], a[1], 321.1, 143.1, 110.0) for a in angles]
    np.testing.assert_allclose(np.stack(kin), scenes.t_agv_cyl(angles[:, 0], angles[:, 1]), atol=1e-9)
    pts, valid = np.zeros((12, 80, 3)), np.zeros((12, 80), bool)
    for f, t in enumerate(kin):
        c = scenes.T_CAM_AGV @ t
        pts[f, :60] = cylinder_points(c[:3, 3], c[:3, 1], 45.0, seed=f)
        valid[f, :60] = True
    reg = dict(ref.registration_fields({}), lm_iters=80)
    out = R.register(pts, valid, angles, np.ones(12, bool), reg)
    np.testing.assert_allclose(out["t_cam_agv"], scenes.T_CAM_AGV, atol=1e-5)
    assert out["fval"] < 1e-10 and out["well_posed"]


@pytest.fixture(scope="module")
def p():
    torch.set_num_threads(4)
    return port()


@pytest.mark.parametrize("name", ["cyl480-kernels", "cyl480-default"])
def test_poses_agree_with_the_port(p, name):
    cfg = config(name)
    stereo, (a, b) = scenes.example_pair(n_frames=2, seed=2 ** 33 + 1, pans=[3.0, 12.0], radius=45.0)
    want = ref.poses(a, b, stereo, cfg["detect"], cfg["fit"], cfg["registration"], workers=1)
    dcfg, fcfg, rcfg = configs(p, cfg)
    got = to_host(p.pipeline.estimate_poses_batch(torch.as_tensor(a), torch.as_tensor(b), rig(p, stereo, "cpu"),
                                                  dcfg, fcfg))
    assert all(f["healthy"] for f in want)
    readings = compare.merge([compare.frame(take(got, f), want[f], cfg["registration"]) for f in range(2)])
    assert not compare.over(readings, limits(f"{name}.batch16")), readings
    summary = to_host(p.pipeline._summarize_batch(
        p.pipeline.estimate_poses_batch(torch.as_tensor(a), torch.as_tensor(b), rig(p, stereo, "cpu"), dcfg, fcfg),
        rcfg))
    readings = compare.merge([compare.summary(take(summary, f), ref.summary(want[f])) for f in range(2)])
    assert not compare.over(readings, limits("cyl480-kernels.stream64")), readings


def test_uint8_frames_agree_with_the_port(p):
    cfg = config("cyl480-kernels")
    stereo, (a, b) = scenes.example_pair(n_frames=1, seed=5, pans=[6.0], radius=45.0)
    a, b = np.clip(a, 0, 255).astype(np.uint8) + 3, np.clip(b, 0, 255).astype(np.uint8)
    want = ref.poses(a, b, stereo, cfg["detect"], cfg["fit"], cfg["registration"], workers=1)
    dcfg, fcfg, _ = configs(p, cfg)
    got = to_host(p.pipeline.estimate_poses_batch(torch.as_tensor(a), torch.as_tensor(b),
                                                  rig(p, stereo, "cpu"), dcfg, fcfg))
    readings = compare.frame(take(got, 0), want[0], cfg["registration"])
    assert not compare.over(readings, limits("cyl480-kernels.batch16")), readings


def test_registration_agrees_with_the_port(p):
    cfg = config("cyl480-kernels")
    angles = scenes.registration_angles(8)
    stereo, _, (a, b), _ = scenes.registration_sequence(8, seed=[9, 0, 0], angles=angles)
    poses = ref.poses(a, b, stereo, cfg["detect"], cfg["fit"], cfg["registration"], workers=2)
    want = ref.registration(poses, angles, cfg["registration"])
    dcfg, fcfg, rcfg = configs(p, cfg)
    batch, reg = p.pipeline.full_experiment(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(angles),
                                            rig(p, stereo, "cpu"), dcfg, fcfg, rcfg)
    batch = to_host(batch)
    readings = compare.merge([compare.frame(take(batch, f), poses[f], cfg["registration"]) for f in range(8)]
                             + [compare.registration(to_host(reg), want)])
    assert not compare.over(readings, limits("cyl480-kernels.experiment100")), readings


def test_reference_refuses_a_distorted_rig():
    stereo = scenes.default_stereo()
    with pytest.raises(ValueError):
        ref.rig(stereo._replace(cam1_radial=np.array([0.1, 0.0, 0.0], np.float32)))
