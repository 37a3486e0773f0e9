"""PyTorch port: the fit tail (correspondence -> triangulation -> cylinder fit)
against the JAX package on the same inputs.

Inputs: the JAX-detected grids of golden scenes 0-1 (the fixture's recorded
view-1/view-2 grid points) and noisy synthetic cylinder scenes, all made with
numpy / the JAX scene tools and handed to both packages.

Tolerances (float32 throughout, different summation orders):
  choose_idx            valid set, ids, fallback flag identical
  triangulate           points3 within 1e-3 mm, reprojection within 1e-4 px
  fit_single_cylinder   fvals rtol 1e-3, axis direction within 1e-3 rad,
                        mean reprojection within 1e-4 px.  The origin is not
                        compared: it slides along the axis (a gauge freedom).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu import types as jtypes
from cylinder_pose_estimation_tpu.config import FitConfig as JFitConfig
from cylinder_pose_estimation_tpu.geometry import correspond as jcorr
from cylinder_pose_estimation_tpu.geometry import curvature as jcurv
from cylinder_pose_estimation_tpu.geometry import transforms as jtr
from cylinder_pose_estimation_tpu.geometry import triangulate as jtri
from cylinder_pose_estimation_tpu.geometry import cylinder as jcyl
from cylinder_pose_estimation_tpu.models.pose import cylinder_axis_info as jaxis
from cylinder_pose_estimation_tpu.models.pose import fit_single_cylinder as jfit
from cylinder_pose_estimation_tpu.ops import linalg as jlin
from cylinder_pose_estimation_tpu.ops import polyfit as jpoly
from cylinder_pose_estimation_tpu.utils.synthetic import cylinder_grid_points, default_stereo
from cylinder_pose_estimation_tpu_torch.config import FitConfig, from_reference
from cylinder_pose_estimation_tpu_torch.geometry import correspond as tcorr
from cylinder_pose_estimation_tpu_torch.geometry import curvature as tcurv
from cylinder_pose_estimation_tpu_torch.geometry import transforms as ttr
from cylinder_pose_estimation_tpu_torch.geometry import triangulate as ttri
from cylinder_pose_estimation_tpu_torch.geometry import cylinder as tcyl
from cylinder_pose_estimation_tpu_torch.models.pose import cylinder_axis_info as taxis
from cylinder_pose_estimation_tpu_torch.models.pose import fit_single_cylinder as tfit
from cylinder_pose_estimation_tpu_torch.ops import linalg as tlin
from cylinder_pose_estimation_tpu_torch.ops import polyfit as tpoly
from cylinder_pose_estimation_tpu_torch.types import GridPoints, stereo_from_numpy

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_scenes.json")
CAP = 576  # the detector's max_rows * max_cols grid slots


def _t(x):
    return torch.as_tensor(np.array(x))


def _port_stereo(st):
    return stereo_from_numpy(*(np.asarray(x) for x in (
        st.cam1.k, st.cam1.radial, st.cam1.tangential,
        st.cam2.k, st.cam2.radial, st.cam2.tangential, st.t_c2_c1)), device="cpu")


def _port_gp(gp):
    """JAX GridPoints -> port GridPoints with a leading frame axis of 1."""
    return GridPoints(*(_t(x)[None] for x in gp))


def _golden_gp(records):
    xy = np.zeros((CAP, 2), np.float32)
    idx = np.zeros((CAP, 2), np.int32)
    valid = np.zeros((CAP,), bool)
    for i, r in enumerate(records):
        xy[i] = (r["x"], r["y"])
        idx[i] = r["id"]
        valid[i] = True
    return jtypes.GridPoints(jnp.asarray(xy), jnp.asarray(idx), jnp.asarray(valid),
                             jnp.zeros((2,), jnp.float32))


def _cases():
    """(name, jax gp1, jax gp2, jax stereo) fit-tail inputs."""
    with open(FIXTURE) as f:
        scenes = json.load(f)["scenes"]
    st = default_stereo(cx=320.0, cy=240.0)
    out = []
    for s in (0, 1):
        out.append((f"golden{s}", _golden_gp(scenes[s]["view1"]),
                    _golden_gp(scenes[s]["view2"]), st))
    st0 = default_stereo()
    for seed, (origin, direction) in enumerate([
        ((0.0, -60.0, 650.0), (0.05, 1.0, 0.02)),
        ((30.0, -40.0, 600.0), (-0.1, 1.0, 0.08)),
        ((-20.0, -50.0, 700.0), (0.2, 1.0, -0.05)),
    ]):
        sc = cylinder_grid_points(st0, origin=origin, direction=direction,
                                  noise_px=0.2, seed=seed, capacity=CAP)
        out.append((f"noisy{seed}", sc.gp1, sc.gp2, st0))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_choose_idx_matches(case):
    _, gp1, gp2, st = case
    j = jcorr.choose_idx(gp1, gp2, st, 3, 0.3, extent=24)
    t = tcorr.choose_idx(_port_gp(gp1), _port_gp(gp2), _port_stereo(st), 3, 0.3, extent=24)
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid[0].numpy())
    np.testing.assert_array_equal(np.asarray(j.idx), t.idx[0].numpy())
    assert bool(j.used_fallback) == bool(t.used_fallback[0])
    np.testing.assert_allclose(np.asarray(j.xy1), t.xy1[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(j.xy2), t.xy2[0].numpy(), atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_find_grid_correspondences_matches(case):
    _, gp1, gp2, _ = case
    j = jcorr.find_grid_correspondences(gp1, gp2, extent=24)
    t = tcorr.find_grid_correspondences(_port_gp(gp1), _port_gp(gp2), extent=24)
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid[0].numpy())
    np.testing.assert_array_equal(np.asarray(j.idx), t.idx[0].numpy())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_triangulate_matches(case):
    _, gp1, gp2, st = case
    c = jcorr.choose_idx(gp1, gp2, st, 3, 0.3, extent=24)
    j = jtri.triangulate(c.xy1, c.xy2, st, valid=c.valid)
    t = ttri.triangulate(_t(c.xy1), _t(c.xy2), _port_stereo(st), valid=_t(c.valid))
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())
    np.testing.assert_allclose(np.asarray(j.points3), t.points3.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(j.reproj_error), t.reproj_error.numpy(), atol=1e-4)


def _axis_angle(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return float(np.arccos(np.clip(abs(np.dot(a, b)), -1.0, 1.0)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fit_single_cylinder_matches(case):
    _, gp1, gp2, st = case
    cfg = JFitConfig()
    j = jax.jit(lambda a, b: jfit(a, b, st, cfg))(gp1, gp2)
    t = tfit(_port_gp(gp1), _port_gp(gp2), _port_stereo(st), from_reference(cfg))
    np.testing.assert_allclose(t.fvals[0].numpy(), np.asarray(j.fvals), rtol=1e-3)
    assert _axis_angle(np.asarray(j.params)[3:], t.params[0, 3:].numpy().astype(np.float64)) < 1e-3
    assert abs(float(j.mean_reproj_error) - float(t.mean_reproj_error[0])) < 1e-4
    np.testing.assert_array_equal(np.asarray(j.points_valid), t.points_valid[0].numpy())
    assert t.t_cam_cyl.shape == (1, 4, 4)


def test_fit_batches_frames_independently():
    """A 2-frame batch fits each frame as a 1-frame batch does (batched
    matmuls may sum in another order, so compare the fit's invariants)."""
    cases = CASES[:2]
    gps = [( _port_gp(c[1]), _port_gp(c[2])) for c in cases]
    st = _port_stereo(cases[0][3])
    both = tfit(GridPoints(*(torch.cat([gps[0][0][k], gps[1][0][k]]) for k in range(4))),
                GridPoints(*(torch.cat([gps[0][1][k], gps[1][1][k]]) for k in range(4))),
                st, FitConfig())
    for i, (g1, g2) in enumerate(gps):
        one = tfit(g1, g2, st, FitConfig())
        assert _axis_angle(both.params[i, 3:].numpy(), one.params[0, 3:].numpy()) < 1e-3
        np.testing.assert_allclose(both.fvals[i].numpy(), one.fvals[0].numpy(), rtol=1e-4)
        assert abs(float(both.mean_reproj_error[i]) - float(one.mean_reproj_error[0])) < 1e-6


# --- building blocks ------------------------------------------------------


def _spd_case(cond, seed):
    """Batch of SPD systems with eigenvalue spread ``cond`` and badly scaled
    columns (the LM normal equations mix curvature- and mm-scale columns)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(8, 6, 6)))
    a = (q * np.geomspace(1.0, cond, 6)[None, None, :]) @ np.swapaxes(q, -1, -2)
    s = np.geomspace(1.0, 1e3, 6)
    a = (a * s[None, :, None] * s[None, None, :]).astype(np.float32)
    return a, rng.normal(size=(8, 6)).astype(np.float32)


@pytest.mark.parametrize("cond", [1e1, 1e3])
def test_solve_spd_matches(cond):
    a, b = _spd_case(cond, 1)
    x_j = np.asarray(jlin.solve_spd(jnp.asarray(a), jnp.asarray(b)))
    x_t = tlin.solve_spd(_t(a), _t(b)).numpy()
    scale = np.abs(x_j).max(axis=-1, keepdims=True)
    assert np.all(np.abs(x_j - x_t) <= 1e-4 * scale)


@pytest.mark.parametrize("cond", [1e5, 1e7])
def test_solve_spd_backward_error_matches(cond):
    """Ill-conditioned: float32 solutions legitimately differ, so hold the
    port to the reference's backward error ||a x - b|| / (||a|| ||x||)
    (computed in float64), within a factor of 4."""
    a, b = _spd_case(cond, 2)
    x_j = np.asarray(jlin.solve_spd(jnp.asarray(a), jnp.asarray(b)), np.float64)
    x_t = tlin.solve_spd(_t(a), _t(b)).numpy().astype(np.float64)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)

    def berr(x):
        r = np.einsum("bij,bj->bi", a64, x) - b64
        return np.linalg.norm(r, axis=-1) / (np.linalg.norm(a64, axis=(-2, -1)) * np.linalg.norm(x, axis=-1))

    assert np.all(berr(x_t) <= 4.0 * berr(x_j) + 1e-7), (berr(x_t), berr(x_j))


def test_eigh2x2_and_pca_match():
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(size=16).astype(np.float32) for _ in range(3))
    ej, vj = jlin.eigh2x2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    et, vt = tlin.eigh2x2(_t(a), _t(b), _t(c))
    np.testing.assert_allclose(np.asarray(ej), et.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.abs(np.asarray(vj)), np.abs(vt.numpy()), atol=1e-5)
    pts = rng.normal(size=(40, 3)).astype(np.float32) * np.array([5.0, 2.0, 0.5], np.float32)
    valid = rng.uniform(size=40) < 0.8
    _, varj = jlin.pca_components(jnp.asarray(pts), jnp.asarray(valid))
    _, vart = tlin.pca_components(_t(pts), _t(valid))
    np.testing.assert_allclose(np.asarray(varj), vart.numpy(), rtol=1e-4)


@pytest.mark.parametrize("degree", [1, 2])
def test_polyfit_and_intersection_match(degree):
    rng = np.random.default_rng(degree)
    x = rng.uniform(50, 600, size=(6, 30)).astype(np.float32)
    y = (0.001 * (x - 300) ** 2 + 0.2 * x + 40 + rng.normal(0, 0.3, x.shape)).astype(np.float32)
    w = (rng.uniform(size=x.shape) < 0.8).astype(np.float32)
    cj = np.asarray(jpoly.masked_polyfit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), degree))
    ct = tpoly.masked_polyfit(_t(x), _t(y), _t(w), degree).numpy()
    xs = np.linspace(50, 600, 12, dtype=np.float32)
    np.testing.assert_allclose(np.polyval(ct[0], xs), np.polyval(cj[0], xs), atol=1e-3)
    col = np.array([1e-4, 0.05, 300.0][-(degree + 1):], np.float32)
    xj, yj = jpoly.poly_intersection(jnp.asarray(cj), jnp.asarray(col)[None], jnp.full((6,), 300.0))
    xt, yt = tpoly.poly_intersection(_t(cj), _t(col)[None], torch.full((6,), 300.0))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-3)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-3)


def test_transforms_match():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(5, 6)).astype(np.float32)
    v[0, :3] = 0.0
    v[1, :3] *= 1e-6
    tj = np.asarray(jtr.vec_to_transform(jnp.asarray(v)))
    tt = ttr.vec_to_transform(_t(v)).numpy()
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(ttr.transform_to_vec(_t(tj)).numpy(),
                               np.asarray(jtr.transform_to_vec(jnp.asarray(tj))), atol=1e-4)
    np.testing.assert_allclose(ttr.invert_transform(_t(tj)).numpy(),
                               np.asarray(jtr.invert_transform(jnp.asarray(tj))), atol=1e-4)
    cp = np.array([1.0, -50.0, 600.0, 0.1, 1.0, 0.05], np.float32)
    np.testing.assert_allclose(ttr.cyl_params_to_transform(_t(cp)).numpy(),
                               np.asarray(jtr.cyl_params_to_transform(jnp.asarray(cp))), atol=1e-5)


@pytest.mark.parametrize("case", CASES[2:], ids=IDS[2:])
def test_curvature_flat_direction_matches(case):
    _, gp1, gp2, st = case
    c = jcorr.choose_idx(gp1, gp2, st, 3, 0.3, extent=24)
    tri = jtri.triangulate(c.xy1, c.xy2, st, valid=c.valid)
    i = int(np.argmax(np.asarray(tri.valid)))
    j = jcurv.estimate_curvature_at(tri.points3, tri.valid, jnp.int32(i), k=20)
    t = tcurv.estimate_curvature_at(_t(tri.points3)[None], _t(tri.valid)[None],
                                    torch.tensor([i]), k=20)
    assert _axis_angle(np.asarray(j.flat_direction), t.flat_direction[0].numpy()) < 1e-3
    np.testing.assert_allclose(np.sort(np.abs(np.asarray(j.curvatures))),
                               np.sort(np.abs(t.curvatures[0].numpy())), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("case", CASES[2:], ids=IDS[2:])
def test_curvatures_all_points_match(case):
    _, gp1, gp2, st = case
    c = jcorr.choose_idx(gp1, gp2, st, 3, 0.3, extent=24)
    tri = jtri.triangulate(c.xy1, c.xy2, st, valid=c.valid)
    j = jcurv.estimate_curvatures(tri.points3, tri.valid, k=20)
    t = tcurv.estimate_curvatures(_t(tri.points3)[None], _t(tri.valid)[None], k=20)
    for i in np.flatnonzero(np.asarray(tri.valid))[:40]:
        assert _axis_angle(np.asarray(j.flat_direction)[i], t.flat_direction[0, i].numpy()) < 1e-3


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_triangulate_with_threshold_matches(case):
    _, gp1, gp2, st = case
    c = jcorr.find_grid_correspondences(gp1, gp2, extent=24)
    j = jtri.triangulate_with_threshold(c.xy1, c.xy2, st, 0.3, valid=c.valid)
    t = ttri.triangulate_with_threshold(_t(c.xy1)[None], _t(c.xy2)[None], _port_stereo(st), 0.3,
                                        valid=_t(c.valid)[None])
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid[0].numpy())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cylinder_axis_info_matches(case):
    _, gp1, gp2, st = case
    cfg = JFitConfig()
    j = jax.jit(lambda a, b: jaxis(a, b, st, cfg))(gp1, gp2)
    t = taxis(_port_gp(gp1), _port_gp(gp2), _port_stereo(st), from_reference(cfg))
    np.testing.assert_array_equal(np.asarray(j[1]), t[1][0].numpy())
    assert _axis_angle(np.asarray(j[4])[3:], t[4][0, 3:].numpy()) < 1e-3
    # Axis-segment length: invariant to the origin's slide along the axis.
    lj = np.linalg.norm(np.asarray(j[3]) - np.asarray(j[2]))
    lt = np.linalg.norm(t[3][0].numpy() - t[2][0].numpy())
    assert abs(lj - lt) < 1e-2 * max(lj, 1.0)
    ms_j = float(jcyl.mean_sq_residual(j[4], j[0], j[1], cfg.cyl_radius))
    ms_t = float(tcyl.mean_sq_residual(t[4], t[0], t[1], cfg.cyl_radius)[0])
    assert abs(ms_j - ms_t) <= 1e-3 * max(ms_j, 1e-3)
