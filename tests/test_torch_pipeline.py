"""PyTorch port end to end: ``estimate_poses_batch`` on the CPU.

* Against tests/fixtures/golden_scenes.json with the contract of
  tests/test_golden_fixtures.py: id sets identical, xy within 0.05 px, fit
  params within 0.05, reprojection within 0.01 px.  Scenes 0-1 here, from
  both scene sources (``__graft_entry__._example_pair`` and the port's own
  ``utils/synthetic.example_pair``); scenes 2-5 and the gap scenes under
  ``slow``.  Measured max |dxy| against the fixture: 1.8e-4 px (scenes 0-1).
  Under ``slow`` the fit's direction vector is compared at the fixture's
  norm: the LM objective is invariant to |direction| (ops/lm.py), so its
  norm after 20 float32 steps is noise-driven.  Measured on the JAX package
  itself: golden grids of scene 3 perturbed by 1e-4 px move its params up to
  0.71 from the fixture (2 of 12 draws > 0.05); the port's scene 4 misses
  the raw 0.05 by 0.003 along |direction| alone, axis within 1e-3 rad.
* Against the JAX Pallas path (interpret mode) on a 240x320 stereo scene:
  ids identical, |dxy| <= 1e-3 px.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_pair
from tests.make_golden import apply_gap
from cylinder_pose_estimation_tpu.config import CylinderDetectConfig as JDetect
from cylinder_pose_estimation_tpu.config import FitConfig as JFit
from cylinder_pose_estimation_tpu.models.pipeline import estimate_pose_stereo as jpose
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)
from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, from_reference
from cylinder_pose_estimation_tpu_torch.models.pipeline import (
    estimate_pose_stereo,
    estimate_poses_batch,
)
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils import synthetic as tsyn

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_scenes.json")
CFG = CylinderDetectConfig(height=480, width=640, use_pallas=True)


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURE) as f:
        return {str(s["scene"]): s for s in json.load(f)["scenes"]}


def _port_stereo(st):
    return stereo_from_numpy(*(np.asarray(x) for x in (
        st.cam1.k, st.cam1.radial, st.cam1.tangential,
        st.cam2.k, st.cam2.radial, st.cam2.tangential, st.t_c2_c1)))


def _records(det, i):
    xy = det.grid.xy[i].numpy().astype(np.float64)
    idx = det.grid.idx[i].numpy()
    v = det.grid.valid[i].numpy()
    return {(int(idx[k, 0]), int(idx[k, 1])): xy[k] for k in range(len(v)) if v[k]}


def _check_view(det, i, records):
    got = _records(det, i)
    want = {tuple(r["id"]): (r["x"], r["y"]) for r in records}
    assert set(got) == set(want), f"+{set(got) - set(want)} -{set(want) - set(got)}"
    dxy = 0.0
    for k, (x, y) in want.items():
        d = max(abs(got[k][0] - x), abs(got[k][1] - y))
        assert d < 0.05, (k, got[k], (x, y))
        dxy = max(dxy, d)
    return dxy


def _check_scene(res, i, want, direction_at_golden_norm=False):
    dxy = max(_check_view(res.detect1, i, want["view1"]), _check_view(res.detect2, i, want["view2"]))
    got = res.fit.params[i].numpy().astype(np.float64)
    ref = np.asarray(want["fit_params"])
    if direction_at_golden_norm:
        got[3:] *= np.linalg.norm(ref[3:]) / np.linalg.norm(got[3:])
    np.testing.assert_allclose(got, ref, atol=0.05)
    assert abs(float(res.fit.mean_reproj_error[i]) - want["mean_reproj_px"]) < 0.01
    return dxy


def _run(i1, i2, st):
    return estimate_poses_batch(torch.as_tensor(np.asarray(i1)), torch.as_tensor(np.asarray(i2)),
                                st, CFG, FitConfig())


@pytest.fixture(scope="module")
def jax_scenes():
    stereo, (i1, i2) = _example_pair(480, 640, n_frames=2)
    return _port_stereo(stereo), i1, i2


@pytest.fixture(scope="module")
def port_scenes():
    st, (i1, i2) = tsyn.example_pair(480, 640, n_frames=2)
    return stereo_from_numpy(*st), i1, i2


@pytest.mark.parametrize("source", ["jax_scenes", "port_scenes"])
def test_golden_scenes_0_1(source, golden, request):
    st, i1, i2 = request.getfixturevalue(source)
    res = _run(i1, i2, st)
    dxy = max(_check_scene(res, s, golden[str(s)]) for s in range(2))
    print(f"{source}: max |dxy| vs golden {dxy:.2e} px")
    assert dxy < 1e-3
    for det in (res.detect1, res.detect2):
        assert bool(det.ok.all()) and bool(det.stable.all())
        assert int(det.bridged_components.sum()) == 0


@pytest.mark.slow
@pytest.mark.parametrize("s", range(2, 6))
def test_golden_scenes_2_5(s, golden):
    stereo, (i1, i2) = _example_pair(480, 640, n_frames=s + 1)
    res = _run(i1[s:s + 1], i2[s:s + 1], _port_stereo(stereo))
    _check_scene(res, 0, golden[str(s)], direction_at_golden_norm=True)


@pytest.fixture(scope="module")
def gap_result():
    stereo, (i1, i2) = _example_pair(480, 640, n_frames=1)
    return _run(apply_gap(i1[0])[None], apply_gap(i2[0])[None], _port_stereo(stereo))


@pytest.mark.slow
def test_golden_gap_scene_pallas(gap_result, golden):
    want = golden["gap0_pallas"]
    _check_scene(gap_result, 0, want, direction_at_golden_norm=True)
    nb = int(gap_result.detect1.bridged_components[0]) + int(gap_result.detect2.bridged_components[0])
    assert nb == want["bridged_components"]


@pytest.mark.slow
def test_golden_gap_scene_xla_record(gap_result, golden):
    """``gap0`` is the JAX XLA path's own record of the bridged scene.  The
    port runs the Pallas path, and on this bridged frame the two JAX
    backends themselves disagree in view 2 (40 vs 42 points, re-ranked
    columns; the bridged_components contract allows it).  So: view 1 and
    the bridged count meet gap0's record; view 2 meets gap0_pallas's."""
    want, want_p = golden["gap0"], golden["gap0_pallas"]
    assert {tuple(r["id"]) for r in want["view2"]} != {tuple(r["id"]) for r in want_p["view2"]}
    _check_view(gap_result.detect1, 0, want["view1"])
    _check_view(gap_result.detect2, 0, want_p["view2"])
    nb = int(gap_result.detect1.bridged_components[0]) + int(gap_result.detect2.bridged_components[0])
    assert nb == want["bridged_components"]


def _small_pair():
    h, w = 240, 320
    # A 40 mm baseline keeps the grid inside both 320-px views.
    st = default_stereo(cx=w / 2.0, cy=h / 2.0, baseline=40.0)
    sc = cylinder_grid_points(st, capacity=128, origin=(0.0, -15.0, 560.0), radius=52.0,
                              row_spacing=12.0, theta_span=2.2)
    rng = np.random.default_rng(7)
    imgs = []
    for gp in (sc.gp1, sc.gp2):
        img = np.asarray(render_grid_image(gp.xy, gp.valid, 9, 9, h, w), np.float32)
        imgs.append(np.clip(img + rng.normal(0, 2.0, (h, w)).astype(np.float32), 0, 255))
    return st, imgs[0], imgs[1]


def test_small_scene_matches_jax_pallas_path():
    st, a, b = _small_pair()
    jcfg = JDetect(height=240, width=320, use_pallas=True, pallas_interpret=True, min_ok_points=10)
    j = jax.jit(lambda x, y: jpose(x, y, st, jcfg, JFit()))(jnp.asarray(a), jnp.asarray(b))
    t = estimate_pose_stereo(torch.as_tensor(a), torch.as_tensor(b), _port_stereo(st),
                             from_reference(jcfg), FitConfig())
    for jd, td_ in ((j.detect1, t.detect1), (j.detect2, t.detect2)):
        want = {tuple(np.asarray(jd.grid.idx)[k]): np.asarray(jd.grid.xy)[k]
                for k in range(576) if bool(jd.grid.valid[k])}
        got = {tuple(td_.grid.idx.numpy()[k]): td_.grid.xy.numpy()[k]
               for k in range(576) if bool(td_.grid.valid[k])}
        assert len(want) >= 30 and set(got) == set(want)
        assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-3
        assert bool(td_.ok) == bool(jd.ok)
    assert abs(float(t.fit.mean_reproj_error) - float(j.fit.mean_reproj_error)) < 1e-4
    ja = np.asarray(j.fit.params)[3:]
    ta = t.fit.params[3:].numpy()
    cos = abs(np.dot(ja, ta)) / (np.linalg.norm(ja) * np.linalg.norm(ta))
    assert np.arccos(min(cos, 1.0)) < 1e-3


def test_detect_probe_returns_stacked_views(jax_scenes):
    st, i1, i2 = jax_scenes
    det = estimate_poses_batch(torch.as_tensor(i1), torch.as_tensor(i2), st, CFG, FitConfig(),
                               probe="detect")
    assert det.grid.xy.shape == (4, 576, 2)
    full = _run(i1, i2, st)
    np.testing.assert_array_equal(det.grid.valid[2:].numpy(), full.detect2.grid.valid.numpy())
    np.testing.assert_array_equal(det.grid.idx[:2].numpy(), full.detect1.grid.idx.numpy())
