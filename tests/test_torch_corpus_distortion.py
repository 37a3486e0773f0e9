"""PyTorch port on the JAX package's distortion round trip
(tests/test_distortion_e2e.py, CPU): the same frames, rendered through a
forward-distorting lens by that file's ``_render_views``, run through the
port's ``ops.remap.undistort_image`` -> ``estimate_pose_stereo``.

The port's chain is held to JAX's jitted chain on the same frames: ids
identical, xy within 0.05 px and the fitted axis within 1e-3 rad.  Under
``jax.jit`` the undistortion's source coordinates move by up to 3e-5 px
(ROADMAP section 3), so the 1e-3 px detection contract does not hold after
it.  The port's chain also meets that file's ground-truth assertions: the
half-resolution k1=-1.2 frames against their zero-distortion control here,
the full-resolution k1=-0.3 absolute accuracy under ``slow``.  The
half-resolution frames and rig of ``tests/fixtures/torch_corpus_scenes.npz``
(``chip_smoke.py`` phase 17) equal these.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import grid_map, port_stereo
from cylinder_pose_estimation_tpu.utils.synthetic import cylinder_grid_points
from cylinder_pose_estimation_tpu_torch.config import from_reference
from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_pose_stereo
from cylinder_pose_estimation_tpu_torch.ops.remap import undistort_image
from test_distortion_e2e import (
    _EXTREME,
    _FULL_RES,
    _HALF_RES,
    _axis_err_deg,
    _detection_errors,
    _distorted_stereo,
    _render_views,
    _run_chain,
)

torch.set_num_threads(1)

CORPUS_FIXTURE = Path(__file__).parent / "fixtures" / "torch_corpus_scenes.npz"


def _port_chain(h, w, distorted, *, coeffs=_EXTREME, n_rows=9, n_cols=9, stride=1, subpixel=False, **scene_kw):
    """``_run_chain``'s frames through the port: returns (scene, result) in
    the JAX chain's form (a StereoPoseResult without a frame axis)."""
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig

    stereo = _distorted_stereo(h, w, coeffs)
    scene = cylinder_grid_points(stereo, capacity=256, n_rows=n_rows, n_cols=n_cols, **scene_kw)
    ncd = (n_cols - 1) * stride + 1
    dense = scene if stride == 1 else cylinder_grid_points(stereo, capacity=1024, n_rows=n_rows, n_cols=ncd,
                                                           **scene_kw)
    imgs = [torch.as_tensor(np.array(im, np.float32))
            for im in _render_views(dense, stereo, n_rows, ncd, h, w, stride, distorted)]
    st = port_stereo(stereo)
    if distorted:
        imgs = [undistort_image(imgs[0], st.cam1), undistort_image(imgs[1], st.cam2)]
    cfg = CylinderDetectConfig(height=h, width=w, subpixel_refine=subpixel)
    fit_cfg = FitConfig(cyl_radius=scene_kw["radius"])
    return scene, estimate_pose_stereo(imgs[0], imgs[1], st, from_reference(cfg), from_reference(fit_cfg))


def _unbatched_map(det):
    xy, idx, v = det.grid.xy.numpy(), det.grid.idx.numpy(), det.grid.valid.numpy()
    return {(int(idx[k, 0]), int(idx[k, 1])): xy[k].astype(np.float64) for k in range(len(v)) if v[k]}


def _hold(got, want, label):
    """The port's chain against JAX's: ids identical, xy within 0.05 px,
    ``ok`` and ``stable`` equal, axis within 1e-3 rad."""
    for view in ("detect1", "detect2"):
        g, w = _unbatched_map(getattr(got, view)), grid_map(getattr(want, view))
        assert set(g) == set(w), (label, view, sorted(set(g) ^ set(w)))
        d = max(np.abs(g[k] - w[k]).max() for k in w)
        assert d < 0.05, (label, view, d)
        for f in ("ok", "stable"):
            assert bool(getattr(getattr(got, view), f)) == bool(getattr(getattr(want, view), f)), (label, view, f)

    def axis(p):
        p = np.asarray(p, np.float64)[3:6]
        return p / np.linalg.norm(p)

    ang = np.arccos(min(1.0, abs(float(axis(got.fit.params.numpy()) @ axis(want.fit.params)))))
    assert ang < 1e-3, (label, ang)


class _NumpyView:
    """A port StereoPoseResult readable by test_distortion_e2e's helpers
    (``np.asarray`` of each leaf)."""

    def __init__(self, res):
        self.detect1, self.detect2, self.fit = res.detect1, res.detect2, res.fit


def test_distorted_roundtrip_matches_zero_distortion_control():
    h, w = 240, 320
    scene_d, res_d = _port_chain(h, w, True, **_HALF_RES)
    scene_c, res_c = _port_chain(h, w, False, **_HALF_RES)
    for label, got, distorted in (("distorted", res_d, True), ("control", res_c, False)):
        _hold(got, _run_chain(h, w, distorted, **_HALF_RES)[1], label)
    for res in (res_d, res_c):
        assert bool(res.detect1.ok) and bool(res.detect2.ok) and bool(res.detect1.stable)
    errs_d = _detection_errors(scene_d, _NumpyView(res_d))
    errs_c = _detection_errors(scene_c, _NumpyView(res_c))
    assert len(errs_d) >= 20
    assert np.median(errs_d) < 1.5 and np.max(errs_d) < 4.0
    assert np.median(errs_d) < np.median(errs_c) + 0.5
    assert _axis_err_deg(res_d, scene_d) < _axis_err_deg(res_c, scene_c) + 3.0
    assert float(res_d.fit.mean_reproj_error) < float(res_c.fit.mean_reproj_error) + 0.3
    np.testing.assert_allclose(res_d.fit.params[:3].numpy(), res_c.fit.params[:3].numpy(), atol=8.0)


@pytest.mark.slow
def test_distorted_roundtrip_full_resolution_absolute():
    scene, res = _port_chain(480, 640, True, **_FULL_RES)
    _hold(res, _run_chain(480, 640, True, **_FULL_RES)[1], "full resolution")
    assert bool(res.detect1.ok) and bool(res.detect2.ok)
    errs = _detection_errors(scene, _NumpyView(res), n_pts=13 * 9)
    assert len(errs) >= 30
    assert np.median(errs) < 0.5 and np.max(errs) < 5.0
    assert _axis_err_deg(res, scene) < 2.0
    assert float(res.fit.mean_reproj_error) < 0.5


def test_fixture_holds_the_half_resolution_frames():
    h, w = 240, 320
    stereo = _distorted_stereo(h, w)
    scene = cylinder_grid_points(stereo, capacity=256, n_rows=9, n_cols=9, **_HALF_RES)
    fx = np.load(CORPUS_FIXTURE)
    for tag, distorted in (("distorted", True), ("control", False)):
        views = _render_views(scene, stereo, 9, 9, h, w, 1, distorted)
        for i, v in enumerate(views):
            assert np.array_equal(fx[f"dist_{tag}_{i + 1}"], np.asarray(v, np.float32)), (tag, i)
    leaves = (stereo.cam1.k, stereo.cam1.radial, stereo.cam1.tangential, stereo.cam2.k, stereo.cam2.radial,
              stereo.cam2.tangential, stereo.t_c2_c1)
    for i, leaf in enumerate(leaves):
        assert np.array_equal(fx[f"dist_stereo_{i}"], np.asarray(leaf, np.float32)), i
    assert float(fx["dist_radius"]) == _HALF_RES["radius"]
