"""PyTorch port: the numpy scene source agrees with the JAX package's.

``utils/synthetic.example_pair`` is the GPU machine's source of scenes (the
JAX one cannot run there).  Its images agree with
``__graft_entry__._example_pair`` except for a few pixels that differ by one
grey level: float32 exp/sin from numpy and from XLA can round differently
before the uint8 truncation.  Measured at 480x640, 2 frames: 43 pixels of
view 1 and 42 of view 2 differ (85 of 1,228,800 over both frames and views),
none by more than 1.
"""

import numpy as np
import pytest

from __graft_entry__ import _example_pair
from tests.make_golden import GAP as JAX_GAP
from tests.make_golden import apply_gap as jax_apply_gap
from cylinder_pose_estimation_tpu.utils import synthetic as jsyn
from cylinder_pose_estimation_tpu_torch.utils import synthetic as tsyn

# Bound on differing pixels per 480x640 view (measured maximum 43, see above).
MAX_DIFF_PER_VIEW = 100


@pytest.fixture(scope="module")
def pairs():
    return tsyn.example_pair(480, 640, n_frames=2), _example_pair(480, 640, n_frames=2)


def test_example_pair_matches_reference(pairs):
    (st, (a1, a2)), (jst, (b1, b2)) = pairs
    total = 0
    for x, y in ((a1, b1), (a2, b2)):
        assert x.shape == y.shape == (2, 480, 640) and x.dtype == np.float32
        d = np.abs(x.astype(np.float64) - np.asarray(y, np.float64))
        assert d.max() <= 1.0 + 1e-4, d.max()
        per_view = (d > 0).reshape(2, -1).sum(axis=1)
        assert per_view.max() <= MAX_DIFF_PER_VIEW, per_view
        total += int(per_view.sum())
    assert total <= 4 * MAX_DIFF_PER_VIEW


def test_default_stereo_matches_reference(pairs):
    (st, _), (jst, _) = pairs
    want = [jst.cam1.k, jst.cam1.radial, jst.cam1.tangential,
            jst.cam2.k, jst.cam2.radial, jst.cam2.tangential, jst.t_c2_c1]
    for a, b in zip(st, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("pan", [0.0, 3.0, 7.0])
def test_cylinder_grid_points_match_reference(pan):
    st = tsyn.default_stereo(cx=320.0, cy=240.0)
    jst = jsyn.default_stereo(cx=320.0, cy=240.0)
    kw = dict(origin=(10.0 * pan, -40.0, 560.0), radius=70.0, row_spacing=18.0, theta_span=2.0)
    sc = tsyn.cylinder_grid_points(st, **kw)
    jsc = jsyn.cylinder_grid_points(jst, capacity=128, **kw)
    n = 81
    np.testing.assert_allclose(sc.xy1, np.asarray(jsc.gp1.xy)[:n], atol=1e-3)
    np.testing.assert_allclose(sc.xy2, np.asarray(jsc.gp2.xy)[:n], atol=1e-3)
    np.testing.assert_array_equal(sc.idx, np.asarray(jsc.gp1.idx)[:n])
    np.testing.assert_allclose(sc.cyl_params, np.asarray(jsc.cyl_params), atol=1e-6)


def test_apply_gap_matches_reference(pairs):
    (_, (a1, _)), _ = pairs
    assert tsyn.GAP == JAX_GAP
    np.testing.assert_array_equal(tsyn.apply_gap(a1[0]), jax_apply_gap(a1[0]))
