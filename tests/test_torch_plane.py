"""PyTorch port: plane mode (``PlaneDetectConfig``) against the JAX package.

* ``_merge_short_column_leaders`` on seeded random spans with ties and
  invalid slots, and ``_roi_plane_from_labels``: exact;
* plane ``detect_grid`` at 240x320 (``roi_threshold=30``, the JAX package's
  own plane tests' value) against the Pallas path in interpret mode, on the
  plane scene of tests/test_detector.py and on the fragmented-column scene of
  tests/test_detect_oracle.py, and on a column cut by a gap that a short
  bridge kernel leaves open (the short-column merge fires), with and without
  ``bridge_endpoint_stats``: ids identical, xy within 1e-3 px, the same
  flags and counts;
* the numpy scene source (``plane_grid_points``, the saturated centre) and
  ``fit_plane``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.config import PlaneDetectConfig
from cylinder_pose_estimation_tpu.geometry.plane import fit_plane as jfit_plane
from cylinder_pose_estimation_tpu.models import detector as jd
from cylinder_pose_estimation_tpu.utils import synthetic as jsyn
from cylinder_pose_estimation_tpu_torch.config import from_reference
from cylinder_pose_estimation_tpu_torch.geometry.plane import fit_plane
from cylinder_pose_estimation_tpu_torch.models import detector as td
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf
from cylinder_pose_estimation_tpu_torch.utils import synthetic as tsyn

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W = 240, 320
JCFG = PlaneDetectConfig(height=H, width=W, roi_threshold=30.0, use_pallas=True,
                         pallas_interpret=True)
JCFG_EP = PlaneDetectConfig(height=H, width=W, roi_threshold=30.0, use_pallas=True,
                            pallas_interpret=True, bridge_endpoint_stats=True)


def _plane_img(gap_col=None, saturate=False, seed=3, cut_col=None):
    """tests/test_detector.py's plane scene (``gap_col=None``) and
    tests/test_detect_oracle.py's (saturated centre, fragmented column);
    ``cut_col`` blanks that column between grid rows 2 and 3."""
    st = jsyn.default_stereo(cx=W / 2.0, cy=H / 2.0)
    sc = jsyn.plane_grid_points(st, capacity=256, n_rows=9, n_cols=9, spacing=23.0)
    img = np.asarray(jsyn.render_grid_image(sc.gp1.xy, sc.gp1.valid, 9, 9, H, W,
                                            saturate_center=saturate), np.float32)
    img = img + np.random.default_rng(seed).normal(0, 2.0, (H, W)).astype(np.float32)
    if gap_col is not None:
        x0 = float(np.asarray(sc.gp1.xy).reshape(-1, 2)[4 * 9 + gap_col, 0])
        img[60:72, int(x0) - 3:int(x0) + 4] *= 0.05
    if cut_col is not None:
        g = np.asarray(sc.gp1.xy)[:81].reshape(9, 9, 2)
        ya, yb = sorted([g[2, cut_col, 1], g[3, cut_col, 1]])
        x0 = int(g[2, cut_col, 0])
        img[int(ya) + 5:int(yb) - 5, x0 - 5:x0 + 6] = 18.0
    return np.clip(img, 0, 255).astype(np.float32)


# --------------------------------------------------------------------------
# Bookkeeping pieces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_merge_short_column_leaders_matches(seed):
    rng = np.random.default_rng(seed)
    v, c = 16, 24
    # Spans from a small set (ties, several short ones), some columns much
    # longer; mean x with ties; invalid slots anywhere.
    span = rng.choice([40.0, 60.0, 90.0, 120.0, 250.0, 300.0], size=(v, c)).astype(np.float32)
    mean_x = rng.integers(0, 12, size=(v, c)).astype(np.float32) * 25.0
    valid = rng.uniform(size=(v, c)) < 0.8
    span = np.where(valid, span, 0.0).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda s, m, ok: jd._merge_short_column_leaders(s, m, ok, c)))(
        jnp.asarray(span), jnp.asarray(mean_x), jnp.asarray(valid)))
    got = td._merge_short_column_leaders(torch.as_tensor(span), torch.as_tensor(mean_x),
                                         torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != np.arange(c)).any(), "the draw must merge some columns"


@pytest.mark.parametrize("case", ["scene", "specks"])
def test_roi_plane_from_labels_matches(case):
    if case == "scene":
        th = _plane_img(saturate=True) > 30.0
    else:
        rng = np.random.default_rng(5)
        th = rng.uniform(size=(H, W)) < 0.02
        th[40:180, 60:260] |= rng.uniform(size=(140, 200)) < 0.9
    seed4 = td._pool4_pad(torch.as_tensor(th)[None])
    ring = td._ring_mask(*seed4.shape[-2:], "cpu")
    labels = tf.connected_components((seed4 & ring).to(torch.float32), 2, 4)
    want = np.asarray(jax.jit(lambda t, lab: jd._roi_plane_from_labels(t, lab, JCFG))(
        jnp.asarray(th), jnp.asarray(labels[0].numpy())))
    got = td._roi_plane_from_labels(torch.as_tensor(th)[None], labels, from_reference(JCFG))
    assert want.sum() > 1000
    np.testing.assert_array_equal(got[0].numpy(), want)


# --------------------------------------------------------------------------
# The plane detector
# --------------------------------------------------------------------------

# name -> (image, config overrides).  "cut": a 5 px bridge kernel leaves the
# gap open, so the column's two fragments are short labels that merge.
_SCENES = {
    "plane": (lambda: _plane_img(), {}),
    "fragmented": (lambda: _plane_img(gap_col=2, saturate=True), {}),
    "cut": (lambda: _plane_img(cut_col=2), {"bridge_kernel_base": 5}),
}


def _grid_map(xy, idx, valid):
    return {tuple(int(a) for a in idx[k]): xy[k] for k in range(len(valid)) if valid[k]}


@pytest.mark.parametrize("cfg", [JCFG, JCFG_EP], ids=["moments", "endpoint"])
@pytest.mark.parametrize("scene", list(_SCENES))
def test_plane_detect_grid_matches(scene, cfg, monkeypatch):
    make, overrides = _SCENES[scene]
    img = make()
    cfg = dataclasses.replace(cfg, **overrides)
    merged = []
    merge = td._merge_short_column_leaders

    def spy(span, mean_x, valid):
        leader = merge(span, mean_x, valid)
        merged.append(int((leader != torch.arange(leader.shape[-1])).sum()))
        return leader

    monkeypatch.setattr(td, "_merge_short_column_leaders", spy)
    res = jax.tree.map(np.asarray, jax.jit(lambda im: jd.detect_grid(im, cfg))(jnp.asarray(img)))
    out = td.detect_grid(torch.as_tensor(img)[None], from_reference(cfg))
    assert (merged[0] > 0) == (scene == "cut")
    want = _grid_map(res.grid.xy, res.grid.idx, res.grid.valid)
    got = _grid_map(out.grid.xy[0].numpy(), out.grid.idx[0].numpy(), out.grid.valid[0].numpy())
    assert len(want) >= 50 and set(got) == set(want)
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-3
    np.testing.assert_allclose(out.grid.center[0].numpy(), res.grid.center, atol=1e-3)
    for flag in ("ok", "stable", "labels_converged"):
        assert bool(getattr(out, flag)[0]) == bool(getattr(res, flag)), flag
    assert int(out.bridged_components[0]) == int(res.bridged_components)
    np.testing.assert_array_equal(out.roi_bbox[0].numpy(), res.roi_bbox)


# --------------------------------------------------------------------------
# Scene source and plane fit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_rows=9, n_cols=9, spacing=23.0),
    dict(origin=(20.0, -10.0, 720.0), normal=(-0.1, 0.05, -1.0), n_rows=9, n_cols=11, spacing=32.0),
])
def test_plane_grid_points_match_reference(kw):
    st = tsyn.default_stereo(cx=320.0, cy=240.0)
    jst = jsyn.default_stereo(cx=320.0, cy=240.0)
    sc = tsyn.plane_grid_points(st, **kw)
    jsc = jsyn.plane_grid_points(jst, capacity=128, **kw)
    n = kw["n_rows"] * kw["n_cols"]
    np.testing.assert_allclose(sc.xy1, np.asarray(jsc.gp1.xy)[:n], atol=1e-3)
    np.testing.assert_allclose(sc.xy2, np.asarray(jsc.gp2.xy)[:n], atol=1e-3)
    np.testing.assert_array_equal(sc.idx, np.asarray(jsc.gp1.idx)[:n])
    np.testing.assert_allclose(sc.pts3, np.asarray(jsc.pts3)[:n], atol=1e-3)
    np.testing.assert_allclose(sc.plane, np.asarray(jsc.plane), atol=1e-5)


def test_render_saturated_center_matches_reference():
    st = tsyn.default_stereo(cx=W / 2.0, cy=H / 2.0)
    sc = tsyn.plane_grid_points(st, n_rows=9, n_cols=9, spacing=23.0)
    got = tsyn.render_grid_image(sc.xy1, 9, 9, H, W, saturate_center=True)
    want = np.asarray(jsyn.render_grid_image(jnp.asarray(sc.xy1), jnp.ones(81, bool), 9, 9, H, W,
                                             saturate_center=True))
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    # float32 exp may round differently in numpy and XLA before the uint8 cut.
    assert d.max() <= 1 and (d > 0).sum() <= 50
    assert (got == 255).sum() >= 500  # a disk of radius 8 * 1.6 px


@pytest.mark.parametrize("seed", range(3))
def test_fit_plane_matches(seed):
    rng = np.random.default_rng(seed)
    n = np.array([0.1, -0.2, -1.0]) + rng.normal(0, 0.1, 3)
    n /= np.linalg.norm(n)
    u = np.cross(n, [1.0, 0.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    ab = rng.uniform(-80, 80, size=(4, 64, 2))
    pts = (np.array([5.0, -3.0, 700.0]) + ab[..., :1] * u + ab[..., 1:] * v
           + rng.normal(0, 0.3, (4, 64, 3))).astype(np.float32)
    valid = rng.uniform(size=(4, 64)) < 0.8
    pts[~valid] = 1e3  # masked points must not matter
    want = np.asarray(jfit_plane(jnp.asarray(pts), jnp.asarray(valid)))
    got = fit_plane(torch.as_tensor(pts), torch.as_tensor(valid)).numpy()
    # The eigenvector's sign is each eigensolver's own: align, then compare.
    sign = np.sign(np.sum(got[:, :3] * want[:, :3], axis=-1, keepdims=True))
    np.testing.assert_allclose(got[:, :3] * sign, want[:, :3], atol=1e-5)
    np.testing.assert_allclose(got[:, 3:] * sign, want[:, 3:], atol=2e-3)
    np.testing.assert_allclose(np.abs(got[:, :3] @ n), 1.0, atol=1e-4)
