"""PyTorch port, the XLA detection branch (``use_pallas=False``, the default)
against the JAX package's XLA branch on the same images (240x320, CPU):

* cylinder scenes (intact, and with a laser dropout that the bridge closes)
  and plane scenes (intact, a faded column, a cut column): every debug mask
  (binary, carved h/v masks, ROI, bridged h/v masks) equal, centroids and
  their validity equal, the grid ids identical, xy within 1e-3 px, and
  ``ok``, ``stable``, ``labels_converged`` and ``bridged_components`` equal;
* the same under ``image_dtype="bfloat16"``;
* ``use_pallas`` routes ``detect_grid``, ``estimate_poses_batch``,
  ``full_experiment`` and ``estimate_poses_stream``: converted from the JAX
  package's default configs by ``from_reference``, the XLA branch calls
  none of the four kernel wrappers, and ``use_pallas=True`` calls them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_stereo
from cylinder_pose_estimation_tpu.config import CylinderDetectConfig as JCyl
from cylinder_pose_estimation_tpu.config import FitConfig as JFit
from cylinder_pose_estimation_tpu.config import PlaneDetectConfig as JPlane
from cylinder_pose_estimation_tpu.models.detector import detect_grid as jdetect
from cylinder_pose_estimation_tpu_torch.config import from_reference
from cylinder_pose_estimation_tpu_torch.models import detector as td
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.ops import frontend
from cylinder_pose_estimation_tpu_torch.utils import synthetic as tsyn
from test_torch_detect import GAP, _scene
from test_torch_plane import _plane_img

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W = 240, 320
DEBUG_MASKS = ("binary", "h_mask", "v_mask", "roi_mask", "h_expanded", "v_expanded")
FLAGS = ("ok", "stable", "labels_converged", "bridged_components")


def _jax_detect(img, jcfg):
    return jax.jit(lambda im: jdetect(im, jcfg, return_debug=True))(jnp.asarray(img))


def _grid_map(xy, idx, valid):
    return {tuple(int(v) for v in idx[k]): xy[k] for k in range(len(valid)) if valid[k]}


def _assert_matches_jax(img, jcfg, min_points):
    jres, jdbg = _jax_detect(img, jcfg)
    tres, tdbg = td.detect_grid(torch.as_tensor(img)[None], from_reference(jcfg), return_debug=True)
    for name in DEBUG_MASKS:
        want = np.asarray(getattr(jdbg, name))
        got = getattr(tdbg, name)[0].numpy()
        assert got.shape == want.shape and int((got != want).sum()) == 0, name
    np.testing.assert_array_equal(tdbg.centroids[0].numpy(), np.asarray(jdbg.centroids))
    np.testing.assert_array_equal(tdbg.centroids_valid[0].numpy(), np.asarray(jdbg.centroids_valid))
    want = _grid_map(np.asarray(jres.grid.xy), np.asarray(jres.grid.idx), np.asarray(jres.grid.valid))
    got = _grid_map(tres.grid.xy[0].numpy(), tres.grid.idx[0].numpy(), tres.grid.valid[0].numpy())
    assert len(want) >= min_points and set(got) == set(want)
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-3
    for f in FLAGS:
        assert getattr(tres, f)[0].item() == np.asarray(getattr(jres, f)).item(), f
    return tres


@pytest.mark.parametrize("gap", [None, GAP], ids=["intact", "gap"])
def test_cylinder_detect_matches_jax_xla(gap):
    res = _assert_matches_jax(_scene(gap), JCyl(height=H, width=W), 30)
    assert int(res.bridged_components[0]) == (0 if gap is None else 2)


@pytest.mark.parametrize("kw", [{}, {"gap_col": 4}, {"cut_col": 3}, {"saturate": True}],
                         ids=["intact", "faded_col", "cut_col", "saturated"])
def test_plane_detect_matches_jax_xla(kw):
    _assert_matches_jax(_plane_img(**kw), JPlane(height=H, width=W, roi_threshold=30.0), 40)


def test_cylinder_detect_bfloat16_matches_jax_xla():
    _assert_matches_jax(_scene(GAP), JCyl(height=H, width=W, image_dtype="bfloat16"), 30)


def test_bridge_repeats_and_cc_iters_match_jax_xla():
    """The XLA-only knobs: two bridge repeats and a short CC budget."""
    _assert_matches_jax(_scene(GAP), JCyl(height=H, width=W, bridge_repeats=2, cc_iters=6), 15)


class _Calls:
    """Count the calls of the four kernel wrappers (the detector looks them
    up on ``ops.frontend`` at call time)."""

    NAMES = ("preprocess_binarize", "connected_components", "bridge_morphology",
             "component_payload_minmax")

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            orig = getattr(frontend, name)

            def wrapped(*args, _orig=orig, _name=name, **kw):
                self.n[_name] += 1
                return _orig(*args, **kw)

            monkeypatch.setattr(frontend, name, wrapped)


def _small_pair(n):
    st, (i1, i2) = tsyn.example_pair(H, W, n_frames=n)
    return port_stereo(st), torch.as_tensor(i1), torch.as_tensor(i2)


def _entry_points():
    st, i1, i2 = _small_pair(2)
    angles = torch.as_tensor(tsyn.registration_angles(2))
    u1 = np.clip(i1.numpy(), 0, 255).astype(np.uint8)
    u2 = np.clip(i2.numpy(), 0, 255).astype(np.uint8)
    return {
        "detect_grid": lambda cfg: td.detect_grid(i1, cfg),
        "estimate_poses_batch": lambda cfg: pipeline.estimate_poses_batch(i1, i2, st, cfg, from_reference(JFit())),
        "full_experiment": lambda cfg: pipeline.full_experiment(i1, i2, angles, st, cfg, from_reference(JFit())),
        "estimate_poses_stream": lambda cfg: pipeline.estimate_poses_stream(
            u1, u2, st, cfg, from_reference(JFit()), chunk=2, device="cpu"),
    }


@pytest.mark.parametrize("entry", ["detect_grid", "estimate_poses_batch", "full_experiment",
                                   "estimate_poses_stream"])
@pytest.mark.parametrize("kernel_branch", [False, True], ids=["xla", "kernels"])
def test_use_pallas_routes_every_entry_point(entry, kernel_branch, monkeypatch):
    """``from_reference`` of the JAX package's default cylinder config runs
    the XLA branch (no kernel wrapper called); with ``use_pallas=True`` the
    kernel branch (every wrapper of the main path called)."""
    jcfg = JCyl(height=H, width=W, min_ok_points=10)
    assert jcfg.use_pallas is False
    cfg = from_reference(dataclasses.replace(jcfg, use_pallas=kernel_branch))
    fn = _entry_points()[entry]
    calls = _Calls(monkeypatch)
    fn(cfg)
    if kernel_branch:
        assert calls.n["preprocess_binarize"] >= 1 and calls.n["connected_components"] >= 3
        assert calls.n["bridge_morphology"] >= 1
    else:
        assert sum(calls.n.values()) == 0, calls.n


def test_xla_branch_ignores_endpoint_stats():
    """As in the JAX package, ``bridge_endpoint_stats`` selects a bridge of
    the kernel branch only: the XLA branch's result does not change."""
    img = torch.as_tensor(_scene(GAP))[None]
    cfg = from_reference(JCyl(height=H, width=W))
    a = td.detect_grid(img, cfg)
    b = td.detect_grid(img, dataclasses.replace(cfg, bridge_endpoint_stats=True))
    for x, y in zip(pipeline._tree_leaves(a), pipeline._tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_unaligned_frame_matches_jax_xla():
    """The XLA branch takes sizes the kernel branch's front end refuses (no
    multiple of 8): a 237x317 crop of the gap scene."""
    img = np.ascontiguousarray(_scene(GAP)[:237, 1:318])
    with pytest.raises(ValueError, match="8-aligned"):
        td.detect_grid(torch.as_tensor(img)[None], from_reference(JCyl(height=237, width=317, use_pallas=True)))
    _assert_matches_jax(img, JCyl(height=237, width=317), 20)
