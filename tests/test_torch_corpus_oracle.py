"""PyTorch port held to the numpy oracle of the reference's detection
bookkeeping (tests/_oracle_detect.py, ``detect_bookkeeping``; CPU).

As tests/test_detect_oracle.py does for the JAX detector, the literal
reference chain (label -> group -> sort -> polyfit -> prune -> intersect ->
relabel -> index -> JSON) is replayed from the port's OWN post-bridge state:
the centroids, ROI box, bridged masks, grey image and saturation radius that
``front_stage``/``roi_stage``/``bridge_stage`` (or their XLA-branch
counterparts) return, the arguments test_detect_oracle.py:59-93 builds from
JAX's ``stage_probe="bridge_state"``.  The port's final grid must match the
oracle id for id within 0.05 px (that file's ``_assert_match``), on each
branch; the XLA branch's grid is also held to JAX's by the corpus contract
(ids identical, xy within 1e-3 px).

Cylinder chain at 480x640, the bench scenes of ``_example_pair`` and the
rendered gap scene; plane chain at 240x320.  Fast: bench scene 0, the gap
scene and the plane scene; under ``slow``: bench scenes 1-3, the randomized
sweep of 8 scenes and the fragmented plane column.
"""

import json

import numpy as np
import pytest
import torch

import _oracle_detect as od
from _torch_port import hold_to_jax, jax_config, jax_detect
from cylinder_pose_estimation_tpu_torch.config import from_reference
from cylinder_pose_estimation_tpu_torch.models import detector as tdet
from test_detect_oracle import _assert_match, _plane_img, _upsample2

torch.set_num_threads(1)

H, W = 480, 640


_SCENES = []


def _scenes():
    """test_detect_oracle's scenes: three view-1 frames and one view-2
    frame of the bench family, then the rendered gap scene (seed 5)."""
    if not _SCENES:
        from __graft_entry__ import _example_pair
        from test_detector_hardening import _gapped_scene

        _, (i1, i2) = _example_pair(H, W, n_frames=3)
        _SCENES.extend([i1[0], i1[1], i1[2], i2[0], np.asarray(_gapped_scene(seed=5)[0], np.float32)])
    return _SCENES


@torch.inference_mode()
def port_and_oracle(img, jcfg, mode="cylinder"):
    """The port's final grid of one image and the oracle's replay of the
    port's post-bridge state, as ({id: (x, y)}, centre) pairs (the oracle's
    None when it finds no grid)."""
    cfg = from_reference(jcfg)
    gray = tdet._to_gray(torch.as_tensor(np.array(img, np.float32))[None])
    kernels = cfg.use_pallas
    front = (tdet.front_stage if kernels else tdet.front_stage_xla)(gray, cfg)
    roi = tdet.roi_stage(front, cfg)
    br = (tdet.bridge_stage if kernels else tdet.bridge_stage_xla)(roi.mh, roi.mv, roi.circle_radius0, cfg)
    h, w = gray.shape[-2:]
    up = (lambda s: _upsample2(s, H if mode == "cylinder" else h, W if mode == "cylinder" else w)) \
        if cfg.label_downsample == 2 else np.asarray
    inside = roi.inside[0].numpy()
    js, _ = od.detect_bookkeeping(
        up(br.h_exp[0].numpy()), up(br.v_exp[0].numpy()), front.cents[0].numpy()[inside], roi.bbox[0].numpy(),
        front.gray[0].numpy(), float(roi.circle_radius0[0]), degree=cfg.poly_degree,
        prune=(cfg.drop_first_row or cfg.drop_last_col) and mode == "cylinder", mode=mode)
    det = tdet.detect_grid(gray, cfg)
    xy, idx, valid = det.grid.xy[0].numpy(), det.grid.idx[0].numpy(), det.grid.valid[0].numpy()
    repo = {(int(idx[i, 0]), int(idx[i, 1])): (float(xy[i, 0]), float(xy[i, 1]))
            for i in range(len(valid)) if valid[i]}
    center = det.grid.center[0].numpy()
    if js is None:
        return det, repo, center, None, None
    data = json.loads(js)
    oracle = {tuple(p["id"]): (p["x"], p["y"]) for p in data["points"]}
    return det, repo, center, oracle, np.asarray(data["center_point"], float)


def _check(img, branch, min_points):
    jcfg = jax_config(H, W, branch)
    det, repo, center, oracle, ocenter = port_and_oracle(img, jcfg)
    assert len(repo) >= min_points
    _assert_match(repo, center, oracle, ocenter)
    if branch == "xla":
        hold_to_jax(det, jax_detect(img, jcfg), label="oracle scene vs JAX")


@pytest.mark.parametrize("branch", ["xla", "kernels"])
def test_bookkeeping_matches_oracle_bench_scene(branch):
    _check(_scenes()[0], branch, 30)


@pytest.mark.parametrize("branch", ["xla", "kernels"])
def test_bookkeeping_matches_oracle_gap_scene(branch):
    """The bridged regime: the oracle labels the port's own bridged masks."""
    _check(_scenes()[4], branch, 20)


@pytest.mark.slow
@pytest.mark.parametrize("branch", ["xla", "kernels"])
@pytest.mark.parametrize("i", [1, 2, 3])
def test_bookkeeping_matches_oracle_more_scenes(i, branch):
    _check(_scenes()[i], branch, 0)


@pytest.mark.slow
def test_bookkeeping_oracle_randomized_sweep():
    """test_bookkeeping_oracle_randomized_sweep's rotated, rescaled grids:
    every scene with a usable grid matches the oracle id for id (XLA
    branch), at least 5 of 8."""
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.utils.synthetic import render_grid_image

    checked = 0
    for seed in range(8):
        rng = np.random.default_rng(2000 + seed)
        tilt = rng.uniform(-8, 8)
        n = int(rng.integers(7, 10))
        spacing = min(rng.uniform(28, 42), (H / 2.0 - 60) / ((n - 1) / 2.0 * 1.2))
        t = np.radians(tilt)
        r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        ij = np.mgrid[0:n, 0:n].astype(np.float64) - (n - 1) / 2.0
        local = np.stack([ij[1], ij[0]], axis=-1).reshape(-1, 2) * spacing
        xy = local @ r.T + np.array([W / 2.0, H / 2.0])
        img = np.asarray(render_grid_image(jnp.asarray(xy, jnp.float32), jnp.ones(n * n, bool), n, n, H, W),
                         np.float32)
        img = np.clip(img + rng.normal(0, 2.0, (H, W)), 0, 255)
        _, repo, center, oracle, ocenter = port_and_oracle(img, jax_config(H, W, "xla"))
        if len(repo) < 12 or oracle is None:
            continue
        _assert_match(repo, center, oracle, ocenter)
        checked += 1
    assert checked >= 5, checked


def _plane_check(gap_col, min_points):
    _, img = _plane_img(gap_col)
    jcfg = jax_config(240, 320, "xla", plane=True, roi_threshold=30.0)
    det, repo, _, oracle, _ = port_and_oracle(img, jcfg, mode="plane")
    assert oracle is not None and len(repo) >= min_points
    assert set(repo) == set(oracle), (sorted(set(repo) - set(oracle)), sorted(set(oracle) - set(repo)))
    hold_to_jax(det, jax_detect(img, jcfg), label="plane oracle scene vs JAX")
    return repo, oracle


def test_plane_bookkeeping_matches_oracle():
    """Plane chain (degree 1, the abnormal-column merge, (row, col) ids, no
    pruning): id sets equal, median within 0.01 px and every point within
    1 px (test_plane_bookkeeping_matches_oracle's tolerances)."""
    repo, oracle = _plane_check(None, 50)
    d = sorted(np.hypot(repo[k][0] - oracle[k][0], repo[k][1] - oracle[k][1]) for k in repo)
    assert d[len(d) // 2] < 0.01 and d[-1] < 1.0


@pytest.mark.slow
def test_plane_bookkeeping_oracle_with_fragmented_column():
    _plane_check(2, 40)
