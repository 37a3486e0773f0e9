"""PyTorch port, the default configuration (the XLA detection branch) against
the JAX XLA branch's own records, on the CPU at 480x640:

* ``tests/fixtures/golden_scenes.json`` (the XLA path's record): scenes 0-1
  and the bridged gap scene ``gap0``, whose view 2 has 40 points where the
  kernel branch finds 42 (``gap0_pallas``), with the golden contract (ids
  identical, xy within 0.05 px, fit params within 0.05 with the direction
  at the fixture's norm, reprojection within 0.01 px) and the bridged
  count; scenes 2-5 under ``slow``;
* ``tests/fixtures/torch_plane_scenes.json``: the 8 plane views under the
  default ``PlaneDetectConfig(roi_threshold=30)``, whose ``stable`` must be
  the XLA record ``stable_xla`` (True on every view, where the kernel
  branch reads False), points, ``ok`` and the bridged count as recorded.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _example_pair
from tests.make_golden import apply_gap
from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, PlaneDetectConfig
from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
from cylinder_pose_estimation_tpu_torch.utils.synthetic import plane_view
from test_torch_pipeline import _check_scene, _port_stereo

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def golden():
    fx = _load("golden_scenes.json")
    assert fx["path"].startswith("XLA (use_pallas=False)")
    return {str(s["scene"]): s for s in fx["scenes"]}


def _nb(res, i):
    return int(res.detect1.bridged_components[i]) + int(res.detect2.bridged_components[i])


def test_default_config_meets_golden_xla_records(golden):
    """Scenes 0, 1 and gap0 in one batch under ``CylinderDetectConfig()``."""
    cfg = CylinderDetectConfig()
    assert cfg.use_pallas is False
    stereo, (i1, i2) = _example_pair(480, 640, n_frames=2)
    a = np.concatenate([i1, apply_gap(i1[0])[None]])
    b = np.concatenate([i2, apply_gap(i2[0])[None]])
    res = estimate_poses_batch(torch.as_tensor(a), torch.as_tensor(b), _port_stereo(stereo), cfg, FitConfig())
    for s, name in enumerate(["0", "1", "gap0"]):
        _check_scene(res, s, golden[name], direction_at_golden_norm=True)
        assert _nb(res, s) == golden[name].get("bridged_components", 0)
    # gap0's view 2: the XLA record, not the kernel branch's.
    assert len(golden["gap0"]["view2"]) == 40 and len(golden["gap0_pallas"]["view2"]) == 42
    assert int(res.detect2.grid.valid[2].sum()) == 40


@pytest.mark.slow
@pytest.mark.parametrize("s", range(2, 6))
def test_default_config_golden_scenes_2_5(s, golden):
    stereo, (i1, i2) = _example_pair(480, 640, n_frames=s + 1)
    res = estimate_poses_batch(torch.as_tensor(i1[s:s + 1]), torch.as_tensor(i2[s:s + 1]),
                               _port_stereo(stereo), CylinderDetectConfig(), FitConfig())
    _check_scene(res, 0, golden[str(s)], direction_at_golden_norm=True)


def test_default_plane_config_meets_stable_xla():
    fx = _load("torch_plane_scenes.json")
    assert fx["path"].startswith("JAX XLA path (use_pallas=False)")
    views = fx["views"]
    imgs = torch.as_tensor(np.stack([plane_view(480, 640, **v["spec"]) for v in views]))
    det = detect_grid(imgs, PlaneDetectConfig(roi_threshold=30.0))
    assert [v["stable_xla"] for v in views] == [True] * 8
    assert [v["stable"] for v in views] == [False] * 8  # the kernel branch's record
    as_xla = [dict(v, stable=v["stable_xla"]) for v in views]
    chip_smoke.plane_check(det, as_xla)
    assert det.bridged_components.tolist() == [v["bridged_components"] for v in views]
