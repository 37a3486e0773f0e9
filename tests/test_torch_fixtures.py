"""PyTorch port: the fixtures that ``chip_smoke.py`` holds the card to.

``tests/fixtures/torch_endpoint_scenes.json`` and ``torch_plane_scenes.json``
come from the JAX package (``tools/make_torch_port_fixtures.py``).  The fast
test checks that the files record the generator's scenes; the slow tests
regenerate one scene of each file from JAX and compare, and run the port on
the CPU against both files with ``chip_smoke.py``'s own contract.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_fixtures", ROOT / "tools" / "make_torch_port_fixtures.py")
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_fixture_files_record_the_generator_scenes():
    ep = _load(gen.ENDPOINT_FIXTURE)
    pl = _load(gen.PLANE_FIXTURE)
    assert [s["scene"] for s in ep["scenes"]] == gen.ENDPOINT_SCENES
    assert [v["spec"] for v in pl["views"]] == gen.PLANE_SPECS
    assert ep["generator"] == pl["generator"] == "tools/make_torch_port_fixtures.py"
    assert all(s["view1"] and s["view2"] for s in ep["scenes"])
    assert all(v["ok"] and v["points"] for v in pl["views"])
    assert any("gap_col" in v["spec"] for v in pl["views"])
    assert chip_smoke.ENDPOINT == gen.ENDPOINT_FIXTURE and chip_smoke.PLANE == gen.PLANE_FIXTURE


def _assert_points_close(got, want, tol):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for a, b in zip(got, want):
        assert abs(a["x"] - b["x"]) <= tol and abs(a["y"] - b["y"]) <= tol, (a, b)


@pytest.mark.slow
def test_endpoint_fixture_regenerates():
    """The gapped scene, through the JAX Pallas path again."""
    import jax.numpy as jnp

    want = _load(gen.ENDPOINT_FIXTURE)["scenes"][-1]
    a, b = gen.endpoint_images()
    got = gen.endpoint_record("gap0_pallas", gen.endpoint_fn()(jnp.asarray(a[-1]), jnp.asarray(b[-1])))
    for view in ("view1", "view2"):
        _assert_points_close(got[view], want[view], 1e-3)
    assert got["bridged_components"] == want["bridged_components"]
    p, q = np.asarray(got["fit_params"]), np.asarray(want["fit_params"])
    p[3:] *= np.linalg.norm(q[3:]) / np.linalg.norm(p[3:])
    np.testing.assert_allclose(p, q, atol=1e-3)


@pytest.mark.slow
def test_plane_fixture_regenerates():
    """The fragmented-column view, through both JAX paths again."""
    import jax.numpy as jnp

    want = next(v for v in _load(gen.PLANE_FIXTURE)["views"] if "gap_col" in v["spec"])
    img = jnp.asarray(gen.plane_image(want["spec"]))
    fn, fn_p = gen.plane_fns()
    got = gen.plane_record(want["spec"], fn(img), fn_p(img))
    _assert_points_close(got["points"], want["points"], 1e-3)
    for k in ("ok", "stable", "stable_xla", "bridged_components"):
        assert got[k] == want[k], k


@pytest.mark.slow
def test_port_meets_fixtures_on_cpu():
    """chip_smoke.py's endpoint and plane contracts, on the CPU."""
    from cylinder_pose_estimation_tpu_torch.config import (
        CylinderDetectConfig,
        FitConfig,
        PlaneDetectConfig,
    )
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import default_stereo

    h, w = gen.HEIGHT, gen.WIDTH
    a, b = gen.endpoint_images()
    cfg = CylinderDetectConfig(height=h, width=w, use_pallas=True, bridge_endpoint_stats=True)
    res = estimate_poses_batch(torch.as_tensor(np.stack(a)), torch.as_tensor(np.stack(b)),
                               stereo_from_numpy(*default_stereo(cx=w / 2.0, cy=h / 2.0)),
                               cfg, FitConfig())
    for s, want in enumerate(_load(gen.ENDPOINT_FIXTURE)["scenes"]):
        chk = chip_smoke.golden_check(res, want, s, gauge=True)
        assert chk["bridged_components"] == want["bridged_components"]
    views = _load(gen.PLANE_FIXTURE)["views"]
    imgs = torch.as_tensor(np.stack([gen.plane_image(v["spec"]) for v in views]))
    det = detect_grid(imgs, PlaneDetectConfig(height=h, width=w, use_pallas=True, roi_threshold=30.0))
    chip_smoke.plane_check(det, views)
