"""PyTorch port: the fixtures that ``chip_smoke.py`` holds the card to.

``tests/fixtures/torch_endpoint_scenes.json``, ``torch_plane_scenes.json``,
``torch_registration.json`` and ``torch_knob_scenes.json`` come from the
JAX package (``tools/make_torch_port_fixtures.py``).  The fast tests check that the
files record the generator's scenes and that ``chip_smoke.py``'s
registration contract accepts the JAX result and refuses a moved one; the
slow tests regenerate one scene of each detection file from JAX and
compare, and run the port on the CPU against all three files with
``chip_smoke.py``'s own contract.  The knob record's 240x320 scenes run
through the port's stages in the fast tests: binary mask, bridged masks and
final labels bit-equal to JAX's (SHA-256), grids within 1e-3 px.
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
                               stereo_from_numpy(*default_stereo(cx=w / 2.0, cy=h / 2.0), device="cpu"),
                               cfg, FitConfig())
    for s, want in enumerate(_load(gen.ENDPOINT_FIXTURE)["scenes"]):
        chk = chip_smoke.golden_check(res, want, s, gauge=True)
        assert chk["bridged_components"] == want["bridged_components"]
    views = _load(gen.PLANE_FIXTURE)["views"]
    imgs = torch.as_tensor(np.stack([gen.plane_image(v["spec"]) for v in views]))
    det = detect_grid(imgs, PlaneDetectConfig(height=h, width=w, use_pallas=True, roi_threshold=30.0))
    chip_smoke.plane_check(det, views)


def test_registration_fixture_records_the_generator():
    fx = _load(gen.REGISTRATION_FIXTURE)
    assert fx["generator"] == "tools/make_torch_port_fixtures.py"
    assert fx["seed"] == gen.REG_SEED and fx["gt_pose"] == gen.REG_GT_POSE
    assert len(fx["angles"]) == len(fx["pts"]) == gen.REG_FRAMES
    assert fx["capacity"] == gen.REG_CAPACITY
    assert [i for i, v in enumerate(fx["frame_valid"]) if not v] == [gen.REG_POISONED]
    assert all(len(p) == 3 * n for p, n in zip(fx["pts"], fx["n_valid"]))
    assert fx["result"]["well_posed"] and fx["result"]["fval"] < fx["result"]["fval0"]
    assert chip_smoke.REGISTRATION == gen.REGISTRATION_FIXTURE
    _, pts, valid, angles, frame_valid = chip_smoke.load_registration_fixture("cpu")
    assert pts.shape == (gen.REG_FRAMES, gen.REG_CAPACITY, 3) and int(valid.sum()) == sum(fx["n_valid"])
    assert angles.shape == (gen.REG_FRAMES, 2) and not bool(frame_valid[gen.REG_POISONED])


def test_registration_check_contract():
    """The JAX result passes chip_smoke's registration contract against
    itself; a T_Cam_AGV moved by 0.2 mm perpendicular to the axes, a minimum
    eigenvalue 2% off, or a flipped ``well_posed``, fails it."""
    from cylinder_pose_estimation_tpu_torch.types import RegistrationResult

    fx = _load(gen.REGISTRATION_FIXTURE)
    want = fx["result"]

    def result(t, well_posed=want["well_posed"], eig_scale=1.0):
        return RegistrationResult(torch.as_tensor(np.asarray(t, np.float32)),
                                  torch.tensor(want["fval0"]), torch.tensor(want["fval"]),
                                  torch.tensor(want["jtj_min_eig"] * eig_scale),
                                  torch.tensor(well_posed))

    chk = chip_smoke.registration_check(result(want["t_cam_agv"]), want, fx["angles"], "self")
    assert chk["axis_deg"] < 1e-3 and chk["perp_mm"] < 1e-3
    moved = np.asarray(want["t_cam_agv"])
    moved[:3, 3] += 0.2 * np.cross(moved[:3, 1], [0.0, 0.0, 1.0])
    with pytest.raises(AssertionError, match="perpendicular"):
        chip_smoke.registration_check(result(moved), want, fx["angles"], "moved")
    with pytest.raises(AssertionError, match="jtj_min_eig"):
        chip_smoke.registration_check(result(want["t_cam_agv"], eig_scale=1.02), want,
                                      fx["angles"], "eig")
    with pytest.raises(AssertionError, match="well_posed"):
        chip_smoke.registration_check(result(want["t_cam_agv"], not want["well_posed"]), want,
                                      fx["angles"], "flag")


@pytest.mark.slow
def test_port_meets_registration_fixture_on_cpu():
    """chip_smoke.py's registration contract on the CPU."""
    from cylinder_pose_estimation_tpu_torch.geometry.registration import fit_cylinders_with_angles

    fx, pts, valid, angles, frame_valid = chip_smoke.load_registration_fixture("cpu")
    res = fit_cylinders_with_angles(pts, valid, angles, frame_valid=frame_valid)
    chk = chip_smoke.registration_check(res, fx["result"], fx["angles"], "CPU")
    assert chk["axis_deg"] < 0.01 and chk["perp_mm"] < 0.01 and chk["fval_rel"] < 1e-3


def test_knob_fixture_records_the_generator():
    """Every knob configuration at both sizes, bench.py's scene family at
    480x640, chip_smoke.py reading the same file."""
    rec = _load(gen.KNOB_FIXTURE)
    assert rec["generator"] == "tools/make_torch_port_fixtures.py knobs"
    assert chip_smoke.KNOBS == gen.KNOB_FIXTURE
    for size in ("240x320", "480x640"):
        configs = rec["records"][size]["configs"]
        assert [c["name"] for c in configs] == [c["name"] for c in gen.KNOB_CONFIGS]
        assert [c["overrides"] for c in configs] == [c["overrides"] for c in gen.KNOB_CONFIGS]
    big = rec["records"]["480x640"]
    assert big["scenes"]["cylinder_views"].startswith("example_pair(480, 640, n_frames=16")
    assert all(len(c["views"]) == 32 and sum(v["ok"] for v in c["views"]) >= 28 for c in big["configs"])
    small = rec["records"]["240x320"]["configs"]
    assert all({"binary", "labels", "h_exp", "v_exp"} <= set(v) for c in small for v in c["views"])


@pytest.mark.parametrize("name", [c["name"] for c in gen.KNOB_CONFIGS])
def test_port_meets_knob_fixture_at_240x320(name):
    """The knob's configuration through the port's stages on the record's
    two scenes: binary mask, bridged masks and final labels equal to the JAX
    package's (SHA-256 of their bytes), ids identical, xy within 1e-3 px,
    ok, stable and the bridged count equal."""
    from tests.test_torch_fullres import _digest, _points_match, _stages
    from cylinder_pose_estimation_tpu_torch import config as tcfg
    from cylinder_pose_estimation_tpu_torch.models import detector as td
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import cylinder_view

    rec = _load(gen.KNOB_FIXTURE)["records"]["240x320"]
    want = next(c for c in rec["configs"] if c["name"] == name)
    views = torch.as_tensor(np.stack([cylinder_view(240, 320, **s) for s in rec["scenes"]["cylinder_views"]]))
    cfg = tcfg.CylinderDetectConfig(height=240, width=320, use_pallas=want["use_pallas"], **want["overrides"])
    with torch.inference_mode():
        br, labels, result = _stages(views, cfg)
        front = (td.front_stage if cfg.use_pallas else td.front_stage_xla)(td._to_gray(views), cfg)
    for i, v in enumerate(want["views"]):
        assert _digest(front.binary[i]) == v["binary"], f"view {i}: binary differs"
        assert _digest(br.h_exp[i]) == v["h_exp"] and _digest(br.v_exp[i]) == v["v_exp"], f"view {i}"
        assert _digest(labels[i].to(torch.int32)) == v["labels"], f"view {i}: final labels differ"
        assert _points_match(result.grid, i, v["points"]) <= 1e-3
        assert (bool(result.ok[i]), bool(result.stable[i]), int(result.bridged_components[i])) == \
            (v["ok"], v["stable"], v["bridged_components"])
