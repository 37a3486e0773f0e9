"""PyTorch port on the JAX package's rendered gap corpus
(tests/test_detector_hardening.py, 240x320, CPU): the 18-px laser dropout
end to end (:467, :509), the randomized backend-agreement sweep (:630) and
the ``bridged_components`` diagnostic (:726); and the gap frames of
``tests/fixtures/torch_corpus_scenes.npz`` (``chip_smoke.py`` phase 17)
equal these JAX frames.

Each port branch is held to the same JAX branch by
``_torch_port.hold_to_jax`` (ids identical, xy within 1e-3 px, the fence
flags and counts equal, ``max_line_tilt`` within 1e-5 rad).  The port's two
branches are then held to each other as the JAX tests hold the JAX
branches, and the port's XLA branch to the JAX tests' ground truth.  The
sweep's first four seeds run here; all twelve under ``slow``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import BRANCHES, grid_map, hold_to_jax, jax_config, jax_detect, port_detect
from cylinder_pose_estimation_tpu.utils.synthetic import render_grid_image
from tests.test_detector_hardening import H, W, _gapped_scene

CORPUS_FIXTURE = Path(__file__).parent / "fixtures" / "torch_corpus_scenes.npz"

torch.set_num_threads(1)

_CACHE = {}


def _both(name, img, branch):
    """(port, JAX) DetectResults of one image, computed once per name."""
    key = (name, branch)
    if key not in _CACHE:
        cfg = jax_config(H, W, branch)
        _CACHE[key] = port_detect(img, cfg), jax_detect(img, cfg)
    return _CACHE[key]


def _gap_images(seed):
    """A control image and the same scene with the dropout band across the
    middle row, placed from the JAX XLA branch's control grid, as the JAX
    tests place it."""
    img0, _ = _gapped_scene(gap=None, seed=seed)
    ids0 = grid_map(jax_detect(img0, jax_config(H, W, "xla")))
    ys = sorted({round(float(xy[1])) for xy in ids0.values()})
    y_mid = ys[len(ys) // 2]
    img1, _ = _gapped_scene(gap=(y_mid - 9, y_mid + 9, 150, 168), seed=seed)
    return np.asarray(img0, np.float32), np.asarray(img1, np.float32), y_mid


@pytest.mark.parametrize("branch", BRANCHES)
def test_gapped_scene_matches_jax(branch):
    img0, img1, _ = _gap_images(3)
    for name, img in (("control", img0), ("gapped", img1)):
        got, want = _both(f"gap3 {name}", img, branch)
        hold_to_jax(got, want, label=f"gap scene {name} {branch}")


def test_gapped_scene_is_bridged_end_to_end():
    """test_rendered_line_gap_is_bridged_end_to_end on the port's XLA
    branch: every control intersection outside the dropout reappears with
    its id, within 1.5 px (3 px on the damaged row)."""
    img0, img1, y_mid = _gap_images(3)
    ctl = _both("gap3 control", img0, "xla")[0]
    det = _both("gap3 gapped", img1, "xla")[0]
    assert bool(ctl.ok[0]) and bool(det.ok[0])
    ids0, ids1 = grid_map(ctl, 0), grid_map(det, 0)
    kept = checked = 0
    for key, xy in ids0.items():
        if abs(xy[1] - y_mid) < 12 and 138 <= xy[0] <= 180:
            continue
        tol = 3.0 if abs(xy[1] - y_mid) < 12 else 1.5
        checked += 1
        kept += key in ids1 and np.linalg.norm(ids1[key] - xy) < tol
    assert checked >= 20 and kept == checked, (kept, checked)


def test_gapped_scene_branches_agree():
    """test_rendered_line_gap_bridged_on_pallas_interpret: the port's kernel
    branch reconnects the line as its XLA branch does (same ids, every
    point within 0.75 px)."""
    _, img1, _ = _gap_images(3)
    ids_x = grid_map(_both("gap3 gapped", img1, "xla")[0], 0)
    ids_p = grid_map(_both("gap3 gapped", img1, "kernels")[0], 0)
    assert set(ids_p) == set(ids_x)
    assert max(np.linalg.norm(ids_p[k] - ids_x[k]) for k in ids_x) < 0.75


def _sweep_image(seed):
    """test_randomized_backend_agreement_sweep's scene of one seed: a tame
    tilted grid, odd seeds with an off-centre dropout (the same draws in the
    same order)."""
    rng = np.random.default_rng(1000 + seed)
    tilt = rng.uniform(-10, 10)
    n = int(rng.integers(7, 9))
    spacing = min(rng.uniform(17, 24), (H / 2.0 - 45.0) / ((n - 1) / 2.0 * 1.18))
    t = np.radians(tilt)
    r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    ij = np.mgrid[0:n, 0:n].astype(np.float64) - (n - 1) / 2.0
    local = np.stack([ij[1], ij[0]], axis=-1).reshape(-1, 2) * spacing
    xy = local @ r.T + np.array([W / 2.0, H / 2.0])
    import jax.numpy as jnp

    img = np.asarray(render_grid_image(jnp.asarray(xy, jnp.float32), jnp.ones(n * n, bool), n, n, H, W),
                     np.float32)
    img = img + rng.normal(0, 2.0, (H, W)).astype(np.float32)
    if seed % 2 == 1:
        y0 = rng.uniform(70, 170)
        x0 = rng.uniform(80, 240)
        yy = np.arange(H, dtype=np.float32)[:, None]
        xx = np.arange(W, dtype=np.float32)[None, :]

        def e(v, lo, hi):
            return 1.0 / (1.0 + np.exp(-(v - lo) / 1.5)) * 1.0 / (1.0 + np.exp((v - hi) / 1.5))

        img = img * (1.0 - 0.97 * e(yy, y0 - 8, y0 + 8) * e(xx, x0 - 9, x0 + 9))
    return np.clip(img, 0, 255).astype(np.float32)


SWEEP = [s if s < 4 else pytest.param(s, marks=pytest.mark.slow) for s in range(12)]


@pytest.mark.parametrize("seed", SWEEP)
def test_sweep_matches_jax_and_the_two_tier_contract(seed):
    """Each branch held to JAX's; then the JAX test's two tiers on the
    port's branches: no bridged component -> id sets equal; and an
    axis-aligned grid (tilt <= 0.035 rad) -> every point within 0.25 px."""
    img = _sweep_image(seed)
    res = {}
    for branch in BRANCHES:
        got, want = _both(f"sweep {seed}", img, branch)
        hold_to_jax(got, want, label=f"sweep seed {seed} {branch}")
        res[branch] = got
    rx, rp = res["xla"], res["kernels"]
    mx, mp = grid_map(rx, 0), grid_map(rp, 0)
    bridged = max(int(rx.bridged_components[0]), int(rp.bridged_components[0]))
    if bridged == 0:
        assert set(mp) == set(mx), seed
        if max(float(rx.max_line_tilt[0]), float(rp.max_line_tilt[0])) <= 0.035:
            assert all(np.linalg.norm(mp[k] - mx[k]) < 0.25 for k in mx), seed


@pytest.mark.parametrize("branch", BRANCHES)
def test_bridged_components_diagnostic(branch):
    """0 on the intact scene, > 0 once the dropout forced a merge, and equal
    to JAX's on both images."""
    img0, img1, _ = _gap_images(4)
    clean, want_clean = _both("gap4 control", img0, branch)
    gapped, want_gapped = _both("gap4 gapped", img1, branch)
    hold_to_jax(clean, want_clean, label=f"gap4 control {branch}")
    hold_to_jax(gapped, want_gapped, label=f"gap4 gapped {branch}")
    assert int(clean.bridged_components[0]) == 0
    assert int(gapped.bridged_components[0]) > 0


def test_fixture_holds_the_gap_frames():
    """``tools/make_torch_port_fixtures.py corpus`` stored these frames."""
    from tests.test_torch_xla_corpus import _double_gap

    img0, img1, _ = _gap_images(3)
    fx = np.load(CORPUS_FIXTURE)
    assert np.array_equal(fx["gap3_control"], img0) and np.array_equal(fx["gap3_gapped"], img1)
    assert np.array_equal(fx["double_gap"], _double_gap())
