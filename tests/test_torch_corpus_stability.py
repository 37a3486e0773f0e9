"""PyTorch port on the JAX package's stability-fence corpus
(tests/test_stability.py, 240x320, CPU).

Each port branch is held to the same branch of the JAX package (the XLA
branch jitted, the kernel branch in Pallas interpret mode) on the same
float32 image by ``_torch_port.hold_to_jax``: outside the chaotic window ids
identical, xy within 1e-3 px, ``ok``, ``stable``, ``labels_converged`` and
``bridged_components`` equal, ``max_line_tilt`` within 1e-5 rad; inside it
(the lattices at 26 and 32 degrees) only ``ok``, ``stable`` and the tilt,
with the id-set difference printed.  Where the JAX test asserts against
ground truth (on its XLA branch), the port's XLA branch meets the same
assertion.

One scene has a budget of its own (ROADMAP section 3): the 19-degree lattice
on the kernel branch, all four noise seeds.  Its labels stay unconverged, and
spurious three-member fragments fit ill-conditioned parabolas, so float32
rounding in the polynomial fit (XLA:CPU's reciprocal square root is not
correctly rounded; the port's is) moves 5-6 of its 31 points by up to
1.12e-2 px; every stage before the fit is equal.

The port renders these lattices itself (``utils.synthetic.tilted_grid_view``,
the card's scenes in ``chip_smoke.py``); the first test holds it to the JAX
test's image.
"""

import numpy as np
import pytest
import torch

from _torch_port import BRANCHES, hold_to_jax, jax_config, jax_detect, port_detect
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)
from cylinder_pose_estimation_tpu_torch.utils.synthetic import tilted_grid_view
from tests.test_stability import H, W, _tilted_grid_image

torch.set_num_threads(1)

# (angle in degrees, noise seed): the fence's lattices.  26 and 32 degrees lie
# in the chaotic window.
LATTICES = [(32.0, 0), (26.0, 0), (14.0, 0), (0.0, 0), (19.0, 0), (19.0, 1), (19.0, 2), (19.0, 3)]
CHAOTIC = {32.0, 26.0}
# (angle, seed, branch) -> (points allowed past 1e-3 px, their limit in px).
BUDGET = {(19.0, s, "kernels"): (6, 1.5e-2) for s in range(4)}


def _lattice(angle, seed):
    if seed == 0:
        return np.asarray(_tilted_grid_image(angle), np.float32)
    # test_19deg_sits_stably_inside_the_fence's reseeded images.
    return tilted_grid_view(H, W, angle, seed)


@pytest.mark.parametrize("angle,seed", LATTICES)
def test_port_renders_the_lattices(angle, seed):
    """The port's renderer gives the JAX test's image: equal pixels, but at
    32 degrees two pixels one grey level apart (float32 ``exp`` rounding
    differs between the libraries before the uint8 truncation)."""
    want = np.asarray(_tilted_grid_image(angle), np.float32)
    if seed:
        import jax.numpy as jnp

        t = np.radians(angle)
        r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        ij = np.mgrid[0:9, 0:9].astype(np.float64) - 4.0
        local = np.stack([ij[1], ij[0]], axis=-1).reshape(-1, 2) * 22.0
        xy = jnp.asarray(local @ r.T + np.array([W / 2.0, H / 2.0]), jnp.float32)
        img = render_grid_image(xy, jnp.ones(81, bool), 9, 9, H, W)
        noise = jnp.asarray(np.random.default_rng(seed).normal(0, 2.0, (H, W)), jnp.float32)
        want = np.asarray(jnp.clip(img.astype(jnp.float32) + noise, 0, 255))
    got = tilted_grid_view(H, W, angle, seed)
    diff = np.abs(got - want)
    assert int((diff > 0).sum()) <= (2 if angle == 32.0 else 0) and diff.max() <= 1.0


_RESULTS = {}


def _run(angle, seed, branch):
    key = (angle, seed, branch)
    if key not in _RESULTS:
        img = _lattice(angle, seed)
        cfg = jax_config(H, W, branch)
        _RESULTS[key] = port_detect(img, cfg), jax_detect(img, cfg)
    return _RESULTS[key]


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("angle,seed", LATTICES)
def test_lattice_matches_jax(angle, seed, branch):
    got, want = _run(angle, seed, branch)
    rep = hold_to_jax(got, want, chaotic=angle in CHAOTIC, budget=BUDGET.get((angle, seed, branch), (0, 0.0)),
                      label=f"{angle} deg seed {seed} {branch}")
    print(angle, seed, branch, rep)
    if branch != "xla":
        return
    # test_stability.py's ground truth, on the branch it runs.
    ok, stable, tilt = bool(got.ok[0]), bool(got.stable[0]), float(got.max_line_tilt[0])
    if angle == 32.0:
        assert not stable
    elif angle == 26.0:
        assert ok and not stable
    elif angle == 14.0:
        assert 0.15 < tilt < 0.33, tilt
    elif angle == 0.0:
        assert tilt < 0.2 and bool(got.labels_converged[0]) and stable
    else:
        assert stable, (seed, tilt)


def test_19deg_tilt_is_reseed_stable():
    """test_19deg_sits_stably_inside_the_fence: the port's tilt diagnostic
    over the four reseeds moves by under 5e-3 rad and stays 0.01 under the
    fence (XLA branch)."""
    tilts = [float(_run(19.0, s, "xla")[0].max_line_tilt[0]) for s in range(4)]
    fence = jax_config(H, W, "xla").max_stable_tilt
    assert max(tilts) - min(tilts) < 5e-3, tilts
    assert max(tilts) < fence - 0.01, tilts


def _bench_scene():
    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0)
    return cylinder_grid_points(stereo, capacity=128, n_rows=9, n_cols=9, origin=(0.0, -15.0, 560.0),
                                radius=52.0, row_spacing=12.0, theta_span=2.2)


def _retention_images():
    """test_retention_fence_ignores_out_of_domain_binary's two noisy images
    (speck clutter away from the grid; a saturated blob carving real line
    pixels), in the order that test draws their noise."""
    scene = _bench_scene()
    base = np.asarray(render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W)).astype(np.float32)
    rng = np.random.default_rng(1)
    clutter = base.copy()
    for cx_, cy_ in ((25, 25), (295, 25), (25, 215), (295, 215), (40, 120)):
        for _ in range(40):
            x = int(np.clip(cx_ + rng.normal(0, 9), 0, W - 1))
            y = int(np.clip(cy_ + rng.normal(0, 9), 0, H - 1))
            clutter[max(0, y - 1): y + 2, max(0, x - 1): x + 2] = 200.0
    saturated = np.asarray(render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W,
                                             saturate_center=True)).astype(np.float32)
    out = {}
    for name, img in (("clutter", clutter), ("saturated", saturated)):
        noise = rng.normal(0, 2.0, (H, W)).astype(np.float32)
        out[name] = np.clip(img + noise, 0, 255).astype(np.float32)
    return out


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("name", ["clutter", "saturated"])
def test_retention_fence_domain_matches_jax(name, branch):
    img = _retention_images()[name]
    cfg = jax_config(H, W, branch)
    got = port_detect(img, cfg)
    hold_to_jax(got, jax_detect(img, cfg), label=f"{name} {branch}")
    if branch == "xla":
        assert bool(got.ok[0]) and bool(got.stable[0]), name
        assert int(got.grid.valid[0].sum()) >= 20, name


@pytest.mark.parametrize("branch", BRANCHES)
def test_bench_family_scene_matches_jax(branch):
    scene = _bench_scene()
    img = np.asarray(render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W)).astype(np.float32)
    img = np.clip(img + np.random.default_rng(1).normal(0, 2.0, (H, W)).astype(np.float32), 0, 255)
    cfg = jax_config(H, W, branch)
    got = port_detect(img, cfg)
    hold_to_jax(got, jax_detect(img, cfg), label=f"bench {branch}")
    if branch == "xla":
        assert bool(got.ok[0]) and bool(got.labels_converged[0]) and bool(got.stable[0])


def test_frame_health_masks_unstable_frames():
    """The port's ``frame_health`` (models/pipeline.py) drops the chaotic
    26-degree frame, as the JAX test's; it equals the JAX ``frame_health``
    of the same batch leaf for leaf, and the port's batch meets the JAX
    batch (fence flags equal, points by the corpus contract)."""
    import jax
    import jax.numpy as jnp

    from _torch_port import port_stereo, to_port
    from cylinder_pose_estimation_tpu.config import FitConfig
    from cylinder_pose_estimation_tpu.models.pipeline import estimate_poses_batch as j_batch
    from cylinder_pose_estimation_tpu.models.pipeline import frame_health as j_health
    from cylinder_pose_estimation_tpu_torch.config import from_reference
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch, frame_health

    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0)
    good, bad = _lattice(0.0, 0), _lattice(26.0, 0)
    imgs = np.stack([good, bad])
    cfg = jax_config(H, W, "xla")
    batch = estimate_poses_batch(torch.as_tensor(imgs), torch.as_tensor(imgs), port_stereo(stereo),
                                 from_reference(cfg), from_reference(FitConfig()))
    health = frame_health(batch).numpy()
    assert not bool(batch.detect1.stable[1]) and not health[1]
    assert health[0]
    want = jax.jit(lambda a, b: j_batch(a, b, stereo, cfg, FitConfig()))(jnp.asarray(imgs), jnp.asarray(imgs))
    assert np.array_equal(health, np.asarray(j_health(want)))
    assert np.array_equal(frame_health(to_port(want)).numpy(), np.asarray(j_health(want)))
    for f, chaotic in ((0, False), (1, True)):
        for view in ("detect1", "detect2"):
            j_view = jax.tree_util.tree_map(lambda x: x[f], getattr(want, view))
            hold_to_jax(getattr(batch, view), j_view, i=f, chaotic=chaotic, label=f"frame {f} {view}")
