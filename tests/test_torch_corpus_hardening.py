"""PyTorch port on the rest of the JAX package's detector-hardening corpus
(tests/test_detector_hardening.py, CPU): ROI clutter (:196), low contrast
with equalisation (:244), the ``_assign_labels`` capacity overflow (:45),
``_joint_peaks`` uniqueness on large images (:395) and, under ``slow`` as in
JAX, the cross-view prune fence (:750).

Detections are held to the same JAX branch by ``_torch_port.hold_to_jax``
(ids identical, xy within 1e-3 px, the fence flags and counts equal,
``max_line_tilt`` within 1e-5 rad); the units to the JAX functions' outputs
exactly; and the port meets each JAX test's ground-truth assertion on the
branch that test runs.
"""

import numpy as np
import pytest
import torch

from _torch_port import BRANCHES, hold_to_jax, jax_config, jax_detect, port_detect, port_stereo
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    plane_grid_points,
    render_grid_image,
)
from cylinder_pose_estimation_tpu_torch.models import detector as tdet
from tests.test_detector_hardening import H, W, _small_stereo

torch.set_num_threads(1)


def _clutter_scene():
    """test_cylinder_roi_rejects_background_clutter's image: a 9x9 grid plus
    a bright 2x2 mini-grid in the top-left corner."""
    import jax.numpy as jnp

    scene = cylinder_grid_points(_small_stereo(), capacity=128, n_rows=9, n_cols=9, origin=(10.0, -15.0, 560.0),
                                 radius=52.0, row_spacing=12.0, theta_span=2.2)
    img = render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W).astype(jnp.float32)
    corner = jnp.asarray([[8.0, 8.0], [50.0, 10.0], [10.0, 36.0], [52.0, 38.0]], jnp.float32)
    clutter = render_grid_image(corner, jnp.ones((4,), bool), 2, 2, H, W, background=0.0,
                                center_gain=0.0).astype(jnp.float32)
    return scene, np.asarray(jnp.maximum(img, clutter), np.float32)


@pytest.mark.parametrize("branch", BRANCHES)
def test_roi_clutter_matches_jax(branch):
    scene, img = _clutter_scene()
    cfg = jax_config(H, W, branch)
    got = port_detect(img, cfg)
    hold_to_jax(got, jax_detect(img, cfg), label=f"clutter {branch}")
    if branch != "xla":
        return
    # Only true grid ids, median error under 2 px.
    assert bool(got.ok[0])
    gt = {tuple(np.asarray(scene.gp1.idx)[i]): np.asarray(scene.gp1.xy)[i] for i in range(81)}
    v = got.grid.valid[0].numpy()
    ids, xy = got.grid.idx[0].numpy()[v], got.grid.xy[0].numpy()[v]
    assert len(ids) >= 20
    assert all(tuple(k) in gt for k in ids)
    assert np.median([np.linalg.norm(p - gt[tuple(k)]) for k, p in zip(ids, xy)]) < 2.0


def _low_contrast_views():
    import jax.numpy as jnp

    stereo = _small_stereo()
    scene = plane_grid_points(stereo, origin=(0.0, 0.0, 700.0), n_rows=7, n_cols=7, spacing=23.5, capacity=128)

    def squash(xy):
        img = render_grid_image(xy, scene.gp1.valid, 7, 7, H, W).astype(jnp.float32)
        return np.asarray(10.0 + img * (50.0 / 255.0), np.float32)

    return stereo, squash(scene.gp1.xy), squash(scene.gp2.xy)


@pytest.mark.parametrize("branch", BRANCHES)
def test_low_contrast_needs_equalization(branch):
    """Raw [10, 60] frames fail the plane ROI threshold; after the port's
    ``preprocess_stereo`` (cubic undistortion, adapthisteq at clip 0.5)
    the grid is found.  The port's equalised frames equal the JAX ones
    (both op by op), and both detections meet JAX's."""
    from cylinder_pose_estimation_tpu.ops.clahe import preprocess_stereo as j_pre
    from cylinder_pose_estimation_tpu_torch.ops.clahe import preprocess_stereo as t_pre

    stereo, img1, img2 = _low_contrast_views()
    cfg = jax_config(H, W, branch, plane=True)
    raw = port_detect(img1, cfg)
    hold_to_jax(raw, jax_detect(img1, cfg), label=f"low contrast raw {branch}")
    assert not bool(raw.ok[0])
    st = port_stereo(stereo)
    eq1, _ = t_pre(torch.as_tensor(img1), torch.as_tensor(img2), st.cam1, st.cam2, clip_limit=0.5)
    want1, _ = j_pre(img1, img2, stereo.cam1, stereo.cam2, clip_limit=0.5)
    assert np.abs(eq1.numpy() - np.asarray(want1)).max() <= 1e-3
    got = port_detect(eq1.numpy(), cfg)
    hold_to_jax(got, jax_detect(np.asarray(want1), cfg), label=f"low contrast equalised {branch}")
    assert bool(got.ok[0]) and int(got.grid.valid[0].sum()) >= 25


def test_assign_labels_overflow_keeps_largest():
    """More components than slots: the slots keep the components with the
    most centroids.  The port's slots and flags equal JAX's."""
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.models.detector import _assign_labels

    h, w = 32, 64
    label_img = np.full((h, w), h * w, np.int32)
    cents, big = [], set()
    for i in range(10):
        x0 = i * 6
        label_img[:, x0:x0 + 4] = x0
        n_c = 6 if i >= 8 else 1
        if n_c > 1:
            big.add(i)
        cents += [(x0 + 1, 3 + 2 * j, i) for j in range(n_c)]
    xy = np.asarray([[c[0], c[1]] for c in cents], np.float32)
    valid = np.ones(len(cents), bool)
    want_of, want_ok, _ = _assign_labels(jnp.asarray(label_img), jnp.asarray(xy), jnp.asarray(valid), capacity=4)
    slot_of, ok = tdet._assign_labels(torch.as_tensor(label_img)[None], torch.as_tensor(xy)[None],
                                      torch.as_tensor(valid)[None], 4, 1)
    slot_of, ok = slot_of[0].numpy(), ok[0].numpy()
    assert np.array_equal(slot_of, np.asarray(want_of)) and np.array_equal(ok, np.asarray(want_ok))
    assert all(ok[k] for k, c in enumerate(cents) if c[2] in big)
    assert len({slot_of[k] for k, c in enumerate(cents) if c[2] in big}) == 2
    assert len(set(slot_of[ok].tolist())) == 4


def test_joint_peaks_unique_on_large_images():
    """One peak per blob when H*W > 2^19 (768x1024): the port's peaks equal
    JAX's on the same joints and box counts."""
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.models.detector import _joint_peaks as j_peaks
    from cylinder_pose_estimation_tpu.ops.image import box_filter as j_box
    from cylinder_pose_estimation_tpu_torch.ops.image import box_filter
    from cylinder_pose_estimation_tpu_torch.ops.labeling import peak_key_shift

    assert peak_key_shift(768, 1024, 11) == 20
    h, w = 768, 1024
    m = np.zeros((h, w), bool)
    m[600:603, 100:103] = True
    m[700:705, 900:905] = True
    m[760:762, 1000:1002] = True
    joints = torch.as_tensor(m)[None]
    cnt = box_filter(joints.to(torch.float32), 11, mode="constant", normalize=False)
    peak = tdet._joint_peaks(joints, cnt, peak_iters=5, window=11)[0].numpy()
    jj = jnp.asarray(m)
    want = np.asarray(j_peaks(jj, j_box(jj.astype(jnp.float32), 11, mode="constant", normalize=False),
                              peak_iters=5, window=11))
    assert np.array_equal(peak, want)
    assert peak.sum() == 3
    for ys, xs in ((slice(600, 603), slice(100, 103)), (slice(700, 705), slice(900, 905)),
                   (slice(760, 762), slice(1000, 1002))):
        assert peak[ys, xs].sum() == 1


@pytest.mark.slow
def test_cross_view_prune_mismatch_is_health_fenced():
    """test_parallel's miniature kinematic frames, where the two views of
    frames 5-6 prune different columns: the port's batch meets JAX's
    (detections by the corpus contract, the same ``frame_health``), the
    poisoned frames exist and the port's fence masks every one of them."""
    import jax

    import test_parallel as tp
    from _torch_port import to_port
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig, RegistrationConfig
    from cylinder_pose_estimation_tpu.models.pipeline import estimate_poses_batch as j_batch
    from cylinder_pose_estimation_tpu.models.pipeline import frame_health as j_health
    from cylinder_pose_estimation_tpu_torch.config import from_reference
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch, frame_health

    stereo = tp.default_stereo(cx=tp.W / 2.0, cy=tp.H / 2.0, baseline=30.0)
    i1, i2 = tp._frames(stereo, 8)
    cfg = CylinderDetectConfig(height=tp.H, width=tp.W, cc_iters=8, min_ok_points=5)
    fit_cfg = FitConfig(cyl_radius=55.0, lm_iters=40)
    rcfg = RegistrationConfig(cyl_radius=55.0, min_frame_points=5)
    want = jax.jit(lambda a, b: j_batch(a, b, stereo, cfg, fit_cfg))(i1, i2)
    batch = estimate_poses_batch(torch.as_tensor(np.asarray(i1)), torch.as_tensor(np.asarray(i2)),
                                 port_stereo(stereo), from_reference(cfg), from_reference(fit_cfg))
    for f in range(8):
        for view in ("detect1", "detect2"):
            j_view = jax.tree_util.tree_map(lambda x: x[f], getattr(want, view))
            hold_to_jax(getattr(batch, view), j_view, i=f, label=f"frame {f} {view}")
    health = frame_health(batch, from_reference(rcfg)).numpy()
    assert np.array_equal(frame_health(to_port(want), from_reference(rcfg)).numpy(),
                          np.asarray(j_health(want, rcfg)))
    poisoned = batch.fit.mean_reproj_error.numpy() > rcfg.max_frame_reproj_px
    assert np.array_equal(poisoned, np.asarray(want.fit.mean_reproj_error) > rcfg.max_frame_reproj_px)
    assert np.array_equal(health, np.asarray(j_health(want, rcfg)))
    assert poisoned.any() and not (poisoned & health).any() and (health & ~poisoned).sum() >= 5
