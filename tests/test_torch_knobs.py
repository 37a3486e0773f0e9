"""PyTorch port: the three detector knobs that choose a TPU formulation,
against the JAX package on the CPU.

* ``smooth_mxu=False``: the preprocess kernel smooths the grey image itself
  (``preprocess_binarize(..., pre_smoothed=False)``).  Its plain version
  equals the Pallas kernel in interpret mode on all six output planes,
  whole images included.
* ``pallas_cc_cross_cap``: the final labels' scans capped across each
  mask's lines (``connected_components(..., cap_axis, cap)``).  The plain
  version equals the Pallas kernel on tests/test_pallas.py's cross-cap mask
  at every schedule, cap and axis, cold and warm.
* ``bright_at_points=False``: the centre seed read from a full-image
  exact-mode brightness, on both branches.

Each knob then runs through ``detect_grid`` at 240x320 against the same JAX
branch (ids identical, xy within 1e-3 px, flags and counts equal), and all
three together through ``estimate_pose_stereo``.  The CUDA kernels are held
to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import hold_to_jax, jax_config, jax_detect, port_detect
from tests.test_pallas import _grid_image
from tests.test_torch_pipeline import _port_stereo, _small_pair
from cylinder_pose_estimation_tpu.config import CylinderDetectConfig as JDetect
from cylinder_pose_estimation_tpu.config import FitConfig as JFit
from cylinder_pose_estimation_tpu.models.pipeline import estimate_pose_stereo as jpose
from cylinder_pose_estimation_tpu.ops.pallas import frontend as jf
from cylinder_pose_estimation_tpu_torch.config import FitConfig, from_reference
from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_pose_stereo
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf
from cylinder_pose_estimation_tpu_torch.utils.synthetic import cylinder_view

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

PLANES = ("binary", "h_mask", "v_mask", "joints", "joint_cnt", "joint_peak")
# The variants record's 240x320 scenes (tools/make_torch_port_fixtures.py).
SCENE = dict(origin=[0.0, -15.0, 560.0], radius=52.0, row_spacing=12.0, theta_span=2.2, seed=0)


def _scene_240x320():
    return cylinder_view(240, 320, **SCENE)


def _noise(h, w):
    return np.random.default_rng(5).uniform(0, 255, (h, w)).astype(np.float32)


@pytest.mark.parametrize("maker, kw", [
    (_grid_image, {}),
    (_scene_240x320, {}),
    (lambda: _noise(64, 128), {"joint_peak_iters": 5}),
    (_grid_image, {"blur_ksize": 3, "ridge_sigma": 2.0}),
], ids=["grid96x256", "cylinder240x320", "noise64x128", "grid96x256_other_taps"])
def test_in_kernel_smoothing_plain_equals_pallas(maker, kw):
    """pre_smoothed=False: every plane equal as a whole image, the margin
    band included (the smoothing wraps around the image in both)."""
    img = np.asarray(maker(), np.float32)
    kw = dict(margin=24, **kw)
    outs_j = jf.preprocess_binarize(jnp.asarray(img), pre_smoothed=False, interpret=True, **kw)
    outs_t = tf.preprocess_binarize(torch.as_tensor(img)[None], pre_smoothed=False, **kw)
    for name, a, b in zip(PLANES, outs_j, outs_t):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy(), err_msg=name)
    assert float(outs_t[0].sum()) > 0


def test_in_kernel_smoothing_is_not_a_no_op():
    """The branch smooths: the same grey image taken as already smoothed
    gives other planes.  Its smoothing wraps around the image where the
    banded matmuls (``smooth_mxu=True``) pad with zeros, so the two differ
    at the border and agree to float rounding inside."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import _smooth

    x = torch.as_tensor(_grid_image())[None]
    own = tf.preprocess_binarize(x, margin=24)
    raw = tf.preprocess_binarize(x, margin=24, pre_smoothed=True)
    assert all(not torch.equal(a, b) for a, b in zip(own, raw))
    k5, k25 = tf.smoothing_taps()
    s = tf._sep_conv_roll(tf._sep_conv_roll(x, k5, 2), k5, 1)
    s = tf._sep_conv_roll(tf._sep_conv_roll(s, k25, 2), k25, 1)
    mm = _smooth(x, CylinderDetectConfig())
    assert float((s - mm)[:, :3].abs().max()) > 1.0
    assert float((s - mm)[:, 20:-20, 20:-20].abs().max()) < 1e-3


def _cross_cap_masks():
    """tests/test_pallas.py's cross-cap mask (wavy 2-px lines along W, a
    blob 24 px thick), its transpose's crop and a random mask."""
    m = np.zeros((96, 256), bool)
    xs = np.arange(10, 246)
    for yc in (24, 44):
        ys = (yc + 6 * np.sin(xs / 45.0)).astype(int)
        m[ys, xs] = True
        m[ys + 1, xs] = True
    m[60:84, 200:230] = True
    t = np.zeros_like(m)
    t[:, :96] = m[:96, :96].T
    rnd = np.random.default_rng(0).random(m.shape) < 0.45
    return np.stack([m, t, rnd]).astype(np.float32)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("cap", [1, 2, 3, 10, 16])
@pytest.mark.parametrize("cap_axis", [0, 1])
def test_capped_scan_plain_equals_pallas(cap_axis, cap, warm):
    masks = _cross_cap_masks()
    init = np.random.default_rng(1).integers(0, 2 * 96 * 256, masks.shape).astype(np.int32) if warm else None
    for rounds in (1, 2, 3, 24):
        want = np.asarray(jf.connected_components(
            jnp.asarray(masks), rounds=rounds, pools_per_round=2, cap_axis=cap_axis, cap=cap, interpret=True,
            init_labels=None if init is None else jnp.asarray(init)))
        got = tf.connected_components(torch.as_tensor(masks), rounds, 2,
                                      None if init is None else torch.as_tensor(init), cap_axis=cap_axis, cap=cap)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{rounds} rounds")


def test_capped_scan_differs_from_the_full_scan():
    """At one round the cap changes the labels (540 px at cap 3 on
    test_pallas's mask), and at 24 rounds cap 16 reaches the fixpoint."""
    masks = torch.as_tensor(_cross_cap_masks()[:1])
    full = tf.connected_components(masks, 1, 2)
    assert int((tf.connected_components(masks, 1, 2, cap_axis=0, cap=3) != full).sum()) == 540
    assert torch.equal(tf.connected_components(masks, 24, 2, cap_axis=0, cap=16),
                       tf.connected_components(masks, 24, 2))


@pytest.mark.parametrize("n, cap, reach", [(96, 1, 0), (96, 2, 1), (96, 3, 3), (96, 10, 15), (96, 16, 15),
                                           (96, 64, 63), (96, 65, -1), (96, 0, -1), (16, 16, -1), (17, 16, 15)])
def test_cap_reach(n, cap, reach):
    assert tf.cap_reach(n, cap) == reach


@pytest.mark.parametrize("cap_axis, cap", [(2, 4), (-2, 4), (0, -1)])
def test_cap_values_jax_would_not_take_raise(cap_axis, cap):
    with pytest.raises(ValueError, match="cap"):
        tf.connected_components(torch.zeros((1, 32, 64)), 1, 2, cap_axis=cap_axis, cap=cap)


# (branch, overrides) of each knob's detect_grid comparison.
KNOBS = [
    ("kernels", {"smooth_mxu": False}),
    ("kernels", {"pallas_cc_cross_cap": 16}),
    ("kernels", {"pallas_cc_cross_cap": 16, "label_downsample": 1}),
    ("kernels", {"bright_at_points": False}),
    ("xla", {"bright_at_points": False}),
]


@pytest.mark.parametrize("branch, override", KNOBS,
                         ids=["smoothing", "cross_cap", "cross_cap_ds1", "bright_kernels", "bright_xla"])
def test_detect_knob_matches_jax(branch, override):
    img = _scene_240x320()
    cfg = jax_config(240, 320, branch, **override)
    want = jax_detect(img, cfg)
    got = port_detect(img, cfg)
    res = hold_to_jax(got, want, label=f"{branch} {override}")
    assert res["n"] >= 30


def test_all_knobs_through_estimate_pose_stereo():
    """smooth_mxu=False, pallas_cc_cross_cap=16 and bright_at_points=False
    together, stereo pair to cylinder fit, against the JAX Pallas path."""
    st, a, b = _small_pair()
    jcfg = JDetect(height=240, width=320, use_pallas=True, pallas_interpret=True, min_ok_points=10,
                   smooth_mxu=False, pallas_cc_cross_cap=16, bright_at_points=False)
    j = jax.jit(lambda x, y: jpose(x, y, st, jcfg, JFit()))(jnp.asarray(a), jnp.asarray(b))
    t = estimate_pose_stereo(torch.as_tensor(a), torch.as_tensor(b), _port_stereo(st), from_reference(jcfg),
                             FitConfig())
    for jd, td_ in ((j.detect1, t.detect1), (j.detect2, t.detect2)):
        want = {tuple(np.asarray(jd.grid.idx)[k]): np.asarray(jd.grid.xy)[k]
                for k in range(576) if bool(jd.grid.valid[k])}
        got = {tuple(td_.grid.idx.numpy()[k]): td_.grid.xy.numpy()[k]
               for k in range(576) if bool(td_.grid.valid[k])}
        assert len(want) >= 30 and set(got) == set(want)
        assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-3
        for flag in ("ok", "stable", "labels_converged", "bridged_components"):
            assert getattr(td_, flag).item() == np.asarray(getattr(jd, flag)).item(), flag
    assert abs(float(t.fit.mean_reproj_error) - float(j.fit.mean_reproj_error)) < 1e-4
    ja = np.asarray(j.fit.params)[3:]
    ta = t.fit.params[3:].numpy()
    cos = abs(np.dot(ja, ta)) / (np.linalg.norm(ja) * np.linalg.norm(ta))
    assert np.arccos(min(cos, 1.0)) < 1e-3
