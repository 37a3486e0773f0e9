"""PyTorch port: the detector's building blocks against the JAX package's
functions on the same numpy inputs -- banded-matrix correlations
(``ops/mxu_conv``), component bookkeeping (``ops/labeling``), rectangle
morphology (``ops/morphology``) and ``bgr_to_gray``.

Integer and mask results must be equal.  Float results: the default
(bf16-operand) correlations within 1e-3 relative (products are exact, only
the summation order differs), exact-mode ones within 1e-5 relative, and
moment-derived stats within 1e-4 relative (the port sums coordinate moments
exactly in float64; the reference in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.ops import labeling as jl
from cylinder_pose_estimation_tpu.ops import morphology as jmo
from cylinder_pose_estimation_tpu.ops import mxu_conv as jm
from cylinder_pose_estimation_tpu.ops.image import bgr_to_gray as jgray
from cylinder_pose_estimation_tpu.ops.pallas.frontend import connected_components as jcc
from cylinder_pose_estimation_tpu_torch.ops import labeling as tl
from cylinder_pose_estimation_tpu_torch.ops import morphology as tmo
from cylinder_pose_estimation_tpu_torch.ops import mxu_conv as tm
from cylinder_pose_estimation_tpu_torch.ops.image import bgr_to_gray as tgray

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _image(h=96, w=128, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


TAPS = {
    "box11": tm.box_taps(11),
    "ramp11": tm.ramp_taps(11),
    "gauss19": tm.gauss_taps_cv(19),
    "composed": tm.compose_taps(tm.gauss_taps_cv(5), tm.gauss_taps_scipy(3.0)),
}


@pytest.mark.parametrize("name", sorted(TAPS))
def test_taps_equal_reference(name):
    ref = {
        "box11": jm.box_taps(11),
        "ramp11": jm.ramp_taps(11),
        "gauss19": jm.gauss_taps_cv(19),
        "composed": jm.compose_taps(jm.gauss_taps_cv(5), jm.gauss_taps_scipy(3.0)),
    }[name]
    assert TAPS[name] == ref


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", ["gauss19", "composed", "box11"])
def test_conv_x_y_match(name, exact):
    img = _image()
    h, w = img.shape
    taps = TAPS[name]
    jx = jm.conv_y(jm.conv_x(jnp.asarray(img), jm.x_mat(taps, w, exact=exact), exact=exact),
                   jm.y_mat(taps, h, exact=exact), exact=exact)
    tx = tm.conv_y(tm.conv_x(_t(img), tm.x_mat(taps, w, "cpu", exact=exact), exact=exact),
                   tm.y_mat(taps, h, "cpu", exact=exact), exact=exact)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5 if exact else 1e-3, atol=1e-3)


def test_band_matrix_rounds_to_bf16_like_reference():
    taps = TAPS["gauss19"]
    np.testing.assert_array_equal(
        tm.x_mat(taps, 64, "cpu").numpy(), np.asarray(jm.x_mat(taps, 64)).astype(np.float32)
    )
    np.testing.assert_array_equal(
        tm.y_mat(taps, 64, "cpu", exact=True).numpy(), np.asarray(jm.y_mat(taps, 64, exact=True))
    )


def test_conv_at_points_and_range_mean_match():
    img = _image(seed=3)
    rng = np.random.default_rng(4)
    ys = rng.integers(0, 96, 40).astype(np.int32)
    xs = rng.integers(0, 128, 40).astype(np.int32)
    j = jm.conv_at_points(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs), jm.box_taps(11))
    t = tm.conv_at_points(_t(img), _t(ys), _t(xs), tm.box_taps(11))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)
    y0, x0 = ys - 4, xs - 7
    y1, x1 = ys + rng.integers(0, 6, 40), xs + rng.integers(0, 9, 40)
    args = [np.clip(a, 0, n).astype(np.int32) for a, n in ((y0, 96), (y1, 96), (x0, 128), (x1, 128))]
    j = np.asarray(jm.range_mean_at_points(jnp.asarray(img), *map(jnp.asarray, args)))
    t = tm.range_mean_at_points(_t(img), *map(_t, args)).numpy()
    assert np.array_equal(np.isinf(j), np.isinf(t))
    np.testing.assert_allclose(t[np.isfinite(j)], j[np.isfinite(j)], rtol=1e-5)


def _labels(seed, h=64, w=128, p=0.4):
    m = np.random.default_rng(seed).uniform(size=(h, w)) < p
    lab = np.asarray(jcc(jnp.asarray(m), rounds=8, pools_per_round=4, interpret=True))
    return m, lab


@pytest.mark.parametrize("seed", [0, 1])
def test_component_stats_first_k_match(seed):
    _, lab = _labels(seed)
    j = jl.component_stats_first_k(jnp.asarray(lab), k=32, compute_bbox=False)
    t = tl.component_stats_first_k(_t(lab)[None], k=32)
    np.testing.assert_array_equal(t.root[0].numpy(), np.asarray(j.root))
    np.testing.assert_array_equal(t.count[0].numpy(), np.asarray(j.count))
    np.testing.assert_array_equal(t.valid[0].numpy(), np.asarray(j.valid))
    for name in ("mxx", "mxy", "myy"):
        np.testing.assert_allclose(getattr(t, name)[0].numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(t.centroid[0].numpy(), np.asarray(j.centroid), rtol=1e-5)


def test_component_stats_pooled_value_shape_match():
    """The bridge's quarter-res form: stats over 2x2 min-pooled labels whose
    values index the unpooled grid."""
    _, lab = _labels(2, h=64, w=128, p=0.3)
    pooled = lab.reshape(32, 2, 64, 2).min(axis=(1, 3))
    j = jl.component_stats_first_k(jnp.asarray(pooled), k=32, compute_bbox=False,
                                   value_shape=(64, 128))
    t = tl.component_stats_first_k(_t(pooled)[None], k=32, value_shape=(64, 128))
    np.testing.assert_array_equal(t.root[0].numpy(), np.asarray(j.root))
    np.testing.assert_array_equal(t.count[0].numpy(), np.asarray(j.count))


@pytest.mark.parametrize("k", [4, 32])
def test_largest_component_and_fill_match(k):
    m, lab = _labels(5, p=0.55)
    j = np.asarray(jl.largest_component_mask(jnp.asarray(lab), k=k))
    t = tl.largest_component_mask(_t(lab)[None], k=k)[0].numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tl.fill_orthoconvex(_t(j))[...].numpy(),
                                  np.asarray(jl.fill_orthoconvex(jnp.asarray(j))))


def test_largest_component_of_empty_mask_is_empty():
    lab = np.full((16, 32), 16 * 32, np.int32)
    assert not tl.largest_component_mask(_t(lab)[None], k=8).any()


def test_prefix_rank_and_compact_true_indices_match():
    m = np.random.default_rng(6).uniform(size=5000) < 0.01
    np.testing.assert_array_equal(tl.prefix_rank(_t(m)).numpy(), np.asarray(jl.prefix_rank(jnp.asarray(m))))
    ji, jv = jl.compact_true_indices(jnp.asarray(m), 64)
    ti, tv = tl.compact_true_indices(_t(m), 64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_peak_key_shift_matches():
    for h, w in ((480, 640), (240, 320), (768, 1024)):
        assert tl.peak_key_shift(h, w, 11) == jl.peak_key_shift(h, w, 11)


@pytest.mark.parametrize("op", ["dilate_rect", "erode_rect", "open_rect"])
@pytest.mark.parametrize("wy, wx", [(3, 3), (9, 9), (1, 20), (20, 1)])
def test_rect_morphology_matches(op, wy, wx):
    m = np.random.default_rng(wy * 31 + wx).uniform(size=(48, 64)) < 0.6
    j = np.asarray(getattr(jmo, op)(jnp.asarray(m), wy, wx))
    t = getattr(tmo, op)(_t(m)[None], wy, wx)[0].numpy()
    np.testing.assert_array_equal(t, j)


def test_bgr_to_gray_matches():
    img = np.random.default_rng(7).uniform(0, 255, (24, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(tgray(_t(img)).numpy(), np.asarray(jgray(jnp.asarray(img))))
