"""PyTorch port, the ops of the XLA detection branch against the JAX package
on the same numpy inputs (240x320, on the CPU):

* ``ops/image.py`` filters in every pad mode: 1e-5 abs (measured: equal,
  since the port reproduces the fused multiply-adds and the reciprocal
  scaling that XLA's CPU backend compiles the JAX code into);
* ``ops/ridge.py``: Hessian minima within 1e-6 and the Sauvola surface
  within 1e-6 abs (a few hundred pixels differ by one float32 ulp, where
  XLA fuses the eigenvalue and variance multiply-adds in its own way); the
  binary masks differ in at most ``BINARY_FLIPS`` pixels (measured: 0);
* ``ops/morphology.py`` shifts, line dilation, ray counts and closing on
  random masks, angles and traced lengths: exact;
* ``ops/labeling.connected_components`` for 1-16 iterations: exact;
* a bfloat16 Gaussian blur: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.ops import image as jimage
from cylinder_pose_estimation_tpu.ops import labeling as jlab
from cylinder_pose_estimation_tpu.ops import morphology as jmorph
from cylinder_pose_estimation_tpu.ops import ridge as jridge
from cylinder_pose_estimation_tpu_torch.ops import image, labeling, morphology, ridge

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W = 240, 320
MODES = ["reflect101", "edge", "constant"]
# Binary pixels allowed to differ from JAX in the ridge binarisation test
# (ROADMAP section 3 records the count).
BINARY_FLIPS = 0


def _images(n=2, seed=0):
    return (np.random.default_rng(seed).random((n, H, W)) * 255).astype(np.float32)


def _masks(n=6, h=120, w=256, density=0.3, seed=1):
    return np.random.default_rng(seed).random((n, h, w)) < density


def _vmap(fn, *args):
    return np.asarray(jax.jit(jax.vmap(fn))(*args))


@pytest.mark.parametrize("mode", MODES)
def test_pad2d_matches(mode):
    x = _images()
    want = _vmap(lambda im: jimage.pad2d(im, 3, 5, mode), x)
    np.testing.assert_array_equal(image.pad2d(torch.as_tensor(x), 3, 5, mode).numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_separable_filters_match(mode):
    x = _images()
    t = torch.as_tensor(x)
    k5 = jimage.gaussian_kernel1d_cv(5)
    k7 = jimage.gaussian_kernel1d_cv(7)
    np.testing.assert_array_equal(image.gaussian_kernel1d_cv(5).numpy(), np.asarray(k5))
    np.testing.assert_array_equal(image.gaussian_kernel1d_scipy(3.0).numpy(),
                                  np.asarray(jimage.gaussian_kernel1d_scipy(3.0)))
    cases = [
        (lambda im: jimage.sep_filter2d(im, k5, k7, mode),
         image.sep_filter2d(t, image.gaussian_kernel1d_cv(5), image.gaussian_kernel1d_cv(7), mode)),
        (lambda im: jimage.gaussian_blur_cv(im, 5, mode=mode), image.gaussian_blur_cv(t, 5, mode=mode)),
        (lambda im: jimage.gaussian_blur_scipy(im, 3.0, mode=mode), image.gaussian_blur_scipy(t, 3.0, mode=mode)),
    ]
    for fn, got in cases:
        np.testing.assert_allclose(got.numpy(), _vmap(fn, x), rtol=0, atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_box_filter_matches(mode, normalize):
    x = _images()
    for k in (11, 15):
        want = _vmap(lambda im: jimage.box_filter(im, k, mode=mode, normalize=normalize), x)
        got = image.box_filter(torch.as_tensor(x), k, mode=mode, normalize=normalize)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_box_filter_counts_are_exact():
    """The joint count: 0/1 images, constant padding, no normalisation."""
    m = _masks(2, H, W, 0.2).astype(np.float32)
    want = _vmap(lambda im: jimage.box_filter(im, 11, mode="constant", normalize=False), m)
    got = image.box_filter(torch.as_tensor(m), 11, mode="constant", normalize=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gradient2d_matches():
    x = _images()
    want = jax.jit(jax.vmap(jimage.gradient2d))(x)
    got = image.gradient2d(torch.as_tensor(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_blur_bfloat16_matches():
    """``image_dtype="bfloat16"``: the blur in bfloat16 arithmetic."""
    x = _images()
    want = jax.jit(jax.vmap(lambda im: jimage.gaussian_blur_cv(im, 5)))(
        jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32)
    got = image.gaussian_blur_cv(torch.as_tensor(x).to(torch.bfloat16), 5).to(torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _blurred():
    return _vmap(lambda im: jimage.gaussian_blur_cv(im, 5), _images())


def test_hessian_and_sauvola_match():
    b = _blurred()
    want_min = _vmap(lambda im: jridge.hessian_eigenimages(im, 3.0)[1], b)
    got_min = ridge.hessian_eigenimages(torch.as_tensor(b), 3.0)[1].numpy()
    np.testing.assert_allclose(got_min, want_min, rtol=0, atol=1e-6)
    want_t = _vmap(jridge.sauvola_threshold, want_min)
    got_t = ridge.sauvola_threshold(torch.as_tensor(want_min)).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-6)
    print(f"minima: {int((got_min != want_min).sum())} px differ; "
          f"threshold: {int((got_t != want_t).sum())} px differ (of {b.size})")


@pytest.mark.parametrize("min_contrast", [0.0, 0.05])
def test_binarize_ridges_flips_counted(min_contrast):
    b = _blurred()
    want = _vmap(lambda im: jridge.binarize_ridges(im, min_contrast=min_contrast), b)
    got = ridge.binarize_ridges(torch.as_tensor(b), min_contrast=min_contrast).numpy()
    flips = int((got != want).sum())
    print(f"binarize_ridges min_contrast={min_contrast}: {flips} of {b.size} pixels flip")
    assert flips <= BINARY_FLIPS


def test_shift2d_matches():
    m = _masks()
    rng = np.random.default_rng(2)
    dy = rng.integers(-40, 40, m.shape[0]).astype(np.int32)
    dx = rng.integers(-300, 300, m.shape[0]).astype(np.int32)
    want = np.asarray(jax.vmap(jmorph.shift2d)(m, dy, dx))
    got = morphology.shift2d(torch.as_tensor(m), torch.as_tensor(dy), torch.as_tensor(dx))
    np.testing.assert_array_equal(got.numpy(), want)
    f = m.astype(np.float32) * 3.0
    want = np.asarray(jax.vmap(jmorph.shift2d)(f, dy, dx))
    np.testing.assert_array_equal(
        morphology.shift2d(torch.as_tensor(f), torch.as_tensor(dy), torch.as_tensor(dx)).numpy(), want)


def _angles(n, seed):
    a = np.random.default_rng(seed).uniform(-np.pi, np.pi, n).astype(np.float32)
    a[:4] = [0.0, np.pi / 2, np.float32(1.5707964), -np.pi / 4]
    return a


@pytest.mark.parametrize("max_length", [2, 62, 125, 180])
def test_dilate_line_matches(max_length):
    m = _masks(8, density=0.02)
    ang = _angles(8, max_length)
    lens = np.random.default_rng(max_length).uniform(0, 2.5 * max_length, 8).astype(np.float32)
    lens[:2] = [0.0, 400.0]
    want = _vmap(lambda mm, a, ln: jmorph.dilate_line(mm, a, max_length, ln), m, ang, lens)
    got = morphology.dilate_line(torch.as_tensor(m), torch.as_tensor(ang), max_length, torch.as_tensor(lens))
    np.testing.assert_array_equal(got.numpy(), want)
    want = _vmap(lambda mm, a: jmorph.dilate_line(mm, a, max_length), m, ang)
    np.testing.assert_array_equal(
        morphology.dilate_line(torch.as_tensor(m), torch.as_tensor(ang), max_length).numpy(), want)


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("probe_len", [0, 1, 2, 3, 5, 9])
def test_directional_count_matches(probe_len, sign):
    m = _masks()
    ang = _angles(m.shape[0], probe_len)
    want = _vmap(lambda mm, a: jmorph.directional_count(mm, a, probe_len, sign), m, ang)
    got = morphology.directional_count(torch.as_tensor(m), torch.as_tensor(ang), probe_len, sign)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wy, wx", [(3, 3), (1, 20), (20, 1), (4, 5)])
def test_rect_morphology_matches(wy, wx):
    m = _masks(3)
    for jfn, tfn in ((jmorph.close_rect, morphology.close_rect), (jmorph.open_rect, morphology.open_rect),
                     (jmorph.dilate_rect, morphology.dilate_rect), (jmorph.erode_rect, morphology.erode_rect)):
        want = _vmap(lambda mm: jfn(mm, wy, wx), m)
        np.testing.assert_array_equal(tfn(torch.as_tensor(m), wy, wx).numpy(), want)


def _cc_masks():
    """Random masks and line grids with a serpentine (unconverged for a
    few iterations)."""
    m = _masks(4, 64, 96, 0.45)
    g = np.zeros((2, 64, 96), bool)
    g[0, 4:60:6, 2:94] = True
    g[0, 2:62, 5:90:11] = True
    for y in range(2, 62, 4):
        g[1, y, 1:95] = True
        g[1, y:y + 4, 94 if (y // 4) % 2 == 0 else 1] = True
    return np.concatenate([m, g])


@pytest.mark.parametrize("iters", range(1, 17))
def test_connected_components_matches(iters):
    m = _cc_masks()
    want = _vmap(lambda mm: jlab.connected_components(mm, iters), m)
    got = labeling.connected_components(torch.as_tensor(m), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
