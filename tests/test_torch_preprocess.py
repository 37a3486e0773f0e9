"""PyTorch port: stereo preprocessing (undistortion + CLAHE) against the JAX
package on the CPU, at 240x320.

The JAX side runs op by op (``jax.vmap`` without ``jax.jit``), which is the
bit-level reference: under ``jax.jit`` XLA rewrites the undistortion's float32
arithmetic (the division by the focal length as a reciprocal multiply, fused
multiply-adds), moving source coordinates by up to 3e-5 px and grey levels by
up to 1e-3.  Op by op the two agree exactly; the assertions hold the stated
tolerances (remap and CLAHE 1e-3 grey levels, ``undistort_points`` 1e-4 px)
and print the measured maximum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _oracle_clahe
from _torch_port import port_stereo
from cylinder_pose_estimation_tpu.models import pipeline as jpipe
from cylinder_pose_estimation_tpu.ops import clahe as jclahe
from cylinder_pose_estimation_tpu.ops import image as jimage
from cylinder_pose_estimation_tpu.ops import remap as jremap
from cylinder_pose_estimation_tpu.types import CameraModel as JCam
from cylinder_pose_estimation_tpu.types import StereoParams as JStereo
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.ops import clahe, image, remap
from cylinder_pose_estimation_tpu_torch.types import CameraModel
from cylinder_pose_estimation_tpu_torch.utils.synthetic import distorted_example_pair

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W = 240, 320
# tests/test_preprocess.py::_distorting_camera
CAM = (np.asarray([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]], np.float32),
       np.asarray([-0.25, 0.08, 0.0], np.float32),
       np.asarray([1e-3, -5e-4], np.float32))


def _cams():
    return JCam(*(jnp.asarray(x) for x in CAM)), CameraModel(*(torch.as_tensor(x) for x in CAM))


def _images(n, seed=0):
    """Smooth fields with bright lines and noise, (n, H, W) float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        img = 80 + 50 * np.sin(xx / (25.0 + 5 * i)) + 30 * np.cos(yy / (20.0 + 3 * i))
        img += 120 * (np.abs((xx + 0.6 * yy + 7 * i) % 40 - 20) < 1.5)
        img += rng.normal(0, 6.0, (H, W))
        out.append(np.clip(img, 0, 255))
    return np.stack(out).astype(np.float32)


def _check(got, want, tol, label):
    d = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    print(f"{label}: max |d| {d:.3e}")
    assert d <= tol, (label, d)


def test_distort_points_matches_jax():
    jcam, tcam = _cams()
    xy = np.random.default_rng(1).uniform(-0.5, 0.5, (5, 7, 2)).astype(np.float32)
    _check(remap.distort_points(torch.as_tensor(xy), tcam),
           jremap.distort_points(jnp.asarray(xy), jcam), 1e-6, "distort_points")


@pytest.mark.parametrize("interp", ["cubic", "bilinear"])
def test_undistort_image_matches_jax(interp):
    jcam, tcam = _cams()
    imgs = _images(3)
    want = jax.vmap(lambda im: jremap.undistort_image(im, jcam, interp=interp))(jnp.asarray(imgs))
    got = remap.undistort_image(torch.as_tensor(imgs), tcam, interp=interp)
    assert got.shape == imgs.shape and got.dtype == torch.float32
    _check(got, want, 1e-3, f"undistort_image {interp}")


def test_undistort_points_matches_jax():
    jcam, tcam = _cams()
    xy = np.random.default_rng(2).uniform([10, 10], [W - 10, H - 10], (64, 2)).astype(np.float32)
    for iters in (8, 12):
        _check(remap.undistort_points(torch.as_tensor(xy), tcam, iters=iters),
               jremap.undistort_points(jnp.asarray(xy), jcam, iters=iters), 1e-4,
               f"undistort_points iters={iters}")


def test_cubic_sample_clamped_border_matches_jax():
    """The base tap is clamped to [1, w-3]: in the outer ~2 px the sample is
    the nearest interior stencil extrapolated, not an interpolation of the
    pixel it lands on, in both packages alike."""
    img = _images(1, seed=3)[0]
    xs = np.asarray([0.0, 0.25, 0.5, 1.0, 1.5, W - 2.5, W - 2.0, W - 1.5, W - 1.0], np.float32)
    ys = np.asarray([0.0, 0.75, 1.0, 2.0, H - 3.0, H - 2.25, H - 2.0, H - 1.5, H - 1.0], np.float32)
    gx, gy = np.meshgrid(xs, ys)
    want = jimage.cubic_sample(jnp.asarray(img), jnp.asarray(gx), jnp.asarray(gy))
    got = image.cubic_sample(torch.as_tensor(img), torch.as_tensor(gx), torch.as_tensor(gy))
    _check(got, want, 1e-3, "cubic_sample border")
    # At the corner pixels the clamped stencil does not return the pixel.
    corners = got.numpy()[[0, 0, -1, -1], [0, -1, 0, -1]]
    assert np.abs(corners - img[[0, 0, -1, -1], [0, -1, 0, -1]]).max() > 1e-2
    # Batched: (2, H, W) images share the coordinates.
    both = image.cubic_sample(torch.as_tensor(np.stack([img, img[::-1].copy()])),
                              torch.as_tensor(gx), torch.as_tensor(gy))
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())


@pytest.mark.parametrize(
    "tiles, clip_limit, normalized",
    [(8, 0.01, True), (4, 0.05, True), (4, 4.5, False)],
    ids=["adapthisteq_defaults", "tiles4_clip0.05", "cv2_clip4.5"],
)
def test_clahe_matches_jax(tiles, clip_limit, normalized):
    imgs = _images(2, seed=4)
    want = jax.vmap(lambda im: jclahe.clahe(im, tiles=tiles, clip_limit=clip_limit,
                                            clip_is_normalized=normalized))(jnp.asarray(imgs))
    got = clahe.clahe(torch.as_tensor(imgs), tiles=tiles, clip_limit=clip_limit,
                      clip_is_normalized=normalized)
    assert got.shape == imgs.shape
    _check(got, want, 1e-3, f"clahe tiles={tiles} clip={clip_limit}")


def test_clahe_cumsum_order_is_xla_cpu_order():
    """The fixed-order prefix sum equals ``jnp.cumsum`` on the CPU bit for
    bit, on 256 bins and on a length that is no multiple of the block."""
    rng = np.random.default_rng(5)
    for n in (256, 40):
        x = (rng.random((9, n)) * 37).astype(np.float32)
        got = image.cumsum_blocked(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))


def test_clahe_meets_adapthisteq_oracle():
    """tests/test_preprocess.py::test_clahe_matches_adapthisteq_oracle's
    contract at 240x320: mean |d| < 0.01, 99.9th percentile < 0.1, max < 3
    grey levels against the numpy transliteration of MATLAB adapthisteq."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:H, 0:W]
    for trial in range(3):
        img = (80 + 60 * np.sin(xx / (30.0 + 10 * trial)) + 40 * np.cos(yy / (25.0 + 8 * trial))
               + rng.normal(0, 10 + 4 * trial, (H, W)))
        img += 110 * np.exp(-((yy - 100 - 15 * trial) ** 2 + (xx - 150) ** 2) / (2 * 35 ** 2))
        img = np.clip(img, 0, 255)
        want = _oracle_clahe.adapthisteq(img)
        got = clahe.clahe(torch.as_tensor(img, dtype=torch.float32)).numpy()
        d = np.abs(want - got)
        assert d.mean() < 0.01, d.mean()
        assert np.percentile(d, 99.9) < 0.1
        assert d.max() < 3.0, d.max()


def _distorted_pair(n):
    st, (i1, i2) = distorted_example_pair(H, W, n_frames=n, seed=1)
    jst = JStereo(cam1=JCam(*(jnp.asarray(x) for x in st[0:3])),
                  cam2=JCam(*(jnp.asarray(x) for x in st[3:6])), t_c2_c1=jnp.asarray(st[6]))
    return st, jst, i1, i2


def test_preprocess_stereo_batch_matches_jax():
    st, jst, i1, i2 = _distorted_pair(2)
    want = jpipe.preprocess_stereo_batch(jnp.asarray(i1), jnp.asarray(i2), jst)
    got = pipeline.preprocess_stereo_batch(torch.as_tensor(i1), torch.as_tensor(i2), port_stereo(st))
    for view in range(2):
        assert got[view].shape == (2, H, W)
        _check(got[view], want[view], 1e-3, f"preprocess_stereo_batch view {view + 1}")


def test_preprocess_stereo_bgr_matches_jax():
    """(F, H, W, 3) BGR frames go to grey first, as in the JAX package."""
    st, jst, i1, i2 = _distorted_pair(1)
    rng = np.random.default_rng(6)
    tint = rng.uniform(0.8, 1.0, 3).astype(np.float32)
    b1 = np.clip(i1[..., None] * tint, 0, 255).astype(np.float32)
    b2 = np.clip(i2[..., None] * tint[::-1], 0, 255).astype(np.float32)
    want = jpipe.preprocess_stereo_batch(jnp.asarray(b1), jnp.asarray(b2), jst)
    got = pipeline.preprocess_stereo_batch(torch.as_tensor(b1), torch.as_tensor(b2), port_stereo(st))
    for view in range(2):
        assert got[view].shape == (1, H, W)
        _check(got[view], want[view], 1e-3, f"preprocess_stereo_batch BGR view {view + 1}")


def test_clahe_refuses_untiled_shape():
    with pytest.raises(ValueError, match="multiple of 8 tiles"):
        clahe.clahe(torch.zeros((1, 100, 90)))
