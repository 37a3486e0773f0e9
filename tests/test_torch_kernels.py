"""PyTorch port: each kernel's plain PyTorch version against the JAX Pallas
kernel it replaces, run in interpret mode on the CPU (as tests/test_pallas.py
runs them).  Every comparison is EXACT: all six preprocess planes, the labels
of every CC schedule the detector uses (cold, warm), and the bridged masks.

The CUDA kernels are held to these plain versions bit for bit on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.ops import mxu_conv as jm
from cylinder_pose_estimation_tpu.ops.pallas import frontend as jf
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

MARGIN = 24  # detector._border_margin at the default config


def _grid_image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 20.0, np.float32)
    for y in range(30, h - 30, 17):
        img[y:y + 3, 30:w - 30] += 150.0
    for x in range(30, w - 30, 19):
        img[30:h - 30, x:x + 3] += 150.0
    return img + rng.normal(0, 2.0, img.shape).astype(np.float32)


def _cylinder_image(h, w, seed):
    st = default_stereo(cx=w / 2.0, cy=h / 2.0)
    sc = cylinder_grid_points(st, capacity=128, origin=(0.0, -15.0, 560.0), radius=52.0,
                              row_spacing=12.0, theta_span=2.2)
    img = np.asarray(render_grid_image(sc.gp1.xy, sc.gp1.valid, 9, 9, h, w), np.float32)
    return np.clip(img + np.random.default_rng(seed).normal(0, 2.0, (h, w)).astype(np.float32), 0, 255)


def _noise_image(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def _jax_smooth(img):
    """The detector's composed smoothing in the JAX package (exact mode)."""
    h, w = img.shape
    ct = jm.compose_taps(jm.gauss_taps_cv(5), jm.gauss_taps_scipy(3.0))
    k = jm.conv_x(jnp.asarray(img), jm.x_mat(ct, w, exact=True), exact=True)
    return np.asarray(jm.conv_x(k.T, jm.x_mat(ct, h, exact=True), exact=True).T)


PLANES = ("binary", "h_mask", "v_mask", "joints", "joint_cnt", "joint_peak")


@pytest.mark.parametrize(
    "maker, h, w",
    [(_grid_image, 96, 256), (_cylinder_image, 240, 320), (_noise_image, 64, 128)],
    ids=["grid96x256", "cylinder240x320", "noise64x128"],
)
def test_preprocess_plain_equals_pallas(maker, h, w):
    smoothed = np.stack([_jax_smooth(maker(h, w, s)) for s in (0, 1)])
    outs_t = tf.preprocess_binarize(torch.as_tensor(smoothed), margin=MARGIN, joint_peak_iters=5,
                                    pre_smoothed=True)
    for i in range(2):
        outs_j = jf.preprocess_binarize(jnp.asarray(smoothed[i]), pre_smoothed=True, margin=MARGIN,
                                        joint_peak_iters=5, interpret=True)
        for name, a, b in zip(PLANES, outs_j, outs_t):
            a = np.asarray(a)
            b = b[i].numpy()
            # A Sauvola near-tie flip would show first in `binary`; none has
            # been observed, so any difference fails with its pixel count.
            n_diff = int((a != b).sum())
            assert n_diff == 0, f"image {i} plane {name}: {n_diff} pixels differ"
        assert np.asarray(outs_j[0]).sum() > 0


def _line_mask(h, w, seed):
    m = np.zeros((h, w), bool)
    rng = np.random.default_rng(seed)
    xs = np.arange(10, w - 10)
    for yc in range(12, h - 12, 14):
        ys = (yc + 4 * np.sin(xs / 9.0 + rng.uniform(0, 6))).astype(int)
        keep = rng.uniform(size=xs.size) > 0.05
        m[ys[keep], xs[keep]] = True
        m[np.clip(ys[keep] + 1, 0, h - 1), xs[keep]] = True
    m[:, ::23] |= rng.uniform(size=(h, 1)) < 0.7
    return m


def _masks(kind, h, w):
    rng = np.random.default_rng(h + w)
    if kind == "lines":
        return np.stack([_line_mask(h, w, s) for s in range(3)])
    return rng.uniform(size=(3, h, w)) < {"sparse": 0.3, "dense": 0.55}[kind]


@pytest.mark.parametrize("kind", ["lines", "sparse", "dense"])
@pytest.mark.parametrize(
    "rounds, pools, init",
    [(2, 4, None), (2, 2, None), (2, 2, "prebridge"), (2, 2, "random"), (1, 1, None)],
    ids=["lowres2x4", "prebridge2x2", "warm2x2", "warmrandom2x2", "1x1"],
)
def test_connected_components_plain_equals_pallas(kind, rounds, pools, init):
    h, w = (64, 128) if kind != "lines" else (96, 256)
    m = _masks(kind, h, w)
    init_np = None
    if init == "prebridge":
        # A warm start as the detector makes one: labels of a sub-mask.
        sub = m & (np.random.default_rng(1).uniform(size=m.shape) < 0.9)
        init_np = np.array(jf.connected_components(jnp.asarray(sub), rounds=2, pools_per_round=2,
                                                     interpret=True))
    elif init == "random":
        init_np = np.random.default_rng(2).integers(0, 2 * h * w, size=m.shape).astype(np.int32)
    lab_j = np.asarray(jf.connected_components(
        jnp.asarray(m), rounds=rounds, pools_per_round=pools, interpret=True,
        init_labels=None if init_np is None else jnp.asarray(init_np)))
    lab_t = tf.connected_components(
        torch.as_tensor(m), rounds, pools, None if init_np is None else torch.as_tensor(init_np))
    assert lab_t.dtype == torch.int32
    np.testing.assert_array_equal(lab_t.numpy(), lab_j)


ANGLES = [0.0, math.pi / 2, 0.4, 1.1, -0.7, 2.3]


def _bridge_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    ms = []
    for a in ANGLES:
        d = (xx - w / 2) * np.sin(a) - (yy - h / 2) * np.cos(a)
        al = (xx - w / 2) * np.cos(a) + (yy - h / 2) * np.sin(a)
        m = (np.abs((d + 200) % 16 - 8) < 1.0) & (np.abs(al % 30 - 15) > 4)
        m[:2] = m[-2:] = False
        ms.append(m)
    ms = np.stack(ms).astype(np.float32)
    ex = (rng.uniform(size=ms.shape) < 0.8).astype(np.float32)
    return ms, ex, np.asarray(ANGLES, np.float32)


@pytest.mark.parametrize("kernel_len", [0.0, 7.0, 20.0, 61.0, 124.0, 300.0])
@pytest.mark.parametrize("probe_len", [5, 2])
def test_bridge_plain_equals_pallas(kernel_len, probe_len):
    h, w = 96, 128
    ms, ex, ang = _bridge_inputs(h, w, int(kernel_len))
    out_j = np.asarray(jf.bridge_morphology(
        jnp.asarray(ms), jnp.asarray(ex), jnp.asarray(ang), jnp.asarray(kernel_len, jnp.float32),
        probe_len=probe_len, max_kernel=125, interpret=True))
    out_t = tf.bridge_morphology(torch.as_tensor(ms), torch.as_tensor(ex), torch.as_tensor(ang),
                                 torch.tensor(kernel_len), probe_len, 125)
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    if kernel_len > 0:
        assert out_j.sum() > ms.sum()


AXIS_BASES = [0.0, float(np.float32(math.pi / 2))]  # detector._axis_bases


@pytest.mark.parametrize("probe_len, max_kernel", [(5, 125), (2, 125), (64, 300)])
def test_bridge_schedule_equals_jax_expressions(probe_len, max_kernel):
    """``bridge_schedule`` against the Pallas kernel's own expressions
    (``_bridge_kernel``: ``jnp.round(sa * k * sgn)`` and the ``eff`` chain)
    over an angle sweep, with kernel lengths 0, 20, 124 and 300."""
    special = [0.0, math.pi / 2, -math.pi / 2, math.pi / 4, -math.pi / 4, *AXIS_BASES]
    angles = np.concatenate([np.asarray(special, np.float32),
                             np.linspace(-math.pi, math.pi, 2001, dtype=np.float32)])
    lengths = np.asarray([0.0, 20.0, 124.0, 300.0], np.float32)
    klen = np.resize(lengths, angles.shape)
    ray, line = tf.bridge_schedule(torch.as_tensor(angles), torch.as_tensor(klen), probe_len, max_kernel)

    a = jnp.asarray(angles)
    sa, ca = jnp.sin(a), jnp.cos(a)
    for s, sgn in enumerate((1.0, -1.0)):
        for k in range(probe_len + 1):
            np.testing.assert_array_equal(ray[:, s, k, 0].numpy(), np.asarray(jnp.round(sa * k * sgn).astype(jnp.int32)))
            np.testing.assert_array_equal(ray[:, s, k, 1].numpy(), np.asarray(jnp.round(ca * k * sgn).astype(jnp.int32)))
    half = max(max_kernel // 2, 1)
    dyn_half = jnp.clip(jnp.asarray(klen) / 2.0, 0.0, float(half))
    stride, covered, s = 1, 0, 0
    dyn_covered = jnp.zeros_like(dyn_half)
    while covered < half:
        step = min(stride, half - covered)
        eff = jnp.clip(dyn_half - dyn_covered, 0.0, float(step))
        np.testing.assert_array_equal(line[:, s, 0].numpy(), np.asarray(jnp.round(sa * eff).astype(jnp.int32)))
        np.testing.assert_array_equal(line[:, s, 1].numpy(), np.asarray(jnp.round(ca * eff).astype(jnp.int32)))
        covered += step
        dyn_covered = dyn_covered + eff
        stride *= 2
        s += 1
    assert line.shape[1] == s == tf.bridge_schedule_size(probe_len, max_kernel) // 2 - 2 * (probe_len + 1)


def test_bridge_schedule_kernel_length_per_pair():
    """A (M,) kernel length covers N / M consecutive masks (the detector's
    one length per view for its h/v pair)."""
    ang = torch.tensor([0.3, 0.3, -1.0, -1.0])
    per_view = tf.bridge_schedule(ang, torch.tensor([20.0, 124.0]), 5, 125)
    per_mask = tf.bridge_schedule(ang, torch.tensor([20.0, 20.0, 124.0, 124.0]), 5, 125)
    for a, b in zip(per_view, per_mask):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dividing"):
        tf.bridge_schedule(ang, torch.tensor([1.0, 2.0, 3.0]), 5, 125)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_bridge_plain_bytes_equal_float(dtype):
    """The plain bridge on bool (uint8) masks and expandability images gives
    the float result as bool (uint8), and a schedule it is asked for equals
    ``bridge_schedule``."""
    ms, ex, ang = _bridge_inputs(96, 128, 3)
    kl = torch.tensor([20.0, 124.0, 0.0])
    want = tf.bridge_morphology(torch.as_tensor(ms), torch.as_tensor(ex), torch.as_tensor(ang), kl, 5, 125)
    sched = torch.zeros((len(ang), tf.bridge_schedule_size(5, 125)), dtype=torch.int32)
    got = tf.bridge_morphology(torch.as_tensor(ms).to(dtype), torch.as_tensor(ex).to(dtype),
                               torch.as_tensor(ang), kl, 5, 125, schedule_out=sched)
    assert got.dtype == dtype and want.dtype == torch.float32
    assert torch.equal(got, (want > 0.5).to(dtype))
    ray, line = tf.bridge_schedule(torch.as_tensor(ang), kl, 5, 125)
    assert torch.equal(sched, torch.cat([ray.reshape(len(ang), -1), line.reshape(len(ang), -1)], 1))


def test_bridge_schedule_rounds_half_to_even():
    """Offsets round half to even, as jnp.round: kernel length 7 at angle 0
    gives line steps of 1, 2 and then 0.5, which rounds to 0 (not 1)."""
    ray, line = tf.bridge_schedule(torch.tensor([0.0]), torch.tensor(7.0), 5, 125)
    assert line[0, :, 1].tolist() == [1, 2, 0, 0, 0, 0]
    assert line[0, :, 0].tolist() == [0] * 6
    assert ray[0, 0, :, 1].tolist() == [0, 1, 2, 3, 4, 5]
    assert ray[0, 1, :, 1].tolist() == [0, -1, -2, -3, -4, -5]


def test_wrappers_refuse_other_devices():
    m = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        tf.connected_components(m, 1, 1)
