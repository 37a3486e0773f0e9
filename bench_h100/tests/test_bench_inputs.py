"""The benchmark's frozen input makers against the port's generators, at
a small size: the same seed gives the same frames, bit for bit."""

import numpy as np
import pytest
import torch

from bench_h100.inputs import scenes
from cylinder_pose_estimation_tpu_torch.geometry.kinematics import t_agv_cyl
from cylinder_pose_estimation_tpu_torch.utils import synthetic

SEED = 2 ** 33 + 5  # wider than 32 bits, as the driver's seeds are


def test_example_pair_bit_equal():
    got = scenes.example_pair(96, 128, n_frames=3, seed=SEED, pans=[1.0, 4.0, 9.0])
    want = synthetic.example_pair(96, 128, n_frames=3, seed=SEED, pans=[1.0, 4.0, 9.0])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, [SEED, 0, 1]])
def test_registration_sequence_bit_equal(seed):
    st, ang, (a, b), t = scenes.registration_sequence(5, 96, 128, seed=seed)
    st2, ang2, (a2, b2), t2 = synthetic.registration_sequence(5, 96, 128, seed=seed)
    for g, w in zip(st, st2):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ang, ang2)
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)
    np.testing.assert_array_equal(t, t2)


def test_kinematics_matches_the_port():
    ang = scenes.registration_angles(11).astype(np.float64)
    got = scenes.t_agv_cyl(ang[:, 0], ang[:, 1])
    want = t_agv_cyl(torch.as_tensor(ang[:, 0]), torch.as_tensor(ang[:, 1])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_tiled_frames_bit_equal():
    _, (a, _) = scenes.example_pair(48, 64, n_frames=5, seed=3, pans=[0.0, 1.0, 2.0, 3.0, 4.0])
    pool = np.clip(a, 0, 255).astype(np.uint8)
    got, want = scenes.TiledFrames(pool, 100), synthetic.TiledFrames(pool, 100)
    for sl in (slice(0, 10), slice(30, 36), slice(33, 80)):
        np.testing.assert_array_equal(got[sl], want[sl])
