"""PyTorch port: ``ops/labeling.component_stats`` and
``ops/image.patch_mean_at`` against the JAX package's functions on the same
numpy inputs.

``component_stats``: on the 32x32 blobs of tests/test_image_ops.py and on
seeded random label images from the port's ``connected_components`` (the
XLA branch's CC), at k = 1, 4 and 64 and ``min_area`` 1 and 3.  ``root``,
``count``, ``bbox`` and ``valid`` must be equal; so must the centroids and
moments (tolerance 0): the port sums in XLA:CPU's prefix-sum order and fuses
the moments' multiply-adds as XLA does, so the float32 roundings are the
same.  A batch of label images equals the images one at a time.

``patch_mean_at``: exact equality, with invalid points (-inf), points
rounded half to even, points clipped to each border, NaN and infinite
coordinates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.ops import image as ji
from cylinder_pose_estimation_tpu.ops import labeling as jl
from cylinder_pose_estimation_tpu_torch.ops import image as ti
from cylinder_pose_estimation_tpu_torch.ops import labeling as tl

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)


def _blobs():
    """The 32x32 mask of tests/test_image_ops.py: blobs of 16, 20 and 1 px."""
    m = np.zeros((32, 32), bool)
    m[2:6, 2:6] = True
    m[20:22, 20:30] = True
    m[10, 10] = True
    return m


def _labels(name):
    if name == "blobs":
        m = _blobs()
    else:
        h, w, p, seed = name
        m = np.random.default_rng(seed).uniform(size=(h, w)) < p
    return tl.connected_components(torch.as_tensor(m)[None], iters=8)[0].numpy()


def _assert_stats_equal(got, want, tag):
    assert got._fields == want._fields
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (tag, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} {name}")


SCENES = ["blobs", (64, 128, 0.4, 0), (64, 128, 0.55, 1), (96, 160, 0.3, 2)]


@pytest.mark.parametrize("min_area", [1, 3])
@pytest.mark.parametrize("k", [1, 4, 64])
@pytest.mark.parametrize("scene", SCENES, ids=lambda s: s if isinstance(s, str) else "x".join(map(str, s)))
def test_component_stats_matches_jax(scene, k, min_area):
    lab = _labels(scene)
    want = jax.jit(lambda x: jl.component_stats(x, k=k, min_area=min_area))(jnp.asarray(lab))
    got = tl.component_stats(torch.as_tensor(lab), k=k, min_area=min_area)
    _assert_stats_equal(got, want, (scene, k, min_area))
    n_valid = int(np.asarray(want.valid).sum())
    assert n_valid >= 1
    if scene == "blobs":
        counts = sorted(np.asarray(want.count)[np.asarray(want.valid)].tolist(), reverse=True)
        assert counts == [20, 16, 1][: min(k, 3 if min_area == 1 else 2)]


def test_component_stats_batched_equals_single():
    labs = np.stack([_labels(s) for s in SCENES[1:3]])
    both = tl.component_stats(torch.as_tensor(labs), k=16, min_area=2)
    for i in range(2):
        one = tl.component_stats(torch.as_tensor(labs[i]), k=16, min_area=2)
        for name in one._fields:
            assert torch.equal(getattr(both, name)[i], getattr(one, name)), name


def test_component_stats_equal_lengths_keep_label_order():
    """Components of equal size come out smaller root first (a stable sort,
    as jnp.argsort)."""
    m = np.zeros((16, 16), bool)
    for r in (1, 5, 9, 13):
        m[r, 2:6] = True  # four 4-px runs
    lab = tl.connected_components(torch.as_tensor(m)[None], iters=4)[0].numpy()
    want = jl.component_stats(jnp.asarray(lab), k=4)
    got = tl.component_stats(torch.as_tensor(lab), k=4)
    _assert_stats_equal(got, want, "ties")
    assert got.root.tolist() == sorted(got.root.tolist())


def test_patch_mean_at_matches_jax():
    rng = np.random.default_rng(0)
    h, w = 24, 40
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    xy = np.stack([rng.uniform(-6, w + 6, (3, 50)), rng.uniform(-6, h + 6, (3, 50))], -1)
    xy[0, :8] = [[0.5, 0.5], [1.5, 2.5], [-0.5, h - 0.5], [w - 0.5, -0.4],
                 [w + 100.0, h + 100.0], [-1e9, 3.0], [np.inf, -np.inf], [np.nan, 4.0]]
    xy = xy.astype(np.float32)
    valid = rng.uniform(size=(3, 50)) < 0.8
    valid[0, :8] = True
    want = np.asarray(ji.patch_mean_at(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid)))
    got = ti.patch_mean_at(torch.as_tensor(img), torch.as_tensor(xy), torch.as_tensor(valid)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 50)
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[~valid]).all() and np.isfinite(got[valid]).all()
    # half to even: x 0.5 -> 0, 1.5 -> 2; clipped to the borders
    assert got[0, 0] == img[0, 0] and got[0, 1] == img[2, 2]
    assert got[0, 4] == img[h - 1, w - 1] and got[0, 5] == img[3, 0]
