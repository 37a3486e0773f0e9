"""PyTorch port: the payload min/max kernel's plain version against the JAX
Pallas kernel it replaces (``component_payload_minmax``, interpret mode on
the CPU).  Every comparison is EXACT, both channels, on straight, curved,
diagonal and ring-touching fragments, for the schedules the detector and the
tests use, with column- and row-major scan-order payloads.

The CUDA kernel is held to this plain version bit for bit on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.ops.pallas import frontend as jf
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)


def _fragments(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), bool)
    if kind == "straight":
        for yc in range(4, h - 4, 9):
            x0 = int(rng.integers(2, w // 2))
            m[yc:yc + 2, x0:x0 + int(rng.integers(6, w // 2))] = True
        for xc in range(7, w - 4, 23):
            y0 = int(rng.integers(2, h // 2))
            m[y0:y0 + int(rng.integers(6, h // 2)), xc:xc + 2] = True
    elif kind == "curved":
        xs = np.arange(2, w - 2)
        for yc in range(8, h - 8, 11):
            ys = (yc + 4 * np.sin(xs / 7.0 + rng.uniform(0, 6))).astype(int)
            keep = rng.uniform(size=xs.size) > 0.12
            m[ys[keep], xs[keep]] = True
            m[ys[keep] + 1, xs[keep]] = True
    elif kind == "diagonal":
        for off in range(-h, w, 13):
            d = xx - 0.6 * yy - off
            m |= (np.abs(d) < 1.0) & ((xx + 2 * yy) // 19 % 3 != 0)
        m |= (np.abs(xx + yy - w // 2) < 1.0) & (xx % 7 != 0)
    else:  # "ring": fragments running into and along the image edge
        m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = True
        m[h // 2, :] = True
        m[:, w // 3] = True
        m[1, w // 2:] = True
        m[5:h - 5, w - 2] = True
        m |= rng.uniform(size=(h, w)) < 0.25
    return m


def _payloads(order, n, h, w):
    ys, xs = np.mgrid[:h, :w]
    pay = xs * h + ys if order == "colmajor" else ys * w + xs
    return np.broadcast_to(pay.astype(np.int32), (n, h, w)).copy()


SIZES = {"straight": (64, 128), "curved": (96, 160), "diagonal": (120, 192), "ring": (64, 128)}


@pytest.mark.parametrize("order", ["colmajor", "rowmajor"])
@pytest.mark.parametrize("rounds, pools", [(1, 4), (2, 4), (2, 2), (1, 2)],
                         ids=["1x4", "2x4", "2x2", "1x2"])
@pytest.mark.parametrize("kind", list(SIZES))
def test_payload_minmax_plain_equals_pallas(kind, rounds, pools, order):
    h, w = SIZES[kind]
    m = np.stack([_fragments(kind, h, w, s) for s in range(2)])
    pay = _payloads(order, 2, h, w)
    lo_j, hi_j = jf.component_payload_minmax(jnp.asarray(m), jnp.asarray(pay), rounds=rounds,
                                             pools_per_round=pools, interpret=True)
    lo_t, hi_t = tf.component_payload_minmax(torch.as_tensor(m), torch.as_tensor(pay),
                                             rounds, pools)
    assert lo_t.dtype == hi_t.dtype == torch.int32
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))


def test_payload_minmax_background_and_ring():
    """Background holds (H*W, -1); the 1-px ring is forced out of the mask."""
    h, w = 64, 128
    m = np.ones((1, h, w), bool)
    pay = _payloads("rowmajor", 1, h, w)
    lo, hi = tf.component_payload_minmax(torch.as_tensor(m), torch.as_tensor(pay), 3, 4)
    lo, hi = lo[0].numpy(), hi[0].numpy()
    assert (lo[0] == h * w).all() and (hi[:, -1] == -1).all()
    # The interior is one component: after enough rounds every pixel holds
    # its first and last interior pixel.
    assert (lo[1:-1, 1:-1] == w + 1).all()
    assert (hi[1:-1, 1:-1] == (h - 2) * w + w - 2).all()


def test_payload_minmax_is_unconverged_after_its_rounds():
    """One round of one pool does not cross a staircase: the schedule is
    exact, not run to convergence (the detector reads it as it is)."""
    h, w = 64, 128
    m = np.zeros((1, h, w), bool)
    for k in range(20):
        m[0, 5 + 2 * k:7 + 2 * k, 5 + 3 * k:9 + 3 * k] = True
    pay = _payloads("colmajor", 1, h, w)
    lo1, _ = tf.component_payload_minmax(torch.as_tensor(m), torch.as_tensor(pay), 1, 1)
    lo40, _ = tf.component_payload_minmax(torch.as_tensor(m), torch.as_tensor(pay), 40, 4)
    vals1 = np.unique(lo1[0].numpy()[m[0]])
    vals40 = np.unique(lo40[0].numpy()[m[0]])
    assert vals40.tolist() == [5 * h + 5] and vals1.size > 1


@pytest.mark.parametrize("name", ["preprocess_binarize", "bridge_morphology",
                                  "component_payload_minmax"])
def test_every_wrapper_refuses_other_devices(name):
    """A tensor that is neither on the CPU nor on a CUDA device reaches no
    kernel and no plain version: the wrapper raises (connected_components:
    tests/test_torch_kernels.py)."""
    m = torch.zeros((2, 16, 16), device="meta")
    args = {
        "preprocess_binarize": (m,),
        "bridge_morphology": (m, m, torch.zeros(2, device="meta"), torch.zeros((), device="meta"), 2, 8),
        "component_payload_minmax": (m, m.to(torch.int32), 1, 1),
    }[name]
    with pytest.raises(ValueError, match="no kernel for device"):
        getattr(tf, name)(*args)
