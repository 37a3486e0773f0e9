"""PyTorch port: ``models/refine.py`` against the JAX package's on the same
seeded inputs.

``refine_curves_cog`` refines row (y = f(x)) and column (x = g(y)) curves
on a rendered grid; invalid labels pass through unchanged, and the refined
curves must agree within ``CURVE_TOL`` px over each label's domain.  The JAX
package refits in float32: on these curves (values up to ~290 px, where a
float32 ulp is 3e-5 px) its refit lies up to 1.24e-4 px from the exact
(float64) refit of its own samples; the port refits in float64 (within
1.4e-5 px of it), so the two differ by up to 1.4e-4 px, and the bound is
2e-4 px rather than 1e-4.
``interval_anomaly_mask`` and ``remove_first_last_labels`` must give
identical masks, on inputs with even counts (the median of two middle
gaps), ties (equal positions, and the float maximum of the invalid labels)
and invalid labels between valid ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.models import refine as jref
from cylinder_pose_estimation_tpu_torch.models import refine as tref
from cylinder_pose_estimation_tpu_torch.ops.polyfit import poly_domain, polyval
from cylinder_pose_estimation_tpu_torch.utils.synthetic import cylinder_view

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W = 240, 320
CURVE_TOL = 2e-4


def _curves(seed: int, swap: bool):
    """(V, L, 3) quadratic curves near the grid lines of two rendered views,
    their (V, L, 2) domains and (V, L) validity: 8 labels per view, the last
    two invalid (one with an empty-sample domain, as the detector gives)."""
    rng = np.random.default_rng(seed)
    v, n_lab = 2, 8
    across = rng.uniform(40, (W if swap else H) - 40, (v, n_lab))
    a = rng.uniform(-4e-4, 4e-4, (v, n_lab))
    b = rng.uniform(-0.1, 0.1, (v, n_lab))
    lo = rng.uniform(10, 60, (v, n_lab))
    hi = lo + rng.uniform(60, 150, (v, n_lab))
    coeffs = np.stack([a, b, across - a * 100.0 ** 2 - b * 100.0], -1).astype(np.float32)
    dom = np.stack([lo, hi], -1).astype(np.float32)
    valid = np.ones((v, n_lab), bool)
    valid[:, -2:] = False
    empty = poly_domain(torch.zeros(1, 4), torch.zeros(1, 4), 50.0).numpy()[0]
    dom[:, -1] = empty
    return coeffs, dom, valid


@pytest.fixture(scope="module")
def gray():
    return np.stack([cylinder_view(H, W, (0.0, -15.0, 560.0), 52.0, 12.0, 2.2, seed) for seed in (0, 1)])


@pytest.mark.parametrize("swap", [False, True], ids=["rows", "cols"])
def test_refine_curves_cog_matches_jax(gray, swap):
    coeffs, dom, valid = _curves(5 + swap, swap)
    fn = jax.jit(jax.vmap(lambda g, c, d, ok: jref.refine_curves_cog(g, c, d, ok, 2, swap_xy=swap)))
    want = np.asarray(fn(jnp.asarray(gray), jnp.asarray(coeffs), jnp.asarray(dom), jnp.asarray(valid)))
    got = tref.refine_curves_cog(torch.as_tensor(gray), torch.as_tensor(coeffs), torch.as_tensor(dom),
                                 torch.as_tensor(valid), 2, swap_xy=swap).numpy()
    # Invalid labels pass through bit for bit; the refinement moved the rest.
    np.testing.assert_array_equal(got[~valid], coeffs[~valid])
    assert np.abs(got[valid] - coeffs[valid]).max() > 1e-3
    # Valid curves agree over their domain (evaluated in float64, so the
    # comparison adds no rounding of its own).
    t = np.linspace(0.0, 1.0, 101)
    xs = dom[valid][:, :1] + t * (dom[valid][:, 1:] - dom[valid][:, :1])
    yg = polyval(torch.as_tensor(got[valid], dtype=torch.float64)[:, None], torch.as_tensor(xs))
    yw = polyval(torch.as_tensor(want[valid], dtype=torch.float64)[:, None], torch.as_tensor(xs))
    assert float((yg - yw).abs().max()) <= CURVE_TOL


def test_unit_linspace_equals_jnp_linspace():
    for n in (1, 2, 7, 64, 100):
        np.testing.assert_array_equal(tref._unit_linspace(n, "cpu").numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


def _labels(seed: int, n_lab: int = 12):
    """Label positions on a regular spacing with an outlier, a duplicated
    position (a tie) and invalid labels between valid ones."""
    rng = np.random.default_rng(seed)
    means = (np.arange(n_lab) * 20.0 + rng.normal(0.0, 1.0, n_lab)).astype(np.float32)
    means[rng.integers(1, n_lab - 1)] += 9.0          # an anomalous gap
    i, j = rng.choice(n_lab, 2, replace=False)
    means[j] = means[i]                                 # a tie
    means = means[rng.permutation(n_lab)]
    valid = rng.random(n_lab) < 0.8
    return means, valid


@pytest.mark.parametrize("seed", range(6))
def test_interval_anomaly_mask_matches_jax(seed):
    means, valid = _labels(seed)
    if seed % 2 == 0:  # an even number of valid labels: an odd number of gaps
        valid[np.flatnonzero(valid)[0]] = bool(valid.sum() % 2 == 0)
    got = tref.interval_anomaly_mask(torch.as_tensor(means), torch.as_tensor(valid)).numpy()
    want = np.asarray(jref.interval_anomaly_mask(jnp.asarray(means), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)


def test_interval_anomaly_mask_batches_and_even_gap_counts():
    """A batch of rows equals each row alone; with an even number of gaps
    the median is the mean of the two middle gaps (jnp.nanmedian), which
    decides this case: gaps 10, 10, 16, 16 have median 13."""
    means = np.array([[0.0, 10.0, 20.0, 36.0, 52.0, 0.0],
                      [5.0, 5.0, 25.0, 45.0, 65.0, 85.0]], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 1]], bool)
    got = tref.interval_anomaly_mask(torch.as_tensor(means), torch.as_tensor(valid)).numpy()
    for r in range(2):
        want = np.asarray(jref.interval_anomaly_mask(jnp.asarray(means[r]), jnp.asarray(valid[r])))
        np.testing.assert_array_equal(got[r], want)


@pytest.mark.parametrize("seed", range(3))
def test_remove_first_last_labels_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rv, cv = rng.random(24) < 0.7, rng.random(24) < 0.6
    rr = rng.permutation(24).astype(np.int32)
    cr = rng.permutation(24).astype(np.int32)
    got = tref.remove_first_last_labels(*(torch.as_tensor(x) for x in (rv, cv, rr, cr)))
    want = jref.remove_first_last_labels(*(jnp.asarray(x) for x in (rv, cv, rr, cr)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
