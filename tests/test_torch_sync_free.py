"""The port's linear algebra with no host synchronisation
(``ops/linalg.eigh_jacobi``, ``geometry/registration.inv3x3``) against
numpy in float64, and the fit's users of ``ops/linalg.eigh``
(``pca_components``, ``estimate_curvature_at``) against the JAX functions.

Bounds, with eps the float32 machine epsilon (2^-23) and ||A|| the largest
|eigenvalue|:
- eigenvalues within 1 eps ||A|| of float64 LAPACK (the Jacobi sweeps run in
  float64 and round once: rounding alone is 0.5 eps ||A||);
- residuals ||A v - w v|| within 2 eps ||A||, and |V^T V - I| within 4 eps
  (the rounding of n unit-vector components);
- eigenvectors, up to sign, within 4 eps ||A|| / gap of float64 LAPACK's
  where the eigenvalue's gap to the others is at least 1e-3 ||A||.
``JACOBI_SWEEPS`` is pinned by the batches here: every bound holds at its
count, and one sweep fewer breaks one (so the count is the least that
meets them).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.geometry import curvature as jcurv
from cylinder_pose_estimation_tpu.ops import linalg as jlin
from cylinder_pose_estimation_tpu_torch.geometry import curvature as tcurv
from cylinder_pose_estimation_tpu_torch.geometry.registration import inv3x3
from cylinder_pose_estimation_tpu_torch.ops import linalg as tlin

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
FAMILIES = ("random", "graded", "repeated", "diagonal", "zero", "covariance")


def _batch(family: str, n: int, b: int = 400, seed: int = 0) -> np.ndarray:
    """(b, n, n) float32 symmetric matrices of one family."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(b, n, n)))
    if family == "random":
        m = rng.normal(size=(b, n, n))
        m = (m + np.swapaxes(m, -1, -2)) / 2
    elif family == "graded":
        lam = 10.0 ** rng.uniform(-6, 0, size=(b, n))
        m = q @ (lam[..., None] * np.swapaxes(q, -1, -2))
    elif family == "repeated":
        lam = np.repeat(rng.normal(size=(b, 1)), n, 1)
        lam[:, 0] += rng.normal(size=b)
        m = q @ (lam[..., None] * np.swapaxes(q, -1, -2))
    elif family == "diagonal":
        m = np.eye(n) * rng.normal(size=(b, 1, n))
    elif family == "zero":
        m = np.zeros((4, n, n))
    else:  # sample covariances of elongated clouds, as the fit's
        scale = np.array([100.0, 10.0, 0.01] + [1.0] * (n - 3))
        d = rng.normal(size=(b, 30, n)) * scale
        d = d - d.mean(1, keepdims=True)
        m = np.swapaxes(d, -1, -2) @ d / 29
    return m.astype(np.float32)


def _errors(a: np.ndarray) -> dict:
    """The largest of each bound's measure over the batch, in its unit."""
    w, v = tlin.eigh_jacobi(torch.as_tensor(a))
    assert w.dtype == torch.float32 and v.dtype == torch.float32
    w, v = w.double().numpy(), v.double().numpy()
    a64 = a.astype(np.float64)
    w64, v64 = np.linalg.eigh(a64)
    n = a.shape[-1]
    norm = np.maximum(np.abs(w64).max(-1), np.finfo(np.float64).tiny)
    resid = np.linalg.norm(a64 @ v - v * w[..., None, :], axis=-2).max(-1)
    orth = np.abs(np.swapaxes(v, -1, -2) @ v - np.eye(n)).max((-1, -2))
    vec = 0.0
    for i in range(n):
        others = np.delete(w64, i, axis=-1)
        gap = np.abs(others - w64[..., i:i + 1]).min(-1) / norm
        ok = gap >= 1e-3
        dot = np.sum(v[..., i] * v64[..., i], -1)
        d = np.linalg.norm(v[..., i] - np.sign(dot)[..., None] * v64[..., i], axis=-1)
        if ok.any():
            vec = max(vec, float((d[ok] * gap[ok]).max() / EPS))
    return {"eigenvalues": float((np.abs(w - w64).max(-1) / norm).max() / EPS),
            "residual": float((resid / norm).max() / EPS),
            "orthonormal": float(orth.max() / EPS),
            "vectors": vec}


BOUNDS = {"eigenvalues": 1.0, "residual": 2.0, "orthonormal": 4.0, "vectors": 4.0}


@pytest.mark.parametrize("n", [3, 6])
@pytest.mark.parametrize("family", FAMILIES)
def test_jacobi_meets_float64_lapack(family, n):
    err = _errors(_batch(family, n))
    for name, bound in BOUNDS.items():
        assert err[name] <= bound, (name, err)


@pytest.mark.parametrize("n", [3, 6])
def test_jacobi_sweep_count_is_the_least_that_meets_the_bounds(n, monkeypatch):
    """One sweep fewer than ``JACOBI_SWEEPS[n]`` misses a bound on one of
    the batches (the counts are 4 for 3x3 and 6 for 6x6)."""
    monkeypatch.setitem(tlin.JACOBI_SWEEPS, n, tlin.JACOBI_SWEEPS[n] - 1)
    fewer = [_errors(_batch(f, n)) for f in FAMILIES]
    assert any(e[name] > bound for e in fewer for name, bound in BOUNDS.items())


def test_jacobi_zero_and_diagonal_exact():
    """A zero matrix gives zeros and the identity; a diagonal one its sorted
    diagonal and a permutation (no rotation is made)."""
    w, v = tlin.eigh_jacobi(torch.zeros(2, 3, 3))
    assert torch.equal(w, torch.zeros(2, 3)) and torch.equal(v, torch.eye(3).expand(2, 3, 3))
    d = torch.tensor([[3.0, -1.0, 2.0, 0.5, 7.0, -4.0]])
    w, v = tlin.eigh_jacobi(torch.diag_embed(d))
    assert torch.equal(w, torch.sort(d).values)
    assert torch.equal(v.abs().sum(-1), torch.ones(1, 6)) and torch.equal(v.abs().sum(-2), torch.ones(1, 6))


def test_eigh_routes_by_device(monkeypatch):
    """``eigh`` is LAPACK on CPU tensors and the Jacobi sweeps on a card's
    (``_lapack`` decides; the card's route is driven here on CPU tensors)."""
    a = torch.as_tensor(_batch("covariance", 3, b=8))
    want = torch.linalg.eigh(a)
    got = tlin.eigh(a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    monkeypatch.setattr(tlin, "_lapack", lambda t: False)
    got = tlin.eigh(a)
    jac = tlin.eigh_jacobi(a)
    assert torch.equal(got[0], jac[0]) and torch.equal(got[1], jac[1])


def test_inv3x3_matches_numpy():
    """Closed-form 3x3 inverse against float64 numpy: random matrices of
    condition below 50 within 64 eps |inv| (cond x the rounding of the
    cofactors), and orthonormal bases (the triad's) within 4 eps."""
    rng = np.random.default_rng(1)
    m = rng.normal(size=(2000, 3, 3))
    m = m[np.linalg.cond(m) < 50].astype(np.float32)
    got = inv3x3(torch.as_tensor(m)).double().numpy()
    want = np.linalg.inv(m.astype(np.float64))
    scale = np.abs(want).max((-1, -2), keepdims=True)
    assert (np.abs(got - want) / scale).max() <= 64 * EPS
    q, _ = np.linalg.qr(rng.normal(size=(500, 3, 3)))
    q = q.astype(np.float32)
    got = inv3x3(torch.as_tensor(q)).double().numpy()
    assert np.abs(got - np.linalg.inv(q.astype(np.float64))).max() <= 4 * EPS


def _cloud(seed: int, f: int = 4, n: int = 60):
    """Points on cylinder patches (radius 45) with some masked out."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-1.0, 1.0, (f, n))
    h = rng.uniform(-60.0, 60.0, (f, n))
    pts = np.stack([45.0 * np.sin(th), h, 45.0 * np.cos(th) + 800.0], -1)
    pts = pts + rng.normal(0, 0.1, pts.shape)
    valid = rng.uniform(size=(f, n)) > 0.15
    return pts.astype(np.float32), valid


def _up_to_sign(got, want, axis=-2):
    s = np.sign(np.sum(got * want, axis=axis, keepdims=True))
    return got * np.where(s == 0, 1.0, s)


@pytest.mark.parametrize("card_route", [False, True], ids=["lapack", "jacobi"])
def test_pca_components_matches_jax(monkeypatch, card_route):
    """Components up to sign within 1e-5 and variances within rel 1e-5 of
    the JAX function (float32 eigensolves of well-separated covariances),
    on both of ``eigh``'s routes."""
    if card_route:
        monkeypatch.setattr(tlin, "_lapack", lambda t: False)
    for seed in range(3):
        pts, valid = _cloud(seed)
        wc, wv = (np.asarray(x) for x in jlin.pca_components(jnp.asarray(pts), jnp.asarray(valid)))
        gc, gv = (x.numpy() for x in tlin.pca_components(torch.as_tensor(pts), torch.as_tensor(valid)))
        np.testing.assert_allclose(gv, wv, rtol=1e-5)
        np.testing.assert_allclose(_up_to_sign(gc, wc), wc, atol=1e-5)


@pytest.mark.parametrize("card_route", [False, True], ids=["lapack", "jacobi"])
def test_curvature_at_matches_jax(monkeypatch, card_route):
    """``estimate_curvature_at`` against the JAX function, frame by frame:
    the flat direction and the two principal directions up to sign within
    1e-4, the curvatures within 1e-6 1/mm (1/45 mm on these patches), on
    both of ``eigh``'s routes (a flipped normal flips the local frame)."""
    if card_route:
        monkeypatch.setattr(tlin, "_lapack", lambda t: False)
    for seed in range(3):
        pts, valid = _cloud(seed + 10)
        idx = np.array([0, 7, 21, 33])
        got = tcurv.estimate_curvature_at(torch.as_tensor(pts), torch.as_tensor(valid),
                                          torch.as_tensor(idx), k=20)
        for f in range(pts.shape[0]):
            want = jcurv.estimate_curvature_at(jnp.asarray(pts[f]), jnp.asarray(valid[f]),
                                               jnp.int32(idx[f]), k=20)
            flat = got.flat_direction[f].numpy()
            np.testing.assert_allclose(_up_to_sign(flat, np.asarray(want.flat_direction), axis=-1),
                                       np.asarray(want.flat_direction), atol=1e-4)
            gd, wd = got.directions[f].numpy(), np.asarray(want.directions)
            order = np.argsort(np.abs(got.curvatures[f].numpy()))
            worder = np.argsort(np.abs(np.asarray(want.curvatures)))
            np.testing.assert_allclose(_up_to_sign(gd[:, order], wd[:, worder]), wd[:, worder], atol=1e-4)
            np.testing.assert_allclose(np.sort(np.abs(got.curvatures[f].numpy())),
                                       np.sort(np.abs(np.asarray(want.curvatures))), atol=1e-6)
