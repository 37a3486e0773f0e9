"""PyTorch port: ``estimate_poses_stream`` against the JAX package on the
card's eigensolver route.

``ops.linalg.eigh`` is LAPACK on CPU tensors (the JAX package's own solver
there) and the fixed Jacobi sweeps (``eigh_jacobi``) on CUDA tensors.
tests/test_torch_stream.py holds the port to JAX on the LAPACK route; here
the same stream runs on the card's route (``linalg._lapack`` refuses every
tensor for this module, before any fixture is made), over the same frames
and the same JAX results:

* the stream equals ``estimate_poses_batch`` per chunk, leaf for leaf
  (tests/test_torch_stream.py's test, unchanged);
* against JAX, the contract of tests/test_torch_stream.py on every healthy
  frame, unchanged.  The unhealthy frame 3 has its own budget: its fit
  fails (37 px reprojection, origin 1 m out along a flat valley) and is
  chaotic in its start, so an eigenvector 1e-7 away from LAPACK's moves
  where it stops.  Measured on this route: its axis 1.69e-3 rad and its
  axis line 1.44 mm from JAX's (LAPACK route: 5.98e-4 rad, 0.62 mm); held
  within 2.5e-3 rad and 2.5 mm.  Reprojection, fvals, flags and centres
  keep their bounds on every frame.
"""

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.models import pipeline as jpipe
from cylinder_pose_estimation_tpu_torch.config import from_reference
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.ops import linalg
from tests.test_torch_stream import (  # noqa: F401  (fixtures and the reused test)
    CHUNK,
    JCFG,
    JFIT,
    JREG,
    N,
    _axis_rad,
    _perp_mm,
    frames,
    jax_streams,
    per_chunk,
    scene,
    test_stream_equals_batch_per_chunk,
)

# The unhealthy frame's budget on this route (module docstring).
UNHEALTHY_AXIS_RAD, UNHEALTHY_PERP_MM = 2.5e-3, 2.5


@pytest.fixture(scope="module", autouse=True)
def card_route():
    """``eigh`` takes the Jacobi sweeps for every tensor in this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linalg, "_lapack", lambda t: False)
        yield


def _axis_within(got_dirs, want_dirs, healthy):
    err = _axis_rad(got_dirs, want_dirs)
    assert err[healthy].max() < 1e-3, err
    assert err.max() < UNHEALTHY_AXIS_RAD, err


def _assert_fit_close(got_params, got_reproj, got_fvals, want_params, want_reproj, want_fvals, healthy):
    healthy = np.asarray(healthy)
    _axis_within(got_params[:, 3:], want_params[:, 3:], healthy)
    perp = _perp_mm(want_params, got_params)
    assert perp[healthy].max() < 0.01 and perp.max() < UNHEALTHY_PERP_MM, perp
    np.testing.assert_allclose(got_reproj, want_reproj, atol=1e-4)
    np.testing.assert_allclose(got_fvals, want_fvals, rtol=1e-3)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_stream_matches_jax_on_the_card_route(frames, jax_streams, compact):
    stereo, i1, i2 = frames
    want = jax_streams[compact]
    got = pipeline.estimate_poses_stream(
        i1, i2, stereo, from_reference(JCFG), from_reference(JFIT), chunk=CHUNK, compact=compact,
        reg_cfg=from_reference(JREG), device="cpu")
    for g, w in zip(pipeline._tree_leaves(got), pipeline._tree_leaves(want)):
        assert g.shape == np.shape(w) and g.shape[0] == N and g.dtype == np.asarray(w).dtype
    if compact:
        for name in ("ok", "stable", "healthy", "n_points", "bridged_components"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        healthy = np.asarray(want.healthy)
        assert 1 <= int(healthy.sum()) < N
        for name in ("center1", "center2"):
            np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-3)
        assert _axis_rad(got.params0[:, 3:], want.params0[:, 3:]).max() < 1e-3
        _axis_within(got.t_cam_cyl[:, :3, 1], want.t_cam_cyl[:, :3, 1], healthy)
        _assert_fit_close(got.params, got.mean_reproj_error, got.fvals,
                          want.params, want.mean_reproj_error, want.fvals, healthy)
        return
    for gd, wd in ((got.detect1, want.detect1), (got.detect2, want.detect2)):
        for name in ("ok", "stable", "bridged_components"):
            np.testing.assert_array_equal(getattr(gd, name), getattr(wd, name), err_msg=name)
        for f in range(N):
            w = {tuple(wd.grid.idx[f, k]): wd.grid.xy[f, k] for k in np.flatnonzero(wd.grid.valid[f])}
            g = {tuple(gd.grid.idx[f, k]): gd.grid.xy[f, k] for k in np.flatnonzero(gd.grid.valid[f])}
            assert set(g) == set(w), f
            assert max(float(np.abs(g[k] - w[k]).max()) for k in w) <= 1e-3
    np.testing.assert_array_equal(got.fit.points_valid, want.fit.points_valid)
    _assert_fit_close(got.fit.params, got.fit.mean_reproj_error, got.fit.fvals,
                      want.fit.params, want.fit.mean_reproj_error, want.fit.fvals,
                      np.asarray(jpipe.frame_health(want, JREG)))


def test_the_card_route_is_taken():
    """``eigh`` on a CPU tensor is the Jacobi sweeps in this module."""
    a = torch.tensor([[2.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 4.0]])
    for got, want in zip(linalg.eigh(a), linalg.eigh_jacobi(a)):
        assert torch.equal(got, want)
