"""PyTorch port: the registration and the whole experiment against the JAX
package on the card's eigensolver route.

``ops.linalg.eigh`` is LAPACK on CPU tensors (the JAX package's own solver
there) and the fixed Jacobi sweeps (``eigh_jacobi``) on CUDA tensors; the
registration takes it for the init fits' PCA and curvature and for the
minimum eigenvalue of JtJ.  tests/test_torch_registration.py holds the port
to JAX on the LAPACK route; here the same tests run on the card's route
(``linalg._lapack`` refuses every tensor for this module, before any fixture
is made), on the same scenarios and JAX results:

* ``fit_cylinders_with_angles`` on every scenario, ``full_experiment`` with
  and without ``preprocess``, and ``register_sequence`` on the JAX batch:
  tests/test_torch_registration.py's tests, unchanged.
* The diagnostic at a common pose (``lm_iters=0``): that module's bounds,
  ``well_posed`` equal, with one budget of its own.  In
  ``poisoned_masked`` the best candidate comes from init fits whose start
  is chaotic, and an eigenvector 1e-7 away from LAPACK's moves it: the
  minimum eigenvalue lies rel 1.86e-3 from JAX's on this route (1.16e-4 on
  LAPACK's); held within rel 3e-3 there.
"""

import pytest

from cylinder_pose_estimation_tpu_torch.ops import linalg
from tests.test_torch_registration import (  # noqa: F401  (fixtures and the reused tests)
    SCENARIOS,
    _both,
    assert_registration_close,
    experiments,
    jax_experiment,
    sequence,
    test_frame_health_and_register_sequence_on_jax_batch,
    test_full_experiment_matches_jax,
    test_registration_matches_jax,
)

# The minimum eigenvalue's budget at the common pose on this route, by
# scenario (module docstring); 1e-3 elsewhere, as on the LAPACK route.
EIG_RTOL = {"poisoned_masked": 3e-3}


@pytest.fixture(scope="module", autouse=True)
def card_route():
    """``eigh`` takes the Jacobi sweeps for every tensor in this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linalg, "_lapack", lambda t: False)
        yield


@pytest.mark.parametrize("name", SCENARIOS)
def test_registration_diagnostic_at_common_pose_on_the_card_route(name):
    ang, cfg, want, got = _both(name, lm_iters=0)
    assert_registration_close(got, want, ang, cfg.kinematics, eig_rtol=EIG_RTOL.get(name, 1e-3))
