"""PyTorch port: the fit tail and ``estimate_poses_batch`` against the JAX
package on the card's eigensolver route.

``ops.linalg.eigh`` is LAPACK on CPU tensors (the JAX package's own solver
there) and the fixed Jacobi sweeps (``eigh_jacobi``) on CUDA tensors; the
fit tail takes it for its initial PCA and the curvature normals.
tests/test_torch_fit.py and tests/test_torch_pipeline.py hold the port to
JAX on the LAPACK route; here their tests of what goes through ``eigh``
run again, unchanged, on the card's route (``linalg._lapack`` refuses every
tensor for this module, before any fixture is made): the curvature
estimates, ``cylinder_axis_info``, ``fit_single_cylinder`` and its batching,
PCA, the golden scenes 0-1 of both scene sources and the small scene
against the JAX Pallas path.
"""

import pytest

from cylinder_pose_estimation_tpu_torch.ops import linalg
from tests.test_torch_fit import (  # noqa: F401  (the reused tests)
    test_curvature_flat_direction_matches,
    test_curvatures_all_points_match,
    test_cylinder_axis_info_matches,
    test_eigh2x2_and_pca_match,
    test_fit_batches_frames_independently,
    test_fit_single_cylinder_matches,
)
from tests.test_torch_pipeline import (  # noqa: F401  (fixtures and the reused tests)
    golden,
    jax_scenes,
    port_scenes,
    test_golden_scenes_0_1,
    test_small_scene_matches_jax_pallas_path,
)


@pytest.fixture(scope="module", autouse=True)
def card_route():
    """``eigh`` takes the Jacobi sweeps for every tensor in this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linalg, "_lapack", lambda t: False)
        yield
