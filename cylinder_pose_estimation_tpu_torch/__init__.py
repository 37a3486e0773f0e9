"""PyTorch + CUDA port of the laser-grid cylinder pose estimation system.

The JAX package ``cylinder_pose_estimation_tpu`` beside it is the reference;
module paths here mirror it:
  ops/       image and numeric operations; ``ops/frontend.py`` holds the four
             front-end kernels of the detector (preprocess/binarise,
             connected components, bridge morphology, component payload
             min/max), hand-written CUDA C++ for Hopper in ``csrc/``, each
             with a plain PyTorch version: a CUDA tensor launches the
             kernel, a CPU tensor runs the plain version.
             ``ops/kernels.py`` catalogues, builds and launches every
             hand-written kernel (these four, ``ops/stencils``,
             ``ops/linalg.solve_spd``).
  geometry/  transforms, correspondence, triangulation, cylinder fit,
             pan/tilt kinematics, multi-frame registration.
  models/    the detector (kernel and XLA branches, cylinder and plane
             modes), sub-pixel refinement, the per-frame fit and the
             pipelines (batch, stream, whole experiment).
  parallel/  frame-parallel serving over ``torch.distributed``, one process
             per device: the frame mesh, the sharded pipelines, a dry run.
  utils/     the reference's JSON contracts (``io``), PNG files, synthetic
             scenes, visualisation, profiling.
  cli.py     the ``cylpose-torch`` drivers.
Entry points run on the card unless the caller passes CPU tensors or a CPU
device.
"""

from cylinder_pose_estimation_tpu_torch import config, types
from cylinder_pose_estimation_tpu_torch.config import (
    CylinderDetectConfig,
    DetectConfig,
    FitConfig,
    KinematicsConfig,
    PlaneDetectConfig,
    RegistrationConfig,
)
from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
from cylinder_pose_estimation_tpu_torch.models.pipeline import (
    estimate_pose_stereo,
    estimate_poses_batch,
    estimate_poses_stream,
    full_experiment,
    register_sequence,
)
from cylinder_pose_estimation_tpu_torch.models.pose import fit_single_cylinder
from cylinder_pose_estimation_tpu_torch.types import (
    CameraModel,
    CylinderFitResult,
    DetectResult,
    GridPoints,
    StereoParams,
)
from cylinder_pose_estimation_tpu_torch.utils import io

__all__ = [
    "config",
    "types",
    "io",
    "CylinderDetectConfig",
    "DetectConfig",
    "FitConfig",
    "KinematicsConfig",
    "PlaneDetectConfig",
    "RegistrationConfig",
    "CameraModel",
    "CylinderFitResult",
    "DetectResult",
    "GridPoints",
    "StereoParams",
    "detect_grid",
    "fit_single_cylinder",
    "estimate_pose_stereo",
    "estimate_poses_batch",
    "estimate_poses_stream",
    "full_experiment",
    "register_sequence",
]

__version__ = "0.1.0"
