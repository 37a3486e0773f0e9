"""The frame-parallel pipelines over a FrameMesh (the JAX package's
parallel/sharding.py).

* ``sharded_pipeline``: the whole experiment, frame-parallel: each rank
  detects and fits its block of frames, one all-gather gives every rank
  every frame's result, and each rank solves the registration on all of
  them (the counterpart of ``jit_sharded_pipeline``, where XLA inserts the
  same all-gather before the replicated solve).
* ``shard_map_pose``: the communication-free detect -> fit stage; each rank
  returns its own frames only, frame-sharded as the JAX ``shard_map``.

Every rank passes the same whole host arrays; each uploads only its block.
On a CUDA device each rank's block is its own compiled step
(``models.pipeline.compiled_batch``, the counterpart of the JAX package's
jitted program: eager at its first call, replayed from the second), and the
all-gather (NCCL) runs after it, outside the graph; the replicated
registration is the registration step.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.config import DetectConfig, FitConfig, RegistrationConfig
from cylinder_pose_estimation_tpu_torch.models.pipeline import (
    StereoPoseResult,
    _stereo_to,
    compiled_batch,
    register_sequence,
)
from cylinder_pose_estimation_tpu_torch.parallel.mesh import (
    FrameMesh,
    frame_slice,
    gather_frames,
    replicated,
)
from cylinder_pose_estimation_tpu_torch.types import RegistrationResult, StereoParams


def _upload(x, sl: slice, device: torch.device) -> torch.Tensor:
    """Frames ``x[sl]`` (numpy, a memmap or a tensor) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x[sl].to(device)
    return torch.from_numpy(np.array(x[sl])).to(device)


def _local_poses(mesh: FrameMesh, stereo: StereoParams, detect_cfg, fit_cfg):
    step = compiled_batch(stereo, detect_cfg, fit_cfg)

    def run(images1, images2) -> StereoPoseResult:
        start, stop = frame_slice(mesh, images1.shape[0])
        sl = slice(start, stop)
        return step(_upload(images1, sl, mesh.device), _upload(images2, sl, mesh.device))

    return run


def sharded_pipeline(
    mesh: FrameMesh,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    reg_cfg: RegistrationConfig = RegistrationConfig(),
):
    """The full multi-frame experiment with the frame axis split over the
    mesh.  Returns ``fn(images1, images2, angles) -> (StereoPoseResult,
    RegistrationResult)``: images (F, H, W[, 3]) with F divisible by the
    mesh size and angles (F, 2), the same whole arrays on every rank.  Every
    rank returns the whole result, on its device."""
    stereo = _stereo_to(stereo, mesh.device)
    local = _local_poses(mesh, stereo, detect_cfg, fit_cfg)

    def fn(images1, images2, angles) -> Tuple[StereoPoseResult, RegistrationResult]:
        batch = gather_frames(local(images1, images2), mesh)
        reg = register_sequence(batch, _upload(angles, slice(None), mesh.device), reg_cfg)
        return batch, replicated(reg)

    return fn


def shard_map_pose(
    mesh: FrameMesh,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
):
    """The detect -> fit stage on each rank's block, with no communication.
    Returns ``fn(images1, images2) -> StereoPoseResult`` of this rank's
    frames (``frame_slice``) only."""
    return _local_poses(mesh, _stereo_to(stereo, mesh.device), detect_cfg, fit_cfg)
