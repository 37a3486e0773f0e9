"""The system under test, as the harness sees it: the PyTorch and CUDA
port, ``cylinder_pose_estimation_tpu_torch``.  Every import of the port
happens inside these functions, at set-up, so that the harness's modules
import without it (the CPU tests, the directory check)."""

from __future__ import annotations

import dataclasses

import numpy as np


def port():
    """The port's modules the harness drives."""
    import cylinder_pose_estimation_tpu_torch as pkg
    from cylinder_pose_estimation_tpu_torch import config, types
    from cylinder_pose_estimation_tpu_torch.models import detector, pipeline
    from cylinder_pose_estimation_tpu_torch.ops import frontend

    return _Port(pkg, config, types, pipeline, detector, frontend)


@dataclasses.dataclass(frozen=True)
class _Port:
    pkg: object
    config: object
    types: object
    pipeline: object
    detector: object
    frontend: object


def configs(p: _Port, cfg: dict):
    """(detect, fit, registration) config objects of the port from a
    configuration file's field groups."""
    c = p.config
    reg = dict(cfg["registration"])
    kin = c.KinematicsConfig(**reg.pop("kinematics", {}))
    return (c.CylinderDetectConfig(**cfg["detect"]), c.FitConfig(**cfg["fit"]),
            c.RegistrationConfig(kinematics=kin, **reg))


def rig(p: _Port, stereo, device):
    return p.types.stereo_from_numpy(*stereo, device=device)


def to_host(tree):
    """A NamedTuple tree of tensors -> the same tree as dicts of NumPy
    arrays (each leaf copied to the host, which waits for it)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {name: to_host(leaf) for name, leaf in zip(tree._fields, tree)}
    if isinstance(tree, np.ndarray):
        return tree
    return tree.detach().cpu().numpy()
