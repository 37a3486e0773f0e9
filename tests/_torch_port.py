"""Helpers of the PyTorch port's tests: JAX results and stereo rigs as port
types."""

from __future__ import annotations

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy


def port_stereo(st):
    """A JAX StereoParams (or the port's numpy Stereo) as the port's."""
    if hasattr(st, "cam1"):
        leaves = (st.cam1.k, st.cam1.radial, st.cam1.tangential,
                  st.cam2.k, st.cam2.radial, st.cam2.tangential, st.t_c2_c1)
    else:
        leaves = tuple(st)
    return stereo_from_numpy(*(np.asarray(x) for x in leaves), device="cpu")


def jax_stereo(st):
    """The port's numpy Stereo (``utils.synthetic``) as a JAX StereoParams."""
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.types import CameraModel, StereoParams

    return StereoParams(
        cam1=CameraModel(*(jnp.asarray(x) for x in st[0:3])),
        cam2=CameraModel(*(jnp.asarray(x) for x in st[3:6])),
        t_c2_c1=jnp.asarray(st[6]),
    )


def to_port(tree):
    """A JAX NamedTuple tree (types, StereoPoseResult, RegistrationResult)
    as the port's NamedTuple of the same class name, leaf by leaf through
    numpy."""
    from cylinder_pose_estimation_tpu_torch import types
    from cylinder_pose_estimation_tpu_torch.models import pipeline

    if not isinstance(tree, tuple):
        return torch.as_tensor(np.asarray(tree))
    name = type(tree).__name__
    cls = getattr(types, name, None) or getattr(pipeline, name)
    return cls(*[to_port(leaf) for leaf in tree])
