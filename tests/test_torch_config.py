"""PyTorch port: configs and converters equal the JAX package's.

The port mirrors the JAX dataclasses field for field (cylinder and plane
detection, fit), copies a JAX config with ``from_reference``, accepts the
branches it carries and refuses every branch it does not carry with an error
that names the ROADMAP item.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu import config as jcfg
from cylinder_pose_estimation_tpu.utils.synthetic import default_stereo
from cylinder_pose_estimation_tpu_torch import config as tcfg
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)


def _fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize(
    "name",
    ["DetectConfig", "CylinderDetectConfig", "PlaneDetectConfig", "FitConfig", "KinematicsConfig",
     "RegistrationConfig"],
)
def test_fields_and_defaults_equal_reference(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_mode_and_image_shape():
    cfg = tcfg.CylinderDetectConfig(height=240, width=320)
    assert cfg.mode == "cylinder"
    assert cfg.image_shape == (240, 320)
    assert tcfg.PlaneDetectConfig().mode == "plane"


@pytest.mark.parametrize(
    "ref",
    [
        jcfg.CylinderDetectConfig(height=240, width=320, use_pallas=True, min_ok_points=7),
        jcfg.PlaneDetectConfig(height=240, width=320, roi_threshold=30.0, merge_margin=7.0),
        jcfg.FitConfig(lm_iters=11, cyl_radius=70.0),
        jcfg.KinematicsConfig(l1=300.0, l2=150.0, h=95.0),
        jcfg.RegistrationConfig(cyl_radius=70.0, lm_iters=12, min_frame_points=5),
    ],
)
def test_from_reference_copies_every_field(ref):
    port = tcfg.from_reference(ref)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_from_reference_converts_nested_kinematics():
    """``RegistrationConfig.kinematics`` becomes the port's
    ``KinematicsConfig``, not a JAX object inside a port config."""
    ref = jcfg.RegistrationConfig(kinematics=jcfg.KinematicsConfig(l1=300.0, l2=150.0, h=95.0),
                                  min_observability=2e-3)
    port = tcfg.from_reference(ref)
    assert isinstance(port, tcfg.RegistrationConfig)
    assert type(port.kinematics) is tcfg.KinematicsConfig
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert type(tcfg.RegistrationConfig().kinematics) is tcfg.KinematicsConfig


def test_from_reference_refuses_plane_mode():
    """Plane mode is ported: ``from_reference`` copies every field of the
    JAX ``PlaneDetectConfig`` (defaults included) and keeps its mode."""
    port = tcfg.from_reference(jcfg.PlaneDetectConfig())
    assert isinstance(port, tcfg.PlaneDetectConfig) and port.mode == "plane"
    assert dataclasses.asdict(port) == dataclasses.asdict(jcfg.PlaneDetectConfig())


@pytest.mark.parametrize(
    "cfg",
    [
        tcfg.CylinderDetectConfig(use_pallas=True, bridge_endpoint_stats=True),
        tcfg.PlaneDetectConfig(use_pallas=True, roi_threshold=30.0),
        tcfg.PlaneDetectConfig(bridge_endpoint_stats=True),
        tcfg.CylinderDetectConfig(merge_short_cols=True),
        tcfg.CylinderDetectConfig(subpixel_refine=True),
        tcfg.PlaneDetectConfig(use_pallas=True, subpixel_refine=True),
        tcfg.CylinderDetectConfig(use_pallas=True, label_downsample=1),
        tcfg.CylinderDetectConfig(bridge_half_res=False),
        tcfg.CylinderDetectConfig(use_pallas=True, bridge_endpoint_stats=True, bridge_half_res=False),
        tcfg.PlaneDetectConfig(label_downsample=1, bridge_half_res=False, subpixel_refine=True),
        # The knobs of the in-kernel smoothing, the capped final scans and
        # the full-image centre brightness.
        tcfg.CylinderDetectConfig(use_pallas=True, pallas_cc_cross_cap=16),
        tcfg.CylinderDetectConfig(use_pallas=True, smooth_mxu=False),
        tcfg.CylinderDetectConfig(bright_at_points=False),
        tcfg.CylinderDetectConfig(use_pallas=True, subpixel_refine=True, smooth_mxu=False),
    ],
    ids=["endpoint_stats", "plane", "plane_endpoint_stats", "cylinder_merge_short_cols",
         "subpixel_refine", "plane_subpixel_refine", "full_res_labels", "full_res_bridge",
         "endpoint_full_res_bridge", "plane_full_res_refine", "cross_cap", "in_kernel_smoothing",
         "full_image_brightness", "refine_in_kernel_smoothing"],
)
def test_validate_accepts_ported_branches(cfg):
    tcfg.validate(cfg)


@pytest.mark.parametrize(
    "override, item",
    [
        # The ported variants beside an unported branch do not hide its
        # refusal.
        ({"bridge_endpoint_stats": True, "label_downsample": 3}, "1.13"),
        ({"merge_short_cols": True, "subpixel_refine": True, "label_downsample": 3}, "1.13"),
        ({"stage_probe": "bridge_state"}, "1.17"),
        ({"label_downsample": 3}, "1.13"),
        ({"bridge_half_res": False, "label_downsample": 0}, "1.13"),
    ],
)
def test_unported_branches_raise(override, item):
    cfg = tcfg.CylinderDetectConfig(**override)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tcfg.validate(cfg)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("override", [{"label_downsample": 3}, {"label_downsample": 4},
                                      {"label_downsample": 3, "bridge_half_res": False}])
def test_full_resolution_variants_refused_on_both_branches(override, use_pallas):
    """Both branches carry label_downsample 1 and 2 with either bridge
    resolution; any other labeling resolution, for which the JAX package
    has no arm, stays refused under its own item."""
    cfg = tcfg.CylinderDetectConfig(use_pallas=use_pallas, **override)
    with pytest.raises(NotImplementedError, match=r"\(ROADMAP 1\.13\.1\)"):
        tcfg.validate(cfg)
    tcfg.validate(dataclasses.replace(cfg, label_downsample=1))
    tcfg.validate(dataclasses.replace(cfg, label_downsample=2))


@pytest.mark.parametrize("cfg", [tcfg.CylinderDetectConfig(), tcfg.PlaneDetectConfig(),
                                 tcfg.CylinderDetectConfig(image_dtype="bfloat16", cc_iters=6),
                                 tcfg.CylinderDetectConfig(bridge_repeats=2)],
                         ids=["cylinder", "plane", "bfloat16", "two_repeats"])
def test_validate_accepts_the_xla_branch(cfg):
    assert cfg.use_pallas is False
    tcfg.validate(cfg)


@pytest.mark.parametrize(
    "override, item",
    [({"subpixel_refine": True, "label_downsample": 3}, "1.13"), ({"label_downsample": 4}, "1.13")],
)
def test_unported_branches_raise_in_plane_mode(override, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tcfg.validate(tcfg.PlaneDetectConfig(**override))


def test_from_reference_refuses_unknown_configs():
    with pytest.raises(NotImplementedError, match="no counterpart"):
        tcfg.from_reference(jcfg.DetectConfig())


def test_default_config_validates():
    tcfg.validate(tcfg.CylinderDetectConfig(use_pallas=True, pallas_interpret=True))


def test_stereo_from_numpy_round_trips():
    st = default_stereo(cx=320.0, cy=240.0)
    leaves = [st.cam1.k, st.cam1.radial, st.cam1.tangential,
              st.cam2.k, st.cam2.radial, st.cam2.tangential, st.t_c2_c1]
    port = stereo_from_numpy(*(np.asarray(x) for x in leaves), device="cpu")
    got = [port.cam1.k, port.cam1.radial, port.cam1.tangential,
           port.cam2.k, port.cam2.radial, port.cam2.tangential, port.t_c2_c1]
    for a, b in zip(leaves, got):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
