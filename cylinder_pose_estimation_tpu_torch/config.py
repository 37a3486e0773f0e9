"""Configuration of the PyTorch port: the detection, fit, kinematics and
registration dataclasses.

Field names and defaults equal those of ``cylinder_pose_estimation_tpu.config``
(the JAX package), so one configuration describes the same problem in both
packages; ``from_reference`` copies a JAX config object field by field.

The port runs both detection branches of the JAX package, in cylinder and
plane mode, and ``use_pallas`` picks one as it does there:
``use_pallas=True`` runs the kernel branch (with or without
``bridge_endpoint_stats``), whose four kernels are hand-written CUDA on a
CUDA tensor and their plain PyTorch versions on a CPU tensor;
``use_pallas=False`` (the default) runs the XLA branch in plain PyTorch on
either device, with ``image_dtype`` and ``cc_iters``; it ignores
``bridge_endpoint_stats``, as the JAX package does.  Both branches carry
the full-resolution variants (``label_downsample`` 1 or 2,
``bridge_half_res`` either way) and ``subpixel_refine``.
``pallas_interpret`` is accepted and ignored.  ``validate`` rejects every branch the port does not
carry, naming the ROADMAP item that would port it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Grid-detection front-end configuration (see the JAX package's
    ``config.DetectConfig`` for the provenance of every field)."""

    height: int = 480
    width: int = 640
    max_points: int = 512
    max_rows: int = 24
    max_cols: int = 24
    cc_iters: int = 16
    label_downsample: int = 2

    blur_ksize: int = 5
    ridge_sigma: float = 3.0
    sauvola_window: int = 15
    sauvola_k: float = 0.5
    sauvola_r: float = 128.0

    line_kernel_len: int = 20

    center_patch_half: int = 5
    joint_peak_iters: int = 5

    sat_blur_ksize: int = 19
    sat_threshold: float = 240.0

    bridge_repeats: int = 1
    endpoint_probe_len: int = 9
    bridge_skip_long: bool = True
    bridge_long_frac: float = 0.8
    bridge_endpoint_stats: bool = False
    bridge_stats_k: int = 32
    lowres_cc_rounds: int = 2
    bridge_stats_quarter: bool = True
    pallas_cc_pools: int = 2
    roi_blob_k: int = 32

    poly_degree: int = 2
    domain_margin: float = 50.0
    newton_iters: int = 12
    intersection_tol: float = 1e-3

    subpixel_refine: bool = False
    subpixel_samples: int = 64
    subpixel_window: int = 7

    index_blur_ksize: int = 7
    patch_half_min: int = 3

    min_ok_points: int = 20
    max_stable_tilt: float = 0.35
    min_mask_retention: float = 0.6

    merge_short_cols: bool = False
    merge_margin: float = 10.0

    image_dtype: str = "float32"

    use_pallas: bool = False
    pallas_cc_rounds: int = 3
    pallas_cc_rounds_prebridge: int = 2
    cc_warm_start: bool = True
    pallas_cc_rounds_warm: int = 2
    pallas_interpret: bool = False
    bridge_half_res: bool = True
    bright_at_points: bool = True
    pallas_cc_cross_cap: int = 0
    smooth_mxu: bool = True
    stage_probe: str = ""

    @property
    def mode(self) -> str:
        raise NotImplementedError

    @property
    def image_shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class CylinderDetectConfig(DetectConfig):
    """Cylinder-surface grid detection."""

    poly_degree: int = 2
    bridge_kernel_base: int = 91
    bridge_min_len: float = 5.0
    bridge_max_len: float = 200.0
    drop_first_row: bool = True
    drop_last_col: bool = True
    drop_negative_cols: bool = True
    id_row_major: bool = False

    @property
    def mode(self) -> str:
        return "cylinder"


@dataclasses.dataclass(frozen=True)
class PlaneDetectConfig(DetectConfig):
    """Planar calibration-target grid detection: threshold-hull ROI, fixed
    bridge kernel, degree-1 fits, (row, col) ids, short-column merge."""

    poly_degree: int = 1
    roi_threshold: float = 127.0
    roi_expand: int = 5
    roi_blob_k: int = 128
    bridge_kernel_base: int = 201
    bridge_min_len: float = 8.0
    bridge_max_len: float = 700.0
    drop_first_row: bool = False
    drop_last_col: bool = False
    drop_negative_cols: bool = False
    id_row_major: bool = True
    bridge_skip_long: bool = False
    merge_short_cols: bool = True

    @property
    def mode(self) -> str:
        return "plane"


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Stereo correspondence + cylinder fitting."""

    cyl_radius: float = 45.0
    patch_size: int = 3
    error_threshold: float = 0.3
    grid_extent: int = 24
    knn_k: int = 20
    lm_iters: int = 20
    lm_lambda0: float = 1e-3
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class KinematicsConfig:
    """Pan/tilt AGV->cylinder forward kinematics (ref utils/getTAGVcyl.m:8-38)."""

    l1: float = 321.1   # cylinder origin -> tilt joint
    l2: float = 143.1   # AGV origin -> tilt joint at tilt 0
    h: float = 110.0    # tilt joint -> cylinder origin height


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Multi-frame camera<->AGV registration (ref utils/fitCylinderWPts3sAngs.m);
    see the JAX package's ``config.RegistrationConfig`` for the provenance
    of the frame-health and observability gates."""

    cyl_radius: float = 45.0
    lm_iters: int = 80
    lm_lambda0: float = 1e-3
    kinematics: KinematicsConfig = dataclasses.field(default_factory=KinematicsConfig)
    min_frame_points: int = 8
    max_frame_reproj_px: float = 2.0
    min_observability: float = 1.5e-3


_COUNTERPARTS = {
    cls.__name__: cls
    for cls in (CylinderDetectConfig, PlaneDetectConfig, FitConfig, KinematicsConfig,
                RegistrationConfig)
}


def from_reference(obj):
    """Port config equal to a JAX package config object, copied field by
    field by attribute name: a JAX ``CylinderDetectConfig``,
    ``PlaneDetectConfig``, ``FitConfig``, ``KinematicsConfig`` or
    ``RegistrationConfig`` becomes the class of the same name here, and a
    nested config field (``RegistrationConfig.kinematics``) is converted the
    same way."""
    name = type(obj).__name__
    target = _COUNTERPARTS.get(name)
    if target is None:
        raise NotImplementedError(f"{name} has no counterpart in the port")
    kwargs = {}
    for f in dataclasses.fields(target):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            value = from_reference(value)
        kwargs[f.name] = value
    return target(**kwargs)


# Each unported branch: (predicate on the config, ROADMAP item, description).
_UNPORTED = (
    (lambda c: c.pallas_cc_cross_cap > 0, "1.17",
     "pallas_cc_cross_cap > 0 (a TPU-only scan cap, not carried)"),
    (lambda c: not c.smooth_mxu, "1.17",
     "smooth_mxu=False (the in-kernel smoothing, not carried)"),
    (lambda c: not c.bright_at_points, "1.17",
     "bright_at_points=False (full-image brightness, not carried)"),
    (lambda c: c.stage_probe != "", "1.17",
     "stage_probe (use the port's stage functions instead)"),
    (lambda c: c.label_downsample not in (1, 2), "1.13.1",
     "label_downsample other than 1 or 2 (the JAX package has no arm for it)"),
)


def validate(cfg: DetectConfig) -> None:
    """Raise NotImplementedError for every config branch the port lacks."""
    for pred, item, what in _UNPORTED:
        if pred(cfg):
            raise NotImplementedError(f"{what}: not ported (ROADMAP {item})")
