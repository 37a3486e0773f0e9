"""Laser-grid detection, cylinder and plane modes: images in, indexed grid
points out.

Port of the JAX package's models/detector.py, ``detect_grid``, over a
leading batch of views, with both of its branches: ``use_pallas=True`` (the
kernel branch: the four kernels of ``ops/frontend``, hand-written CUDA on the
card) and ``use_pallas=False`` (the XLA branch, the JAX package's default:
filters, ridge binarisation, segmented-scan CC and the morphological bridge
in plain PyTorch, ``ops/image``, ``ops/ridge``, ``ops/labeling``,
``ops/morphology``; it launches none of the four kernels).  Where the JAX
code ``vmap``s one image, every function here takes (V, ...) tensors; the
(h, v) line-mask pair of each view rides as a second axis and is flattened
into (2V, ...) batches.  Either branch takes any height and width (the
kernel branch's front end needs multiples of 8, as in the JAX package).

The stages, in order (each a function the tests can drive on its own):
  ``front_stage``    kernel branch: smoothing (the stencil kernel of
                     ``ops/stencils``, or inside the preprocess kernel with
                     ``smooth_mxu=False``) -> preprocess kernel ->
                     statistic images (a stencil kernel) -> joint centroids
  ``front_stage_xla``  XLA branch: Gaussian blur -> ridge binarisation ->
                     border band -> line openings -> joint count and peaks ->
                     the statistic images (banded matmuls) and centroids
  ``roi_stage``      quarter-res ROI / saturation CC (kernel, or the XLA
                     CC) -> ROI mask (cylinder: line-density blob; plane:
                     threshold hull), bbox, centre seed -> saturation carve
  ``bridge_stage``   kernel branch: pre-bridge CC (or, under
                     ``bridge_endpoint_stats``, the payload min/max kernel)
                     -> angles / expandability -> bridge kernel
  ``bridge_stage_xla``  XLA branch: CC -> angles / expandability -> ray
                     counts, oriented line dilation, 3x3 closing
  ``grid_stage``     final CC (kernel: warm, or cold after the endpoint
                     bridge, one call for the h/v pair or two capped ones
                     under ``pallas_cc_cross_cap``; XLA: cold, with the
                     pre-bridge recount) ->
                     assign -> polyfit -> short-column merge (plane) ->
                     sub-pixel refinement (``subpixel_refine``) -> prune ->
                     Newton intersections -> relabel -> index -> DetectResult
The labels run at ``label_downsample`` 2 (the half-res padded canvas) or 1
(full resolution); the bridge runs on the half-res canvas with a halved
reach (``bridge_half_res`` with ``label_downsample=2``, the defaults) or on
the full-resolution masks.  Fixed shapes and masks throughout, no host
synchronisation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cylinder_pose_estimation_tpu_torch.config import DetectConfig, validate
from cylinder_pose_estimation_tpu_torch.models.refine import refine_curves_cog
from cylinder_pose_estimation_tpu_torch.ops import frontend, labeling, morphology, ridge, stencils
from cylinder_pose_estimation_tpu_torch.ops import mxu_conv as mxc
from cylinder_pose_estimation_tpu_torch.ops.image import bgr_to_gray, box_filter, gaussian_blur_cv
from cylinder_pose_estimation_tpu_torch.ops.polyfit import (
    masked_polyfit,
    poly_domain,
    poly_intersection,
    polyder,
    polyval,
)
from cylinder_pose_estimation_tpu_torch.types import DetectResult, GridPoints
from cylinder_pose_estimation_tpu_torch.utils import profiling

_SHIFT4 = 1  # quarter-res content offset inside the padded canvas
_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min
_HALF_PI = math.pi / 2


def _axis_bases(device) -> torch.Tensor:
    """[0, pi/2] (h, v base angles), built on the device: a host tensor
    copied there would synchronise the stream."""
    return torch.arange(2, dtype=torch.float32, device=device) * _HALF_PI


class DetectDebug(NamedTuple):
    binary: torch.Tensor
    h_mask: torch.Tensor
    v_mask: torch.Tensor
    roi_mask: torch.Tensor
    h_expanded: torch.Tensor
    v_expanded: torch.Tensor
    centroids: torch.Tensor
    centroids_valid: torch.Tensor
    center_seed: torch.Tensor
    row_coeffs: torch.Tensor
    col_coeffs: torch.Tensor
    row_valid: torch.Tensor
    col_valid: torch.Tensor


def _border_margin(cfg: DetectConfig) -> int:
    reach = (
        (cfg.blur_ksize - 1) // 2
        + int(4.0 * cfg.ridge_sigma + 0.5)
        + 2
        + cfg.sauvola_window // 2
        + 1
    )
    return max(cfg.line_kernel_len, reach)


def _to_gray(images: torch.Tensor) -> torch.Tensor:
    img = images.to(torch.float32)
    return bgr_to_gray(img) if img.dim() == 4 else img


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` over the last axis: linear interpolation between the
    middle order statistics of the non-NaN values, NaN when there are none."""
    cnt = torch.sum(~torch.isnan(x), dim=-1).to(torch.float32)
    s = torch.sort(torch.where(torch.isnan(x), float("inf"), x), dim=-1).values
    q = 0.5 * (cnt - 1.0)
    low = torch.floor(q)
    high = torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    top = torch.clamp(cnt - 1.0, min=0.0)
    lo_i = torch.clamp(torch.minimum(low, cnt - 1.0), min=0.0).to(torch.int64)
    hi_i = torch.clamp(torch.minimum(high, top), min=0.0).to(torch.int64)
    lo_v = s.gather(-1, lo_i[..., None])[..., 0]
    hi_v = s.gather(-1, hi_i[..., None])[..., 0]
    out = lo_v * lw + hi_v * hw
    return torch.where(cnt > 0, out, float("nan"))


# ---------------------------------------------------------------------------
# Stage 1-2: smoothing, preprocess kernel, statistic images, joint centroids
# ---------------------------------------------------------------------------


def _smooth(gray: torch.Tensor, cfg: DetectConfig) -> torch.Tensor:
    """Composed Gaussian(blur_ksize) o Gaussian(ridge_sigma), exact mode
    (``stencils.smooth``: the banded matmuls on the CPU, a stencil on the
    card)."""
    return stencils.smooth(gray, cfg.blur_ksize, cfg.ridge_sigma)


def _stats_args(cfg: DetectConfig) -> dict:
    return dict(sat_blur_ksize=cfg.sat_blur_ksize, sat_threshold=cfg.sat_threshold, margin=_border_margin(cfg),
                index_blur_ksize=cfg.index_blur_ksize,
                center_patch_half=None if cfg.bright_at_points else cfg.center_patch_half)


def _stats_images(gray, joints_f, cnt, cfg: DetectConfig, joint_window: int = 11):
    """Saturation mask, centre-seed brightness image (``bright_at_points=
    False`` only, else None), index-brightness image and joint box
    centroids by banded matmuls on either device (``stencils.
    stats_images_plain``: the XLA branch's route; the kernel branch calls
    ``stencils.stats_images``)."""
    return stencils.stats_images_plain(gray, joints_f, cnt, joint_window=joint_window, **_stats_args(cfg))


def _joint_centroids(peak: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, k: int):
    """First k joint peaks in 4x4-block scan order -> ((V, k, 2), (V, k))."""
    v, h, w = peak.shape
    pk = torch.stack([torch.where(peak > 0.5, cx, -1.0), torch.where(peak > 0.5, cy, -1.0)], 1)
    ph, pw = (-h) % 4, (-w) % 4
    if ph or pw:
        pk = F.pad(pk, (0, pw, 0, ph), value=-1.0)
    blk = F.max_pool2d(pk, 4, 4).reshape(v, 2, -1)  # (V, 2, nb)
    has = blk[:, 0] >= 0.0
    rank = labeling.prefix_rank(has).to(torch.int64)
    slot = torch.where(has & (rank < k), rank, k)
    payload = torch.stack([blk[:, 0], blk[:, 1], torch.ones_like(blk[:, 0])], -1)
    picked = torch.zeros((v, k + 1, 3), dtype=torch.float32, device=peak.device)
    picked = picked.scatter(1, slot[..., None].expand(payload.shape), payload)[:, :k]
    valid = picked[..., 2] > 0.5
    return torch.where(valid[..., None], picked[..., :2], 0.0), valid


class Front(NamedTuple):
    gray: torch.Tensor
    binary: torch.Tensor
    h_mask: torch.Tensor
    v_mask: torch.Tensor
    sat_mask: torch.Tensor
    bright_blur: torch.Tensor
    cents: torch.Tensor
    cvalid: torch.Tensor
    bright_center: torch.Tensor | None = None


def front_stage(gray: torch.Tensor, cfg: DetectConfig) -> Front:
    """Stages 1-2 on (V, H, W) gray images: the preprocess kernel on the
    composed-Gaussian smoothing (``smooth_mxu``) or on the grey image, which
    it then smooths itself; then the statistic images (``stencils.
    stats_images``) and the joint centroids."""
    h, w = gray.shape[-2:]
    if h % 8 or w % 8:
        raise ValueError(f"the front-end needs 8-aligned image shapes, got {(h, w)}")
    b_f, h_f, v_f, j_f, joint_cnt, joint_peak = frontend.preprocess_binarize(
        _smooth(gray, cfg) if cfg.smooth_mxu else gray,
        blur_ksize=cfg.blur_ksize,
        ridge_sigma=cfg.ridge_sigma,
        pre_smoothed=cfg.smooth_mxu,
        sauvola_window=cfg.sauvola_window,
        sauvola_k=cfg.sauvola_k,
        sauvola_r=cfg.sauvola_r,
        min_contrast=0.05,
        line_len=cfg.line_kernel_len,
        margin=_border_margin(cfg),
        joint_peak_iters=cfg.joint_peak_iters,
    )
    sat_mask, bright_center, bright_blur, cx, cy = stencils.stats_images(gray, j_f, joint_cnt, **_stats_args(cfg))
    cents, cvalid = _joint_centroids(joint_peak, cx, cy, cfg.max_points)
    return Front(gray, b_f > 0.5, h_f > 0.5, v_f > 0.5, sat_mask, bright_blur, cents, cvalid, bright_center)


def _joint_peaks(joints: torch.Tensor, cnt: torch.Tensor, peak_iters: int, window: int = 11) -> torch.Tensor:
    """Per-blob peak mask of (V, H, W) joints: the pixel whose (box count,
    linear index) key is the largest of its 8-connected blob, by
    ``peak_iters`` rounds of masked 3x1 then 1x3 max propagation (exact
    int32 keys, as the preprocess kernel's peaks)."""
    h, w = joints.shape[-2:]
    lin = torch.arange(h * w, dtype=torch.int32, device=joints.device).reshape(h, w)
    key = cnt.to(torch.int32) * (1 << labeling.peak_key_shift(h, w, window)) + lin
    km = torch.where(joints, key, _I32_MIN)
    for _ in range(peak_iters):
        p = F.pad(km, (0, 0, 1, 1), value=_I32_MIN)
        km = torch.maximum(torch.maximum(p[..., :-2, :], p[..., 1:-1, :]), p[..., 2:, :])
        p = F.pad(km, (1, 1), value=_I32_MIN)
        km = torch.maximum(torch.maximum(p[..., :-2], p[..., 1:-1]), p[..., 2:])
        km = torch.where(joints, km, _I32_MIN)
    return joints & (key == km)


def front_stage_xla(gray: torch.Tensor, cfg: DetectConfig) -> Front:
    """Stages 1-2 of the XLA branch on (V, H, W) gray images: Gaussian blur
    (in ``cfg.image_dtype``), ridge minima and Sauvola binarisation, the
    border band, the 1xL and Lx1 line openings, their joints, the 11x11
    joint count and the joint peaks; then the statistic images by banded
    matmuls (``_stats_images``) and the joint centroids."""
    h, w = gray.shape[-2:]
    dtype = torch.float32 if cfg.image_dtype == "float32" else torch.bfloat16
    blurred = gaussian_blur_cv(gray.to(dtype), cfg.blur_ksize)
    binary = ridge.binarize_ridges(blurred.to(torch.float32), cfg.ridge_sigma, cfg.sauvola_window,
                                   cfg.sauvola_k, cfg.sauvola_r, min_contrast=0.05)
    rr = torch.arange(h, device=gray.device)[:, None]
    cc = torch.arange(w, device=gray.device)[None, :]
    mrg = _border_margin(cfg)
    binary = binary & (rr >= mrg) & (rr < h - mrg) & (cc >= mrg) & (cc < w - mrg)
    h_mask = morphology.open_rect(binary, 1, cfg.line_kernel_len)
    v_mask = morphology.open_rect(binary, cfg.line_kernel_len, 1)
    joints = h_mask & v_mask
    jf = joints.to(torch.float32)
    joint_cnt = box_filter(jf, 11, mode="constant", normalize=False)
    peak = _joint_peaks(joints, joint_cnt, cfg.joint_peak_iters)
    sat_mask, bright_center, bright_blur, cx, cy = _stats_images(gray, jf, joint_cnt, cfg)
    cents, cvalid = _joint_centroids(peak.to(torch.float32), cx, cy, cfg.max_points)
    return Front(gray, binary, h_mask, v_mask, sat_mask, bright_blur, cents, cvalid, bright_center)


# ---------------------------------------------------------------------------
# Stages 3-5: ROI, centre seed, saturation carve
# ---------------------------------------------------------------------------


def _pool2_pad(mask: torch.Tensor) -> torch.Tensor:
    """Half-res 2x2 max-pool of (..., H, W) into an (8, 128)-padded canvas."""
    lead = mask.shape[:-2]
    x = mask.to(torch.float32).reshape((-1, 1) + mask.shape[-2:])
    small = F.max_pool2d(x, 2, 2) > 0.5
    h2, w2 = small.shape[-2:]
    hp = ((h2 + 7) // 8) * 8
    wp = ((w2 + 127) // 128) * 128
    small = F.pad(small, (0, wp - w2, 0, hp - h2))
    return small.reshape(lead + (hp, wp))


def _pool4_pad(mask: torch.Tensor) -> torch.Tensor:
    """Quarter-res 4x4 max-pool of (..., H, W), shifted by (1, 1) into an
    (8, 128)-padded canvas."""
    lead = mask.shape[:-2]
    x = mask.to(torch.float32).reshape((-1, 1) + mask.shape[-2:])
    small = F.max_pool2d(x, 4, 4) > 0.5
    h4, w4 = small.shape[-2:]
    hp = ((h4 + 2 * _SHIFT4 + 7) // 8) * 8
    wp = ((w4 + 2 * _SHIFT4 + 127) // 128) * 128
    small = F.pad(small, (_SHIFT4, wp - w4 - _SHIFT4, _SHIFT4, hp - h4 - _SHIFT4))
    return small.reshape(lead + (hp, wp))


def _ring_mask(h: int, w: int, device) -> torch.Tensor:
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return (rows >= 1) & (rows < h - 1) & (cols >= 1) & (cols < w - 1)


def _cc_pairs(masks: torch.Tensor, rounds: int, pools: int, init=None) -> torch.Tensor:
    """CC of (V, 2, h, w) mask pairs in one (2V, h, w) kernel launch."""
    v, two, h, w = masks.shape
    lab = frontend.connected_components(
        masks.reshape(v * two, h, w).to(torch.float32),
        rounds=rounds,
        pools_per_round=pools,
        init_labels=None if init is None else init.reshape(v * two, h, w),
    )
    return lab.reshape(v, two, h, w)


def _cc_xla(masks: torch.Tensor, iters: int) -> torch.Tensor:
    """The XLA branch's CC of (V, k, h, w) masks, all in one batch."""
    v, k, h, w = masks.shape
    return labeling.connected_components(masks.reshape(v * k, h, w), iters).reshape(v, k, h, w)


def _roi_cylinder_from_labels(merged, labels, h: int, w: int, k: int) -> torch.Tensor:
    largest = labeling.largest_component_mask(labels, k=k) & merged
    filled = labeling.fill_orthoconvex(largest)
    h4, w4 = -(-h // 4), -(-w // 4)
    filled = filled[..., _SHIFT4:_SHIFT4 + h4, _SHIFT4:_SHIFT4 + w4]
    up = filled.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)
    return up[..., :h, :w]


def _roi_plane_from_labels(th: torch.Tensor, labels: torch.Tensor, cfg: DetectConfig) -> torch.Tensor:
    """Threshold hull ROI: the largest quarter-res component of the threshold
    mask, upsampled and ANDed with it, orthoconvex-filled at full resolution,
    then dilated by ``roi_expand``."""
    h, w = th.shape[-2:]
    largest4 = labeling.largest_component_mask(labels, k=cfg.roi_blob_k)
    h4, w4 = -(-h // 4), -(-w // 4)
    largest4 = largest4[..., _SHIFT4:_SHIFT4 + h4, _SHIFT4:_SHIFT4 + w4]
    up = largest4.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)
    hull = labeling.fill_orthoconvex(up[..., :h, :w] & th)
    return morphology.dilate_rect(hull, 2 * cfg.roi_expand + 1, 2 * cfg.roi_expand + 1)


def _bbox_of(mask: torch.Tensor) -> torch.Tensor:
    """(V, 4) int32 (x, y, w, h) bounding boxes of (V, H, W) masks."""
    h, w = mask.shape[-2:]
    cols_any = torch.any(mask, dim=-2)
    rows_any = torch.any(mask, dim=-1)
    xs = torch.arange(w, device=mask.device)
    ys = torch.arange(h, device=mask.device)
    x0 = torch.amin(torch.where(cols_any, xs, w), dim=-1)
    x1 = torch.amax(torch.where(cols_any, xs, -1), dim=-1)
    y0 = torch.amin(torch.where(rows_any, ys, h), dim=-1)
    y1 = torch.amax(torch.where(rows_any, ys, -1), dim=-1)
    return torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], -1).to(torch.int32)


def _center_seed(cents, cvalid, gray, bbox, cfg: DetectConfig, bright_img=None):
    """Brightest joint inside the ROI bbox + distance to its 2nd neighbour;
    the brightness read from ``bright_img`` (``bright_at_points=False``) or
    evaluated at the joints."""
    x0, y0, bw, bh = (bbox[:, i:i + 1] for i in range(4))
    inside = (
        cvalid
        & (cents[..., 0] >= x0) & (cents[..., 0] < x0 + bw)
        & (cents[..., 1] >= y0) & (cents[..., 1] < y0 + bh)
    )
    h, w = gray.shape[-2:]
    xi = torch.clamp(cents[..., 0].to(torch.int32), 0, w - 1)
    yi = torch.clamp(cents[..., 1].to(torch.int32), 0, h - 1)
    if bright_img is None:
        pc = 2 * cfg.center_patch_half + 1
        vals = mxc.conv_at_points(gray, yi, xi, mxc.box_taps(pc)) / float(pc * pc)
    else:
        vals = bright_img.reshape(bright_img.shape[0], -1).gather(1, (yi * w + xi).to(torch.int64))
    bright = torch.where(inside, vals, float("-inf"))
    ci = torch.argmax(bright, dim=-1)
    center = cents.gather(1, ci[:, None, None].expand(-1, 1, 2))[:, 0]
    d = _norm(cents - center[:, None, :])
    d = torch.where(inside, d, float("inf"))
    i1 = torch.argmin(d, dim=-1)
    ar = torch.arange(d.shape[-1], device=d.device)
    d2 = torch.amin(torch.where(ar == i1[:, None], float("inf"), d), dim=-1)
    d2 = torch.where(torch.isfinite(d2), d2, 0.0)
    return center, torch.floor(d2), inside


def _saturation_carve(h_mask, v_mask, roi_mask, small, labels):
    """Carve the largest saturated blob's ellipse out of the line masks.
    small/labels: the quarter-res saturation mask and its labels."""
    hgt, wdt = h_mask.shape[-2:]
    dev = h_mask.device
    stats = labeling.component_stats_first_k(labels, k=32)
    li = torch.argmax(stats.count, dim=-1, keepdim=True)  # (V, 1)
    has = stats.valid.gather(1, li)[:, 0]
    cen = stats.centroid.gather(1, li[..., None].expand(-1, 1, 2))[:, 0]
    cx = 4.0 * (cen[:, 0] - _SHIFT4) + 1.5
    cy = 4.0 * (cen[:, 1] - _SHIFT4) + 1.5
    sh, sw = small.shape[-2:]
    yy_s = 4.0 * (torch.arange(sh, dtype=torch.float32, device=dev)[:, None] - _SHIFT4) + 1.5
    xx_s = 4.0 * (torch.arange(sw, dtype=torch.float32, device=dev)[None, :] - _SHIFT4) + 1.5
    root = stats.root.gather(1, li)[:, :, None]
    blob = labels == root
    ddx = xx_s - cx[:, None, None]
    ddy = yy_s - cy[:, None, None]
    dist_s = torch.sqrt(ddx * ddx + ddy * ddy) + 2.2
    far = torch.amax(torch.where(blob, dist_s, 0.0).reshape(blob.shape[0], -1), dim=-1)
    r0i = torch.floor(torch.where(has, far, 0.0))
    yy = torch.arange(hgt, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(wdt, dtype=torch.float32, device=dev)[None, :]
    radius = torch.where(r0i < 30, r0i + 20.0, r0i + 5.0)
    ax = ((radius + 40.0) / 2.0)[:, None, None]
    ay = (torch.clamp(radius + 20.0, min=1.0) / 2.0)[:, None, None]
    ex = (xx - cx[:, None, None]) / ax
    ey = (yy - cy[:, None, None]) / ay
    in_ellipse = ex * ex + ey * ey <= 1.0
    carve = has[:, None, None] & in_ellipse
    domain = ~carve & roi_mask
    mh = morphology.open_rect(h_mask & domain, 3, 3)
    mv = morphology.open_rect(v_mask & domain, 3, 3)
    return mh, mv, r0i, domain


class Roi(NamedTuple):
    roi: torch.Tensor
    bbox: torch.Tensor
    center: torch.Tensor
    inside: torch.Tensor
    mh: torch.Tensor
    mv: torch.Tensor
    circle_radius0: torch.Tensor
    carve_domain: torch.Tensor


def roi_stage(front: Front, cfg: DetectConfig) -> Roi:
    """Stages 3-5: quarter-res ROI + saturation labeling (one CC kernel
    launch, or the XLA branch's CC at min(cc_iters, 8) iterations; the
    1-px ring is cleared on both),
    ROI mask and bbox, centre seed, saturation carve.  The ROI seed is the
    9x9-dilated line mask in cylinder mode and the grey threshold
    ``roi_threshold`` in plane mode."""
    h, w = front.gray.shape[-2:]
    plane = cfg.mode == "plane"
    if plane:
        roi_th = front.gray > cfg.roi_threshold
        pooled = _pool4_pad(torch.stack([front.sat_mask, roi_th], 1))
        roi_seed4 = pooled[:, 1]
    else:
        pooled = _pool4_pad(torch.stack([front.sat_mask, front.h_mask | front.v_mask], 1))
        roi_seed4 = morphology.dilate_rect(pooled[:, 1], 9, 9)
    sat_small = pooled[:, 0]
    ring = _ring_mask(*sat_small.shape[-2:], sat_small.device)
    pair = torch.stack([roi_seed4 & ring, sat_small & ring], 1)
    if cfg.use_pallas:
        labels = _cc_pairs(pair, rounds=cfg.lowres_cc_rounds, pools=4)
    else:
        labels = _cc_xla(pair, min(cfg.cc_iters, 8))
    if plane:
        roi = _roi_plane_from_labels(roi_th, labels[:, 0], cfg)
    else:
        roi = _roi_cylinder_from_labels(roi_seed4, labels[:, 0], h, w, k=cfg.roi_blob_k)
    bbox = _bbox_of(roi)
    center, _, inside = _center_seed(front.cents, front.cvalid, front.gray, bbox, cfg, front.bright_center)
    mh, mv, r0i, domain = _saturation_carve(front.h_mask, front.v_mask, roi, sat_small, labels[:, 1])
    return Roi(roi, bbox, center, inside, mh, mv, r0i, domain)


# ---------------------------------------------------------------------------
# Stage 6a: bridging
# ---------------------------------------------------------------------------


def _n_components(masks: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Roots (pixels holding their own index) of (V, 2, h, w), per view."""
    h, w = masks.shape[-2:]
    idx = torch.arange(h * w, dtype=torch.int32, device=masks.device).reshape(h, w)
    root = masks & (labels == idx)
    return torch.sum(root.reshape(root.shape[0], -1), dim=-1).to(torch.int32)


def _labels_converged(masks: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """No in-mask pixel has an 8-neighbour (in the mask) with a smaller
    label: the min-propagation fixpoint, per view of (V, 2, h, w)."""
    lab = torch.where(masks, labels, _I32_MAX)
    h, w = lab.shape[-2:]
    padded = F.pad(lab, (1, 1, 1, 1), value=_I32_MAX)
    neigh = lab
    for dy in range(3):
        for dx in range(3):
            neigh = torch.minimum(neigh, padded[..., dy:dy + h, dx:dx + w])
    bad = masks & (neigh < lab)
    return ~torch.any(bad.reshape(bad.shape[0], -1), dim=-1)


def _bridge_angle_exp_pair(outs: torch.Tensor, labels: torch.Tensor, cfg: DetectConfig, scale: int):
    """Median component orientation (V, 2) and per-pixel expandability
    (V, 2, h, w) of the h/v mask pairs."""
    v, n, hgt, wdt = outs.shape
    dev = outs.device
    base = _axis_bases(dev)
    quarter = cfg.bridge_stats_quarter and hgt % 2 == 0 and wdt % 2 == 0
    if quarter:
        stats_labels = labels.reshape(v, n, hgt // 2, 2, wdt // 2, 2).amin(dim=(-3, -1))
        stats_scale, min_area, value_shape = 2.0, 1, (hgt, wdt)
    else:
        stats_labels = labels
        stats_scale, min_area, value_shape = 1.0, (4 if scale == 1 else 2), None
    stats = labeling.component_stats_first_k(
        stats_labels, k=cfg.bridge_stats_k, min_area=min_area, value_shape=value_shape
    )
    ang = labeling.component_orientation(stats) - base[:, None]
    ang = torch.atan2(torch.sin(ang), torch.cos(ang))
    ang = torch.where(ang > _HALF_PI, ang - math.pi, ang)
    ang = torch.where(ang <= -_HALF_PI, ang + math.pi, ang)
    half_tr = 0.5 * (stats.mxx + stats.myy)
    half_df = 0.5 * (stats.mxx - stats.myy)
    lam_max = half_tr + torch.sqrt(half_df * half_df + stats.mxy * stats.mxy)
    diag = (float(scale) * stats_scale) * torch.sqrt(12.0 * torch.clamp(lam_max, min=0.0))
    gate_med = stats.valid & (diag >= cfg.bridge_min_len) & (diag <= cfg.bridge_max_len)
    med = nanmedian(torch.where(gate_med, ang, float("nan")))
    angle = torch.where(torch.isnan(med), 0.0, med) + base
    if not cfg.bridge_skip_long:
        return angle, outs
    sized = stats.valid & (diag >= cfg.bridge_min_len)
    max_diag = torch.amax(torch.where(sized, diag, 0.0), dim=-1, keepdim=True)
    expandable = sized & (diag <= cfg.bridge_long_frac * max_diag)
    # Per-pixel gate: a (hw + 1)-entry lookup table of the expandable roots.
    hw = hgt * wdt
    table = torch.zeros((v, n, hw + 1), dtype=torch.bool, device=dev)
    table = table.scatter(-1, stats.root.to(torch.int64).clamp(0, hw), expandable)
    table[..., hw].fill_(False)
    flat = labels.reshape(v, n, hw).to(torch.int64).clamp(0, hw)
    return angle, table.gather(-1, flat).reshape(v, n, hgt, wdt)


# In-band line fragments tracked for the median angle of the endpoint-stats
# bridge (the JAX package's compaction capacity).
_MEDIAN_CAP = 64


def _scan_payloads(h: int, w: int, device) -> torch.Tensor:
    """(2, h, w) int32 scan orders: column-major (x*h + y) for the h mask,
    row-major (y*w + x) for the v mask, so each fragment's payload extremes
    are its end pixels along the line."""
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return torch.stack([xs * h + ys, ys * w + xs])


def _bridge_angle_exp_endpoint_pair(outs: torch.Tensor, pmin: torch.Tensor, pmax: torch.Tensor,
                                    cfg: DetectConfig, scale: int):
    """``_bridge_angle_exp_pair`` from each component's end pixels: the
    payload min/max of (V, 2, h, w) masks (payloads of ``_scan_payloads``)
    give the chord, its length ``scale * |p1 - p0|`` and its angle.  The
    median runs over the first ``_MEDIAN_CAP`` in-band roots (pixels holding
    their component's payload minimum) in raster order.  Returns the (V, 2)
    median angles and the per-pixel expandability."""
    v, n, hgt, wdt = outs.shape
    hw = hgt * wdt
    dev = outs.device
    base = _axis_bases(dev)
    in_mask = pmin < hw
    multi = in_mask & (pmax > pmin)

    def decode(p):
        # h mask (channel 0): p = x*h + y; v mask (channel 1): p = y*w + x.
        x = torch.stack([torch.div(p[:, 0], hgt, rounding_mode="floor"), p[:, 1] % wdt], 1)
        y = torch.stack([p[:, 0] % hgt, torch.div(p[:, 1], wdt, rounding_mode="floor")], 1)
        return x.to(torch.float32), y.to(torch.float32)

    x0, y0 = decode(pmin)
    x1, y1 = decode(pmax)
    dx = x1 - x0
    dy = y1 - y0
    ext = float(scale) * torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx) - base[None, :, None, None]
    ang = torch.atan2(torch.sin(ang), torch.cos(ang))
    ang = torch.where(ang > _HALF_PI, ang - math.pi, ang)
    ang = torch.where(ang <= -_HALF_PI, ang + math.pi, ang)

    is_root = in_mask & (pmin == _scan_payloads(hgt, wdt, dev))
    band = multi & (ext >= cfg.bridge_min_len) & (ext <= cfg.bridge_max_len)
    ridx, rvalid = labeling.compact_true_indices((is_root & band).reshape(v, n, hw), _MEDIAN_CAP)
    picked = ang.reshape(v, n, hw).gather(-1, torch.clamp(ridx, 0, hw - 1).to(torch.int64))
    s = torch.sort(torch.where(rvalid, picked, float("inf")), dim=-1).values
    m = torch.sum(rvalid, dim=-1, keepdim=True)
    k1 = torch.clamp(torch.div(m + 1, 2, rounding_mode="floor") - 1, min=0)
    k2 = torch.div(m, 2, rounding_mode="floor")
    med = 0.5 * (s.gather(-1, k1) + s.gather(-1, k2))
    angle = torch.where(m > 0, med, 0.0)[..., 0] + base
    if not cfg.bridge_skip_long:
        return angle, outs
    sized = multi & (ext >= cfg.bridge_min_len)
    max_ext = torch.amax(torch.where(sized, ext, 0.0).reshape(v, n, hw), dim=-1)
    return angle, sized & (ext <= cfg.bridge_long_frac * max_ext[..., None, None])


class Bridge(NamedTuple):
    h_exp: torch.Tensor
    v_exp: torch.Tensor
    warm_labels: torch.Tensor | None
    angles: torch.Tensor
    n_pre: torch.Tensor
    pre_converged: torch.Tensor


def _upsample2(small: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Undo ``_pool2_pad`` on (..., hp, wp): crop the half-res canvas, 2x
    nearest upsample, crop to (h, w)."""
    s = small[..., :(h + 1) // 2, :(w + 1) // 2]
    return s.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)[..., :h, :w]


def _bridge_reach(circle_radius0: torch.Tensor, cfg: DetectConfig, half: bool):
    """(kernel lengths (V,), max kernel, probe length) of the bridge: the
    reference's reach, halved with the probe for the half-res bridge."""
    kernel_len = float(cfg.bridge_kernel_base) + circle_radius0
    max_kernel = cfg.bridge_kernel_base + 160
    if not half:
        return kernel_len, max_kernel, cfg.endpoint_probe_len
    return kernel_len / 2.0, max(max_kernel // 2, 1), max(2, (cfg.endpoint_probe_len + 1) // 2)


def bridge_stage(mh: torch.Tensor, mv: torch.Tensor, circle_radius0: torch.Tensor,
                 cfg: DetectConfig) -> Bridge:
    """Stage 6a: the bridge of the carved h/v line masks (the JAX package's
    ``_bridge_pair``, kernel branch).  Under ``label_downsample=2`` and
    ``bridge_half_res`` (the defaults) everything runs on the half-res padded
    canvas with a halved reach and probe; otherwise the bridge kernel runs
    on the (H, W) masks with the full reach, its statistics come from the
    half-res canvas (``label_downsample=2``, expandability upsampled) or
    from the full masks (``label_downsample=1``).  Returns the bridged
    masks, the statistics CC's labels (warm start; None under
    ``bridge_endpoint_stats``, whose payload kernel gives no labels), the
    (V, 2) median angles and the pre-bridge component count."""
    v = mh.shape[0]
    h_img, w_img = mh.shape[-2:]
    dev = mh.device
    ds = cfg.label_downsample
    half = ds == 2 and cfg.bridge_half_res
    masks = torch.stack([mh, mv], 1)
    if half:
        masks = _pool2_pad(masks)  # (V, 2, h2, w2)
    kernel_len, max_kernel, probe_len = _bridge_reach(circle_radius0, cfg, half)
    rounds = max(1, int(cfg.pallas_cc_rounds_prebridge))
    n_pre = torch.zeros((v,), dtype=torch.int32, device=dev)
    pre_converged = torch.full((v,), cfg.bridge_repeats == 0, dtype=torch.bool, device=dev)
    warm = None
    angles = _axis_bases(dev).expand(v, 2)
    _, _, hm, wm = masks.shape
    for rep in range(cfg.bridge_repeats):
        small = _pool2_pad(masks) if ds == 2 and not half else masks
        _, _, hs, ws = small.shape
        if cfg.bridge_endpoint_stats:
            pay = _scan_payloads(hs, ws, dev).expand(v, 2, hs, ws)
            # The JAX package calls this kernel with its default 4 pools per
            # round, not cfg.pallas_cc_pools.
            pmin, pmax = frontend.component_payload_minmax(
                small.reshape(2 * v, hs, ws).to(torch.float32),
                pay.reshape(2 * v, hs, ws), rounds=rounds, pools_per_round=4,
            )
            pmin = pmin.reshape(v, 2, hs, ws)
            pmax = pmax.reshape(v, 2, hs, ws)
            if rep == 0:
                # One pixel per component holds its scan-order payload minimum.
                root = small & (pay == pmin)
                n_pre = torch.sum(root.reshape(v, -1), dim=-1).to(torch.int32)
            angles, exps = _bridge_angle_exp_endpoint_pair(small, pmin, pmax, cfg, scale=ds)
        else:
            labels = _cc_pairs(small, rounds=rounds, pools=cfg.pallas_cc_pools)
            warm = labels
            if rep == 0:
                n_pre = _n_components(small, labels)
                pre_converged = _labels_converged(small, labels)
            angles, exps = _bridge_angle_exp_pair(small, labels, cfg, scale=ds)
        if ds == 2 and not half:
            exps = _upsample2(exps, h_img, w_img)
        # Bool in, bool out; each view's kernel length covers its h/v pair.
        bridged = frontend.bridge_morphology(
            masks.reshape(2 * v, hm, wm),
            exps.reshape(2 * v, hm, wm),
            angles.reshape(2 * v),
            kernel_len,
            probe_len=probe_len,
            max_kernel=max_kernel,
        )
        masks = bridged.reshape(v, 2, hm, wm)
    return Bridge(masks[:, 0], masks[:, 1], warm, angles, n_pre, pre_converged)


def bridge_stage_xla(mh: torch.Tensor, mv: torch.Tensor, circle_radius0: torch.Tensor,
                     cfg: DetectConfig) -> Bridge:
    """Stage 6a of the XLA branch (the JAX package's ``_bridge`` per mask):
    per repeat, the XLA CC at cc_iters // 2, the median angles and
    expandability, the endpoints (expandable mask pixels whose forward or
    backward ray count within the probe is at most 1), their oriented line
    dilation, a 3x3 dilation and the closing-style combine.  Resolutions as
    ``bridge_stage``: all on the half-res canvas with the halved reach and
    probe under the defaults, else on the (H, W) masks with statistics from
    the half-res canvas (upsampled) or the full masks.  Not the kernel
    branch's bridge: at non-axis angles the two footprints differ by a
    discretisation pixel.  Returns the bridged masks, no warm labels, the
    (V, 2) angles and the pre-bridge count of repeat 0."""
    v = mh.shape[0]
    h_img, w_img = mh.shape[-2:]
    dev = mh.device
    ds = cfg.label_downsample
    half = ds == 2 and cfg.bridge_half_res
    masks = torch.stack([mh, mv], 1)
    if half:
        masks = _pool2_pad(masks)  # (V, 2, h2, w2)
    _, _, hm, wm = masks.shape
    kernel_len, max_kernel, probe_len = _bridge_reach(circle_radius0, cfg, half)
    klen = kernel_len.repeat_interleave(2)
    n_pre = torch.zeros((v,), dtype=torch.int32, device=dev)
    angles = _axis_bases(dev).expand(v, 2)
    for rep in range(cfg.bridge_repeats):
        small = _pool2_pad(masks) if ds == 2 and not half else masks
        labels = _cc_xla(small, cfg.cc_iters // 2)
        if rep == 0:
            n_pre = _n_components(small, labels)
        angles, exps = _bridge_angle_exp_pair(small, labels, cfg, scale=ds)
        if ds == 2 and not half:
            exps = _upsample2(exps, h_img, w_img)
        out = masks.reshape(2 * v, hm, wm)
        ang = angles.reshape(2 * v)
        fwd = morphology.directional_count(out, ang, probe_len, 1)
        bwd = morphology.directional_count(out, ang, probe_len, -1)
        ends = out & exps.reshape(2 * v, hm, wm) & ((fwd <= 1.0) | (bwd <= 1.0))
        grown = morphology.dilate_rect(morphology.dilate_line(ends, ang, max_kernel, klen), 3, 3)
        out = out | (morphology.erode_rect(out | grown, 3, 3) & grown)
        masks = out.reshape(v, 2, hm, wm)
    return Bridge(masks[:, 0], masks[:, 1], None, angles, n_pre,
                  torch.ones((v,), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# Stage 6b-6g: labels -> grid points
# ---------------------------------------------------------------------------


def _min3x3(lab: torch.Tensor, fill: int) -> torch.Tensor:
    h, w = lab.shape[-2:]
    padded = F.pad(lab, (1, 1, 1, 1), value=fill)
    out = padded[..., 1:1 + h, 1:1 + w]
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, padded[..., dy:dy + h, dx:dx + w])
    return out


def _assign_labels(label_img, cents, cvalid, capacity: int, scale: int):
    """Map each centroid to the (3x3-tolerant) component label under it,
    compacted to [0, capacity) slots by member count.  label_img:
    (B, h, w); cents (B, P, 2); cvalid (B, P)."""
    h, w = label_img.shape[-2:]
    hw = h * w
    xi = torch.clamp((cents[..., 0] / scale).to(torch.int32), 1, w - 2)
    yi = torch.clamp((cents[..., 1] / scale).to(torch.int32), 1, h - 2)
    m3 = _min3x3(label_img.to(torch.int32), hw)
    best = m3.reshape(m3.shape[0], -1).gather(1, (yi * w + xi).to(torch.int64))
    assigned = cvalid & (best < hw)
    roots = torch.where(assigned, best, hw)
    p = roots.shape[-1]
    pos = torch.arange(p, device=roots.device)
    eq = (roots[:, :, None] == roots[:, None, :]) & assigned[:, None, :]
    count = torch.sum(eq, dim=2)
    is_first = assigned & (torch.sum(eq & (pos[None, :] < pos[:, None]), dim=2) == 0)
    better = is_first[:, None, :] & (
        (count[:, None, :] > count[:, :, None])
        | ((count[:, None, :] == count[:, :, None]) & (roots[:, None, :] < roots[:, :, None]))
    )
    kept = is_first & (torch.sum(better, dim=2) < capacity)
    root_lt = kept[:, None, :] & (roots[:, None, :] < roots[:, :, None])
    slot_of = torch.sum(root_lt, dim=2)
    ok = assigned & torch.any(eq & kept[:, None, :], dim=2)
    slot_of = torch.clamp(slot_of, 0, capacity - 1)
    return torch.where(ok, slot_of, capacity - 1), ok


def _label_onehot(slot_of, ok, capacity: int) -> torch.Tensor:
    ar = torch.arange(capacity, device=slot_of.device)
    return (slot_of[:, None, :] == ar[None, :, None]) & ok[:, None, :]  # (V, cap, P)


def _label_min(vals, slot_of, ok, capacity: int) -> torch.Tensor:
    onehot = _label_onehot(slot_of, ok, capacity)
    return torch.amin(torch.where(onehot, vals[:, None, :], float("inf")), dim=-1)


def _fit_polys(xs, ys, wgt, cfg: DetectConfig):
    """Masked polynomial fits of (V, L, P) samples -> (coeffs, domain, valid,
    count) per label."""
    coeffs = masked_polyfit(xs, ys, wgt, cfg.poly_degree)
    domain = poly_domain(xs, wgt, cfg.domain_margin)
    count = torch.sum(wgt, dim=-1)
    return coeffs, domain, count >= cfg.poly_degree + 1, count


def _fit_column_polys(cents, col_of, col_ok, cfg: DetectConfig):
    """Per-label column fits x = g(y)."""
    wgt = _label_onehot(col_of, col_ok, cfg.max_cols).to(cents.dtype)
    return _fit_polys(cents[:, None, :, 1].expand_as(wgt), cents[:, None, :, 0].expand_as(wgt),
                      wgt, cfg)


def _fit_label_polys_pair(cents, row_of, row_ok, col_of, col_ok, cfg: DetectConfig):
    """Row fits y = f(x) and column fits x = g(y) in one batched solve."""
    r, c = cfg.max_rows, cfg.max_cols
    x, y = cents[..., 0], cents[..., 1]
    w_r = _label_onehot(row_of, row_ok, r).to(x.dtype)
    w_c = _label_onehot(col_of, col_ok, c).to(x.dtype)
    wgt = torch.cat([w_r, w_c], dim=1)
    xs = torch.cat([x[:, None, :].expand_as(w_r), y[:, None, :].expand_as(w_c)], dim=1)
    ys = torch.cat([y[:, None, :].expand_as(w_r), x[:, None, :].expand_as(w_c)], dim=1)
    coeffs, domain, valid, count = _fit_polys(xs, ys, wgt, cfg)
    return (
        (coeffs[:, :r], domain[:, :r], valid[:, :r], count[:, :r]),
        (coeffs[:, r:], domain[:, r:], valid[:, r:], count[:, r:]),
    )


def _label_mean(vals, slot_of, ok, capacity: int) -> torch.Tensor:
    """Per-label masked mean of a per-centroid value -> (V, capacity)."""
    onehot = _label_onehot(slot_of, ok, capacity)
    cnt = torch.clamp(torch.sum(onehot, dim=-1), min=1)
    return torch.sum(torch.where(onehot, vals[:, None, :], 0.0), dim=-1) / cnt


def _merge_short_column_leaders(span: torch.Tensor, mean_x: torch.Tensor,
                                valid: torch.Tensor) -> torch.Tensor:
    """Group leaders of the plane path's short-column merge, (V, C) -> (V, C)
    slot indices (identity for normal, unmerged and invalid slots).

    A column whose span is at most 0.9x the longest is short.  Walking the
    slots in mean-x order, runs of consecutive short columns merge while the
    group's summed span stays within the longest; a normal column closes the
    group.  The JAX package's ``lax.scan`` over the sorted slots is a loop
    over the C slots here, vectorised over views."""
    threshold = torch.amax(torch.where(valid, span, 0.0), dim=-1)
    abnormal = valid & (span <= 0.9 * threshold[:, None])
    order = torch.argsort(torch.where(valid, mean_x, float("inf")), dim=-1, stable=True)
    cum = torch.zeros_like(threshold)
    leader = torch.zeros_like(order[:, 0])
    has_group = torch.zeros_like(valid[:, 0])
    emits = []
    for i in range(order.shape[-1]):
        slot = order[:, i:i + 1]
        s = span.gather(1, slot)[:, 0]
        v = valid.gather(1, slot)[:, 0]
        ab = abnormal.gather(1, slot)[:, 0]
        slot = slot[:, 0]
        fits = has_group & (cum + s <= threshold)
        new_leader = torch.where(fits, leader, slot)
        new_cum = torch.where(fits, cum + s, s)
        emits.append(torch.where(v & ab, new_leader, slot))
        # Invalid slots pass through without touching the open group.
        cum = torch.where(v, torch.where(ab, new_cum, 0.0), cum)
        leader = torch.where(v, torch.where(ab, new_leader, leader), leader)
        has_group = torch.where(v, ab, has_group)
    return torch.zeros_like(order).scatter(1, order, torch.stack(emits, 1))


def _rank_by(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    k = torch.where(valid, key, float("inf"))
    ar = torch.arange(k.shape[-1], device=k.device)
    lt = (k[:, None, :] < k[:, :, None]) | (
        (k[:, None, :] == k[:, :, None]) & (ar[None, :] < ar[:, None])
    )
    return torch.sum(lt, dim=2).to(torch.int32)


def _median_tilt(coeffs, dom, valid_lab):
    mid = 0.5 * (dom[..., 0] + dom[..., 1])
    slope = polyval(polyder(coeffs), mid)
    med = nanmedian(torch.where(valid_lab, torch.abs(slope), float("nan")))
    return torch.atan(torch.where(torch.isnan(med), 0.0, med))


class GridState(NamedTuple):
    """The inputs of ``grid_stage``: the JAX detector's ``bridge_state``
    probe (the grey image feeds ``subpixel_refine``) plus what it leaves out
    (the bridge's warm labels, angles and counts, and the masks for the
    retention fence)."""

    cents: torch.Tensor
    inside: torch.Tensor
    bbox: torch.Tensor
    h_exp: torch.Tensor
    v_exp: torch.Tensor
    circle_radius0: torch.Tensor
    gray: torch.Tensor
    bright_blur: torch.Tensor
    warm_labels: torch.Tensor | None
    bridge_angles: torch.Tensor
    n_pre: torch.Tensor
    binary: torch.Tensor
    mh: torch.Tensor
    mv: torch.Tensor
    carve_domain: torch.Tensor


def _final_labels_xla(st: GridState, hv_masks: torch.Tensor, cfg: DetectConfig):
    """The XLA branch's final labels: a cold CC at cc_iters of the bridged
    pair, and (when it bridged) of the pre-bridge pair on the same canvas,
    whose count replaces the bridge's; one batch of 4 masks per view."""
    if cfg.bridge_repeats == 0:
        return _cc_xla(hv_masks, cfg.cc_iters), st.n_pre
    pre = torch.stack([st.mh, st.mv], 1)
    if cfg.label_downsample == 2:
        pre = _pool2_pad(pre)
    labels = _cc_xla(torch.cat([hv_masks, pre], 1), cfg.cc_iters)
    return labels[:, :2], _n_components(pre, labels[:, 2:])


def final_labels(st: GridState, cfg: DetectConfig):
    """Stage 6b: the final row/column labels of the bridged masks on the
    labeling canvas (half-res padded at ``label_downsample=2``, the masks'
    own (H, W) at 1).  Returns ((V, 2, h, w) masks, their labels, the
    pre-bridge component count)."""
    hv_masks = torch.stack([st.h_exp, st.v_exp], 1)
    if cfg.label_downsample == 2 and not cfg.bridge_half_res:
        # The full-res bridge's masks, labelled on the half-res canvas.
        hv_masks = _pool2_pad(hv_masks)
    if not cfg.use_pallas:
        return (hv_masks, *_final_labels_xla(st, hv_masks, cfg))
    # Warm start where the bridge's labels share the final canvas.
    warm = (cfg.cc_warm_start and st.warm_labels is not None
            and st.warm_labels.shape == hv_masks.shape)
    rounds = max(1, int(cfg.pallas_cc_rounds_warm)) if warm else max(1, int(cfg.pallas_cc_rounds))
    init = st.warm_labels if warm else None
    if cfg.pallas_cc_cross_cap > 0:
        # Two launches, as in the JAX package: the h masks' scan capped
        # along H, the v masks' along W.
        lab_pair = torch.stack([
            frontend.connected_components(
                hv_masks[:, i].to(torch.float32), rounds=rounds, pools_per_round=cfg.pallas_cc_pools,
                init_labels=None if init is None else init[:, i].contiguous(), cap_axis=i,
                cap=cfg.pallas_cc_cross_cap)
            for i in (0, 1)], 1)
    else:
        lab_pair = _cc_pairs(hv_masks, rounds=rounds, pools=cfg.pallas_cc_pools, init=init)
    return hv_masks, lab_pair, st.n_pre


def grid_stage(st: GridState, cfg: DetectConfig):
    """Stages 6b-6g: final CC -> assign -> polyfit (-> sub-pixel refinement)
    -> prune -> intersect -> relabel -> index.  Returns (DetectResult, (row/col coeffs + valid))."""
    v = st.cents.shape[0]
    ds = cfg.label_downsample
    hv_masks, lab_pair, n_pre = final_labels(st, cfg)
    labels_converged = _labels_converged(hv_masks, lab_pair)
    n_post = _n_components(hv_masks, lab_pair)
    bridged_components = torch.clamp(n_pre - n_post, min=0)

    if cfg.max_rows == cfg.max_cols:
        hs, ws = lab_pair.shape[-2:]
        of, okk = _assign_labels(
            lab_pair.reshape(2 * v, hs, ws),
            st.cents.repeat_interleave(2, dim=0),
            st.inside.repeat_interleave(2, dim=0),
            cfg.max_rows, scale=ds,
        )
        of, okk = of.reshape(v, 2, -1), okk.reshape(v, 2, -1)
        row_of, row_ok, col_of, col_ok = of[:, 0], okk[:, 0], of[:, 1], okk[:, 1]
    else:
        row_of, row_ok = _assign_labels(lab_pair[:, 0], st.cents, st.inside, cfg.max_rows, ds)
        col_of, col_ok = _assign_labels(lab_pair[:, 1], st.cents, st.inside, cfg.max_cols, ds)

    (row_coeffs, row_dom, row_valid, row_count), (col_coeffs, col_dom, col_valid, col_count) = (
        _fit_label_polys_pair(st.cents, row_of, row_ok, col_of, col_ok, cfg)
    )

    r, c = cfg.max_rows, cfg.max_cols
    dev = st.cents.device
    if cfg.merge_short_cols:
        # Fragments of one physical column that failed to bridge: merge runs
        # of short columns and refit the columns.
        span = torch.where(
            col_valid,
            (col_dom[..., 1] - col_dom[..., 0]) - 2.0 * cfg.domain_margin + 2.0 * cfg.merge_margin,
            0.0,
        )
        mean_x = _label_mean(st.cents[..., 0], col_of, col_ok, c)
        leader = _merge_short_column_leaders(span, mean_x, col_valid)
        col_of = leader.gather(1, col_of.to(torch.int64))
        col_coeffs, col_dom, col_valid, col_count = _fit_column_polys(
            st.cents, col_of, col_ok, cfg)
    if cfg.subpixel_refine:
        # Fitted curves moved to the grey-level centre of gravity.
        row_coeffs = refine_curves_cog(st.gray, row_coeffs, row_dom, row_valid, cfg.poly_degree,
                                       n_samples=cfg.subpixel_samples, window=cfg.subpixel_window,
                                       swap_xy=False)
        col_coeffs = refine_curves_cog(st.gray, col_coeffs, col_dom, col_valid, cfg.poly_degree,
                                       n_samples=cfg.subpixel_samples, window=cfg.subpixel_window,
                                       swap_xy=True)
    if cfg.drop_first_row:
        row_min_y = _label_min(st.cents[..., 1], row_of, row_ok, r)
        first = torch.argmin(torch.where(row_count >= 1, row_min_y, float("inf")), dim=-1)
        row_valid = row_valid & (torch.arange(r, device=dev) != first[:, None])
    if cfg.drop_last_col:
        col_min_y = _label_min(st.cents[..., 1], col_of, col_ok, c)
        last = torch.argmax(torch.where(col_count >= 1, col_min_y, float("-inf")), dim=-1)
        col_valid = col_valid & (torch.arange(c, device=dev) != last[:, None])

    x0 = 0.5 * (row_dom[..., 0] + row_dom[..., 1])
    xi, yi = poly_intersection(
        row_coeffs[:, :, None, :], col_coeffs[:, None, :, :],
        x0[:, :, None].expand(v, r, c), iters=cfg.newton_iters,
    )
    tol = cfg.intersection_tol
    bb = st.bbox.to(torch.float32)
    bx0, by0 = bb[:, 0, None, None], bb[:, 1, None, None]
    bx1 = bx0 + bb[:, 2, None, None]
    by1 = by0 + bb[:, 3, None, None]
    residual_ok = torch.abs(xi - polyval(col_coeffs[:, None, :, :], yi)) < 0.5
    accept = (
        row_valid[:, :, None] & col_valid[:, None, :]
        & (xi >= row_dom[:, :, None, 0] - tol) & (xi <= row_dom[:, :, None, 1] + tol)
        & (yi >= col_dom[:, None, :, 0] - tol) & (yi <= col_dom[:, None, :, 1] + tol)
        & (xi >= bx0) & (xi <= bx1) & (yi >= by0) & (yi <= by1)
        & residual_ok & torch.isfinite(xi) & torch.isfinite(yi)
    )

    any_row = torch.any(accept, dim=2)
    any_col = torch.any(accept, dim=1)
    mean_y = torch.sum(torch.where(accept, yi, 0.0), dim=2) / torch.clamp(
        torch.sum(accept, dim=2), min=1).to(torch.float32)
    mean_x = torch.sum(torch.where(accept, xi, 0.0), dim=1) / torch.clamp(
        torch.sum(accept, dim=1), min=1).to(torch.float32)
    row_rank = _rank_by(mean_y, any_row)
    col_rank = _rank_by(mean_x, any_col)

    # Brightness patch half-size from the saturation radius.
    if cfg.mode == "plane":
        half_b = torch.clamp(torch.floor(st.circle_radius0 / 4.5), min=1.0)[:, None]
    else:
        half_b = torch.clamp(torch.floor(st.circle_radius0 / 5.0), min=float(cfg.patch_half_min))
        half_b = torch.where(half_b > 10.0, half_b + 5.0, half_b)[:, None]
    h, w = st.bright_blur.shape[-2:]
    xf = xi.reshape(v, -1)
    yf = yi.reshape(v, -1)
    x0b = torch.clamp(torch.floor(xf - half_b), 0, w).to(torch.int32)
    x1b = torch.clamp(torch.floor(xf + half_b), 0, w).to(torch.int32)
    y0b = torch.clamp(torch.floor(yf - half_b), 0, h).to(torch.int32)
    y1b = torch.clamp(torch.floor(yf + half_b), 0, h).to(torch.int32)
    bvals = mxc.range_mean_at_points(st.bright_blur, y0b, y1b, x0b, x1b)
    bright = torch.where(accept.reshape(v, -1), bvals, float("-inf"))
    flat_ci = torch.argmax(bright, dim=-1)
    c_r = torch.div(flat_ci, c, rounding_mode="floor")
    c_c = flat_ci % c

    row_idx = row_rank - row_rank.gather(1, c_r[:, None])
    col_idx = col_rank - col_rank.gather(1, c_c[:, None])
    if cfg.drop_negative_cols:
        accept = accept & (col_idx[:, None, :] >= 0)
    ri = row_idx[:, :, None].expand(v, r, c)
    ci = col_idx[:, None, :].expand(v, r, c)
    ids = torch.stack([ri, ci] if cfg.id_row_major else [ci, ri], dim=-1)

    n = r * c
    xy_flat = torch.stack([xi, yi], dim=-1).reshape(v, n, 2)
    accept_flat = accept.reshape(v, n)
    center_ok = accept_flat.gather(1, flat_ci[:, None])[:, 0]
    center_xy = xy_flat.gather(1, flat_ci[:, None, None].expand(v, 1, 2))[:, 0]
    grid = GridPoints(
        xy=torch.where(accept_flat[..., None], xy_flat, 0.0),
        idx=ids.reshape(v, n, 2).to(torch.int32),
        valid=accept_flat,
        center=torch.where(center_ok[:, None], center_xy, 0.0),
    )
    ok = torch.sum(accept_flat, dim=-1) >= cfg.min_ok_points

    poly_tilt = torch.maximum(
        _median_tilt(row_coeffs, row_dom, row_valid),
        _median_tilt(col_coeffs, col_dom, col_valid),
    )
    base = _axis_bases(dev)
    dev_ang = torch.remainder(st.bridge_angles - base + _HALF_PI, math.pi) - _HALF_PI
    bridge_tilt = torch.amax(torch.abs(dev_ang), dim=-1)
    max_line_tilt = torch.maximum(poly_tilt, bridge_tilt)
    kept = torch.sum((st.mh | st.mv).reshape(v, -1), dim=-1).to(torch.float32)
    seen = torch.sum((st.binary & st.carve_domain).reshape(v, -1), dim=-1).to(torch.float32)
    retention = kept / torch.clamp(seen, min=1.0)
    stable = (
        labels_converged
        & (max_line_tilt <= cfg.max_stable_tilt)
        & (retention >= cfg.min_mask_retention)
    )
    result = DetectResult(
        grid=grid, ok=ok, roi_bbox=st.bbox, circle_radius0=st.circle_radius0,
        labels_converged=labels_converged, max_line_tilt=max_line_tilt,
        stable=stable, bridged_components=bridged_components,
    )
    return result, (row_coeffs, col_coeffs, row_valid, col_valid)


@torch.inference_mode()
def detect_grid(images: torch.Tensor, cfg: DetectConfig, return_debug: bool = False):
    """Grid detection on a (V, H, W) or (V, H, W, 3) batch of views ->
    DetectResult with a leading V axis (+ DetectDebug).  ``cfg.use_pallas``
    picks the branch: the kernel branch (True) or the XLA branch (False,
    the default), as in the JAX package.

    Spans (``utils.profiling``), each timed on the device on a card:
    ``detect.front`` (grey conversion and the front stage),
    ``detect.roi``, ``detect.bridge``, ``detect.grid``."""
    validate(cfg)
    kernels = cfg.use_pallas
    with profiling.span("detect.front", like=images):
        gray = _to_gray(images)
        front = front_stage(gray, cfg) if kernels else front_stage_xla(gray, cfg)
    with profiling.span("detect.roi", like=images):
        roi = roi_stage(front, cfg)
    with profiling.span("detect.bridge", like=images):
        bridge = bridge_stage if kernels else bridge_stage_xla
        br = bridge(roi.mh, roi.mv, roi.circle_radius0, cfg)
    with profiling.span("detect.grid", like=images):
        st = GridState(
            cents=front.cents, inside=roi.inside, bbox=roi.bbox, h_exp=br.h_exp, v_exp=br.v_exp,
            circle_radius0=roi.circle_radius0, gray=front.gray, bright_blur=front.bright_blur,
            warm_labels=br.warm_labels, bridge_angles=br.angles, n_pre=br.n_pre,
            binary=front.binary, mh=roi.mh, mv=roi.mv, carve_domain=roi.carve_domain,
        )
        result, (row_coeffs, col_coeffs, row_valid, col_valid) = grid_stage(st, cfg)
    if not return_debug:
        return result
    debug = DetectDebug(
        binary=front.binary, h_mask=roi.mh, v_mask=roi.mv, roi_mask=roi.roi,
        h_expanded=br.h_exp, v_expanded=br.v_exp, centroids=front.cents,
        centroids_valid=roi.inside, center_seed=roi.center, row_coeffs=row_coeffs,
        col_coeffs=col_coeffs, row_valid=row_valid, col_valid=col_valid,
    )
    return result, debug
