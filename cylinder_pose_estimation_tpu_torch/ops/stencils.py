"""The kernel branch's banded separable correlations: the composed-Gaussian
smoothing before the preprocess kernel (``smooth``) and the statistic
images after it (``stats_images``), each a tiled stencil on the card.

The JAX package writes both as dense products with banded matrices
(``ops/mxu_conv``; ``models/detector._smooth`` and ``_stats_images``).
Their plain versions here, ``smooth_plain`` and ``stats_images_plain``,
are that code: a CPU tensor runs them, and the XLA branch runs
``stats_images_plain`` on either device.  A CUDA tensor launches
``csrc/stencils.cu`` (one launch each) and raises if it cannot; nothing
falls back.  The kernels compute the same correlations over the bands'
taps alone: the same operand precision (float32 for the smoothing and the
centre box, bfloat16-rounded inputs, taps and intermediates elsewhere),
another summation order (see the source's notes), the centroid images
equal bit for bit.  Each wrapper call on the card counts
``stencil_smooth`` or ``stencil_stats`` (``kernels.launch_counts``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from cylinder_pose_estimation_tpu_torch.ops import kernels
from cylinder_pose_estimation_tpu_torch.ops import mxu_conv as mxc

# Output tiles of the two launches (csrc/stencils.cu kSmoothH x kSmoothW,
# kStatsTile x kStatsTile), and the widest band radius they take.
SMOOTH_TILE = (64, 128)
STATS_TILE = 64
MAX_RADIUS = 31
_OUT_PITCH = STATS_TILE | 1


@functools.lru_cache(maxsize=64)
def smooth_taps(blur_ksize: int = 5, ridge_sigma: float = 3.0) -> Tuple[float, ...]:
    """The smoothing's taps: the OpenCV Gaussian of ``blur_ksize`` composed
    with the scipy Gaussian of ``ridge_sigma``, rounded to float32 as the
    exact-mode band matrix holds them (29 taps at the defaults).  Raises
    ``ValueError`` past ``MAX_RADIUS``."""
    ct = mxc.compose_taps(mxc.gauss_taps_cv(blur_ksize), mxc.gauss_taps_scipy(ridge_sigma))
    if len(ct) > 2 * MAX_RADIUS + 1:
        raise ValueError(f"the composed smoothing has {len(ct)} taps, at most {2 * MAX_RADIUS + 1}")
    return tuple(torch.tensor(ct, dtype=torch.float32).tolist())


def _bf16_taps(taps) -> Tuple[float, ...]:
    """Taps as the default-mode band matrix holds them: float32, then
    bfloat16."""
    return tuple(torch.tensor(taps, dtype=torch.float32).to(torch.bfloat16).to(torch.float32).tolist())


@functools.lru_cache(maxsize=64)
def stats_taps(sat_blur_ksize: int = 19, index_blur_ksize: int = 7, center_patch_half: Optional[int] = None,
               joint_window: int = 11) -> Tuple[Tuple[int, int, int, int], Tuple[float, ...]]:
    """(radii, taps) of the statistic images: the radii of the saturation
    blur, the index blur, the centre box (-1: none, ``bright_at_points``)
    and the joint window; the taps packed in that order, then the joint
    box, as the kernel reads them (the blurs rounded to bfloat16).  Raises
    ``ValueError`` for an even band or a radius past ``MAX_RADIUS``."""
    bands = [_bf16_taps(mxc.gauss_taps_cv(sat_blur_ksize)), _bf16_taps(mxc.gauss_taps_cv(index_blur_ksize))]
    if center_patch_half is not None:
        bands.append(mxc.box_taps(2 * center_patch_half + 1))
    bands += [mxc.ramp_taps(joint_window), mxc.box_taps(joint_window)]
    for k in bands:
        if len(k) % 2 != 1 or len(k) > 2 * MAX_RADIUS + 1:
            raise ValueError(f"a band of {len(k)} taps: odd and at most {2 * MAX_RADIUS + 1}")
    radii = (len(bands[0]) // 2, len(bands[1]) // 2,
             -1 if center_patch_half is None else center_patch_half, joint_window // 2)
    return radii, tuple(float(t) for k in bands for t in k)


def _check_size(n: int, h: int, w: int) -> None:
    if n * h * w >= 2**31:
        raise ValueError(f"{n}x{h}x{w} pixels overflow the kernels' 32-bit plane index")


@functools.lru_cache(maxsize=64)
def smooth_plan(n: int, h: int, w: int, radius: int = 14) -> Dict[str, object]:
    """Launch plan of the smoothing: one launch over (image, tile row, tile
    column) blocks of ``SMOOTH_TILE`` outputs; each loads its grey tile
    with a halo of ``radius`` and keeps it and the pass along W in shared
    memory (csrc/stencils.cu ``LayoutS0``, which the bytes mirror: the
    kernel refuses other values).  Cached: treat the dict as read-only."""
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"smoothing radius {radius}: at most {MAX_RADIUS}")
    _check_size(n, h, w)
    th, tw = SMOOTH_TILE
    xh, xw = th + 2 * radius, tw + 2 * radius
    words = xh * (xw | 1) + xh * (tw | 1)
    plan = {"tile": (th, tw), "grid": (-(-w // tw), -(-h // th), n), "radius": radius, "smem": 4 * words}
    if plan["smem"] > kernels.MAX_DYNAMIC_SMEM:
        raise ValueError(f"smoothing: {plan['smem']} B of shared memory (max {kernels.MAX_DYNAMIC_SMEM})")
    return plan


@functools.lru_cache(maxsize=64)
def stats_plan(n: int, h: int, w: int, radii: Tuple[int, int, int, int] = (9, 3, -1, 5)) -> Dict[str, object]:
    """Launch plan of the statistic images: one launch over (tile column,
    tile row, plane) blocks of ``STATS_TILE`` squares, planes 0 .. N - 1
    the grey tiles and N .. 2N - 1 the joint tiles.  ``radii``: the
    saturation blur, the index blur, the centre box (-1: none) and the joint
    window.  The shared bytes are the larger of the two kinds' layouts
    (csrc/stencils.cu ``LayoutT``; the kernel refuses other values).
    Cached: treat the dict as read-only."""
    rs, ri, rb, rj = radii
    if not (0 <= rs <= MAX_RADIUS and 0 <= ri <= MAX_RADIUS and -1 <= rb <= MAX_RADIUS and 0 <= rj <= MAX_RADIUS):
        raise ValueError(f"statistic-image radii {radii}: each at most {MAX_RADIUS}")
    _check_size(n, h, w)
    if 2 * n > 65535:
        raise ValueError(f"{n} images: at most 32767 a launch")
    t = STATS_TILE
    halo = max(rs, ri, rb)
    gh = t + 2 * halo
    grey = gh * (gh | 1) + (t + 2 * rs) * _OUT_PITCH + (t + 2 * ri) * _OUT_PITCH
    if rb >= 0:
        grey += (t + 2 * rb) * _OUT_PITCH
    jh = t + 2 * rj
    joint = jh * (jh | 1) + jh * _OUT_PITCH + t * (jh | 1)
    plan = {"tile": t, "grid": (-(-w // t), -(-h // t), 2 * n), "radii": tuple(radii), "halo": (halo, rj),
            "smem": 4 * max(grey, joint)}
    if plan["smem"] > kernels.MAX_DYNAMIC_SMEM:
        raise ValueError(f"statistic images: {plan['smem']} B of shared memory (max {kernels.MAX_DYNAMIC_SMEM})")
    return plan


def smooth_plain(gray: torch.Tensor, blur_ksize: int = 5, ridge_sigma: float = 3.0) -> torch.Tensor:
    """Composed Gaussian(blur_ksize) o Gaussian(ridge_sigma) of (..., H, W)
    grey images by exact-mode banded matmuls along W, then H."""
    h, w = gray.shape[-2:]
    ct = mxc.compose_taps(mxc.gauss_taps_cv(blur_ksize), mxc.gauss_taps_scipy(ridge_sigma))
    kin = mxc.conv_x(gray, mxc.x_mat(ct, w, gray.device, exact=True), exact=True)
    kin = mxc.conv_x(kin.transpose(-1, -2), mxc.x_mat(ct, h, gray.device, exact=True), exact=True)
    return kin.transpose(-1, -2).contiguous()


def smooth(gray: torch.Tensor, blur_ksize: int = 5, ridge_sigma: float = 3.0) -> torch.Tensor:
    """``smooth_plain`` of (N, H, W) float32 grey images: on the card one
    launch (``smooth_plan``) into a new plane, zero padded, counted as
    ``stencil_smooth``."""
    if not kernels.route(gray):
        return smooth_plain(gray, blur_ksize, ridge_sigma)
    kernels.check("gray", gray, torch.float32, 3)
    taps = smooth_taps(blur_ksize, ridge_sigma)
    n, h, w = gray.shape
    plan = smooth_plan(n, h, w, len(taps) // 2)
    out = torch.empty_like(gray)
    # The taps stay on the host: the C entry copies them into the launch's
    # parameters (nothing to copy to the device, so a capture stays clean).
    host_taps = torch.tensor(taps, dtype=torch.float32)
    kernels.launch("cpe_stencil_smooth", [gray, out, host_taps], [n, h, w, plan["radius"], *plan["tile"], plan["smem"]],
                   [])
    kernels.count("stencil_smooth")
    return out


def stats_images_plain(gray, joints_f, cnt, sat_blur_ksize: int = 19, sat_threshold: float = 240.0,
                       margin: int = 0, index_blur_ksize: int = 7, center_patch_half: Optional[int] = None,
                       joint_window: int = 11):
    """Saturation mask, centre-seed brightness image (``center_patch_half``
    given, else None), index-brightness image and joint box centroids of
    (V, H, W) images (bf16-operand banded matmuls, as the reference; the
    centre-seed brightness in exact mode: it feeds an argmax over near-ties).
    ``margin``: the border band where the saturation mask is False."""
    h, w = gray.shape[-2:]
    dev = gray.device
    rr = torch.arange(h, device=dev)[:, None]
    cc = torch.arange(w, device=dev)[None, :]
    inside = (rr >= margin) & (rr < h - margin) & (cc >= margin) & (cc < w - margin)

    gt = mxc.gauss_taps_cv(sat_blur_ksize)
    sat = mxc.conv_y(mxc.conv_x(gray, mxc.x_mat(gt, w, dev)), mxc.y_mat(gt, h, dev))
    sat_mask = (sat > sat_threshold) & inside

    bright_center = None
    if center_patch_half is not None:
        pc = 2 * center_patch_half + 1
        bt = mxc.box_taps(pc)
        bc = mxc.conv_y(mxc.conv_x(gray, mxc.x_mat(bt, w, dev, exact=True), exact=True),
                        mxc.y_mat(bt, h, dev, exact=True), exact=True)
        bright_center = bc / float(pc * pc)

    gk = mxc.gauss_taps_cv(index_blur_ksize)
    bright_blur = mxc.conv_y(mxc.conv_x(gray, mxc.x_mat(gk, w, dev)), mxc.y_mat(gk, h, dev))

    jb = mxc.box_taps(joint_window)
    jr = mxc.ramp_taps(joint_window)
    tx = mxc.conv_x(joints_f, mxc.x_mat(jr, w, dev))
    ty = mxc.conv_y(joints_f, mxc.y_mat(jr, h, dev))
    sx = cc.to(torch.float32) * cnt + mxc.conv_y(tx, mxc.y_mat(jb, h, dev))
    sy = rr.to(torch.float32) * cnt + mxc.conv_x(ty, mxc.x_mat(jb, w, dev))
    c = torch.clamp(cnt, min=1.0)
    return sat_mask, bright_center, bright_blur, torch.floor(sx / c), torch.floor(sy / c)


def stats_images(gray, joints_f, cnt, sat_blur_ksize: int = 19, sat_threshold: float = 240.0,
                 margin: int = 0, index_blur_ksize: int = 7, center_patch_half: Optional[int] = None,
                 joint_window: int = 11, sat_out: Optional[torch.Tensor] = None):
    """``stats_images_plain`` of (N, H, W) float32 gray, joints and joint
    counts: on the card one launch (``stats_plan``), counted as
    ``stencil_stats``.  ``sat_out`` (card only, for checks; the detector
    never passes it): an (N, H, W) float32 tensor that receives the
    saturation blur before its threshold, which the card tests and
    chip_smoke hold to the matmuls' blur within the bf16 pair's bound."""
    if not kernels.route(gray):
        if sat_out is not None:
            raise ValueError("sat_out: the card's route only")
        return stats_images_plain(gray, joints_f, cnt, sat_blur_ksize, sat_threshold, margin, index_blur_ksize,
                                  center_patch_half, joint_window)
    for name, t in (("gray", gray), ("joints_f", joints_f), ("cnt", cnt)):
        kernels.check(name, t, torch.float32, 3)
    if joints_f.shape != gray.shape or cnt.shape != gray.shape:
        raise ValueError(f"gray, joints_f and cnt differ in shape: {tuple(gray.shape)}, "
                         f"{tuple(joints_f.shape)}, {tuple(cnt.shape)}")
    if sat_out is not None:
        kernels.check("sat_out", sat_out, torch.float32, 3)
        if sat_out.shape != gray.shape:
            raise ValueError("sat_out: the images' shape")
    radii, taps = stats_taps(sat_blur_ksize, index_blur_ksize, center_patch_half, joint_window)
    n, h, w = gray.shape
    plan = stats_plan(n, h, w, radii)
    with_center = center_patch_half is not None
    planes = torch.empty((3 + int(with_center),) + gray.shape, dtype=torch.float32, device=gray.device).unbind(0)
    bright_blur, cx, cy = planes[:3]
    bright_center = planes[3] if with_center else None
    sat_mask = torch.empty(gray.shape, dtype=torch.bool, device=gray.device)
    host_taps = torch.tensor(taps, dtype=torch.float32)
    kernels.launch(
        "cpe_stencil_stats",
        [gray, joints_f, cnt, sat_mask, bright_blur, bright_center, cx, cy, sat_out, host_taps],
        [n, h, w, *radii, margin, plan["tile"], plan["smem"]],
        [sat_threshold],
    )
    kernels.count("stencil_stats")
    return sat_mask, bright_center, bright_blur, cx, cy


__all__ = [
    "SMOOTH_TILE", "STATS_TILE", "MAX_RADIUS", "smooth_taps", "stats_taps", "smooth_plan", "stats_plan",
    "smooth", "smooth_plain", "stats_images", "stats_images_plain",
]
