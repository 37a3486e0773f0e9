"""Contrast-limited adaptive histogram equalisation (CLAHE) and the stereo
preprocessing built on it (port of the JAX package's ops/clahe.py; replaces
MATLAB adapthisteq in ref utils/preProcessing.m:17-18).

Every function takes a leading batch of images.  The per-tile 256-bin
histograms are integer counts (one ``scatter_add_`` over int64), exact like
the JAX package's ``segment_sum`` of ones, and become float32 only for the
16 fixed clip rounds, the cumulative sum, the LUT and the bilinear blend of
the four surrounding tile LUTs, which follow the JAX code step by step.

The cumulative sum runs in a fixed order of float32 additions
(``ops.image.cumsum_blocked``), not ``torch.cumsum``: that accumulates in float64 on
the CPU and in a parallel order on the GPU, so the LUTs would differ in the
last bits between the two devices and from the JAX package, and a detector
threshold downstream can turn such a bit into a moved grid point.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.ops.image import bgr_to_gray, cumsum_blocked, div_exact
from cylinder_pose_estimation_tpu_torch.ops.remap import undistort_image


def _clip_limit(tile_px: int, clip_limit: float, n_bins: int, clip_is_normalized: bool) -> float:
    """The per-bin count limit, in float32 arithmetic as the JAX code
    computes it."""
    if clip_is_normalized:
        # MATLAB adapthisteq: minClip + round(norm * (tilePx - minClip)),
        # minClip = ceil(tilePx / nBins).
        min_clip = np.float32(math.ceil(tile_px / n_bins))
        return float(min_clip + np.round(np.float32(clip_limit) * (np.float32(tile_px) - min_clip)))
    return float(np.float32(max(1.0, clip_limit * tile_px / n_bins)))


def clahe(
    img: torch.Tensor,
    tiles: int = 8,
    clip_limit: float = 0.01,
    n_bins: int = 256,
    clip_is_normalized: bool = True,
) -> torch.Tensor:
    """CLAHE of (..., H, W) images with values in [0, 255].

    ``clip_is_normalized=True`` reads clip_limit as MATLAB adapthisteq does
    (fraction of the tile's pixels per bin); False as cv2 does (multiplier on
    the uniform bin height).  H and W must be multiples of ``tiles``."""
    h, w = img.shape[-2:]
    if h % tiles or w % tiles:
        raise ValueError(f"image {h}x{w} is not a multiple of {tiles} tiles; pad it first")
    lead = img.shape[:-2]
    dev = img.device
    th, tw = h // tiles, w // tiles
    tile_px = th * tw

    x = torch.clamp(img.reshape(-1, h, w).to(torch.float32), 0.0, 255.0)
    b = x.shape[0]
    bins = torch.clamp((x * (n_bins / 256.0)).to(torch.int64), 0, n_bins - 1)

    ty = torch.arange(h, device=dev) // th
    tx = torch.arange(w, device=dev) // tw
    tile_id = ty[:, None] * tiles + tx[None, :]
    image_id = torch.arange(b, device=dev)[:, None, None] * (tiles * tiles)
    seg = ((image_id + tile_id) * n_bins + bins).reshape(-1)
    counts = torch.zeros(b * tiles * tiles * n_bins, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, seg, torch.ones_like(seg))
    hist = counts.to(torch.float32).reshape(b, tiles * tiles, n_bins)

    limit = _clip_limit(tile_px, clip_limit, n_bins, clip_is_normalized)
    # Iterative excess redistribution: 16 fixed rounds (mass preserved each
    # round; the regenerated excess shrinks geometrically).
    for _ in range(16):
        excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1, keepdim=True)
        hist = torch.clamp(hist, max=limit) + excess / n_bins

    cdf = cumsum_blocked(hist)
    # Full-range 'uniform' mapping: 255 * cdf / tilePx.
    lut = torch.clamp(div_exact(255.0 * cdf, tile_px), max=255.0).reshape(b, tiles, tiles, n_bins)

    # Bilinear blend of the four surrounding tile LUTs.
    fy = div_exact(torch.arange(h, dtype=torch.float32, device=dev) + 0.5, th) - 0.5
    fx = div_exact(torch.arange(w, dtype=torch.float32, device=dev) + 0.5, tw) - 0.5
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, tiles - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, tiles - 1)
    y1 = torch.clamp(y0 + 1, 0, tiles - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(fx - x0, 0.0, 1.0)[None, :]

    bi = torch.arange(b, device=dev)[:, None, None]
    y0g, y1g = y0[:, None], y1[:, None]
    x0g, x1g = x0[None, :], x1[None, :]
    v00 = lut[bi, y0g, x0g, bins]
    v01 = lut[bi, y0g, x1g, bins]
    v10 = lut[bi, y1g, x0g, bins]
    v11 = lut[bi, y1g, x1g, bins]
    out = (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )
    return out.reshape(lead + (h, w))


def preprocess_stereo(
    img1: torch.Tensor,
    img2: torch.Tensor,
    cam1,
    cam2,
    tiles: int = 8,
    clip_limit: float = 0.01,
    interp: str = "cubic",
):
    """Stereo preprocessing (ref utils/preProcessing.m:1-22) of (F, H, W) grey
    or (F, H, W, 3) BGR frame batches: to grey, undistort each view with its
    camera, adaptive histogram equalisation.  ``interp`` defaults to 'cubic',
    the MATLAB experiment path's undistortImage(..., 'cubic')."""

    def one(img, cam):
        g = bgr_to_gray(img.to(torch.float32)) if img.dim() == 4 else img
        g = undistort_image(g, cam, interp=interp)
        return clahe(g, tiles=tiles, clip_limit=clip_limit)

    return one(img1, cam1), one(img2, cam2)
