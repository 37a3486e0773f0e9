"""Hessian ridge detection and Sauvola binarisation of the XLA detection
branch (port of the JAX package's ops/ridge.py; replaces the reference's
preprocess/binarize stage, ref utils/util_cylinder.py:1734-1802).

Plain PyTorch on (..., H, W) batches, on the CPU and on the card alike: the
JAX package computes this branch outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.image import box_filter, fma32, gaussian_blur_scipy, gradient2d


def hessian_eigenimages(img: torch.Tensor, sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(maxima, minima) Hessian eigenvalue images, skimage-compatible: the
    gradient applied twice to the Gaussian-smoothed image (reflect padding,
    as the JAX package: no ridge ring along the border)."""
    g = gaussian_blur_scipy(img, sigma, mode="reflect101")
    gr, gc = gradient2d(g)
    hrr, hrc = gradient2d(gr)
    _, hcc = gradient2d(gc)
    # linalg.eigh2x2's eigenvalues, with the multiply-add that XLA's CPU
    # backend fuses there (hrc^2 + half_diff^2) fused here too.
    half_tr = 0.5 * (hrr + hcc)
    half_diff = 0.5 * (hrr - hcc)
    root = torch.sqrt(fma32(hrc, hrc, half_diff * half_diff))
    return half_tr + root, half_tr - root


def sauvola_threshold(img: torch.Tensor, window: int = 15, k: float = 0.5, r: float = 128.0) -> torch.Tensor:
    """Sauvola threshold surface from box-filter mean and variance
    (BORDER_REPLICATE), T = m (1 + k (s / R - 1))."""
    mean = box_filter(img, window, mode="edge")
    mean_sq = box_filter(img * img, window, mode="edge")
    var = torch.clamp(fma32(-mean, mean, mean_sq), min=0.0)  # fused, as XLA's CPU backend
    std = torch.sqrt(var)
    return mean * (1.0 + k * (std / r - 1.0))


def binarize_ridges(gray_blurred: torch.Tensor, ridge_sigma: float = 3.0, window: int = 15,
                    k: float = 0.5, r: float = 128.0, min_contrast: float = 0.0) -> torch.Tensor:
    """Ridge minima -> Sauvola -> inverted binary: True on laser lines.
    ``min_contrast`` > 0 also requires minima < -min_contrast (flat regions
    otherwise tie-break to True)."""
    _, minima = hessian_eigenimages(gray_blurred, ridge_sigma)
    t = sauvola_threshold(minima, window, k, r)
    binary = ~(minima > t)
    if min_contrast > 0.0:
        binary = binary & (minima < -min_contrast)
    return binary
