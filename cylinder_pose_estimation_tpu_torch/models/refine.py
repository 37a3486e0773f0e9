"""Sub-pixel curve refinement and the plane path's outlier-label removal
(port of the JAX package's models/refine.py).

* ``refine_curves_cog``: sample each fitted row/column polynomial at fixed
  steps, move every sample to the grey-level centre of gravity of a strip
  perpendicular to the curve, and refit.  ``subpixel_refine=True`` runs it
  inside ``detector.grid_stage``.
* ``remove_first_last_labels`` and ``interval_anomaly_mask``: library
  functions over label slots (the JAX package has no caller for them).

Where the JAX code ``vmap``s over labels (and the detector over views),
every function here takes leading batch axes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cylinder_pose_estimation_tpu_torch.ops.image import fma32
from cylinder_pose_estimation_tpu_torch.ops.polyfit import masked_polyfit, polyval


def _unit_linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: i * f32(1 / (n - 1)) (XLA turns
    the division by a constant into a product by its reciprocal), with the
    end point exactly 1."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.tensor(1.0, dtype=torch.float32) / float(n - 1)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * step.to(device)
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def _bilinear_per_view(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``ops.image.bilinear_sample`` of (V, H, W) images at (V, ...)
    coordinates of their own: view v samples image v."""
    v, h, w = img.shape
    shape = x.shape
    x = torch.clamp(x, 0.0, w - 1.0).reshape(v, -1)
    y = torch.clamp(y, 0.0, h - 1.0).reshape(v, -1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(v, h * w)

    def at(yy, xx):
        return flat.gather(1, yy * w + xx)

    out = (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x0 + 1) * fx * (1 - fy)
        + at(y0 + 1, x0) * (1 - fx) * fy
        + at(y0 + 1, x0 + 1) * fx * fy
    )
    return out.reshape(shape)


def refine_curves_cog(
    gray: torch.Tensor,
    coeffs: torch.Tensor,
    domain: torch.Tensor,
    valid: torch.Tensor,
    degree: int,
    n_samples: int = 64,
    window: int = 7,
    max_shift: float = 0.5,
    swap_xy: bool = False,
) -> torch.Tensor:
    """Refine per-label polynomials to the grey-level centre of gravity.

    gray: (V, H, W); coeffs: (V, L, D+1) polynomials y = f(x) (x = g(y)
    with ``swap_xy``); domain: (V, L, 2); valid: (V, L).  Returns the
    refined coefficients, invalid labels passed through.  The centre of
    gravity runs over a +-window strip perpendicular to the curve, sampled
    bilinearly, and each shift is clamped to +-max_shift * window."""
    h, w = gray.shape[-2:]
    g = gray.to(torch.float32)
    dev = g.device
    t = _unit_linspace(n_samples, dev)
    lo, hi = domain[..., 0:1], domain[..., 1:2]
    # lo + t * (hi - lo) with one rounding, as XLA contracts it.
    xs = fma32(t, hi - lo, lo)                                 # (V, L, S)
    ys = polyval(coeffs[..., None, :], xs)
    offs = torch.arange(-window, window + 1, dtype=torch.float32, device=dev)
    across = ys[..., None] + offs                              # (V, L, S, K)
    along = xs[..., None].expand(across.shape)
    sx, sy = (across, along) if swap_xy else (along, across)
    vals = _bilinear_per_view(g, sx, sy)
    wsum = torch.sum(vals, dim=-1)
    cog = torch.sum(vals * offs, dim=-1) / torch.clamp(wsum, min=1e-6)
    cog = torch.clamp(cog, -max_shift * window, max_shift * window)
    ys_new = ys + cog
    # Only samples whose curve point lies inside the image enter the refit.
    img_x, img_y = (ys, xs) if swap_xy else (xs, ys)
    inside = (img_x >= 0) & (img_x < w) & (img_y >= 0) & (img_y < h)
    # The refit's normal equations in float64, rounded once: float32 sums
    # leave ~6 ulp of the intercept to their order (the JAX package's own
    # float32 refit is within ~2 ulp of the exact one).
    c_new = masked_polyfit(xs.double(), ys_new.double(), inside.double(), degree).to(coeffs.dtype)
    return torch.where(valid[..., None], c_new, coeffs)


def remove_first_last_labels(
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
    row_rank: torch.Tensor,
    col_rank: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop the first and last row and column by rank over the last axis
    (ref utils/util_plane.py:1789-1858)."""
    n_rows = torch.sum(row_valid, dim=-1, keepdim=True)
    n_cols = torch.sum(col_valid, dim=-1, keepdim=True)
    rv = row_valid & (row_rank != 0) & (row_rank != n_rows - 1)
    cv = col_valid & (col_rank != 0) & (col_rank != n_cols - 1)
    return rv, cv


def interval_anomaly_mask(
    means: torch.Tensor,
    valid: torch.Tensor,
    rel_tolerance: float = 0.45,
) -> torch.Tensor:
    """Interval-based anomaly gate over sorted label positions, (..., L)
    (ref utils/util_plane.py:1861-2042): each consecutive gap is compared
    with the median gap, and a label is dropped when both of its gaps
    deviate by more than ``rel_tolerance`` (its one gap, at either end)."""
    from cylinder_pose_estimation_tpu_torch.models.detector import nanmedian

    n_lab = means.shape[-1]
    key = torch.where(valid, means, torch.finfo(means.dtype).max)
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_means = key.gather(-1, order)
    n = torch.sum(valid, dim=-1, keepdim=True)
    idx = torch.arange(n_lab, device=means.device)
    gaps = sorted_means[..., 1:] - sorted_means[..., :-1]
    gap_valid = idx[1:] < n
    med = nanmedian(torch.where(gap_valid, gaps, float("nan")))
    med = torch.where(torch.isnan(med), 1.0, med)[..., None]
    bad_gap = gap_valid & (torch.abs(gaps - med) > rel_tolerance * torch.abs(med))
    # gaps[i] lies between ranks i and i + 1.
    none = torch.zeros_like(bad_gap[..., :1])
    bad_below = torch.cat([none, bad_gap], dim=-1)
    bad_above = torch.cat([bad_gap, none], dim=-1)
    bad_sorted = torch.where(idx == 0, bad_above,
                             torch.where(idx == n - 1, bad_below, bad_below & bad_above))
    keep_sorted = ~bad_sorted & (idx < n)
    keep = torch.zeros_like(valid).scatter(-1, order, keep_sorted)
    return valid & keep
