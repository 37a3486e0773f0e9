"""Stereo grid-index correspondence and patch-consensus selection (port of the
JAX package's geometry/correspond.py) over a leading frame axis.

Both views are rasterised into a dense (G, G) grid-index raster; the
reference's sliding-patch consensus reduces to box sums over that raster (see
the JAX module's docstring for the derivation).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from cylinder_pose_estimation_tpu_torch.geometry.triangulate import triangulate
from cylinder_pose_estimation_tpu_torch.types import Correspondences, GridPoints, StereoParams


def _rasterize(gp: GridPoints, offset: torch.Tensor, extent: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, G, G, 2) coord raster + (F, G, G) occupancy of (F, P) grid points."""
    cell = gp.idx - offset[..., None, :]
    inside = gp.valid & torch.all(cell >= 0, dim=-1) & torch.all(cell < extent, dim=-1)
    ar = torch.arange(extent, dtype=cell.dtype, device=cell.device)
    dt = gp.xy.dtype
    rowhot = (inside[..., None] & (cell[..., 0:1] == ar)).to(dt)  # (F, P, G)
    colhot = (inside[..., None] & (cell[..., 1:2] == ar)).to(dt)
    payload = torch.cat([gp.xy, torch.ones_like(gp.xy[..., :1])], dim=-1)
    payload = torch.where(inside[..., None], payload, 0.0)
    b = (colhot[..., :, None] * payload[..., None, :]).reshape(
        gp.xy.shape[:-1] + (extent * 3,)
    )
    sums = torch.matmul(rowhot.transpose(-1, -2), b).reshape(
        gp.xy.shape[:-2] + (extent, extent, 3)
    )
    cnt = sums[..., 2]
    coords = sums[..., :2] / torch.clamp(cnt, min=1.0)[..., None]
    return coords, cnt > 0.5


def _box_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """'Valid' size x size box sum of (..., G, G) via a 2-D cumsum."""
    c = torch.cumsum(torch.cumsum(x, dim=-2), dim=-1)
    c = F.pad(c, (1, 0, 1, 0))
    n = x.shape[-1] - size + 1
    return (
        c[..., size:size + n, size:size + n]
        - c[..., 0:n, size:size + n]
        - c[..., size:size + n, 0:n]
        + c[..., 0:n, 0:n]
    )


def _anchor_max(patch_ok: torch.Tensor, size: int, extent: int) -> torch.Tensor:
    p = size - 1
    padded = F.pad(patch_ok.to(torch.float32), (p, p, p, p))
    out = torch.zeros(patch_ok.shape[:-2] + (extent, extent), dtype=torch.float32,
                      device=patch_ok.device)
    for di in range(size):
        for dj in range(size):
            out = torch.maximum(out, padded[..., di:di + extent, dj:dj + extent])
    return out > 0


def _common_offset(gp1: GridPoints, gp2: GridPoints) -> torch.Tensor:
    big = torch.iinfo(torch.int32).max

    def mn(gp):
        return torch.amin(torch.where(gp.valid[..., None], gp.idx, big), dim=-2)

    return torch.minimum(mn(gp1), mn(gp2)).to(torch.int32)


def _raster_idx(offset: torch.Tensor, extent: int) -> torch.Tensor:
    ix = torch.arange(extent, dtype=torch.int32, device=offset.device)
    gi, gj = torch.meshgrid(ix, ix, indexing="ij")
    idx = torch.stack([gi, gj], dim=-1) + offset[..., None, None, :]
    return idx.reshape(offset.shape[:-1] + (extent * extent, 2))


def find_grid_correspondences(gp1: GridPoints, gp2: GridPoints, extent: int = 32) -> Correspondences:
    """Exact grid-index matching in raster layout (M = extent^2 rows)."""
    offset = _common_offset(gp1, gp2)
    c1, o1 = _rasterize(gp1, offset, extent)
    c2, o2 = _rasterize(gp2, offset, extent)
    lead = offset.shape[:-1]
    return Correspondences(
        xy1=c1.reshape(lead + (-1, 2)),
        xy2=c2.reshape(lead + (-1, 2)),
        idx=_raster_idx(offset, extent),
        valid=(o1 & o2).reshape(lead + (-1,)),
        used_fallback=torch.zeros(lead, dtype=torch.bool, device=offset.device),
    )


def _permute_rows_cols(x: torch.Tensor, perm_r: torch.Tensor, perm_c: torch.Tensor) -> torch.Tensor:
    """x[..., perm_r[i], perm_c[j]] for (..., G, G) x and (..., G) perms."""
    g = x.shape[-1]
    x = x.gather(-2, perm_r[..., :, None].expand(x.shape))
    return x.gather(-1, perm_c[..., None, :].expand(x.shape[:-2] + (g, g)))


def choose_idx(
    gp1: GridPoints,
    gp2: GridPoints,
    stereo: StereoParams,
    patch_size: int = 3,
    error_threshold: float = 0.3,
    extent: int = 32,
) -> Correspondences:
    """Patch-consensus correspondence selection over (F, P) grid points."""
    offset = _common_offset(gp1, gp2)
    c1, o1 = _rasterize(gp1, offset, extent)
    c2, o2 = _rasterize(gp2, offset, extent)
    both = o1 & o2
    lead = offset.shape[:-1]
    tri = triangulate(
        c1.reshape(lead + (-1, 2)), c2.reshape(lead + (-1, 2)), stereo,
        valid=both.reshape(lead + (-1,)),
    )
    err = tri.reproj_error.reshape(both.shape)
    vall = tri.valid.reshape(both.shape)
    err = torch.where(both & vall, err, torch.where(both, 1e6, 0.0))

    row_present = torch.any(o1, dim=-1)
    col_present = torch.any(o1, dim=-2)
    perm_r = torch.argsort((~row_present).to(torch.int32), dim=-1, stable=True)
    perm_c = torch.argsort((~col_present).to(torch.int32), dim=-1, stable=True)
    both_c = _permute_rows_cols(both, perm_r, perm_c)
    err_c = _permute_rows_cols(err, perm_r, perm_c)

    occ_count = _box_sum(both_c.to(torch.float32), patch_size)
    err_sum = _box_sum(err_c, patch_size)
    full = occ_count >= patch_size * patch_size - 0.5
    mean_err = err_sum / (patch_size * patch_size)
    patch_ok = full & (mean_err < error_threshold)
    selected_c = _anchor_max(patch_ok, patch_size, extent) & both_c

    ar = torch.arange(extent, device=perm_r.device)
    p_r = (perm_r[..., :, None] == ar).to(torch.float32)
    p_c = (perm_c[..., :, None] == ar).to(torch.float32)
    selected = (
        torch.matmul(torch.matmul(p_r.transpose(-1, -2), selected_c.to(torch.float32)), p_c)
        > 0.5
    ) & both
    any_selected = torch.any(selected.reshape(lead + (-1,)), dim=-1)
    final = torch.where(any_selected[..., None, None], selected, both)
    return Correspondences(
        xy1=c1.reshape(lead + (-1, 2)),
        xy2=c2.reshape(lead + (-1, 2)),
        idx=_raster_idx(offset, extent),
        valid=final.reshape(lead + (-1,)),
        used_fallback=~any_selected,
    )
