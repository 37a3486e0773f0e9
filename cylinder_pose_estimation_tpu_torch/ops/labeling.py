"""Connected components of the XLA detection branch, and the component
bookkeeping on min-linear-index label images (the JAX package's
ops/labeling.py).

``connected_components`` runs ``connected_components_plain`` on CPU tensors
and launches its hand-written CUDA kernel (``csrc/scan_cc.cu``) on CUDA
tensors, bit for bit the plain version there.

The JAX code enumerates roots and reduces per-component sums with one-hot
matrix products, the TPU's fast form.  Here the same quantities come from
cumsum ranks, lookup tables and ``scatter_add``: integer results are exact,
and the coordinate moment sums accumulate in float64 (exact for integer
coordinates, then rounded once to float32), so they are deterministic where
float32 atomics would not be.  All functions take a leading batch axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cylinder_pose_estimation_tpu_torch.ops import kernels
from cylinder_pose_estimation_tpu_torch.ops.image import cumsum_blocked, fma32

# Warps of a block of the CUDA CC's launches (``csrc/scan_cc.cu``), and the
# strip widths its column launch may take, widest first.
SCAN_CC_WARPS = 8
SCAN_CC_STRIPS = (32, 16, 8, 4, 2, 1)


def _seg_min_scan(v: torch.Tensor, mask: torch.Tensor, bg: int) -> torch.Tensor:
    """Forward segmented min-scan along the last axis: each in-mask pixel
    gets the minimum of its in-mask run up to itself.  Exact and free of
    atomics: with k the run's index along the line (a prefix count of run
    starts), the running maximum of k (bg + 1) + (bg - v) stays inside the
    current run and holds its smallest v so far (values lie in [0, bg])."""
    start = mask.clone()
    start[..., 1:] &= ~mask[..., :-1]
    run = torch.cumsum(start, dim=-1) * (bg + 1)
    key = run + (bg - v.to(torch.int64))
    return bg - (torch.cummax(key, dim=-1).values - run)


def _run_min_rows(lab: torch.Tensor, mask: torch.Tensor, bg: int) -> torch.Tensor:
    """Each in-mask pixel of (B, H, W) takes the minimum over its contiguous
    in-mask run of the row: the JAX package's forward and backward
    segmented min-scans."""
    fwd = _seg_min_scan(lab, mask, bg)
    bwd = _seg_min_scan(lab.flip(-1), mask.flip(-1), bg).flip(-1)
    return torch.where(mask, torch.minimum(fwd, bwd).to(lab.dtype), lab)


def connected_components_plain(mask: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """8-connected labels of (B, H, W) bool masks, the XLA branch's
    segmented-scan CC: background H*W, each in-mask pixel the minimum linear
    index of its component after exactly ``iters`` rounds (unconverged when
    they run out).  A round: a masked 3x3 min-pool (float32, exact below
    2^24, as the JAX code), then run minima along rows, then along columns.
    No border ring, unlike the kernel branch's CC."""
    _, h, w = mask.shape
    hw = h * w
    idx = torch.arange(hw, dtype=torch.int32, device=mask.device).reshape(h, w)
    lab = torch.where(mask, idx, hw)
    mask_t = mask.transpose(-1, -2).contiguous()
    for _ in range(iters):
        labf = torch.where(mask, lab, hw).to(torch.float32)
        pooled = -F.max_pool2d(-labf[:, None], 3, stride=1, padding=1)[:, 0]
        lab = torch.where(mask, torch.minimum(lab, pooled.to(torch.int32)), hw)
        lab = torch.where(mask, _run_min_rows(lab, mask, hw), hw)
        lab_t = _run_min_rows(lab.transpose(-1, -2).contiguous(), mask_t, hw)
        lab = torch.where(mask, lab_t.transpose(-1, -2), hw)
    return lab.to(torch.int32)


def scan_cc_plan(n: int, h: int, w: int) -> dict:
    """The CUDA CC's launch plan for n (h, w) masks: ``seg``, the pixels of
    a row each lane of the row launch holds (odd); ``strip``, the columns a
    block of the column launch holds (the widest of ``SCAN_CC_STRIPS`` whose
    h rows, padded by one, and the segments' summaries fit a quarter of
    ``kernels.MAX_DYNAMIC_SMEM``, so that several blocks share an SM); and
    the two launches' shared bytes.  Raises ValueError for what the kernel
    does not take."""
    if h * w >= 1 << 24:
        raise ValueError(f"connected_components: {h}x{w} masks, labels must stay below 2^24")
    if n > 65535:
        raise ValueError(f"connected_components: {n} masks in one call (at most 65535)")
    seg = -(-w // 32) | 1
    row_smem = SCAN_CC_WARPS * 32 * seg * 4
    if row_smem > kernels.MAX_DYNAMIC_SMEM:
        raise ValueError(f"connected_components: rows of {w} pixels pass shared memory")
    for strip in SCAN_CC_STRIPS:
        col_smem = (h * (strip + 1) + 3 * 32 * SCAN_CC_WARPS) * 4
        if col_smem <= kernels.MAX_DYNAMIC_SMEM // 4:
            return {"seg": seg, "strip": strip, "row_smem": row_smem, "col_smem": col_smem}
    raise ValueError(f"connected_components: columns of {h} pixels pass shared memory")


def scan_cc_launches(iters: int) -> int:
    """Device kernels of one CUDA CC call: two a round, one for no round."""
    return 2 * iters if iters else 1


def _check_scan_cc(mask: torch.Tensor, iters: int) -> dict:
    """The plan of a CUDA CC call on ``mask``; raises ValueError for what
    the kernel does not take, before anything launches."""
    if mask.dtype != torch.bool:
        raise ValueError(f"connected_components: expected bool masks, got {mask.dtype}")
    if mask.dim() != 3:
        raise ValueError(f"connected_components: masks must be (n, h, w), got shape {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("connected_components: expected contiguous masks")
    if int(iters) != iters or iters < 0:
        raise ValueError(f"connected_components: iters must be a count, got {iters}")
    return scan_cc_plan(*mask.shape)


def connected_components(mask: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """``connected_components_plain`` of (n, h, w) bool masks (contiguous,
    h * w below 2^24).  A CPU tensor runs the plain version; a CUDA tensor
    launches ``csrc/scan_cc.cu`` (two launches a round) and raises if it
    cannot."""
    if not kernels.route(mask):
        return connected_components_plain(mask, iters)
    plan = _check_scan_cc(mask, iters)
    kernels.check("mask", mask, torch.bool, 3)
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    if out.numel():
        scratch = torch.empty_like(out) if iters >= 2 else None
        kernels.launch("cpe_scan_cc", [mask, out, scratch], [*mask.shape, int(iters), plan["strip"]], [])
    kernels.count("scan_cc")
    return out


class ComponentStats(NamedTuple):
    root: torch.Tensor      # (..., K) int32 root label (sentinel if empty)
    count: torch.Tensor     # (..., K) int32
    centroid: torch.Tensor  # (..., K, 2) float (x, y)
    bbox: torch.Tensor      # (..., K, 4) int32 x0, y0, x1, y1 (inclusive)
    valid: torch.Tensor     # (..., K)
    mxx: torch.Tensor
    mxy: torch.Tensor
    myy: torch.Tensor


def peak_key_shift(h: int, w: int, window: int) -> int:
    """Bit shift packing a (box-count, linear-index) key into int32."""
    shift = max(19, (h * w - 1).bit_length())
    if shift + (window * window).bit_length() > 31:
        raise ValueError(
            f"joint-peak key overflow: {h}x{w} image with window {window} "
            f"needs {shift + (window * window).bit_length()} bits > 31"
        )
    return shift


def prefix_rank(mask: torch.Tensor) -> torch.Tensor:
    """rank[i] = (# True in mask[..., :i+1]) - 1 along the last axis."""
    return (torch.cumsum(mask.to(torch.int32), dim=-1) - 1).to(torch.int32)


def _first_k(mask: torch.Tensor, values: torch.Tensor, k: int, sentinel: int):
    """Values at the first k True positions of ``mask`` (..., n) in scan
    order -> (..., k) int64, ``sentinel`` in empty slots."""
    rank = prefix_rank(mask).to(torch.int64)
    slot = torch.where(mask & (rank < k), rank, k)
    vals = torch.where(mask, values.to(torch.int64), sentinel)
    out = torch.full(mask.shape[:-1] + (k + 1,), sentinel, dtype=torch.int64,
                     device=mask.device)
    out = out.scatter_reduce(-1, slot, vals, reduce="amin", include_self=True)
    return out[..., :k]


def compact_true_indices(mask: torch.Tensor, k: int):
    """First-k indices of True entries of (..., n) -> (idx (..., k) int32
    with n in empty slots, valid (..., k))."""
    n = mask.shape[-1]
    pos = torch.arange(n, device=mask.device).expand(mask.shape)
    idx = _first_k(mask, pos, k, n)
    return idx.to(torch.int32), idx < n


def _slot_image(flat: torch.Tensor, root_k: torch.Tensor, vhw: int) -> torch.Tensor:
    """Per pixel, the slot in ``root_k`` whose value equals the pixel's label
    (K where none): a (vhw+1)-entry lookup table per batch element."""
    k = root_k.shape[-1]
    table = torch.full(flat.shape[:-1] + (vhw + 1,), k, dtype=torch.int64,
                       device=flat.device)
    slots = torch.arange(k, device=flat.device).expand(root_k.shape)
    table = table.scatter_reduce(-1, torch.clamp(root_k, max=vhw), slots,
                                 reduce="amin", include_self=True)
    table[..., vhw].fill_(k)
    return table.gather(-1, torch.clamp(flat.to(torch.int64), 0, vhw))


def component_stats_first_k(
    labels: torch.Tensor,
    k: int,
    min_area: int = 1,
    value_shape: tuple | None = None,
) -> ComponentStats:
    """Stats of the first K components in scan order of (..., h, w) labels,
    without boxes (``bbox`` all zero: the JAX function's
    ``compute_bbox=False``, the only form the detector calls).

    ``value_shape`` (vh, vw): labels are a min-pooled view whose VALUES are
    linear indices of the (vh, vw) grid; the root test maps each value to
    the pooled block holding its root pixel.

    The sums are exact (float64, rounded once); the second moments
    ``s / c - m * m`` are fused multiply-adds (``image.fma32``), as XLA's CPU
    backend compiles the JAX function's, so the moments and the
    orientations equal the JAX function's on the CPU."""
    h, w = labels.shape[-2:]
    hw = h * w
    lead = labels.shape[:-2]
    flat = labels.reshape(lead + (hw,)).to(torch.int64)
    lin = torch.arange(hw, device=labels.device)
    if value_shape is None or tuple(value_shape) == (h, w):
        is_root = (flat == lin) & (flat < hw)
        vhw = hw
    else:
        vh, vw = value_shape
        py, px = vh // h, vw // w
        vy, vx = flat // vw, flat % vw
        is_root = (flat < vh * vw) & (vy // py == lin // w) & (vx // px == lin % w)
        vhw = vh * vw
    root_k = _first_k(is_root, flat, k, vhw)
    slot = _slot_image(flat, root_k, vhw)

    xs = (lin % w).to(torch.float64)
    ys = (lin // w).to(torch.float64)
    payload = torch.stack([torch.ones_like(xs), xs, ys, xs * xs, xs * ys, ys * ys], -1)
    sums = torch.zeros(lead + (k + 1, 6), dtype=torch.float64, device=labels.device)
    sums = sums.scatter_add(
        -2, slot[..., None].expand(lead + (hw, 6)), payload.expand(lead + (hw, 6))
    )[..., :k, :].to(torch.float32)

    cnt = sums[..., 0]
    valid = cnt >= min_area
    c = torch.clamp(cnt, min=1.0)
    cx = sums[..., 1] / c
    cy = sums[..., 2] / c
    # (mxx, mxy, myy) in one fused pass: fewer launches on the card.
    mxx, mxy, myy = fma32(-torch.stack([cx, cx, cy]), torch.stack([cx, cy, cy]),
                          sums[..., 3:].movedim(-1, 0) / c).unbind(0)
    return ComponentStats(
        root=torch.where(valid, root_k, vhw).to(torch.int32),
        count=cnt.to(torch.int32),
        centroid=torch.stack([cx, cy], -1),
        bbox=torch.zeros(lead + (k, 4), dtype=torch.int32, device=labels.device),
        valid=valid,
        mxx=mxx,
        mxy=mxy,
        myy=myy,
    )


def component_stats(labels: torch.Tensor, k: int, min_area: int = 1) -> ComponentStats:
    """Stats of the K largest components of (..., h, w) labels, the JAX
    function's sort-based reduction: a stable sort of the flat labels (so
    components of equal size keep the smaller label first), runs of equal
    labels, per-run sums as differences of one float32 prefix sum in XLA's
    CPU order (``image.cumsum_blocked``), per-run boxes from the run's
    minima and maxima, and the K longest runs by a stable sort.  The second
    moments ``s / c - m * m`` are fused multiply-adds (``image.fma32``), as
    XLA's CPU backend compiles them, so every field equals the JAX
    function's on the CPU.

    Roots, counts, boxes and validity are exact.  The moments are not: the
    prefix sum of x^2 and y^2 reaches ~4e10 at 480x640, so a run sorted late
    carries an absolute moment error up to ~2.5e3 (~0.05 px of centroid);
    ``component_stats_first_k`` sums exactly where K slots in scan order
    suffice."""
    h, w = labels.shape[-2:]
    hw = h * w
    lead = labels.shape[:-2]
    flat = labels.reshape(lead + (hw,))
    sl, order = torch.sort(flat, dim=-1, stable=True)
    xs = (order % w).to(torch.float32)
    ys = (order // w).to(torch.float32)
    csum = cumsum_blocked(torch.stack([xs, ys, xs * xs, xs * ys, ys * ys], dim=-2))  # (..., 5, hw)

    pos = torch.arange(hw, device=labels.device).expand(sl.shape)
    boundary = torch.ones_like(sl, dtype=torch.bool)
    boundary[..., 1:] = sl[..., 1:] != sl[..., :-1]
    # Sorted run starts; the slots past the last run park at hw.
    starts = torch.sort(torch.where(boundary, pos, hw), dim=-1).values
    ends = torch.cat([starts[..., 1:], torch.full(lead + (1,), hw, device=labels.device)], -1)
    root = sl.gather(-1, starts.clamp(max=hw - 1))
    length = torch.where((starts < hw) & (root < hw), ends - starts, 0)  # background: 0

    sel = torch.sort(-length, dim=-1, stable=True).indices[..., :k]
    cnt_k = length.gather(-1, sel)
    valid = cnt_k >= min_area
    s_idx = starts.gather(-1, sel).clamp(max=hw - 1)
    e_idx = (ends.gather(-1, sel) - 1).clamp(0, hw - 1)

    def at(idx):
        return csum.gather(-1, idx[..., None, :].expand(lead + (5, idx.shape[-1])))

    sums = at(e_idx) - torch.where(s_idx[..., None, :] > 0, at((s_idx - 1).clamp(min=0)), 0.0)
    c = torch.clamp(cnt_k.to(torch.float32), min=1.0)
    cx = sums[..., 0, :] / c
    cy = sums[..., 1, :] / c

    # Boxes: each run's extremes, read at the run holding e_idx.
    run = torch.cumsum(boundary, dim=-1) - 1
    run_e = run.gather(-1, e_idx)
    ext = []
    for v, reduce in ((xs, "amin"), (ys, "amin"), (xs, "amax"), (ys, "amax")):
        table = torch.zeros_like(v).scatter_reduce(-1, run, v, reduce=reduce, include_self=False)
        ext.append(table.gather(-1, run_e))
    bbox = torch.where(valid[..., None], torch.stack(ext, -1), 0.0).to(torch.int32)
    return ComponentStats(
        root=torch.where(valid, root.gather(-1, sel), hw).to(torch.int32),
        count=cnt_k.to(torch.int32),
        centroid=torch.stack([cx, cy], -1),
        bbox=bbox,
        valid=valid,
        mxx=fma32(-cx, cx, sums[..., 2, :] / c),
        mxy=fma32(-cx, cy, sums[..., 3, :] / c),
        myy=fma32(-cy, cy, sums[..., 4, :] / c),
    )


def largest_component_mask(labels: torch.Tensor, k: int = 128) -> torch.Tensor:
    """Mask of the largest of the first k components (scan order) of
    (..., h, w) labels; all False when there is none."""
    h, w = labels.shape[-2:]
    hw = h * w
    lead = labels.shape[:-2]
    flat = labels.reshape(lead + (hw,)).to(torch.int64)
    lin = torch.arange(hw, device=labels.device)
    is_root = (flat == lin) & (flat < hw)
    root_k = _first_k(is_root, flat, k, hw)
    slot = _slot_image(flat, root_k, hw)
    cnt = torch.zeros(lead + (k + 1,), dtype=torch.int64, device=labels.device)
    cnt = cnt.scatter_add(-1, slot, torch.ones_like(slot))[..., :k]
    li = torch.argmax(cnt, dim=-1, keepdim=True)
    root = root_k.gather(-1, li)[..., None]  # (..., 1, 1)
    return (labels.to(torch.int64) == root) & (root < hw)


def component_orientation(stats: ComponentStats) -> torch.Tensor:
    return 0.5 * torch.atan2(2.0 * stats.mxy, stats.mxx - stats.myy)


def fill_orthoconvex(mask: torch.Tensor, rounds: int = 2) -> torch.Tensor:
    """Row/column convex fill of (..., H, W) masks, iterated."""

    def fill_axis(m, axis):
        n = m.shape[axis]
        shape = [1] * m.dim()
        shape[axis] = n
        idx = torch.arange(n, device=m.device).reshape(shape)
        lo = torch.amin(torch.where(m, idx, n + 1), dim=axis, keepdim=True)
        hi = torch.amax(torch.where(m, idx, -1), dim=axis, keepdim=True)
        return (idx >= lo) & (idx <= hi)

    out = mask
    for _ in range(rounds):
        out = fill_axis(out, -1)
        out = fill_axis(out, -2)
    return out
