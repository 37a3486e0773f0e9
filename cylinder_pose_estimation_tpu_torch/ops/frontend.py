"""The four front-end kernels of the detection path, each with its plain
PyTorch version (port of the JAX package's ops/pallas/frontend.py).

* ``preprocess_binarize``      replaces ``preprocess_binarize`` / ``_preprocess_kernel``
* ``connected_components``     replaces ``connected_components`` / ``_cc_kernel``
* ``bridge_morphology``        replaces ``bridge_morphology`` / ``_bridge_kernel``
* ``component_payload_minmax`` replaces ``component_payload_minmax`` /
  ``_cc_payload_minmax_kernel`` (the ``bridge_endpoint_stats`` bridge only)

Each wrapper takes (N, H, W) batches.  A CPU tensor runs the plain version
(``*_plain``), which mirrors the Pallas algorithm step for step with
``torch.roll`` and the same doubling order; a CUDA tensor launches the
hand-written CUDA kernel from ``csrc/`` (built at first use; its catalogue
entry, route, input checks and launch counters are in ``ops/kernels.py``)
and raises if it cannot.  Nothing falls back.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from cylinder_pose_estimation_tpu_torch.ops import kernels, mxu_conv
# The benchmark's site recorder reads the launch counts here.
from cylinder_pose_estimation_tpu_torch.ops.kernels import launch_counts
from cylinder_pose_estimation_tpu_torch.ops.labeling import peak_key_shift
from cylinder_pose_estimation_tpu_torch.ops.morphology import shift2d

# --------------------------------------------------------------------------
# Shared plain helpers (torch.roll has jnp.roll's semantics: out[i] = x[i-s]).
# --------------------------------------------------------------------------


def _roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    shift = shift % x.shape[dim]
    if shift == 0:
        return x
    return torch.roll(x, shifts=shift, dims=dim)


def _box_sum_roll(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Odd-size centred box sum by Hillis-Steele doubling (the Pallas
    kernel's exact addition tree)."""
    assert size % 2 == 1
    pows = {1: x}
    m = 1
    while m * 2 <= size:
        pows[m * 2] = pows[m] + _roll(pows[m], -m, dim)
        m *= 2
    out = None
    off = 0
    while size:
        p = 1 << (size.bit_length() - 1)
        part = pows[p] if off == 0 else _roll(pows[p], -off, dim)
        out = part if out is None else out + part
        off += p
        size -= p
    return _roll(out, off // 2, dim)


def _line_minmax(x: torch.Tensor, length: int, dim: int, op) -> torch.Tensor:
    covered = 1
    out = x
    while covered < length:
        take = min(covered, length - covered)
        out = op(out, _roll(out, -take, dim))
        covered += take
    return _roll(out, (length - 1) // 2, dim)


# --------------------------------------------------------------------------
# 2.1 preprocess / binarize / openings / joints / joint count / joint peak
# --------------------------------------------------------------------------


def smoothing_taps(blur_ksize: int = 5, ridge_sigma: float = 3.0) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """The in-kernel smoothing's taps, rounded to float32 as the TPU kernel
    multiplies them: the OpenCV Gaussian of ``blur_ksize`` and the scipy
    Gaussian of ``ridge_sigma``.  Raises ``ValueError`` for taps that are
    not symmetric (the passes add the pixel pairs +-i before the multiply)."""
    taps = []
    for k in (mxu_conv.gauss_taps_cv(blur_ksize), mxu_conv.gauss_taps_scipy(ridge_sigma)):
        k = tuple(torch.tensor(k, dtype=torch.float32).tolist())
        if len(k) % 2 != 1 or k != k[::-1]:
            raise ValueError(f"smoothing taps must be odd in number and symmetric, got {len(k)}")
        taps.append(k)
    return taps[0], taps[1]


def _sep_conv_roll(x: torch.Tensor, k: Tuple[float, ...], dim: int) -> torch.Tensor:
    """1-D correlation along ``dim`` with circular wrap, in the TPU kernel's
    order: k[r] * x, then + k[r - i] * (x[p - i] + x[p + i]) for i = 1 .. r."""
    r = len(k) // 2
    out = k[r] * x
    for i in range(1, r + 1):
        out = out + k[r - i] * (_roll(x, i, dim) + _roll(x, -i, dim))
    return out


def wrapped_smoothing_plain(gray: torch.Tensor, blur_ksize: int = 5, ridge_sigma: float = 3.0) -> torch.Tensor:
    """Plain version of the preprocess kernel's own smoothing on (N, H, W)
    float32 grey images: the ``blur_ksize`` Gaussian along W, then H, then
    the ``ridge_sigma`` Gaussian along W, then H, each wrapping around the
    image (``_sep_conv_roll``)."""
    k5, k25 = smoothing_taps(blur_ksize, ridge_sigma)
    s = _sep_conv_roll(_sep_conv_roll(gray.to(torch.float32), k5, 2), k5, 1)
    return _sep_conv_roll(_sep_conv_roll(s, k25, 2), k25, 1)


def preprocess_binarize_plain(
    gray: torch.Tensor,
    blur_ksize: int = 5,
    ridge_sigma: float = 3.0,
    sauvola_window: int = 15,
    sauvola_k: float = 0.5,
    sauvola_r: float = 128.0,
    min_contrast: float = 0.05,
    line_len: int = 20,
    margin: int = 20,
    joint_window: int = 11,
    joint_peak_iters: int = 8,
    pre_smoothed: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of the preprocess kernel on an (N, H, W) float32 batch.
    With ``pre_smoothed`` the input is already smoothed; else the kernel's
    own smoothing runs first: the ``blur_ksize`` Gaussian along W, then H,
    then the ``ridge_sigma`` Gaussian along W, then H, each wrapping around
    the image.  Returns (binary, h_mask, v_mask, joints, joint_cnt,
    joint_peak), all float32 (N, H, W)."""
    s = gray.to(torch.float32) if pre_smoothed else wrapped_smoothing_plain(gray, blur_ksize, ridge_sigma)
    _, h, w = s.shape
    dev = s.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    inside = ((rows >= margin) & (rows < h - margin) & (cols >= margin) & (cols < w - margin))
    inside_f = inside.to(torch.float32)

    def ddy(x):
        return 0.5 * (_roll(x, -1, 1) - _roll(x, 1, 1))

    def ddx(x):
        return 0.5 * (_roll(x, -1, 2) - _roll(x, 1, 2))

    gr = ddy(s)
    gc = ddx(s)
    hrr = ddy(gr)
    hrc = ddx(gr)
    hcc = ddx(gc)
    half_tr = 0.5 * (hrr + hcc)
    half_diff = 0.5 * (hrr - hcc)
    root = torch.sqrt(half_diff * half_diff + hrc * hrc)
    minima = half_tr - root

    n_px = float(sauvola_window * sauvola_window)
    m1 = _box_sum_roll(minima, sauvola_window, 2)
    m1 = _box_sum_roll(m1, sauvola_window, 1) / n_px
    m2 = _box_sum_roll(minima * minima, sauvola_window, 2)
    m2 = _box_sum_roll(m2, sauvola_window, 1) / n_px
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    std = torch.sqrt(var)
    thresh = m1 * (1.0 + sauvola_k * (std / sauvola_r - 1.0))

    bf = torch.where(minima > thresh, 0.0, 1.0)
    if min_contrast > 0.0:
        bf = bf * torch.where(minima < -min_contrast, 1.0, 0.0)
    bf = bf * inside_f

    h_open = _line_minmax(_line_minmax(bf, line_len, 2, torch.minimum), line_len, 2, torch.maximum)
    v_open = _line_minmax(_line_minmax(bf, line_len, 1, torch.minimum), line_len, 1, torch.maximum)
    joints = torch.minimum(h_open, v_open)

    cnt = _box_sum_roll(joints, joint_window, 2)
    cnt = _box_sum_roll(cnt, joint_window, 1)
    lin = (rows * w + cols).to(torch.int32)
    key = cnt.to(torch.int32) * (1 << peak_key_shift(h, w, joint_window)) + lin
    neg = torch.iinfo(torch.int32).min
    is_joint = joints > 0.5
    km = torch.where(is_joint, key, neg)
    for _ in range(joint_peak_iters):
        km = torch.maximum(km, torch.maximum(_roll(km, 1, 1), _roll(km, -1, 1)))
        km = torch.maximum(km, torch.maximum(_roll(km, 1, 2), _roll(km, -1, 2)))
        km = torch.where(is_joint, km, neg)
    peak = torch.where(km == key, 1.0, 0.0) * joints
    return bf, h_open, v_open, joints, cnt, peak


def preprocess_reach(sauvola_window: int = 15, line_len: int = 20, joint_window: int = 11) -> int:
    """How far (px) the preprocess chain reads from a kept pixel along one
    axis: the Hessian (2) plus the Sauvola box, the two line passes of an
    opening, the joint count.  The kernel reads 0 outside the image where
    the plain version wraps; with the margin at least this reach, both give
    the same whole images."""
    a = (line_len - 1) // 2
    return max(2 + sauvola_window // 2, 2 * (line_len - 1 - a), joint_window // 2 + 1)


# Output tile of the two preprocess launches (csrc/preprocess.cu kTileH,
# kTileW) and of the smoothing launch (kSmoothH, kSmoothW).
PREPROCESS_TILE = (32, 64)
SMOOTH_TILE = (64, 128)


# Taps the preprocess kernel's smoothing takes (csrc/preprocess.cu kMaxTaps).
MAX_SMOOTHING_TAPS = 64


@functools.lru_cache(maxsize=64)
def smoothing_plan(n: int, h: int, w: int, smooth: Tuple[int, int] = (2, 12)) -> Dict[str, object]:
    """Launch plan of the preprocess kernel's own smoothing (``smooth``: the
    blur's and the ridge Gaussian's radii): one launch over (image, tile row,
    tile column) blocks of ``SMOOTH_TILE`` outputs; each loads its grey tile
    with a halo of r1 + r2, wrapped around the image, and runs the four
    passes in shared memory (csrc/preprocess.cu ``LayoutS``: the halo tile,
    the first pass's output, the wrapped row and column indices).  The shared
    bytes mirror the kernel's layout (it refuses other values).  Raises
    ``ValueError`` for radii the kernel does not take.  Cached: treat the
    returned dict as read-only."""
    r1, r2 = smooth
    if r1 < 0 or r2 < 0 or 2 * (r1 + r2) + 2 > MAX_SMOOTHING_TAPS:
        raise ValueError(f"smoothing radii {smooth}: at most {MAX_SMOOTHING_TAPS} taps in all")
    if n * h * w >= 2**31:
        raise ValueError(f"{n}x{h}x{w} pixels overflow the kernel's 32-bit plane index")
    th, tw = SMOOTH_TILE
    halo = r1 + r2
    xh, xw = th + 2 * halo, tw + 2 * halo
    words = xh * (xw | 1) + xh * ((tw + 2 * r2) | 1) + xh + xw
    plan = {"tile": (th, tw), "grid": (-(-w // tw), -(-h // th), n), "halo": halo, "smooth": (r1, r2),
            "smem": 4 * words}
    if plan["smem"] > kernels.MAX_DYNAMIC_SMEM:
        raise ValueError(f"smoothing: {plan['smem']} B of shared memory (max {kernels.MAX_DYNAMIC_SMEM})")
    return plan


@functools.lru_cache(maxsize=64)
def preprocess_plan(
    n: int, h: int, w: int, sauvola_window: int = 15, line_len: int = 20,
    joint_window: int = 11, joint_peak_iters: int = 8,
) -> Dict[str, object]:
    """Launch plan of the preprocess kernel: two launches over the same grid
    of (image, tile row, tile column) blocks.  Launch A (binarize) loads the
    tile with a halo of 2 + window // 2; launch B (masks, count, peak) loads
    the bit-packed binary with the openings' and the peak rounds' halos.
    Both run on a smoothed image (the kernel's own smoothing is a launch
    before them, ``smoothing_plan``).  The shared bytes mirror the kernel's
    layouts (it refuses other values).  Raises ``ValueError`` for
    parameters the kernel does not take.  Cached: treat the returned dict
    as read-only."""
    if sauvola_window % 2 != 1 or joint_window % 2 != 1 or sauvola_window > 15 or joint_window > 15:
        raise ValueError("box windows must be odd and at most 15")
    if not 1 <= line_len <= 32:
        raise ValueError(f"line_len must lie in [1, 32], got {line_len}")
    if joint_peak_iters < 0 or joint_peak_iters + joint_window // 2 > 32:
        raise ValueError("joint_peak_iters + joint_window // 2 must lie in [0, 32]")
    if n * h * w >= 2**31:
        raise ValueError(f"{n}x{h}x{w} pixels overflow the kernel's 32-bit plane index")
    th, tw = PREPROCESS_TILE
    tile_words = tw // 32
    # Launch A (floats): input + halo, minima + halo (odd stride), 2 row-sum
    # planes.
    rb = sauvola_window // 2
    hs = rb + 2
    mh, mw, rw = th + 2 * rb, (tw + 2 * rb) | 1, tw + 1
    sh, sw = th + 2 * hs, tw + 2 * hs
    floats_a = sh * sw + mh * mw + 2 * mh * rw
    # Launch B (32-bit words): binary bits, row erosion, 3 word planes, row
    # counts, counts, two key planes and the joint count.
    a = (line_len - 1) // 2
    up, down = 2 * a, 2 * (line_len - 1 - a)
    rj = joint_peak_iters + joint_window // 2
    jh = th + 2 * rj
    kh, kw = th + 2 * joint_peak_iters, tw + 2 * joint_peak_iters
    words_b = ((jh + up + down) * (tile_words + 6) + (jh + line_len - 1) * (tile_words + 2)
               + 3 * jh * (tile_words + 2) + jh * kw + 3 * kh * kw + 1)
    plan = {
        "launches": 2,
        "tile": (th, tw),
        "grid": (-(-w // tw), -(-h // th), n),
        "halo_a": hs,
        "halo_b_rows": (rj + up, rj + down),
        "halo_b_cols": (rj, rj),
        "bit_words": -(-w // 32),
        "smem_a": 4 * floats_a,
        "smem_b": 4 * words_b,
    }
    for key in ("smem_a", "smem_b"):
        if plan[key] > kernels.MAX_DYNAMIC_SMEM:
            raise ValueError(f"{key}: {plan[key]} B of shared memory (max {kernels.MAX_DYNAMIC_SMEM})")
    return plan


def wrapped_smoothing(gray: torch.Tensor, blur_ksize: int = 5, ridge_sigma: float = 3.0) -> torch.Tensor:
    """The preprocess kernel's own smoothing on (N, H, W) float32 grey
    images (see ``wrapped_smoothing_plain``): on the card one launch
    (``smoothing_plan``) into a new plane, counted as
    ``preprocess_binarize.smoothing``."""
    if not kernels.route(gray):
        return wrapped_smoothing_plain(gray, blur_ksize, ridge_sigma)
    kernels.check("gray", gray, torch.float32, 3)
    taps = smoothing_taps(blur_ksize, ridge_sigma)
    n, h, w = gray.shape
    plan = smoothing_plan(n, h, w, tuple(len(k) // 2 for k in taps))
    out = torch.empty_like(gray)
    # The taps stay on the host: the C entry copies them into the launch's
    # parameters.
    host_taps = torch.tensor([t for k in taps for t in k], dtype=torch.float32)
    kernels.launch("cpe_smooth_wrapped", [gray, out, host_taps], [n, h, w, *plan["smooth"], *plan["tile"], plan["smem"]],
                   [])
    kernels.count("preprocess_binarize.smoothing")
    return out


def preprocess_binarize(
    gray: torch.Tensor,
    blur_ksize: int = 5,
    ridge_sigma: float = 3.0,
    sauvola_window: int = 15,
    sauvola_k: float = 0.5,
    sauvola_r: float = 128.0,
    min_contrast: float = 0.05,
    line_len: int = 20,
    margin: int = 20,
    joint_window: int = 11,
    joint_peak_iters: int = 8,
    pre_smoothed: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Preprocess kernel on (N, H, W) float32 grey images, smoothed in the
    kernel, or already smoothed with ``pre_smoothed`` (see
    ``preprocess_binarize_plain`` for the outputs).  ``margin`` must cover
    ``preprocess_reach``: the smoothing wraps around the image as the plain
    version does, the stages after it read 0 outside the image."""
    args = dict(
        blur_ksize=blur_ksize, ridge_sigma=ridge_sigma,
        sauvola_window=sauvola_window, sauvola_k=sauvola_k, sauvola_r=sauvola_r,
        min_contrast=min_contrast, line_len=line_len, margin=margin,
        joint_window=joint_window, joint_peak_iters=joint_peak_iters, pre_smoothed=pre_smoothed,
    )
    reach = preprocess_reach(sauvola_window, line_len, joint_window)
    if margin < reach:
        raise ValueError(f"margin {margin} is below the stencil reach {reach}: the kernel's zero "
                         "halo and the plain version's wrap-around would differ")
    if not kernels.route(gray):
        return preprocess_binarize_plain(gray, **args)
    kernels.check("gray", gray, torch.float32, 3)
    n, h, w = gray.shape
    plan = preprocess_plan(n, h, w, sauvola_window, line_len, joint_window, joint_peak_iters)
    smoothed = gray if pre_smoothed else wrapped_smoothing(gray, blur_ksize, ridge_sigma)
    shift = peak_key_shift(h, w, joint_window)
    outs = torch.empty((6,) + gray.shape, dtype=torch.float32, device=gray.device).unbind(0)
    bits = torch.empty((n, h, plan["bit_words"]), dtype=torch.int32, device=gray.device)
    kernels.launch(
        "cpe_preprocess_binarize",
        [smoothed, *outs, bits],
        [n, h, w, sauvola_window, line_len, margin, joint_window, joint_peak_iters, shift,
         *plan["tile"], plan["smem_a"], plan["smem_b"]],
        [sauvola_k, sauvola_r, min_contrast],
    )
    kernels.count("preprocess_binarize")
    return tuple(outs)


# --------------------------------------------------------------------------
# 2.2 connected components: Jacobi 3x3 min-pools + row / column run-min scans
# --------------------------------------------------------------------------


def _seg_min_scan_roll(lab, maskf, dim, n, cap: int = 0):
    """Every in-mask pixel takes the minimum of its contiguous in-mask run
    along ``dim`` by Hillis-Steele doubling; ``cap`` > 0 stops the doubling
    at min(n, cap) (the reach of ``cap_reach``)."""
    if cap > 0:
        n = min(n, cap)
    out = lab
    for direction in (1, -1):
        v = lab
        clear = maskf
        d = 1
        while d < n:
            vs = _roll(v, direction * d, dim)
            cs = _roll(clear, direction * d, dim)
            v = torch.where(clear > 0.5, torch.minimum(v, vs), v)
            clear = clear * cs
            d *= 2
        out = torch.minimum(out, v)
    return out


def cap_reach(n: int, cap: int) -> int:
    """How far (px) the capped scan along an axis of ``n`` pixels carries a
    label: its ceil(log2(min(n, cap))) doubling steps take every pixel to the
    minimum of its run within 2^steps - 1 pixels on each side.  -1 where
    that covers every run (no cap, or a cap of at least the axis)."""
    if cap <= 0:
        return -1
    d = 1
    while d < min(n, cap):
        d *= 2
    return -1 if d - 1 >= n - 1 else d - 1


def _check_cap(cap_axis: int, cap: int) -> None:
    if cap_axis not in (-1, 0, 1):
        raise ValueError(f"cap_axis must be -1, 0 (rows) or 1 (columns), got {cap_axis}")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")


# The 8 neighbour offsets of the CC pools, in the Pallas kernels' order.
_NEIGHBOURS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def _ring(h: int, w: int, device) -> torch.Tensor:
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return ((rows >= 1) & (rows < h - 1) & (cols >= 1) & (cols < w - 1)).to(torch.float32)


def connected_components_plain(
    mask: torch.Tensor,
    rounds: int = 10,
    pools_per_round: int = 4,
    init_labels: torch.Tensor | None = None,
    cap_axis: int = -1,
    cap: int = 0,
) -> torch.Tensor:
    """Plain version of the CC kernel on (N, H, W) masks -> int32 labels (the
    minimum linear index of each component after exactly ``rounds`` rounds;
    background H*W).  ``cap_axis`` (0: along H, 1: along W) and ``cap`` > 0
    cap the scan along that axis (``_seg_min_scan_roll``)."""
    _check_cap(cap_axis, cap)
    _, h, w = mask.shape
    maskf = mask.to(torch.float32) * _ring(h, w, mask.device)
    m = maskf > 0.5
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    big = h * w
    if init_labels is not None:
        lab = torch.where(m, torch.minimum(init_labels.to(torch.int32), idx), big)
    else:
        lab = torch.where(m, idx, big)
    lab = lab.to(torch.int32)

    def pool(lab):
        out = lab
        for dy, dx in _NEIGHBOURS:
            out = torch.minimum(out, _roll(_roll(lab, dy, 1), dx, 2))
        return torch.where(m, out, big)

    for _ in range(rounds):
        for _ in range(pools_per_round):
            lab = pool(lab)
        lab = torch.where(m, _seg_min_scan_roll(lab, maskf, 2, w, cap if cap_axis == 1 else 0), big)
        lab = torch.where(m, _seg_min_scan_roll(lab, maskf, 1, h, cap if cap_axis == 0 else 0), big)
    return lab.to(torch.int32)


CLUSTER_SIZES = (1, 2, 4, 8)


# The capped scans of the large-frame route (csrc/connected_components.cu):
# along W one in-place pass of the band kernel's rows up to
# CAPPED_ROW_REACH; along H a streamed column pass (cc_capped_cols_stream,
# strips of CAPPED_STREAM_ROWS rows) up to CAPPED_STREAM_REACH.  Past them a
# walk per pixel, along W into a second band buffer.
CAPPED_ROW_REACH = 31
CAPPED_STREAM_REACH = 15
CAPPED_STREAM_ROWS = 64


@functools.lru_cache(maxsize=64)
def cc_plan(n: int, h: int, w: int, channels: int = 1, pools_per_round: int = 4, cap_axis: int = -1,
            cap: int = 0) -> Dict[str, object]:
    """Launch plan of the CC kernel with 1 (labels) or 2 (payload min and
    max) channels: one thread-block cluster per mask, its rows split over the
    smallest cluster (1, 2, 4 or 8 CTAs) whose two int32 buffers per channel
    of rows_per_cta x W, plus per column an int32 top and bottom entry per
    channel and a one-run flag, fit in one CTA's shared memory.  Where 8 CTAs
    do not hold a mask, the large-frame route (``_band_plan``):
    ``{"route": "global", ...}``, rows in bands.  ``pools_per_round`` only
    shapes the global plan.  A capped scan (``cap_axis``, ``cap``; labels
    only) that does not cover every run takes the large-frame route at every
    size (on the detector's masks it is the faster route for those calls,
    PERF.md section 6): the plan adds its axis and reach (``cap_reach``) as
    ``"cap_axis"`` and ``"cap_reach"``, and along H the streamed column
    pass's ``"cap_strip"`` rows; along W past ``CAPPED_ROW_REACH`` the bands
    keep a second buffer for the walk.  Raises ``ValueError`` where the
    labels overflow 32 bits.  Cached: treat the returned dict as
    read-only."""
    if channels not in (1, 2):
        raise ValueError(f"channels must be 1 or 2, got {channels}")
    _check_cap(cap_axis, cap)
    if n * h * w >= 2**31:
        raise ValueError(f"{n}x{h}x{w} labels overflow the kernel's 32-bit index")
    reach = cap_reach((h, w)[cap_axis], cap) if cap_axis >= 0 else -1
    if reach >= 0:
        if channels != 1:
            raise ValueError("the capped scan takes labels only (1 channel)")
        strip = {"cap_strip": min(CAPPED_STREAM_ROWS, h)} if cap_axis == 0 else {}
        walk = cap_axis == 1 and reach > CAPPED_ROW_REACH
        return {**_band_plan(n, h, w, channels, pools_per_round, walk), "cap_axis": cap_axis, "cap_reach": reach,
                **strip}
    for c in CLUSTER_SIZES:
        rows = -(-h // c)
        smem = 4 * (2 * channels * rows * w + (2 * channels + 1) * w)
        if smem <= kernels.MAX_DYNAMIC_SMEM and (c - 1) * rows < h:
            return {"cluster": c, "rows_per_cta": rows, "smem": smem, "ctas": c * n}
    return _band_plan(n, h, w, channels, pools_per_round)


def _band_plan(n: int, h: int, w: int, channels: int, pools: int, two_buffers: bool = False) -> Dict[str, object]:
    """The global route's plan (csrc/connected_components.cu ``cc_band``):
    one CTA per (mask, band of ``band_rows`` rows), holding per channel two
    Jacobi buffers of the band plus a halo of ``pools`` rows on each side
    (one buffer without pools, unless ``two_buffers``: a capped walk along
    W), the bands as tall as shared memory allows and evened out over H.  ``fused``: the pools run inside the band kernel;
    where that leaves bands of fewer than max(pools, 1) rows, they run as
    device-memory passes and the band kernel holds no halo.
    ``scratch_ints``: a state plane per channel, then the edge tables (per
    mask, band and column: the top and bottom runs' extremes per channel and
    lengths).  Raises ``ValueError`` where not one row of a channel fits."""
    if pools < 0:
        raise ValueError(f"pools_per_round must be >= 0, got {pools}")
    row = 4 * channels * w
    fused = pools == 0 or kernels.MAX_DYNAMIC_SMEM // (2 * row) - 2 * pools >= pools
    halo = pools if fused else 0
    nbuf = 2 if halo or two_buffers else 1
    rows_max = kernels.MAX_DYNAMIC_SMEM // (nbuf * row) - 2 * halo
    if rows_max < 1:
        raise ValueError(f"a {w}-pixel row of {channels} channel(s) passes the band kernel's shared memory")
    bands = -(-h // rows_max)
    band_rows = -(-h // bands)
    return {"route": "global", "band_rows": band_rows, "bands": bands, "fused": fused,
            "smem": nbuf * row * (band_rows + 2 * halo), "ctas": n * bands,
            "scratch_ints": channels * n * h * w + n * bands * w * (2 * channels + 2)}


def cc_global_launches(rounds: int, pools_per_round: int, fused: bool = True) -> int:
    """Device kernels of one call on the CC family's global route: per round
    the band kernel and the fix, or with a cap along H the capped column
    pass in the fix's place (with no round, the start alone); unfused, the
    start and per round the pools, the band kernel and the fix."""
    if fused:
        return 2 * rounds if rounds else 1
    return 1 + rounds * (pools_per_round + 2)


def _cc_global(name: str, mask: torch.Tensor, src, outs, rounds: int, pools_per_round: int,
               plan: Dict[str, object]) -> None:
    """Launch the global route ``name`` with its scratch (``_band_plan``) and
    the plan's capped scan, if any (``cc_plan``)."""
    n, h, w = mask.shape
    scratch = torch.empty(plan["scratch_ints"], dtype=torch.int32, device=mask.device)
    kernels.launch(name, [mask, src, *outs, scratch],
                   [n, h, w, rounds, pools_per_round, plan["band_rows"], int(plan["fused"]), plan["smem"],
                    plan.get("cap_axis", -1), plan.get("cap_reach", -1), plan.get("cap_strip", 0)], [])


def connected_components(
    mask: torch.Tensor,
    rounds: int = 10,
    pools_per_round: int = 4,
    init_labels: torch.Tensor | None = None,
    cap_axis: int = -1,
    cap: int = 0,
) -> torch.Tensor:
    """8-connected labels of (N, H, W) masks on the Pallas kernel's exact
    round schedule (see ``connected_components_plain``), the scan along
    ``cap_axis`` capped by ``cap`` > 0."""
    _check_cap(cap_axis, cap)
    if not kernels.route(mask):
        return connected_components_plain(mask, rounds, pools_per_round, init_labels, cap_axis, cap)
    mask = mask.to(torch.float32).contiguous()
    kernels.check("mask", mask, torch.float32, 3)
    n, h, w = mask.shape
    if init_labels is not None:
        init_labels = init_labels.to(torch.int32).contiguous()
        kernels.check("init_labels", init_labels, torch.int32, 3)
        if init_labels.shape != mask.shape:
            raise ValueError("init_labels must have the mask's shape")
    plan = cc_plan(n, h, w, pools_per_round=pools_per_round, cap_axis=cap_axis, cap=cap)
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    if plan.get("route") == "global":
        _cc_global("cpe_connected_components_global", mask, init_labels, [out], rounds, pools_per_round, plan)
        kernels.count("connected_components.band")
    else:
        kernels.launch(
            "cpe_connected_components",
            [mask, init_labels, out],
            [n, h, w, rounds, pools_per_round, plan["cluster"], plan["rows_per_cta"], plan["smem"]],
            [],
        )
    kernels.count("connected_components")
    if "cap_axis" in plan:
        kernels.count("connected_components.capped.band")
    return out


# --------------------------------------------------------------------------
# 2.4 per-component payload min and max on the CC round schedule
# --------------------------------------------------------------------------


def _seg_max_scan_roll(v0, maskf, dim, n):
    """``_seg_min_scan_roll``'s max mirror: every in-mask pixel gets the
    maximum of its contiguous in-mask run (out-of-mask sources hold -1)."""
    out = v0
    for direction in (1, -1):
        v = v0
        clear = maskf
        d = 1
        while d < n:
            vs = _roll(v, direction * d, dim)
            cs = _roll(clear, direction * d, dim)
            v = torch.where(clear > 0.5, torch.maximum(v, vs), v)
            clear = clear * cs
            d *= 2
        out = torch.maximum(out, v)
    return out


def component_payload_minmax_plain(
    mask: torch.Tensor,
    payload: torch.Tensor,
    rounds: int = 10,
    pools_per_round: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the payload min/max kernel on (N, H, W) masks and
    int32 payloads -> (pmin, pmax) int32: each in-mask pixel's minimum and
    maximum payload over its 8-connected component after exactly ``rounds``
    rounds (unconverged when the rounds run out); background (H*W, -1).
    Pools update both channels from the previous state (Jacobi), then run
    scans along rows and then columns, as ``connected_components_plain``."""
    _, h, w = mask.shape
    maskf = mask.to(torch.float32) * _ring(h, w, mask.device)
    m = maskf > 0.5
    big = h * w
    pay = payload.to(torch.int32)
    lo = torch.where(m, pay, big).to(torch.int32)
    hi = torch.where(m, pay, -1).to(torch.int32)

    def pool(lo, hi):
        mn, mx = lo, hi
        for dy, dx in _NEIGHBOURS:
            mn = torch.minimum(mn, _roll(_roll(lo, dy, 1), dx, 2))
            mx = torch.maximum(mx, _roll(_roll(hi, dy, 1), dx, 2))
        return torch.where(m, mn, big), torch.where(m, mx, -1)

    for _ in range(rounds):
        for _ in range(pools_per_round):
            lo, hi = pool(lo, hi)
        lo = torch.where(m, _seg_min_scan_roll(lo, maskf, 2, w), big)
        lo = torch.where(m, _seg_min_scan_roll(lo, maskf, 1, h), big)
        hi = torch.where(m, _seg_max_scan_roll(hi, maskf, 2, w), -1)
        hi = torch.where(m, _seg_max_scan_roll(hi, maskf, 1, h), -1)
    return lo.to(torch.int32), hi.to(torch.int32)


def component_payload_minmax(
    mask: torch.Tensor,
    payload: torch.Tensor,
    rounds: int = 10,
    pools_per_round: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-component payload min and max of (N, H, W) masks on the Pallas
    kernel's exact round schedule (see ``component_payload_minmax_plain``).
    The payload has the mask's shape; values must lie in [0, H*W) (not
    checked: that would cost a host sync).  On the card: the CC kernel with
    two channels, one launch (or its global route, ``cc_plan``)."""
    if not kernels.route(mask):
        return component_payload_minmax_plain(mask, payload, rounds, pools_per_round)
    mask = mask.to(torch.float32).contiguous()
    payload = payload.to(torch.int32).contiguous()
    kernels.check("mask", mask, torch.float32, 3)
    kernels.check("payload", payload, torch.int32, 3)
    if payload.shape != mask.shape:
        raise ValueError("payload must have the mask's shape")
    n, h, w = mask.shape
    plan = cc_plan(n, h, w, channels=2, pools_per_round=pools_per_round)
    pmin = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    pmax = torch.empty_like(pmin)
    if plan.get("route") == "global":
        _cc_global("cpe_component_payload_minmax_global", mask, payload, [pmin, pmax], rounds, pools_per_round,
                   plan)
    else:
        kernels.launch(
            "cpe_component_payload_minmax",
            [mask, payload, pmin, pmax],
            [n, h, w, rounds, pools_per_round, plan["cluster"], plan["rows_per_cta"], plan["smem"]],
            [],
        )
    kernels.count("component_payload_minmax")
    return pmin, pmax


# --------------------------------------------------------------------------
# 2.3 bridge morphology: endpoint ray counts -> oriented line dilation ->
#     3x3 dilation -> closing-style combine, per mask with a traced angle
# --------------------------------------------------------------------------


def _lengths_per_mask(kernel_len: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """The kernel lengths, () or (M,) with M dividing N (each length covers
    N / M consecutive masks), as (M,) float32 and the number of masks each
    covers."""
    klen = kernel_len.to(torch.float32).reshape(-1)
    m = klen.shape[0]
    if m == 0 or n % m:
        raise ValueError(f"kernel_len must be () or (M,) with M dividing {n}, got {tuple(kernel_len.shape)}")
    return klen, max(n // m, 1)


def bridge_schedule_size(probe_len: int, max_kernel: int) -> int:
    """Ints per mask of the flat schedule the kernel can write out: the
    ray offsets [sign][k][dy, dx] then the line steps [step][dy, dx] (steps
    of 1, 2, 4, ... cover half = max(max_kernel // 2, 1) in
    half.bit_length() of them)."""
    return 4 * (probe_len + 1) + 2 * max(max_kernel // 2, 1).bit_length()


def bridge_schedule(
    angles: torch.Tensor, kernel_len: torch.Tensor, probe_len: int, max_kernel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-mask integer offsets of the bridge (the plain version's schedule;
    the kernel computes the same in shared memory).

    ray: (N, 2, probe_len + 1, 2) int32, [:, s, k] = (round(sin a * k * sgn),
    round(cos a * k * sgn)) for sgn = +1 (s=0) and -1 (s=1).
    line: (N, S, 2) int32, the line-dilation doubling steps (dy, dx) with the
    traced effective length.  Rounding is half to even, as ``jnp.round``.
    ``kernel_len``: () or (M,) with M dividing N."""
    angles = angles.to(torch.float32)
    ca = torch.cos(angles)
    sa = torch.sin(angles)
    ray = []
    for sgn in (1.0, -1.0):
        ks = []
        for k in range(probe_len + 1):
            ks.append(torch.stack([torch.round(sa * k * sgn), torch.round(ca * k * sgn)], -1))
        ray.append(torch.stack(ks, 1))
    ray = torch.stack(ray, 1).to(torch.int32)

    half = max(max_kernel // 2, 1)
    klen, group = _lengths_per_mask(kernel_len, angles.shape[0])
    klen = klen.repeat_interleave(group)
    dyn_half = torch.clamp(klen / 2.0, 0.0, float(half))
    stride, covered = 1, 0
    dyn_covered = torch.zeros_like(dyn_half)
    steps = []
    while covered < half:
        step = min(stride, half - covered)
        eff = torch.clamp(dyn_half - dyn_covered, 0.0, float(step))
        steps.append(torch.stack([torch.round(sa * eff), torch.round(ca * eff)], -1))
        covered += step
        dyn_covered = dyn_covered + eff
        stride *= 2
    line = torch.stack(steps, 1).to(torch.int32)
    return ray.contiguous(), line.contiguous()


def bridge_morphology_plain(
    masks: torch.Tensor,
    exp_imgs: torch.Tensor,
    angles: torch.Tensor,
    kernel_len: torch.Tensor,
    probe_len: int,
    max_kernel: int,
) -> torch.Tensor:
    """Plain version of the bridge kernel: (N, H, W) 0/1 masks and
    expandability images, (N,) angles, () or (M,) kernel lengths (M dividing
    N) -> bridged (N, H, W) masks, bool or uint8 for masks of that type and
    float32 otherwise."""
    ray, line = bridge_schedule(angles, kernel_len, probe_len, max_kernel)
    m = masks.to(torch.float32)
    expf = exp_imgs.to(torch.float32)

    def ray_count(s):
        def d(k):
            return ray[:, s, k, 0], ray[:, s, k, 1]

        dy1, dx1 = d(1)
        pows = {1: shift2d(m, -dy1, -dx1)}
        mm = 1
        while mm * 2 <= probe_len:
            dy, dx = d(mm)
            pows[2 * mm] = pows[mm] + shift2d(pows[mm], -dy, -dx)
            mm *= 2
        cnt = None
        off = 0
        size = probe_len
        while size:
            p = 1 << (size.bit_length() - 1)
            if off == 0:
                part = pows[p]
            else:
                dy, dx = d(off)
                part = shift2d(pows[p], -dy, -dx)
            cnt = part if cnt is None else cnt + part
            off += p
            size -= p
        return cnt

    fwd = ray_count(0)
    bwd = ray_count(1)
    is_end = torch.where((fwd <= 1.0) | (bwd <= 1.0), 1.0, 0.0)
    out = m * expf * is_end
    for s in range(line.shape[1]):
        dy, dx = line[:, s, 0], line[:, s, 1]
        out = torch.maximum(out, torch.maximum(shift2d(out, dy, dx), shift2d(out, -dy, -dx)))
    zero = torch.zeros_like(line[:, 0, 0])
    one = torch.ones_like(zero)
    g1 = torch.maximum(out, torch.maximum(shift2d(out, zero, one), shift2d(out, zero, -one)))
    grown = torch.maximum(g1, torch.maximum(shift2d(g1, one, zero), shift2d(g1, -one, zero)))
    u = torch.maximum(m, grown)
    e1 = torch.minimum(u, torch.minimum(shift2d(u, zero, one, 1.0), shift2d(u, zero, -one, 1.0)))
    er = torch.minimum(e1, torch.minimum(shift2d(e1, one, zero, 1.0), shift2d(e1, -one, zero, 1.0)))
    out = torch.maximum(m, er * grown)
    return out.to(masks.dtype) if masks.dtype in (torch.bool, torch.uint8) else out


# The bridge kernel's pixel types (bytes per pixel), its shared-memory
# layout (csrc/bridge.cu: kPlanes bit planes, then kScheduleInts ints of
# schedule) and the SMs of the H100 SXM, which bridge_plan fills in one wave.
_BRIDGE_TYPES = {torch.bool: 1, torch.uint8: 1, torch.float32: 4}
BRIDGE_PLANES = 9
BRIDGE_SCHEDULE_INTS = 4 * (64 + 1) + 2 * 32
H100_SMS = 132
# The split route (csrc/bridge.cu ``bridge_split``): per CTA a row-pointer
# table (8 B a mask row), kSplitPlanes bit planes of its rows, the schedule
# and the ray offsets' sums (kSplitScheduleInts); 512 threads a CTA with
# __launch_bounds__(512, 2), so two CTAs share an SM's 228 KB (233,472 B,
# 1 KB of it reserved per CTA) where their shared memory allows.
BRIDGE_SPLIT_PLANES = 4
BRIDGE_SPLIT_SCHEDULE_INTS = BRIDGE_SCHEDULE_INTS + 2 * 2 * 64
BRIDGE_SPLIT_CTAS_PER_SM = 2
H100_SM_SMEM = 233472


def bridge_split_smem(h: int, w: int, rows: int) -> int:
    """Shared bytes of one ``bridge_split`` CTA holding ``rows`` rows of an
    (h, w) mask."""
    return 8 * h + 4 * (BRIDGE_SPLIT_PLANES * rows * -(-w // 32) + BRIDGE_SPLIT_SCHEDULE_INTS)


def _split_plan(n: int, h: int, w: int) -> Dict[str, object] | None:
    """The split route's plan: the smallest cluster of 2, 4 or 8 CTAs whose
    share of the rows fits one CTA, raised while c n CTAs still run in one
    wave on the 132 SMs; every CTA keeps rows.  None where 8 CTAs do not
    hold the mask."""
    plan = None
    for c in CLUSTER_SIZES[1:]:
        rows = -(-h // c)
        smem = bridge_split_smem(h, w, rows)
        if smem > kernels.MAX_DYNAMIC_SMEM or (c - 1) * rows >= h:
            continue
        per_sm = min(BRIDGE_SPLIT_CTAS_PER_SM, H100_SM_SMEM // (smem + 1024))
        if plan is not None and c * n > H100_SMS * per_sm:
            break
        plan = {"route": "split", "cluster": c, "rows_per_cta": rows, "smem": smem, "ctas": c * n}
    return plan


@functools.lru_cache(maxsize=64)
def bridge_plan(n: int, h: int, w: int) -> Dict[str, object]:
    """Launch plan of the bridge kernel, one of three routes.

    * Cluster (no ``"route"`` key): one thread-block cluster per mask, the
      largest (1, 2, 4 or 8 CTAs) whose c * n CTAs fit the 132 SMs at once
      and leave every CTA rows to load and write; each CTA holds the whole
      mask as nine bit planes of H x ceil(W / 32) words plus the schedule.
    * ``{"route": "split", ...}`` where the nine planes pass one CTA's shared
      memory (``_split_plan``): one cluster of c CTAs per mask, each holding
      only its ``rows_per_cta`` rows of four bit planes and reading the
      other rows from their CTA's shared memory; one launch.
    * ``{"route": "global", ...}`` where 8 CTAs do not hold the mask either:
      one launch per bit pass (``bridge_global_launches``) on planes in
      device memory (``scratch_ints``: the nine planes, then the schedule).

    Raises ``ValueError`` only where the global route's word index
    overflows 32 bits.  Cached: treat the returned dict as read-only."""
    words = -(-w // 32)
    smem = 4 * (BRIDGE_PLANES * h * words + BRIDGE_SCHEDULE_INTS)
    if smem > kernels.MAX_DYNAMIC_SMEM:
        split = _split_plan(n, h, w)
        if split is not None:
            return split
        if 32 * n * h * words >= 2**31:
            raise ValueError(f"{n}x{h}x{w} masks overflow the kernel's 32-bit index")
        return {"route": "global", "words_per_row": words,
                "scratch_ints": BRIDGE_PLANES * n * h * words + n * BRIDGE_SCHEDULE_INTS}
    c = 1
    for cand in CLUSTER_SIZES:
        if cand * n <= H100_SMS and (cand - 1) * -(-h // cand) < h:
            c = cand
    return {"cluster": c, "rows_per_cta": -(-h // c), "words_per_row": words, "smem": smem, "ctas": c * n}


def bridge_global_launches(probe_len: int, max_kernel: int) -> int:
    """Device kernels of one call on the bridge's global route: the
    schedule, the packing, per ray direction a start and one pass per level,
    the line steps, four closing passes and the unpacking."""
    levels = probe_len.bit_length()
    steps = max(max_kernel // 2, 1).bit_length()
    return 2 + 2 * (1 + levels) + steps + 4 + 1


def bridge_morphology(
    masks: torch.Tensor,
    exp_imgs: torch.Tensor,
    angles: torch.Tensor,
    kernel_len: torch.Tensor,
    probe_len: int,
    max_kernel: int,
    schedule_out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bridge kernel over (N, H, W) masks (see ``bridge_morphology_plain``):
    bool, uint8 or float32 0/1 masks and expandability images (converted to
    the masks' type if they differ); the result has the masks' type.  On the
    card: one launch (cluster and split routes), which computes the
    schedule itself.
    ``schedule_out``: an optional (N, ``bridge_schedule_size(probe_len,
    max_kernel)``) int32 tensor that receives the offsets used
    (``bridge_schedule``'s ray then line, flattened per mask).  The plan
    (``bridge_plan``) picks the route: masks whose nine bit planes fit one
    CTA's shared memory take the cluster kernel, larger ones the split
    kernel (still one launch), and only masks that 8 CTAs cannot hold the
    global route, one launch per pass.  A route whose launch fails raises;
    none falls back to another."""
    n = masks.shape[0]
    if not kernels.route(masks):
        if schedule_out is not None:
            ray, line = bridge_schedule(angles, kernel_len, probe_len, max_kernel)
            schedule_out.copy_(torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1))
        return bridge_morphology_plain(masks, exp_imgs, angles, kernel_len, probe_len, max_kernel)
    if masks.dtype not in _BRIDGE_TYPES:
        raise ValueError(f"masks: expected bool, uint8 or float32, got {masks.dtype}")
    if exp_imgs.dtype != masks.dtype:
        exp_imgs = exp_imgs.to(masks.dtype)
    masks = masks.contiguous()
    exp_imgs = exp_imgs.contiguous()
    kernels.check("masks", masks, masks.dtype, 3)
    kernels.check("exp_imgs", exp_imgs, masks.dtype, 3)
    if exp_imgs.shape != masks.shape:
        raise ValueError("exp_imgs must have the masks' shape")
    _, h, w = masks.shape
    angles = angles.to(torch.float32).contiguous()
    kernels.check("angles", angles, torch.float32, 1)
    if angles.shape != (n,):
        raise ValueError(f"angles must be ({n},), got {tuple(angles.shape)}")
    klen, group = _lengths_per_mask(kernel_len, n)
    klen = klen.contiguous()
    kernels.check("kernel_len", klen, torch.float32, 1)
    if not 1 <= probe_len <= 64:
        raise ValueError("probe_len must lie in [1, 64]")
    half = max(max_kernel // 2, 1)
    if half > 1 << 20:
        raise ValueError(f"max_kernel {max_kernel} is beyond the kernel's 2**21")
    if schedule_out is not None:
        kernels.check("schedule_out", schedule_out, torch.int32, 2)
        if schedule_out.shape != (n, bridge_schedule_size(probe_len, max_kernel)):
            raise ValueError(f"schedule_out must be ({n}, {bridge_schedule_size(probe_len, max_kernel)})")
    plan = bridge_plan(n, h, w)
    route = plan.get("route", "cluster")
    out = torch.empty_like(masks)
    if route == "global":
        scratch = torch.empty(plan["scratch_ints"], dtype=torch.int32, device=masks.device)
        kernels.launch(
            "cpe_bridge_morphology_global",
            [masks, exp_imgs, angles, klen, out, schedule_out, scratch],
            [n, h, w, _BRIDGE_TYPES[masks.dtype], probe_len, half, group],
            [],
        )
    else:
        kernels.launch(
            "cpe_bridge_morphology_split" if route == "split" else "cpe_bridge_morphology",
            [masks, exp_imgs, angles, klen, out, schedule_out],
            [n, h, w, _BRIDGE_TYPES[masks.dtype], probe_len, half, group, plan["cluster"],
             plan["rows_per_cta"], plan["smem"]],
            [],
        )
    kernels.count("bridge_morphology")
    kernels.count(f"bridge_morphology.{route}")
    return out


__all__ = [
    "preprocess_binarize", "preprocess_binarize_plain", "preprocess_plan", "preprocess_reach",
    "smoothing_taps", "smoothing_plan", "wrapped_smoothing", "wrapped_smoothing_plain",
    "connected_components", "connected_components_plain", "cc_plan", "cap_reach",
    "cc_global_launches",
    "bridge_morphology", "bridge_morphology_plain", "bridge_schedule", "bridge_schedule_size",
    "bridge_plan", "bridge_split_smem", "bridge_global_launches",
    "component_payload_minmax", "component_payload_minmax_plain",
    "launch_counts",
]
