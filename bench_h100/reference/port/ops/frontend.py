"""The plain PyTorch versions of the detection path's four front-end
kernels (preprocess/binarise, connected components, bridge morphology,
component payload min/max), on (N, H, W) batches: the reference's side of
each kernel, with the wrappers' argument checks kept and no launch path.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from ..ops import mxu_conv
from ..ops.labeling import peak_key_shift
from ..ops.morphology import shift2d


def _route(x: torch.Tensor) -> bool:
    """False: the reference runs every kernel's plain version, on the CPU only."""
    if x.device.type != "cpu":
        raise ValueError(f"the reference runs on the CPU, not on {x.device}")
    return False


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
    if not _route(gray):
        return preprocess_binarize_plain(gray, **args)


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
    if not _route(mask):
        return connected_components_plain(mask, rounds, pools_per_round, init_labels, cap_axis, cap)


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
    if not _route(mask):
        return component_payload_minmax_plain(mask, payload, rounds, pools_per_round)


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


H100_SMS = 132
H100_SM_SMEM = 233472


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
    if not _route(masks):
        if schedule_out is not None:
            ray, line = bridge_schedule(angles, kernel_len, probe_len, max_kernel)
            schedule_out.copy_(torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1))
        return bridge_morphology_plain(masks, exp_imgs, angles, kernel_len, probe_len, max_kernel)


