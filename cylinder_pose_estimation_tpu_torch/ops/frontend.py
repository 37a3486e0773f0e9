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
hand-written CUDA kernel from ``csrc/`` (built at first use, see
``ops/kernels.py``) and raises if it cannot.  Nothing falls back.

``launch_counts()`` holds, per kernel, the number of wrapper calls that
launched the CUDA kernel (plain runs do not count).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from cylinder_pose_estimation_tpu_torch.ops import kernels
from cylinder_pose_estimation_tpu_torch.ops.labeling import peak_key_shift
from cylinder_pose_estimation_tpu_torch.ops.morphology import shift2d

_LAUNCHES: Dict[str, int] = {
    "preprocess_binarize": 0,
    "connected_components": 0,
    "bridge_morphology": 0,
    "component_payload_minmax": 0,
}


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _route(x: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


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


def preprocess_binarize_plain(
    smoothed: torch.Tensor,
    sauvola_window: int = 15,
    sauvola_k: float = 0.5,
    sauvola_r: float = 128.0,
    min_contrast: float = 0.05,
    line_len: int = 20,
    margin: int = 20,
    joint_window: int = 11,
    joint_peak_iters: int = 8,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of the preprocess kernel on an already smoothed (N, H, W)
    float32 batch.  Returns (binary, h_mask, v_mask, joints, joint_cnt,
    joint_peak), all float32 (N, H, W)."""
    s = smoothed.to(torch.float32)
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


# Output tile of both preprocess launches (csrc/preprocess.cu kTileH, kTileW).
PREPROCESS_TILE = (32, 64)


@functools.lru_cache(maxsize=64)
def preprocess_plan(
    n: int, h: int, w: int, sauvola_window: int = 15, line_len: int = 20,
    joint_window: int = 11, joint_peak_iters: int = 8,
) -> Dict[str, object]:
    """Launch plan of the preprocess kernel: two launches over the same grid
    of (image, tile row, tile column) blocks.  Launch A (binarize) loads the
    tile with a halo of 2 + window // 2; launch B (masks, count, peak) loads
    the bit-packed binary with the openings' and the peak rounds' halos.
    The shared bytes mirror the kernel's layouts (it refuses other values).
    Raises ``ValueError`` for parameters the kernel does not take.  Cached:
    treat the returned dict as read-only."""
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
    # Launch A (floats): input + halo, minima + halo (odd stride), 2 row-sum planes.
    rb = sauvola_window // 2
    hs = rb + 2
    mh, mw, rw = th + 2 * rb, (tw + 2 * rb) | 1, tw + 1
    floats_a = (th + 2 * hs) * (tw + 2 * hs) + mh * mw + 2 * mh * rw
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


def preprocess_binarize(
    smoothed: torch.Tensor,
    sauvola_window: int = 15,
    sauvola_k: float = 0.5,
    sauvola_r: float = 128.0,
    min_contrast: float = 0.05,
    line_len: int = 20,
    margin: int = 20,
    joint_window: int = 11,
    joint_peak_iters: int = 8,
) -> Tuple[torch.Tensor, ...]:
    """Preprocess kernel on (N, H, W) float32 smoothed images (see
    ``preprocess_binarize_plain`` for the outputs).  ``margin`` must cover
    ``preprocess_reach``."""
    args = dict(
        sauvola_window=sauvola_window, sauvola_k=sauvola_k, sauvola_r=sauvola_r,
        min_contrast=min_contrast, line_len=line_len, margin=margin,
        joint_window=joint_window, joint_peak_iters=joint_peak_iters,
    )
    reach = preprocess_reach(sauvola_window, line_len, joint_window)
    if margin < reach:
        raise ValueError(f"margin {margin} is below the stencil reach {reach}: the kernel's zero "
                         "halo and the plain version's wrap-around would differ")
    if not _route(smoothed):
        return preprocess_binarize_plain(smoothed, **args)
    _check("smoothed", smoothed, torch.float32, 3)
    n, h, w = smoothed.shape
    plan = preprocess_plan(n, h, w, sauvola_window, line_len, joint_window, joint_peak_iters)
    shift = peak_key_shift(h, w, joint_window)
    outs = torch.empty((6,) + smoothed.shape, dtype=torch.float32, device=smoothed.device).unbind(0)
    bits = torch.empty((n, h, plan["bit_words"]), dtype=torch.int32, device=smoothed.device)
    kernels.launch(
        "cpe_preprocess_binarize",
        [smoothed, *outs, bits],
        [n, h, w, sauvola_window, line_len, margin, joint_window, joint_peak_iters, shift,
         *plan["tile"], plan["smem_a"], plan["smem_b"]],
        [sauvola_k, sauvola_r, min_contrast],
    )
    _LAUNCHES["preprocess_binarize"] += 1
    return tuple(outs)


# --------------------------------------------------------------------------
# 2.2 connected components: Jacobi 3x3 min-pools + row / column run-min scans
# --------------------------------------------------------------------------


def _seg_min_scan_roll(lab, maskf, dim, n):
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
) -> torch.Tensor:
    """Plain version of the CC kernel on (N, H, W) masks -> int32 labels (the
    minimum linear index of each component after exactly ``rounds`` rounds;
    background H*W)."""
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
        lab = torch.where(m, _seg_min_scan_roll(lab, maskf, 2, w), big)
        lab = torch.where(m, _seg_min_scan_roll(lab, maskf, 1, h), big)
    return lab.to(torch.int32)


CLUSTER_SIZES = (1, 2, 4, 8)


@functools.lru_cache(maxsize=64)
def cc_plan(n: int, h: int, w: int, channels: int = 1) -> Dict[str, object]:
    """Launch plan of the CC kernel with 1 (labels) or 2 (payload min and
    max) channels: one thread-block cluster per mask, its rows split over the
    smallest cluster (1, 2, 4 or 8 CTAs) whose two int32 buffers per channel
    of rows_per_cta x W, plus per column an int32 top and bottom entry per
    channel and a one-run flag, fit in one CTA's shared memory.  Where 8 CTAs
    do not hold a mask, the large-frame route: ``{"route": "global", ...}``,
    one launch per pass (``cc_global_launches``) on buffers in device memory
    (``scratch_ints`` of scratch besides the outputs).  Raises
    ``ValueError`` only where the labels overflow 32 bits.  Cached: treat
    the returned dict as read-only."""
    if channels not in (1, 2):
        raise ValueError(f"channels must be 1 or 2, got {channels}")
    if n * h * w >= 2**31:
        raise ValueError(f"{n}x{h}x{w} labels overflow the kernel's 32-bit index")
    for c in CLUSTER_SIZES:
        rows = -(-h // c)
        smem = 4 * (2 * channels * rows * w + (2 * channels + 1) * w)
        if smem <= kernels.MAX_DYNAMIC_SMEM and (c - 1) * rows < h:
            return {"cluster": c, "rows_per_cta": rows, "smem": smem, "ctas": c * n}
    return {"route": "global", "scratch_ints": channels * n * h * w}


def cc_global_launches(rounds: int, pools_per_round: int) -> int:
    """Device kernels of one call on the CC family's global route: the
    start, then per round the pools, the row pass and the column pass."""
    return 1 + rounds * (pools_per_round + 2)


def connected_components(
    mask: torch.Tensor,
    rounds: int = 10,
    pools_per_round: int = 4,
    init_labels: torch.Tensor | None = None,
) -> torch.Tensor:
    """8-connected labels of (N, H, W) masks on the Pallas kernel's exact
    round schedule (see ``connected_components_plain``)."""
    if not _route(mask):
        return connected_components_plain(mask, rounds, pools_per_round, init_labels)
    mask = mask.to(torch.float32).contiguous()
    _check("mask", mask, torch.float32, 3)
    n, h, w = mask.shape
    if init_labels is not None:
        init_labels = init_labels.to(torch.int32).contiguous()
        _check("init_labels", init_labels, torch.int32, 3)
        if init_labels.shape != mask.shape:
            raise ValueError("init_labels must have the mask's shape")
    plan = cc_plan(n, h, w)
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    if plan.get("route") == "global":
        scratch = torch.empty(plan["scratch_ints"], dtype=torch.int32, device=mask.device)
        kernels.launch("cpe_connected_components_global", [mask, init_labels, out, scratch],
                       [n, h, w, rounds, pools_per_round], [])
    else:
        kernels.launch(
            "cpe_connected_components",
            [mask, init_labels, out],
            [n, h, w, rounds, pools_per_round, plan["cluster"], plan["rows_per_cta"], plan["smem"]],
            [],
        )
    _LAUNCHES["connected_components"] += 1
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
    if not _route(mask):
        return component_payload_minmax_plain(mask, payload, rounds, pools_per_round)
    mask = mask.to(torch.float32).contiguous()
    payload = payload.to(torch.int32).contiguous()
    _check("mask", mask, torch.float32, 3)
    _check("payload", payload, torch.int32, 3)
    if payload.shape != mask.shape:
        raise ValueError("payload must have the mask's shape")
    n, h, w = mask.shape
    plan = cc_plan(n, h, w, channels=2)
    pmin = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    pmax = torch.empty_like(pmin)
    if plan.get("route") == "global":
        scratch = torch.empty(plan["scratch_ints"], dtype=torch.int32, device=mask.device)
        kernels.launch("cpe_component_payload_minmax_global", [mask, payload, pmin, pmax, scratch],
                       [n, h, w, rounds, pools_per_round], [])
    else:
        kernels.launch(
            "cpe_component_payload_minmax",
            [mask, payload, pmin, pmax],
            [n, h, w, rounds, pools_per_round, plan["cluster"], plan["rows_per_cta"], plan["smem"]],
            [],
        )
    _LAUNCHES["component_payload_minmax"] += 1
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


@functools.lru_cache(maxsize=64)
def bridge_plan(n: int, h: int, w: int) -> Dict[str, object]:
    """Launch plan of the bridge kernel: one thread-block cluster per mask,
    the largest (1, 2, 4 or 8 CTAs) whose c * n CTAs fit the 132 SMs at once
    and leave every CTA rows to load and write.  Each CTA holds the whole
    mask as bit planes of H x ceil(W / 32) words plus the schedule.  Where
    they do not fit in shared memory, the large-frame route:
    ``{"route": "global", ...}``, one launch per bit pass
    (``bridge_global_launches``) on planes in device memory
    (``scratch_ints``: the nine planes, then the schedule).  Raises
    ``ValueError`` only where its word index overflows 32 bits.  Cached:
    treat the returned dict as read-only."""
    words = -(-w // 32)
    smem = 4 * (BRIDGE_PLANES * h * words + BRIDGE_SCHEDULE_INTS)
    if smem > kernels.MAX_DYNAMIC_SMEM:
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
    card: one launch, which computes the schedule itself.
    ``schedule_out``: an optional (N, ``bridge_schedule_size(probe_len,
    max_kernel)``) int32 tensor that receives the offsets used
    (``bridge_schedule``'s ray then line, flattened per mask).  Large masks
    take the kernel's global route (``bridge_plan``)."""
    n = masks.shape[0]
    if not _route(masks):
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
    _check("masks", masks, masks.dtype, 3)
    _check("exp_imgs", exp_imgs, masks.dtype, 3)
    if exp_imgs.shape != masks.shape:
        raise ValueError("exp_imgs must have the masks' shape")
    _, h, w = masks.shape
    angles = angles.to(torch.float32).contiguous()
    _check("angles", angles, torch.float32, 1)
    if angles.shape != (n,):
        raise ValueError(f"angles must be ({n},), got {tuple(angles.shape)}")
    klen, group = _lengths_per_mask(kernel_len, n)
    klen = klen.contiguous()
    _check("kernel_len", klen, torch.float32, 1)
    if not 1 <= probe_len <= 64:
        raise ValueError("probe_len must lie in [1, 64]")
    half = max(max_kernel // 2, 1)
    if half > 1 << 20:
        raise ValueError(f"max_kernel {max_kernel} is beyond the kernel's 2**21")
    if schedule_out is not None:
        _check("schedule_out", schedule_out, torch.int32, 2)
        if schedule_out.shape != (n, bridge_schedule_size(probe_len, max_kernel)):
            raise ValueError(f"schedule_out must be ({n}, {bridge_schedule_size(probe_len, max_kernel)})")
    plan = bridge_plan(n, h, w)
    out = torch.empty_like(masks)
    if plan.get("route") == "global":
        scratch = torch.empty(plan["scratch_ints"], dtype=torch.int32, device=masks.device)
        kernels.launch(
            "cpe_bridge_morphology_global",
            [masks, exp_imgs, angles, klen, out, schedule_out, scratch],
            [n, h, w, _BRIDGE_TYPES[masks.dtype], probe_len, half, group],
            [],
        )
    else:
        kernels.launch(
            "cpe_bridge_morphology",
            [masks, exp_imgs, angles, klen, out, schedule_out],
            [n, h, w, _BRIDGE_TYPES[masks.dtype], probe_len, half, group, plan["cluster"],
             plan["rows_per_cta"], plan["smem"]],
            [],
        )
    _LAUNCHES["bridge_morphology"] += 1
    return out


# Where each kernel's TPU original lives (file:line of its pallas_call's
# function), for reports.
REPLACES = {
    "preprocess_binarize": "cylinder_pose_estimation_tpu/ops/pallas/frontend.py:286",
    "connected_components": "cylinder_pose_estimation_tpu/ops/pallas/frontend.py:761",
    "bridge_morphology": "cylinder_pose_estimation_tpu/ops/pallas/frontend.py:475",
    "component_payload_minmax": "cylinder_pose_estimation_tpu/ops/pallas/frontend.py:711",
}
SOURCES = {
    "preprocess_binarize": "cylinder_pose_estimation_tpu_torch/csrc/preprocess.cu",
    "connected_components": "cylinder_pose_estimation_tpu_torch/csrc/connected_components.cu",
    "bridge_morphology": "cylinder_pose_estimation_tpu_torch/csrc/bridge.cu",
    "component_payload_minmax": "cylinder_pose_estimation_tpu_torch/csrc/connected_components.cu",
}


def min_bytes(name: str, n: int, h: int, w: int, warm: bool = False, itemsize: int = 4) -> int:
    """The bytes kernel ``name`` must move for an (n, h, w) call: each input
    plane read once and each output plane written once, ``itemsize`` bytes
    per element (1: the bridge's bool interface).  The bridge's per-mask
    angles and kernel lengths (8 B a mask) are left out.  ``warm``: the CC
    call reads a warm-start label plane too."""
    planes = {
        "preprocess_binarize": 1 + 6,               # smoothed -> six planes
        "connected_components": 2 + int(warm),      # mask (+ init) -> labels
        "bridge_morphology": 3,                     # masks, exps -> bridged
        "component_payload_minmax": 4,              # mask, payload -> min, max
    }[name]
    return itemsize * planes * n * h * w


__all__ = [
    "preprocess_binarize", "preprocess_binarize_plain", "preprocess_plan", "preprocess_reach",
    "connected_components", "connected_components_plain", "cc_plan", "cc_global_launches", "min_bytes",
    "bridge_morphology", "bridge_morphology_plain", "bridge_schedule", "bridge_schedule_size",
    "bridge_plan", "bridge_global_launches",
    "component_payload_minmax", "component_payload_minmax_plain",
    "launch_counts", "reset_launch_counts", "REPLACES", "SOURCES",
]
