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

from typing import Dict, Tuple

import torch

from cylinder_pose_estimation_tpu_torch.ops import kernels
from cylinder_pose_estimation_tpu_torch.ops.labeling import peak_key_shift

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
    ``preprocess_binarize_plain`` for the outputs)."""
    args = dict(
        sauvola_window=sauvola_window, sauvola_k=sauvola_k, sauvola_r=sauvola_r,
        min_contrast=min_contrast, line_len=line_len, margin=margin,
        joint_window=joint_window, joint_peak_iters=joint_peak_iters,
    )
    if not _route(smoothed):
        return preprocess_binarize_plain(smoothed, **args)
    _check("smoothed", smoothed, torch.float32, 3)
    n, h, w = smoothed.shape
    if sauvola_window % 2 != 1 or joint_window % 2 != 1 or sauvola_window > 15 or joint_window > 15:
        raise ValueError("box windows must be odd and at most 15")
    shift = peak_key_shift(h, w, joint_window)
    outs = [torch.empty_like(smoothed) for _ in range(6)]
    scratch_f = [torch.empty_like(smoothed) for _ in range(3)]
    scratch_i = [torch.empty(smoothed.shape, dtype=torch.int32, device=smoothed.device)
                 for _ in range(2)]
    kernels.launch(
        "cpe_preprocess_binarize",
        [smoothed, *outs, *scratch_f, *scratch_i],
        [n, h, w, sauvola_window, line_len, margin, joint_window, joint_peak_iters, shift],
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
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    tmp = torch.empty_like(out)
    kernels.launch(
        "cpe_connected_components",
        [mask, init_labels, out, tmp],
        [n, h, w, rounds, pools_per_round],
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
    The payload has the mask's shape; values must lie in [0, H*W)."""
    if not _route(mask):
        return component_payload_minmax_plain(mask, payload, rounds, pools_per_round)
    mask = mask.to(torch.float32).contiguous()
    payload = payload.to(torch.int32).contiguous()
    _check("mask", mask, torch.float32, 3)
    _check("payload", payload, torch.int32, 3)
    if payload.shape != mask.shape:
        raise ValueError("payload must have the mask's shape")
    n, h, w = mask.shape
    pmin = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    pmax = torch.empty_like(pmin)
    tmin = torch.empty_like(pmin)
    tmax = torch.empty_like(pmin)
    kernels.launch(
        "cpe_component_payload_minmax",
        [mask, payload, pmin, pmax, tmin, tmax],
        [n, h, w, rounds, pools_per_round],
        [],
    )
    _LAUNCHES["component_payload_minmax"] += 1
    return pmin, pmax


# --------------------------------------------------------------------------
# 2.3 bridge morphology: endpoint ray counts -> oriented line dilation ->
#     3x3 dilation -> closing-style combine, per mask with a traced angle
# --------------------------------------------------------------------------


def bridge_schedule(
    angles: torch.Tensor, kernel_len: torch.Tensor, probe_len: int, max_kernel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-mask integer offsets shared by the kernel and its plain version.

    ray: (N, 2, probe_len + 1, 2) int32, [:, s, k] = (round(sin a * k * sgn),
    round(cos a * k * sgn)) for sgn = +1 (s=0) and -1 (s=1).
    line: (N, S, 2) int32, the line-dilation doubling steps (dy, dx) with the
    traced effective length.  Rounding is half to even, as ``jnp.round``."""
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
    klen = torch.broadcast_to(kernel_len.to(torch.float32), angles.shape)
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


def _dshift(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """out[b, y, x] = x[b, y - dy[b], x - dx[b]], ``fill`` where that is
    outside the image (the Pallas ``_dshift``)."""
    n, h, w = x.shape
    rows = torch.arange(h, device=x.device)[None, :, None] - dy.to(torch.int64)[:, None, None]
    cols = torch.arange(w, device=x.device)[None, None, :] - dx.to(torch.int64)[:, None, None]
    ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    src = (rows.clamp(0, h - 1) * w + cols.clamp(0, w - 1)).reshape(n, -1)
    y = x.reshape(n, -1).gather(1, src).reshape(n, h, w)
    return torch.where(ok, y, fill)


def bridge_morphology_plain(
    masks: torch.Tensor,
    exp_imgs: torch.Tensor,
    angles: torch.Tensor,
    kernel_len: torch.Tensor,
    probe_len: int,
    max_kernel: int,
) -> torch.Tensor:
    """Plain version of the bridge kernel: (N, H, W) float 0/1 masks and
    expandability images, (N,) angles, () or (N,) kernel length -> bridged
    (N, H, W) float masks."""
    ray, line = bridge_schedule(angles, kernel_len, probe_len, max_kernel)
    m = masks.to(torch.float32)
    expf = exp_imgs.to(torch.float32)

    def ray_count(s):
        def d(k):
            return ray[:, s, k, 0], ray[:, s, k, 1]

        dy1, dx1 = d(1)
        pows = {1: _dshift(m, -dy1, -dx1)}
        mm = 1
        while mm * 2 <= probe_len:
            dy, dx = d(mm)
            pows[2 * mm] = pows[mm] + _dshift(pows[mm], -dy, -dx)
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
                part = _dshift(pows[p], -dy, -dx)
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
        out = torch.maximum(out, torch.maximum(_dshift(out, dy, dx), _dshift(out, -dy, -dx)))
    zero = torch.zeros_like(line[:, 0, 0])
    one = torch.ones_like(zero)
    g1 = torch.maximum(out, torch.maximum(_dshift(out, zero, one), _dshift(out, zero, -one)))
    grown = torch.maximum(g1, torch.maximum(_dshift(g1, one, zero), _dshift(g1, -one, zero)))
    u = torch.maximum(m, grown)
    e1 = torch.minimum(u, torch.minimum(_dshift(u, zero, one, 1.0), _dshift(u, zero, -one, 1.0)))
    er = torch.minimum(e1, torch.minimum(_dshift(e1, one, zero, 1.0), _dshift(e1, -one, zero, 1.0)))
    return torch.maximum(m, er * grown)


def bridge_morphology(
    masks: torch.Tensor,
    exp_imgs: torch.Tensor,
    angles: torch.Tensor,
    kernel_len: torch.Tensor,
    probe_len: int,
    max_kernel: int,
) -> torch.Tensor:
    """Bridge kernel over (N, H, W) masks (see ``bridge_morphology_plain``)."""
    if not _route(masks):
        return bridge_morphology_plain(masks, exp_imgs, angles, kernel_len, probe_len, max_kernel)
    masks = masks.to(torch.float32).contiguous()
    exp_imgs = exp_imgs.to(torch.float32).contiguous()
    _check("masks", masks, torch.float32, 3)
    _check("exp_imgs", exp_imgs, torch.float32, 3)
    if exp_imgs.shape != masks.shape:
        raise ValueError("exp_imgs must have the masks' shape")
    n, h, w = masks.shape
    if angles.shape != (n,):
        raise ValueError(f"angles must be ({n},), got {tuple(angles.shape)}")
    if probe_len < 1 or probe_len > 64:
        raise ValueError("probe_len must lie in [1, 64]")
    smem = 2 * h * w
    if smem > kernels.MAX_DYNAMIC_SMEM:
        raise ValueError(f"{h}x{w} masks need {smem} B of shared memory (max {kernels.MAX_DYNAMIC_SMEM})")
    ray, line = bridge_schedule(angles, kernel_len, probe_len, max_kernel)
    out = torch.empty_like(masks)
    kernels.launch(
        "cpe_bridge_morphology",
        [masks, exp_imgs, ray, line, out],
        [n, h, w, probe_len, line.shape[1]],
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
    "component_payload_minmax": "cylinder_pose_estimation_tpu_torch/csrc/payload_minmax.cu",
}

__all__ = [
    "preprocess_binarize", "preprocess_binarize_plain",
    "connected_components", "connected_components_plain",
    "bridge_morphology", "bridge_morphology_plain", "bridge_schedule",
    "component_payload_minmax", "component_payload_minmax_plain",
    "launch_counts", "reset_launch_counts", "REPLACES", "SOURCES",
]
