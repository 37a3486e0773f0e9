"""Binary morphology of the port (the JAX package's ops/morphology.py):
rectangle openings and closings on (..., H, W) bool masks, and the XLA
bridge's shifts, oriented line dilation and directional ray counts on (B, H,
W) batches with a traced angle (and length) per mask.

Rectangle border semantics follow the reference's ``reduce_window`` 'SAME'
windows: out-of-image pixels are ignored, i.e. they count as 0 for a
dilation and as 1 for an erosion.  Even window sizes anchor as XLA pads them
(the extra tap on the high side).  Shifts fill with zeros.  Offsets round
half to even (``jnp.round``), in the JAX code's float order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_reduce(mask: torch.Tensor, wy: int, wx: int, op: str) -> torch.Tensor:
    fill = 0.0 if op == "max" else 1.0
    x = mask.to(torch.float32)
    lead = x.shape[:-2]
    x = x.reshape((-1, 1) + x.shape[-2:])
    # 'SAME': total pad k-1, low side (k-1)//2.
    py0, px0 = (wy - 1) // 2, (wx - 1) // 2
    x = F.pad(x, (px0, wx - 1 - px0, py0, wy - 1 - py0), value=fill)
    if op == "max":
        y = F.max_pool2d(x, (wy, wx), stride=1)
    else:
        y = -F.max_pool2d(-x, (wy, wx), stride=1)
    return y.reshape(lead + y.shape[-2:])


def dilate_rect(mask: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    return _window_reduce(mask, wy, wx, "max") > 0.5


def erode_rect(mask: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    return _window_reduce(mask, wy, wx, "min") > 0.5


def open_rect(mask: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    return dilate_rect(erode_rect(mask, wy, wx), wy, wx)


def close_rect(mask: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    return erode_rect(dilate_rect(mask, wy, wx), wy, wx)


def shift2d(mask: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, fill: float = 0) -> torch.Tensor:
    """Shift each (H, W) image of a (B, H, W) batch by its own integer offset
    (dy, dx: (B,)): out[b, y, x] = mask[b, y - dy, x - dx] (positive dy
    moves content down, positive dx right), ``fill`` where that lies outside
    the image (the JAX ``shift2d``'s zeros; the Pallas ``_dshift``'s fill)."""
    b, h, w = mask.shape
    rows = torch.arange(h, device=mask.device)[None, :, None] - dy.to(torch.int64)[:, None, None]
    cols = torch.arange(w, device=mask.device)[None, None, :] - dx.to(torch.int64)[:, None, None]
    ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    src = (rows.clamp(0, h - 1) * w + cols.clamp(0, w - 1)).reshape(b, -1)
    out = mask.reshape(b, -1).gather(1, src).reshape(b, h, w)
    return torch.where(ok, out, torch.tensor(fill, dtype=mask.dtype, device=mask.device))


def dilate_line(mask: torch.Tensor, angle: torch.Tensor, max_length: int,
                length: torch.Tensor | None = None) -> torch.Tensor:
    """Dilation of (B, H, W) masks with a centred line kernel at a traced
    angle per mask, by logarithmic Minkowski doubling (step_k = covered + 1,
    no holes).  ``max_length`` is static; ``length`` (B,) optionally gives a
    shorter effective length per mask: each doubling step is clipped to the
    half-extent left, so surplus steps shift by 0."""
    ca = torch.cos(angle)
    sa = torch.sin(angle)
    out = mask
    half = max(max_length // 2, 1)
    if length is None:
        dyn_half = torch.full_like(ca, float(half))
    else:
        dyn_half = torch.clamp(length.to(torch.float32) / 2.0, 0.0, float(half))
    stride, covered = 1, 0
    dyn_covered = torch.zeros_like(dyn_half)
    while covered < half:
        step = min(stride, half - covered)
        eff = torch.clamp(dyn_half - dyn_covered, 0.0, float(step))
        dy = torch.round(sa * eff).to(torch.int32)
        dx = torch.round(ca * eff).to(torch.int32)
        out = out | shift2d(out, dy, dx) | shift2d(out, -dy, -dx)
        covered += step
        dyn_covered = dyn_covered + eff
        stride *= 2
    return out


def directional_count(mask: torch.Tensor, angle: torch.Tensor, probe_len: int, sign: int) -> torch.Tensor:
    """Per pixel of (B, H, W) masks, the mask pixels along ``sign`` times the
    direction of its (B,) angle within ``probe_len`` steps (float32), by
    Hillis-Steele doubling: C_2m = C_m + shift(C_m, -d(m)), the far halves
    offset by d(m) + d(k) (the JAX package's exact scheme)."""
    ca = torch.cos(angle)
    sa = torch.sin(angle)
    f = mask.to(torch.float32)
    if probe_len <= 0:
        return torch.zeros_like(f)

    def d(m):
        return torch.round(sa * m * sign).to(torch.int32), torch.round(ca * m * sign).to(torch.int32)

    dy1, dx1 = d(1)
    pows = {1: shift2d(f, -dy1, -dx1)}
    m = 1
    while m * 2 <= probe_len:
        dy, dx = d(m)
        pows[2 * m] = pows[m] + shift2d(pows[m], -dy, -dx)
        m *= 2
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
