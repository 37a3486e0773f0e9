"""Banded-matrix separable correlations (port of the JAX package's
ops/mxu_conv.py).

Plain matrix products: the CPU route and the XLA branch's.  On the card
the kernel branch computes the same correlations over the bands' taps
alone (``ops/stencils``: ``csrc/stencils.cu``), with the operand precision
below and another summation order.  The numerics are kept: the default
mode rounds BOTH operands to bfloat16 and multiplies them in float32 (a
product of two bf16 values is exact in f32, so only the summation order can
differ from the reference); ``exact=True`` keeps float32 operands (TF32 is
off, see ``linalg.exact_float32``).  Zero padding at the borders, as in the
reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_CV_SMALL_GAUSSIAN = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


def box_taps(n: int) -> tuple:
    return (1.0,) * n


def ramp_taps(n: int) -> tuple:
    r = n // 2
    return tuple(float(t - r) for t in range(n))


def gauss_taps_cv(ksize: int, sigma: float = 0.0) -> tuple:
    """cv2.getGaussianKernel taps (the fixed table for ksize <= 7)."""
    if sigma <= 0 and ksize in _CV_SMALL_GAUSSIAN:
        return _CV_SMALL_GAUSSIAN[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / k.sum()
    return tuple(float(v) for v in k)


def gauss_taps_scipy(sigma: float, truncate: float = 4.0) -> tuple:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(2 * radius + 1) - radius
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / k.sum()
    return tuple(float(v) for v in k)


def compose_taps(a: tuple, b: tuple) -> tuple:
    return tuple(
        float(v) for v in np.convolve(np.asarray(a, np.float64), np.asarray(b, np.float64))
    )


@functools.lru_cache(maxsize=64)
def _band_np(taps: tuple, n: int) -> np.ndarray:
    assert len(taps) % 2 == 1, "band matrices need an odd tap count"
    r = len(taps) // 2
    m = np.zeros((n, n), np.float32)
    for t, v in enumerate(taps):
        off = t - r
        d = np.arange(max(0, -off), min(n, n - off))
        m[d + off, d] = v
    return m


_BAND_CACHE: dict = {}


def band_matrix(taps: tuple, n: int, exact: bool, device) -> torch.Tensor:
    """(n, n) float32 matrix B with B[j, i] = taps[j - i + r]; in the default
    mode its entries are rounded to bf16 once (stored back as float32)."""
    key = (tuple(taps), n, exact, str(device))
    m = _BAND_CACHE.get(key)
    if m is None:
        m = torch.from_numpy(_band_np(tuple(taps), n)).to(device)
        if not exact:
            m = m.to(torch.bfloat16).to(torch.float32)
        _BAND_CACHE[key] = m
    return m


def x_mat(taps: tuple, w: int, device, exact: bool = False) -> torch.Tensor:
    return band_matrix(tuple(taps), w, exact, device)


def y_mat(taps: tuple, h: int, device, exact: bool = False) -> torch.Tensor:
    return band_matrix(tuple(taps)[::-1], h, exact, device)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def conv_x(img: torch.Tensor, bmat: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Correlate along the last axis: img (..., H, W) @ bmat (W, W)."""
    img = img.to(torch.float32)
    if exact:
        return torch.matmul(img, bmat)
    return torch.matmul(_bf16(img), _bf16(bmat))


def conv_y(img: torch.Tensor, amat: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Correlate along axis -2: amat (H, H) @ img (..., H, W)."""
    img = img.to(torch.float32)
    if exact:
        return torch.matmul(amat, img)
    return torch.matmul(_bf16(amat), _bf16(img))


def _taps_rows(idx: torch.Tensor, taps: tuple, n: int) -> torch.Tensor:
    """(..., P, n): row p holds ``taps`` centred at column idx[..., p]."""
    r = len(taps) // 2
    jj = torch.arange(n, dtype=torch.int32, device=idx.device)
    off = jj - idx.to(torch.int32)[..., None] + r
    first = taps[0]
    if all(t == first for t in taps):
        return torch.where((off >= 0) & (off < len(taps)), float(first), 0.0)
    out = torch.zeros(off.shape, dtype=torch.float32, device=idx.device)
    for t, v in enumerate(taps):
        out = out + torch.where(off == t, v, 0.0)
    return out


def conv_at_points(
    img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, taps: tuple
) -> torch.Tensor:
    """Separable correlation of img (..., H, W) with ``taps`` evaluated at
    integer points (ys, xs) (..., P) -> (..., P)."""
    h, w = img.shape[-2:]
    u = _taps_rows(ys, taps, h)
    m = torch.matmul(u, img.to(torch.float32))
    v = _taps_rows(xs, taps, w)
    return torch.sum(m * v, dim=-1)


def range_mean_at_points(
    img: torch.Tensor,
    y0: torch.Tensor,
    y1: torch.Tensor,
    x0: torch.Tensor,
    x1: torch.Tensor,
) -> torch.Tensor:
    """Mean of img[..., y0:y1, x0:x1) per point (traced bounds), -inf where
    the rectangle is empty."""
    h, w = img.shape[-2:]

    def rows(lo, hi, n):
        jj = torch.arange(n, dtype=torch.int32, device=img.device)
        return ((jj >= lo[..., None]) & (jj < hi[..., None])).to(torch.float32)

    u = rows(y0, y1, h)
    m = torch.matmul(u, img.to(torch.float32))
    v = rows(x0, x1, w)
    sums = torch.sum(m * v, dim=-1)
    area = ((y1 - y0) * (x1 - x0)).to(torch.float32)
    return torch.where(area > 0, sums / torch.clamp(area, min=1.0), float("-inf"))
