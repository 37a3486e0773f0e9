"""Image helpers of the port (the JAX package's ops/image.py): grey
conversion, sampling for the undistortion (``ops/remap.py``), and the
padded separable filters, Gaussians, box filter and gradients of the XLA
detection branch (``ops/ridge.py``).  Every function takes leading batch
axes.

The filters add in the JAX code's order: ``sep_filter2d`` sums its taps in
index order, rows then columns; ``box_filter`` takes its prefix sums in the
order XLA's CPU backend runs ``jnp.cumsum`` (``cumsum_blocked``), so the
port equals the JAX package bit for bit on the CPU and runs the same
additions on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.constants import device_constant
from ..ops.mxu_conv import gauss_taps_cv, gauss_taps_scipy

_PAD_MODES = {"reflect101": "reflect", "edge": "replicate", "constant": "constant"}


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device: PyTorch's CUDA division by
    a Python number multiplies by the float32 reciprocal instead, which
    differs from the CPU (and the JAX package) in the last bit.  The divisor
    tensor is made once per (d, dtype, device)."""
    return x / device_constant(d, x.dtype, x.device)


def _cumsum_seq(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis, one float32 add at a time."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def cumsum_blocked(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the order XLA's CPU backend
    uses for ``jnp.cumsum``: sequential scans within blocks of ``base``, the
    block totals scanned the same way, their exclusive prefix added to each
    block.  Bit-identical to the JAX package on the CPU, and the same on
    every device (``torch.cumsum`` accumulates in float64 on the CPU and in
    a parallel order on the GPU)."""
    n = x.shape[-1]
    if n <= base:
        return _cumsum_seq(x)
    pad = -n % base
    if pad:  # trailing zeros leave every prefix unchanged
        x = F.pad(x, (0, pad))
    blocks = _cumsum_seq(x.reshape(x.shape[:-1] + (-1, base)))
    totals = cumsum_blocked(blocks[..., -1], base)
    before = F.pad(totals[..., :-1], (1, 0))
    return (blocks + before[..., None]).flatten(-2)[..., :n]


def pad2d(img: torch.Tensor, ry: int, rx: int, mode: str) -> torch.Tensor:
    """Pad (..., H, W) images by (ry, rx) on each side: 'reflect101' (cv2's
    default, the edge pixel not repeated), 'edge' (cv2 BORDER_REPLICATE) or
    'constant' (zeros)."""
    if mode not in _PAD_MODES:
        raise ValueError(f"unknown pad mode {mode}")
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.reshape((-1, 1, h, w))
    if mode == "constant":
        x = F.pad(x, (rx, rx, ry, ry))
    else:
        x = F.pad(x, (rx, rx, ry, ry), mode=_PAD_MODES[mode])
    return x.reshape(lead + x.shape[-2:])


def _taps(k, dtype, device) -> torch.Tensor:
    """Filter taps as a float32 vector, then in the image's type (as the JAX
    code casts them); made once per (taps, dtype, device)."""
    return device_constant(k, torch.float32, device).to(dtype)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors with one rounding, as a fused
    multiply-add: the product is exact in float64, the sum is rounded to
    float64 and then to float32 (the two roundings part only on a float32
    tie, a chance near 2^-29).  XLA's CPU backend contracts the JAX
    package's tap multiply-adds into fused multiply-adds; separate torch ops
    would round twice.  The same float64 ops run on the card."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def sep_filter2d(img: torch.Tensor, ky, kx, mode: str = "reflect101") -> torch.Tensor:
    """Separable correlation (cv2.sepFilter2D): rows with ``kx``, then
    columns with ``ky``, each a sum of shifted slices in tap order, in the
    image's type.  A float32 image accumulates by fused multiply-adds
    (``fma32``'s arithmetic: the float64 product of two float32 values is
    exact, so one float64 add and one rounding to float32 per tap), the JAX
    package's arithmetic on the CPU; bfloat16 rounds after every operation,
    as it does there."""
    ky = _taps(ky, img.dtype, img.device)
    kx = _taps(kx, img.dtype, img.device)
    ry, rx = ky.shape[0] // 2, kx.shape[0] // 2
    h, w = img.shape[-2:]
    p = pad2d(img, ry, rx, mode)
    if img.dtype != torch.float32:
        out = torch.zeros_like(p[..., :, :w])
        for i in range(kx.shape[0]):
            out = out + kx[i] * p[..., :, i:i + w]
        acc = torch.zeros_like(out[..., :h, :])
        for j in range(ky.shape[0]):
            acc = acc + ky[j] * out[..., j:j + h, :]
        return acc
    # fma32 per tap, with the image and the taps widened once per pass.
    f64 = torch.float64
    kx, ky, p = kx.to(f64), ky.to(f64), p.to(f64)
    out = torch.zeros_like(p[..., :, :w], dtype=torch.float32)
    for i in range(kx.shape[0]):
        out = torch.addcmul(out.to(f64), p[..., :, i:i + w], kx[i]).to(torch.float32)
    out = out.to(f64)
    acc = torch.zeros_like(out[..., :h, :], dtype=torch.float32)
    for j in range(ky.shape[0]):
        acc = torch.addcmul(acc.to(f64), out[..., j:j + h, :], ky[j]).to(torch.float32)
    return acc


def gaussian_kernel1d_cv(ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.getGaussianKernel's taps (``mxu_conv.gauss_taps_cv``), float32."""
    return torch.tensor(gauss_taps_cv(ksize, sigma), dtype=torch.float32)


def gaussian_blur_cv(img: torch.Tensor, ksize: int, sigma: float = 0.0,
                     mode: str = "reflect101") -> torch.Tensor:
    """cv2.GaussianBlur equivalent (square kernel, default border)."""
    k = gauss_taps_cv(ksize, sigma)
    return sep_filter2d(img, k, k, mode)


def gaussian_kernel1d_scipy(sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter's taps (``mxu_conv.gauss_taps_scipy``),
    float32."""
    return torch.tensor(gauss_taps_scipy(sigma, truncate), dtype=torch.float32)


def gaussian_blur_scipy(img: torch.Tensor, sigma: float, mode: str = "constant",
                        truncate: float = 4.0) -> torch.Tensor:
    """scipy/skimage-style Gaussian of radius round(truncate * sigma)."""
    k = gauss_taps_scipy(sigma, truncate)
    return sep_filter2d(img, k, k, mode)


def box_filter(img: torch.Tensor, ksize: int, mode: str = "edge", normalize: bool = True) -> torch.Tensor:
    """cv2.boxFilter equivalent: the padded image's float32 prefix sums along
    rows, then columns, differenced at ``ksize``; scaled by the float32
    1 / ksize^2 when ``normalize`` (XLA turns the JAX code's division by a
    constant into that product); in the image's type."""
    r = ksize // 2
    h, w = img.shape[-2:]
    p = pad2d(img, r, r, mode).to(torch.float32)

    def box_last(x, n_out):
        cs = F.pad(cumsum_blocked(x), (1, 0))
        return cs[..., ksize:ksize + n_out] - cs[..., :n_out]

    out = box_last(p, w)
    out = box_last(out.transpose(-1, -2), h).transpose(-1, -2)
    if normalize:
        out = out * device_constant(1.0 / (ksize * ksize), torch.float32, out.device)
    return out.to(img.dtype)


def gradient2d(img: torch.Tensor):
    """np.gradient of (..., H, W) images: central differences inside,
    one-sided at the two borders.  Returns (d/drow, d/dcol)."""

    def grad_axis(x, dim):
        n = x.shape[dim]
        g = (torch.roll(x, -1, dim) - torch.roll(x, 1, dim)) * 0.5
        first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
        last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
        shape = [1] * x.dim()
        shape[dim] = n
        idx = torch.arange(n, device=x.device).reshape(shape)
        g = torch.where(idx == 0, first, g)
        return torch.where(idx == n - 1, last, g)

    return grad_axis(img, -2), grad_axis(img, -1)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor BGR2GRAY weights on a (..., H, W, 3) image."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (..., H, W) images at float pixel coords (x, y),
    clamped to the image; the coordinates are shared by every image of the
    leading axes."""
    h, w = img.shape[-2:]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = x - x0
    fy = y - y0
    v00 = img[..., y0, x0]
    v01 = img[..., y0, x0 + 1]
    v10 = img[..., y0 + 1, x0]
    v11 = img[..., y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _keys(t: torch.Tensor):
    """Keys cubic-convolution weights (a = -0.5) of the taps at offsets
    -1, 0, 1, 2 for fraction t."""
    a = -0.5
    t2 = t * t
    t3 = t2 * t
    w_m1 = a * (t3 - 2 * t2 + t)
    w_0 = (a + 2) * t3 - (a + 3) * t2 + 1
    w_p1 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w_p2 = a * (t2 - t3)
    return w_m1, w_0, w_p1, w_p2


def cubic_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bicubic-convolution (Catmull-Rom, MATLAB's 'cubic') sample of
    (..., H, W) images at float pixel coords (x, y), shared by every image.

    The base tap is clamped to [1, w-3] x [1, h-3] as in the JAX package, so
    within ~2 px of the border the sample is not an interpolation of the
    pixel it lands on: the fraction runs outside [0, 1] and the stencil
    extrapolates from the nearest interior 4x4 block.  Kept as it is there."""
    h, w = img.shape[-2:]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 1, w - 3)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 1, h - 3)
    wx = _keys(x - x0)
    wy = _keys(y - y0)
    out = torch.zeros(img.shape[:-2] + x.shape, dtype=img.dtype, device=img.device)
    for j, wyj in enumerate(wy):
        row = torch.zeros_like(out)
        for i, wxi in enumerate(wx):
            row = row + wxi * img[..., y0 + (j - 1), x0 + (i - 1)]
        out = out + wyj * row
    return out


def patch_mean_at(img_boxmean: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """A precomputed box-mean image (H, W) read at the nearest pixel of each
    point (..., 2) (x, y), clipped to the image; -inf at invalid points.  A
    NaN coordinate reads pixel 0 and an infinite one the border, as XLA's
    saturating float-to-int conversion does."""
    h, w = img_boxmean.shape

    def index(v, n):
        return torch.nan_to_num(torch.round(v), nan=0.0).clamp(0, n - 1).to(torch.int64)

    vals = img_boxmean[index(xy[..., 1], h), index(xy[..., 0], w)]
    return torch.where(valid, vals, device_constant(-torch.inf, vals.dtype, vals.device))
