"""Image helpers of the port: the part of the JAX package's ops/image.py that
the detection path and the undistortion (``ops/remap.py``) call."""

from __future__ import annotations

import torch


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
