"""Image helpers of the port (the part of the JAX package's ops/image.py that
the cylinder detection path calls)."""

from __future__ import annotations

import torch


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor BGR2GRAY weights on a (..., H, W, 3) image."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r
