"""Binary rectangle morphology on (..., H, W) bool masks (the part of the JAX
package's ops/morphology.py that the cylinder detection path calls).

Border semantics follow the reference's ``reduce_window`` 'SAME' windows:
out-of-image pixels are ignored, i.e. they count as 0 for a dilation and as
1 for an erosion.  Even window sizes anchor as XLA pads them (the extra tap
on the high side).
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
