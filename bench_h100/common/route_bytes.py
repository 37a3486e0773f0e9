"""The least bytes one call of a kernel moves on its large-frame route, for
the roofline shares of the full-HD cell (``common.roofline.bandwidth_share``
turns them into a share of the card's peak).  Counted from the kernels'
interfaces, each input read once and each output written once; the
scratch a route keeps in device memory (the CC band route's state plane
and edge tables) is not counted, since a kernel that held it on chip
would not move it.  Nothing of the program is imported."""

from __future__ import annotations

from bench_h100.common.roofline import F32

I32 = 4
BOOL = 1


def connected_components_bytes(n: int, h: int, w: int, warm: bool = True) -> int:
    """One ``connected_components`` call on (n, h, w) masks: the float32
    mask in, the int32 initial labels in (a warm start only) and the int32
    labels out."""
    px = n * h * w
    return px * (F32 + (I32 if warm else 0) + I32)


def bridge_morphology_bytes(n: int, h: int, w: int) -> int:
    """One ``bridge_morphology`` call on (n, h, w) bool masks: the mask and
    its expandable pixels in, the bridged mask out, one byte a pixel each
    (the per-mask angles and kernel lengths are a few bytes a mask)."""
    px = n * h * w
    return px * (BOOL + BOOL + BOOL)
