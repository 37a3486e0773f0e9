"""The card's peak bandwidth and the least bytes a kernel moves, for the
roofline share of a bandwidth-bound kernel: the least time (bytes over
the peak bandwidth) over the measured time.

Peak: NVIDIA's H100 SXM data sheet, at the 700 W limit; a card set to a
lower power limit reaches less (the harness prints the limit beside every
run)."""

from __future__ import annotations

PEAK = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12},
}
F32 = 4


def peak(kind: str) -> dict:
    if kind not in PEAK:
        raise KeyError(f"no peak table for {kind!r}")
    return PEAK[kind]


def preprocess_binarize_bytes(n: int, h: int, w: int) -> int:
    """Bytes of one ``preprocess_binarize`` call on (n, h, w) views, from its
    interface (the JAX signature, cylinder_pose_estimation_tpu/ops/pallas/
    frontend.py:286): the float32 input plane read once and its six
    float32 output planes (binary, h and v openings, joints, joint count,
    joint peak) written once."""
    plane = n * h * w * F32
    return plane + 6 * plane


def bandwidth_share(nbytes: int, ms: float, kind: str) -> float:
    """Percent of the card's peak bandwidth that moving ``nbytes`` in
    ``ms`` milliseconds reaches."""
    least_s = nbytes / peak(kind)["bytes_per_s"]
    return 100.0 * least_s / (ms * 1e-3)
