"""Constant tensors made once per (value, dtype, device).

A ``torch.tensor(value, device=cuda)`` built in every call copies from
pageable host memory, which synchronises with the host and which a CUDA
graph capture refuses.  The port's compiled steps (``models/pipeline.py``)
capture whole entry points, so every constant their ops need comes from
here: made on first use (the eager warm-up call before a capture), then
the same device tensor in every later call.  The values are those the
per-call ``torch.tensor`` gave, so the arithmetic is bit-equal.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _cached(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # A normal tensor even when first asked for under inference mode: the
    # registration's forward-mode AD takes these constants too.
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once and
    shared: a Python number or a (nested) sequence of them.  The caller must
    not write to it.  The cache is unbounded; its keys are the port's fixed
    constants (filter taps, divisors, kinematic lengths), a few dozen."""
    if not isinstance(values, (int, float, bool)):
        values = _frozen(values)
    return _cached(values, dtype, torch.device(device))


def _frozen(values):
    """A (nested) sequence or array of numbers as nested tuples (hashable)."""
    if hasattr(values, "tolist"):
        values = values.tolist()
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values
