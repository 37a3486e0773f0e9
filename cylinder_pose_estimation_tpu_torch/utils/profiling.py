"""Stage timing and traces (port of the JAX package's utils/profiling.py).

* ``stage_timer``: time ``fn(*make_args(i))`` over calls with a different
  input each, after warm-up, with every output fully materialised; on CUDA
  tensors the time comes from CUDA events around the calls, after a
  synchronisation.
* ``trace``: a ``torch.profiler`` session that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _materialise(out) -> None:
    """Copy every tensor of an output tree to the host (waits for it)."""
    for t in _leaves(out):
        t.detach().cpu()


def stage_timer(
    fn: Callable,
    make_args: Callable[[int], Tuple],
    n_calls: int = 8,
    warmup: int = 1,
) -> dict:
    """Time ``fn(*make_args(i))`` for i in range(n_calls).

    ``make_args`` must give different argument values for each i (the
    warm-up calls use i = -1, -2, ...).  Returns the total and mean seconds
    and the device the time was taken on: CUDA events around the calls when
    the arguments hold a CUDA tensor, else the host clock; either way the
    outputs are copied to the host inside the timed region."""
    for i in range(warmup):
        _materialise(fn(*make_args(-1 - i)))
    args = [make_args(i) for i in range(n_calls)]
    cuda = [t.device for t in _leaves(args) if t.device.type == "cuda"]
    if cuda:
        dev = cuda[0]
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        outs = [fn(*a) for a in args]
        for o in outs:
            _materialise(o)
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        total = start.elapsed_time(end) / 1e3
        device = torch.cuda.get_device_name(dev)
    else:
        t0 = time.perf_counter()
        outs = [fn(*a) for a in args]
        for o in outs:
            _materialise(o)
        total = time.perf_counter() - t0
        device = "cpu"
    return {"total_s": total, "avg_s": total / n_calls, "n_calls": n_calls, "device": device}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host and, where there is one, the CUDA device) and
    write ``logdir/trace.json``, a Chrome trace (chrome://tracing or
    Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
