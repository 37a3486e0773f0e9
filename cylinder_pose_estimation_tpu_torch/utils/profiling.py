"""Stage timing and traces (port of the JAX package's utils/profiling.py).

* ``stage_timer``: time ``fn(*make_args(i))`` over calls with a different
  input each, after warm-up, with every output fully materialised; on CUDA
  tensors the time comes from CUDA events around the calls, after a
  synchronisation.
* ``graph_kernels``: the CUDA kernels one call launches, counted from the
  kernel nodes of a CUDA graph captured from it, and the device ms of a
  replay of that graph by CUDA events.
* ``alternating_ms``: two or more callables timed in alternating turns by
  CUDA events (eager against replayed steps).
* ``trace``: a ``torch.profiler`` session that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import statistics
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


_CU_STREAM_CAPTURE_ACTIVE = 1
_CU_GRAPH_NODE_KERNEL = 0


def _driver_call(cu, name: str, *args) -> None:
    rc = getattr(cu, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA driver error {rc}")


def _capture_kernel_nodes(cu) -> int:
    """Kernel nodes of the graph the current stream is capturing, read
    through the driver (cuStreamGetCaptureInfo, cuGraphGetNodes,
    cuGraphNodeGetType) before the capture ends."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
    deps, ndeps, size = ctypes.c_void_p(), ctypes.c_size_t(), ctypes.c_size_t()
    _driver_call(cu, "cuStreamGetCaptureInfo_v2", stream, ctypes.byref(status), ctypes.byref(cid),
                 ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps))
    if status.value != _CU_STREAM_CAPTURE_ACTIVE:
        raise RuntimeError("the stream is not capturing")
    _driver_call(cu, "cuGraphGetNodes", graph, None, ctypes.byref(size))
    nodes = (ctypes.c_void_p * size.value)()
    _driver_call(cu, "cuGraphGetNodes", graph, nodes, ctypes.byref(size))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int()
        _driver_call(cu, "cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    return kinds.count(_CU_GRAPH_NODE_KERNEL)


def graph_kernels(fn: Callable, reps: int = 20, warmup: int = 3) -> Tuple[int, float]:
    """(CUDA kernels one ``fn()`` call launches, median device ms of a
    replay of them) on the current CUDA device.

    ``fn`` runs once, then once more under CUDA graph capture; the count is
    the captured graph's kernel nodes (memory copies and sets are other
    node types), and the time comes from CUDA events around ``reps``
    replays of that graph, one at a time after ``warmup``: the device's
    time for the call's work with no host launch path.  Unlike a
    ``torch.profiler`` session, which late in a long process may record
    nothing, neither number depends on the process's history.  A call that
    cannot be captured (one that synchronises with the host) raises."""
    cu = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
        n_kernels = _capture_kernel_nodes(cu)
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return n_kernels, statistics.median(times)


def alternating_ms(fns: dict, pairs: int, warmup: int = 2) -> dict:
    """Median CUDA-event ms of each ``fn()`` of ``fns``, called in turns
    (a, b, b, a, ...) ``pairs`` times each after ``warmup`` calls each (two
    by default: a compiled step's first call is eager and its second
    captures its graph, so the timed calls are replays)."""
    names = list(fns)
    for _ in range(warmup):
        for n in names:
            fns[n]()
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    for i in range(pairs):
        for n in (names if i % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[n]()
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end))
    return {n: statistics.median(t) for n, t in times.items()}


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
