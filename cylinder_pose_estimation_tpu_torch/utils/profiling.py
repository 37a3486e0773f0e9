"""Stage timing, traces, and the program's spans and counters (port of the
JAX package's utils/profiling.py, plus the port's own registry).

* ``stage_timer``: time ``fn(*make_args(i))`` over calls with a different
  input each, after warm-up, with every output fully materialised; on CUDA
  tensors the time comes from CUDA events around the calls, after a
  synchronisation.
* ``graph_kernels``: the CUDA kernels one call launches, counted from the
  kernel nodes of a CUDA graph captured from it, and the device ms of a
  replay of that graph by CUDA events.
* ``trace``: a ``torch.profiler`` session that writes a Chrome trace; the
  program's spans appear in it as ranges of the same names.
* The registry: ``span`` (a named host interval with its parent, call and
  thread, and, given a CUDA tensor, the device ms between two events on
  its stream), ``count`` (named integer counters, always on), ``enable`` /
  ``disable`` / ``enabled``, ``records``, ``counters``, ``flush`` and
  ``reset``.  Tracing is off by default: a span then costs one flag check
  (two while a ``torch.profiler`` session runs, when it opens a
  ``record_function`` range of its name whatever the flag).  Span times
  are ``time.time_ns()``, the Unix epoch in ns, which is the clock of the
  profiler's events.

Device times are read lazily: the events of a span are kept pending and
read once ``query()`` says they have completed (``poll``, which the
compiled steps call at every call) or, waiting for them, at ``flush``.  A
span recorded inside a CUDA graph capture puts its two events into the
graph (``external=True`` event-record nodes); each replay of that graph
then gives a record of its own (``replayed``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import os
import statistics
import threading
import time
from typing import Callable, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


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
    """Kernel nodes of the graph the current stream is capturing."""
    return _capture_node_kinds(cu).count(_CU_GRAPH_NODE_KERNEL)


def _capture_node_kinds(cu) -> list:
    """Node types (``CUgraphNodeType``) of the graph the current stream is
    capturing, read through the driver (cuStreamGetCaptureInfo,
    cuGraphGetNodes, cuGraphNodeGetType) before the capture ends."""
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
    return kinds


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


# ---------------------------------------------------------------------------
# The registry: spans and counters
# ---------------------------------------------------------------------------

_ON = False
_LOCK = threading.Lock()
_COUNTS: collections.Counter = collections.Counter()
_RECORDS: list = []
# [record, start event, end event, owner]: device times not read yet; owner
# is the graph step whose replays record the events again, or None.
_PENDING: list = []
_IDS = itertools.count(1)
# Per thread: .stack, the open spans; .capture, the timed spans of the CUDA
# graph being captured (``graph_stages``).
_LOCAL = threading.local()
_NULL = contextlib.nullcontext()


def enable() -> None:
    """Turn tracing on: spans are recorded from now on."""
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _LOCK:
        _COUNTS[name] += n


def counters(prefix: str = "") -> dict:
    """{name: n} of the counters whose names start with ``prefix``."""
    with _LOCK:
        return {k: v for k, v in _COUNTS.items() if k.startswith(prefix)}


def reset_counters(prefix: str) -> None:
    with _LOCK:
        for k in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[k]


def records() -> list:
    """The finished spans in the order they ended, as dicts: ``id``,
    ``name``, ``start`` and ``end`` (ns, Unix epoch), ``parent`` (id or
    None), ``call`` (the id of the span's top-level span), ``thread``
    (name) and ``attrs`` (``device_ms`` once read)."""
    with _LOCK:
        return [dict(r, attrs=dict(r["attrs"])) for r in _RECORDS]


def reset() -> None:
    """Forget every record and pending device time, and the ``sync.*``
    counters.  The launch counters (``kernel.*``, ``graph.*``,
    ``step.replay``) are cleared only by their own resets
    (``ops.kernels.reset_launch_counts``,
    ``models.pipeline.reset_graph_launch_counts``)."""
    with _LOCK:
        _RECORDS.clear()
        _PENDING.clear()
    reset_counters("sync.")


def now() -> int:
    """The spans' clock: ns since the Unix epoch."""
    return time.time_ns()


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def current():
    """The innermost open span of this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def _new_record(name: str, start: int, up: Optional[dict], attrs: dict) -> dict:
    rid = next(_IDS)
    return {"id": rid, "name": name, "start": start, "end": start, "parent": up["id"] if up else None,
            "call": up["call"] if up else rid, "thread": threading.current_thread().name, "attrs": attrs}


def _finish(rec: dict) -> None:
    with _LOCK:
        _RECORDS.append(rec)


def _pend(rec: dict, start, end, owner=None) -> None:
    with _LOCK:
        _PENDING.append([rec, start, end, owner])


def _capturing() -> Optional[bool]:
    """Whether the current stream is capturing a graph: True inside a
    capture that collects its timed spans (``graph_stages``), None inside
    any other (whose graph nobody reads: no event goes into it), else
    False."""
    if not torch.cuda.is_current_stream_capturing():
        return False
    return True if getattr(_LOCAL, "capture", None) is not None else None


def _event(like: torch.Tensor, capturing: bool):
    """A timing event recorded now on the current stream of ``like``'s
    device; inside a capture an event-record node of the graph."""
    ev = torch.cuda.Event(enable_timing=True, external=capturing)
    ev.record(torch.cuda.current_stream(like.device))
    return ev


class _Span:
    __slots__ = ("name", "parent", "like", "attrs", "range", "record", "start_event", "capturing")

    def __init__(self, name, parent, like, attrs):
        self.name, self.parent, self.like, self.attrs = name, parent, like, attrs
        self.range = self.record = self.start_event = None

    def __enter__(self):
        start = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        if _ON:
            stack = _stack()
            up = self.parent if self.parent is not None else (stack[-1] if stack else None)
            self.record = _new_record(self.name, start, getattr(up, "record", None), self.attrs)
            stack.append(self)
            if self.like is not None and self.like.is_cuda:
                self.capturing = _capturing()
                if self.capturing is not None:
                    self.start_event = _event(self.like, self.capturing)
        return self

    def __exit__(self, *exc):
        rec = self.record
        if rec is not None:
            stack = _stack()
            if self in stack:
                del stack[stack.index(self):]
            if self.start_event is not None:
                end_event = _event(self.like, self.capturing)
                if self.capturing:
                    _LOCAL.capture.append((rec["id"], rec["parent"], self.name, self.start_event, end_event,
                                           self.attrs))
                else:
                    _pend(rec, self.start_event, end_event)
        if self.range is not None:
            self.range.__exit__(*exc)
        if rec is not None:
            rec["end"] = time.time_ns()
            _finish(rec)
        return False


def span(name: str, parent=None, like: Optional[torch.Tensor] = None, **attrs):
    """A context manager: the host interval of the block as a record of
    ``name`` with ``attrs``, its parent the innermost open span of this
    thread or ``parent`` (a span of another thread: its call id carries
    over).  With ``like``, a CUDA tensor, the block's device ms on the
    current stream of its device as well (``attrs["device_ms"]``).  While
    a ``torch.profiler`` session runs, also a ``record_function`` range of
    the same name, with tracing on or off.  With neither, it does nothing."""
    if not (_ON or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, parent, like, attrs)


def add(name: str, start: int, end: int, parent=None, **attrs) -> None:
    """Record a span whose interval was taken by hand (one that starts and
    ends in different threads); ``parent`` a span object or None."""
    if _ON:
        rec = _new_record(name, start, getattr(parent, "record", None), attrs)
        rec["end"] = end
        _finish(rec)


def device_event(like: torch.Tensor):
    """With tracing on, a timing event recorded now on the current stream
    of a CUDA tensor's device; else None."""
    if _ON and like.is_cuda:
        capturing = _capturing()
        if capturing is not None:
            return _event(like, capturing)
    return None


def time_device(target, start, end, owner=None) -> None:
    """Set ``target``'s (an open span's) ``device_ms`` from two events,
    once they have completed."""
    if start is not None and getattr(target, "record", None) is not None:
        _pend(target.record, start, end, owner)


@contextlib.contextmanager
def graph_stages():
    """Collects the timed spans of a CUDA graph captured inside the block:
    (id, parent id, name, start event, end event, attrs) each, for
    ``replayed``."""
    stages: list = []
    _LOCAL.capture = stages
    try:
        yield stages
    finally:
        _LOCAL.capture = None


def replayed(stages: list, owner) -> None:
    """After a replay of a graph whose capture timed ``stages``: one record
    of each, children of the innermost open span (the step), zero-length at
    the time of the replay, its ``device_ms`` read from the graph's events
    (before ``owner``'s next replay records them again)."""
    if not (_ON and stages):
        return
    stack = _stack()
    up = stack[-1].record if stack else None
    t = time.time_ns()
    ids = {sid: next(_IDS) for sid, *_ in stages}
    for sid, sparent, name, start_event, end_event, attrs in stages:
        rec = _new_record(name, t, up, dict(attrs, replay=True))
        rec["id"] = ids[sid]
        if sparent in ids:
            rec["parent"] = ids[sparent]
        _finish(rec)
        _pend(rec, start_event, end_event, owner)


def _read(item) -> None:
    rec, start, end, _ = item
    rec["attrs"]["device_ms"] = start.elapsed_time(end)


def poll(owner=None) -> None:
    """Read the pending device times whose events have completed.  Those
    of ``owner``'s graph that have not are dropped (their records keep no
    ``device_ms``): its next replay records the same events again."""
    if not _PENDING:
        return
    with _LOCK:
        items = list(_PENDING)
        _PENDING.clear()
    keep = []
    for item in items:
        if item[2].query():
            _read(item)
        elif owner is None or item[3] is not owner:
            keep.append(item)
    with _LOCK:
        _PENDING[:0] = keep


def flush() -> None:
    """Wait for and read every pending device time."""
    with _LOCK:
        items = list(_PENDING)
        _PENDING.clear()
    for item in items:
        item[2].synchronize()
        _read(item)
