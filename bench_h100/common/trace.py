"""Device busy time, idle share and the trace breakdown, from a
``torch.profiler`` session: the benchmark's own copy of the interval-union
arithmetic (``tools/torch_step_time.py``'s ``busy_share``), over a window
of whole calls marked by the harness's ``bench.window`` range.

Events are reduced to plain tuples first, ``(name, on_device, start_ns,
end_ns)``; everything after that is arithmetic on tuples, which the CPU
tests exercise on hand-made traces.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

WINDOW = "bench.window"
NAME_CHARS = 120
# Host events of the profiler's own bookkeeping, which say nothing of the program.
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")

Event = Tuple[str, bool, int, int]


class TraceSummary(NamedTuple):
    window_s: float          # length of the traced window (its bench.window range)
    busy_s: float            # union of device intervals inside it
    device_ops: list         # [[name, seconds], ...] the ten with most device time
    idle_gaps: list          # [[what the host did, seconds], ...] the ten longest gaps
    n_device_events: int

    @property
    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0 or self.n_device_events == 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def events_of(prof) -> List[Event]:
    """(name, on_device, start_ns, end_ns) of every event of a finished
    ``torch.profiler.profile``: kernels, copies and sets on the device;
    operators, ranges and runtime calls on the host.  The device's copies
    of the host's ranges (user annotations, such as ``bench.window``) are
    no work of the device and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == cuda
        if on_device and e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((e.name(), on_device, start, start + e.duration_ns()))
    return out


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Disjoint, sorted union of half-open [start, end) intervals."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def clip(intervals: Sequence[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(busy: Sequence[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi) between the (disjoint, sorted) busy ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def host_activity(host: Sequence[Event], t: int) -> str:
    """The innermost host event (shortest) that covers time t, by name;
    "host idle" where none does."""
    best = None
    for name, _, a, b in host:
        if a <= t < b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "host idle"


def summarise(events: Sequence[Event], top: int = 10) -> TraceSummary:
    """Busy time, top device operations and longest idle gaps inside the
    (last) ``bench.window`` range of the events."""
    windows = [(a, b) for name, dev, a, b in events if name == WINDOW and not dev]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW} range")
    lo, hi = windows[-1]
    device = [(n, a, b) for n, dev, a, b in events if dev and n != WINDOW and b > lo and a < hi]
    busy = union(clip([(a, b) for _, a, b in device], lo, hi))
    busy_ns = sum(b - a for a, b in busy)
    per_op: dict = {}
    for n, a, b in device:
        a, b = max(a, lo), min(b, hi)
        per_op[n] = per_op.get(n, 0) + (b - a)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    host = [e for e in events if not e[1] and e[0] != WINDOW and e[0] not in PROFILER_OWN]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:top]
    idle_named = [[host_activity(host, (a + b) // 2), (b - a) * 1e-9] for a, b in idle]
    return TraceSummary(window_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9,
                        device_ops=[[_short(n), ns * 1e-9] for n, ns in ops],
                        idle_gaps=[[_short(n), s] for n, s in idle_named],
                        n_device_events=len(device))
