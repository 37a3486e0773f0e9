"""The program's own spans and counters (``utils/profiling`` of the port),
read for the per-layer metrics whose source is ``program_span`` or
``program_counter``.

In a ``--trace 1`` run, after the profiled window and with the profiler
off, ``collect`` turns the program's tracing on, warms the cell's steps up
again (tracing is part of a compiled step's key: the traced steps are
captured anew, with their stages' device events inside the graphs), clears
the registry, runs the traffic's ``trace_calls`` whole calls timed on the
host clock, reads every pending device time and turns tracing off again.
It runs once per run (memoised on the ``Run``).  A program without the
registry gives None, and so does every reader of these metrics.

Everything after ``collect`` is arithmetic on the records, plain dicts
(``id``, ``name``, ``start``, ``end`` in ns, ``parent``, ``call``,
``attrs``), which the CPU tests exercise on hand-made records.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

from bench_h100.common import stats


class Spans(NamedTuple):
    records: List[dict]
    counters: Dict[str, int]   # the ``sync.*`` counters: the waits of the calls
    wall_s: float   # host seconds of the calls, back to back
    calls: int


def _registry():
    """The program's registry, or None where the program has none."""
    try:
        from cylinder_pose_estimation_tpu_torch.utils import profiling
    except ImportError:
        return None
    needed = ("enable", "disable", "reset", "records", "counters", "flush")
    return profiling if all(hasattr(profiling, n) for n in needed) else None


def collect(run) -> Optional[Spans]:
    return run.memo("program_spans", lambda: _collect(run.driver))


def _collect(driver) -> Optional[Spans]:
    profiling = _registry()
    if profiling is None:
        return None
    n = driver.traffic["trace_calls"]
    profiling.enable()
    try:
        driver.warm()
        profiling.reset()
        t0 = time.perf_counter()
        for i in range(n):
            driver.call(i)
        wall = time.perf_counter() - t0
        profiling.flush()
        return Spans(profiling.records(), profiling.counters("sync."), wall, n)
    finally:
        profiling.disable()


def ms(rec: dict) -> float:
    """Host ms of a span."""
    return (rec["end"] - rec["start"]) * 1e-6


def replays(spans: Spans, kinds: Iterable[str]) -> List[dict]:
    """The replayed calls of the compiled steps of these kinds."""
    names = {f"step.{k}" for k in kinds}
    return [r for r in spans.records if r["name"] in names and r["attrs"].get("phase") == "replay"]


def stage_ms(spans: Spans, stage: str, kind: str) -> List[float]:
    """Device ms of a stage in each replay of the ``kind`` step (its events
    inside the graph)."""
    steps = {r["id"] for r in replays(spans, [kind])}
    by_id = {r["id"]: r for r in spans.records}
    out = []
    for r in spans.records:
        if r["name"] == stage and r["attrs"].get("replay") and "device_ms" in r["attrs"]:
            # The stage's step: up the parents (a stage may sit inside another).
            up = r
            while up is not None and up["id"] not in steps:
                up = by_id.get(up["parent"])
            if up is not None:
                out.append(r["attrs"]["device_ms"])
    return out


def stage_ms_per_frame(spans: Optional[Spans], stage: str, kind: str, frames: int) -> Optional[float]:
    """Median device ms of a stage over the replays, per frame of the step."""
    if spans is None:
        return None
    vals = stage_ms(spans, stage, kind)
    return statistics.median(vals) / frames if vals else None


def launch_ms_per_call(spans: Optional[Spans], kinds: Iterable[str]) -> Optional[float]:
    """Median over the calls of the host ms of their steps' ``step.launch``
    (``graph.replay()``), summed within a call."""
    if spans is None:
        return None
    steps = {r["id"]: r["call"] for r in replays(spans, kinds)}
    per_call: Dict[int, float] = {}
    for r in spans.records:
        if r["name"] == "step.launch" and r["parent"] in steps:
            per_call[r["call"]] = per_call.get(r["call"], 0.0) + ms(r)
    return statistics.median(per_call.values()) if per_call else None


def step_gap_pct(spans: Optional[Spans], kinds: Iterable[str]) -> Optional[float]:
    """100 x (1 - the steps' device time over the calls' wall time): the
    share of the calls in which the card was not running a replayed graph
    (each replay timed from the graph's first node to its last, on the
    card): copies to and from the host and into the graph's inputs, the
    wait for the launch, host work."""
    if spans is None or spans.wall_s <= 0:
        return None
    device = [r["attrs"]["device_ms"] for r in replays(spans, kinds) if "device_ms" in r["attrs"]]
    if not device:
        return None
    return 100.0 * (1.0 - 1e-3 * sum(device) / spans.wall_s)


def p95_ms(spans: Optional[Spans], name: str) -> Optional[float]:
    """95th percentile of the host ms of the spans ``name``."""
    if spans is None:
        return None
    vals = [ms(r) for r in spans.records if r["name"] == name]
    return stats.percentile(vals, 95.0) if vals else None


def wait_pct(spans: Optional[Spans], name: str) -> Optional[float]:
    """100 x the summed host time of the spans ``name`` over the calls'
    wall time (0 where the calls never waited there)."""
    if spans is None or spans.wall_s <= 0 or not spans.records:
        return None
    return 100.0 * 1e-3 * sum(ms(r) for r in spans.records if r["name"] == name) / spans.wall_s


def per_call(spans: Optional[Spans], prefix: str) -> Optional[float]:
    """The counters named ``prefix...``, summed, per call."""
    if spans is None or spans.calls <= 0:
        return None
    return sum(n for k, n in spans.counters.items() if k.startswith(prefix)) / spans.calls
