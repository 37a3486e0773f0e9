"""The readers of the program's spans and counters on the CPU: each new
metric has its reader and a valid entry, none loads JAX, and their
arithmetic (median over B, p95, shares, syncs per call) on hand-made
records, with no card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100.common import harness
from bench_h100.common import spans as sp

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cylinder_pose_estimation_tpu"}
BATCH = ["cyl480-kernels.batch16", "cyl480-default.batch16"]
NEW = {
    "front_ms.batch": BATCH, "roi_ms.batch": BATCH, "bridge_ms.batch": BATCH, "grid_ms.batch": BATCH,
    "correspond_ms.batch": BATCH, "lm_ms.batch": BATCH, "graph_launch_ms.batch": BATCH,
    "step_gap_pct.batch": BATCH, "chunk_p95_ms.stream": ["cyl480-kernels.stream64"],
    "wait_upload_pct.stream": ["cyl480-kernels.stream64"], "wait_readback_pct.stream": ["cyl480-kernels.stream64"],
    "graph_launch_ms.experiment": ["cyl480-kernels.experiment100"],
    "step_gap_pct.experiment": ["cyl480-kernels.experiment100"],
    "host_syncs.experiment": ["cyl480-kernels.experiment100"],
}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_each_new_metric_has_a_reader_and_an_entry(bench):
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert len(NEW) == 14
    for name, cells in NEW.items():
        m = entries[name]
        assert m["workloads"] == cells and m["better"] == "lower"
        assert m["source"] == ("program_counter" if name.startswith("host_syncs") else "program_span")
        assert (BENCH / "metrics" / f"{name}.py").exists()
        assert callable(harness.reader(name))
        for cell in cells:
            assert name in {x["name"] for x in harness.Cell(bench, cell).per_layer}
    # Appended after the accepted entries, which keep their order.
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-14:] == list(NEW)


def test_readers_and_spans_load_no_jax():
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from bench_h100.common import harness, spans
for name in {sorted(NEW)!r}:
    harness.reader(name)
spans._registry()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "cylinder_pose_estimation_tpu_torch" in tops
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def _rec(i, name, start_ms, end_ms, parent=None, call=None, **attrs):
    return {"id": i, "name": name, "start": int(start_ms * 1e6), "end": int(end_ms * 1e6), "parent": parent,
            "call": i if call is None else call, "thread": "MainThread", "attrs": attrs}


def _batch_spans():
    """Three batch calls of a B=4 step: one eager, two replays with their
    stages timed in the graph; a stage of another kind of step too."""
    recs = [_rec(1, "step.batch", 0, 50, phase="eager"),
            _rec(2, "detect.front", 1, 10, parent=1, call=1, device_ms=9.0)]
    for k, (base, front, launch, dev) in enumerate(((100, 4.0, 0.2, 8.0), (200, 6.0, 0.4, 10.0))):
        sid = 10 * (k + 1)
        recs += [_rec(sid + 2, "step.launch", base + 0.1, base + 0.1 + launch, parent=sid, call=sid),
                 _rec(sid + 4, "detect.front", base + 1, base + 1, parent=sid, call=sid, replay=True,
                      device_ms=front),
                 _rec(sid + 5, "fit.lm", base + 1, base + 1, parent=sid, call=sid, replay=True, device_ms=1.0),
                 _rec(sid, "step.batch", base, base + 20, phase="replay", device_ms=dev)]
    recs += [_rec(40, "step.batch.detect", 300, 310, phase="replay", device_ms=3.0),
             _rec(41, "detect.front", 301, 301, parent=40, call=40, replay=True, device_ms=99.0)]
    return sp.Spans(recs, {"step.replay": 3}, wall_s=0.05, calls=2)


def test_stage_median_over_frames():
    s = _batch_spans()
    assert sp.stage_ms(s, "detect.front", "batch") == [4.0, 6.0]   # not the eager call's, nor the probe's
    assert sp.stage_ms_per_frame(s, "detect.front", "batch", 4) == pytest.approx(5.0 / 4)
    assert sp.stage_ms_per_frame(s, "fit.lm", "batch", 4) == pytest.approx(0.25)
    assert sp.stage_ms_per_frame(s, "detect.grid", "batch", 4) is None
    assert sp.stage_ms_per_frame(None, "detect.front", "batch", 4) is None


def test_launch_and_gap():
    s = _batch_spans()
    assert sp.launch_ms_per_call(s, ["batch"]) == pytest.approx(0.3)
    # 18 device ms of replays in 50 ms of calls.
    assert sp.step_gap_pct(s, ["batch"]) == pytest.approx(100 * (1 - 18 / 50))
    assert sp.step_gap_pct(s, ["registration"]) is None
    assert sp.launch_ms_per_call(None, ["batch"]) is None and sp.step_gap_pct(None, ["batch"]) is None


def test_two_steps_per_call():
    """An experiment call replays two steps under one top-level span: their
    launches add up within the call."""
    recs = []
    for k, base in enumerate((0, 100)):
        call = 100 + k
        recs.append(_rec(call, "experiment", base, base + 40))
        for j, (kind, launch, dev) in enumerate((("batch", 1.0, 10.0), ("registration", 2.0 + k, 20.0))):
            sid = call * 10 + j
            recs += [_rec(sid + 5000, "step.launch", base, base + launch, parent=sid, call=call),
                     _rec(sid, f"step.{kind}", base, base + 30, parent=call, call=call, phase="replay",
                          device_ms=dev)]
    s = sp.Spans(recs, {"sync.stereo_key": 16, "step.replay": 4}, wall_s=0.08, calls=2)
    assert sp.launch_ms_per_call(s, ["batch", "registration"]) == pytest.approx(3.5)   # median of 3.0, 4.0
    assert sp.step_gap_pct(s, ["batch", "registration"]) == pytest.approx(100 * (1 - 60 / 80))
    assert sp.per_call(s, "sync.") == 8.0
    assert sp.per_call(sp.Spans(recs, {}, 0.08, 2), "sync.") == 0.0
    assert sp.per_call(None, "sync.") is None


def test_chunk_p95_and_waits():
    recs = [_rec(10 + c, "stream.chunk", 10 * c, 10 * c + 20 + c, chunk=c) for c in range(20)]
    recs += [_rec(100 + c, "stream.wait_readback", 0, 30, chunk=c) for c in range(10)]
    s = sp.Spans(recs, {}, wall_s=1.0, calls=1)
    durations = [20.0 + c for c in range(20)]
    assert sp.p95_ms(s, "stream.chunk") == pytest.approx(sp.stats.percentile(durations, 95.0))
    assert sp.wait_pct(s, "stream.wait_readback") == pytest.approx(30.0)
    assert sp.wait_pct(s, "stream.wait_upload") == 0.0
    assert sp.wait_pct(sp.Spans([], {}, 1.0, 1), "stream.wait_upload") is None
    assert sp.p95_ms(None, "stream.chunk") is None


class _Driver:
    def __init__(self, entry, batch=4):
        self.entry, self.batch, self.traffic = entry, batch, {"trace_calls": 2}


def test_readers_on_recorded_spans_and_on_a_program_without_them(bench):
    """Each reader reads the memoised spans of its cell's kind of loop, and
    None where the program has no registry (the parent of this benchmark)."""
    entries = {"batch": _batch_spans(),
               "stream": sp.Spans([_rec(1, "stream.chunk", 0, 5, chunk=0)], {}, 0.01, 1),
               "experiment": sp.Spans([], {"sync.stereo_key": 14}, 1.0, 2)}
    for name, cells in NEW.items():
        cell = harness.Cell(bench, cells[0])
        entry = cell.traffic["entry"]
        read = harness.reader(name)
        run = harness.Run(cell, _Driver(entry), "cpu")
        run._memo["program_spans"] = entries[entry]
        value = read(run)
        if name in ("graph_launch_ms.experiment", "step_gap_pct.experiment", "grid_ms.batch",
                    "correspond_ms.batch", "roi_ms.batch", "bridge_ms.batch"):
            assert value is None, name   # nothing of theirs in the hand-made records
        else:
            assert isinstance(value, float), name
        run = harness.Run(cell, _Driver(entry), "cpu")
        run._memo["program_spans"] = None
        assert read(run) is None, name
        other = harness.Run(cell, _Driver("countdown"), "cpu")
        other._memo["program_spans"] = entries[entry]
        assert read(other) is None, name
    run = harness.Run(harness.Cell(bench, "cyl480-kernels.experiment100"), _Driver("experiment"), "cpu")
    run._memo["program_spans"] = entries["experiment"]
    assert harness.reader("host_syncs.experiment")(run) == 7.0


def test_collect_turns_tracing_off_and_reads_the_calls():
    """``collect`` on a driver whose calls open spans: tracing is on only
    inside it, the warm-up's records are cleared, the calls are counted."""
    from cylinder_pose_estimation_tpu_torch.utils import profiling

    class Tracer:
        traffic = {"trace_calls": 3}

        def __init__(self):
            self.warmed = 0

        def warm(self):
            self.warmed += 1
            with profiling.span("warm"):
                pass

        def call(self, i):
            assert profiling.enabled()
            with profiling.span("call", i=i):
                profiling.count("sync.x")

    class Run:
        def __init__(self, driver):
            self.driver, self._memo = driver, {}

        def memo(self, key, fn):
            if key not in self._memo:
                self._memo[key] = fn()
            return self._memo[key]

    run = Run(Tracer())
    s = sp.collect(run)
    assert not profiling.enabled() and run.driver.warmed == 1
    assert [r["attrs"]["i"] for r in s.records] == [0, 1, 2] and s.calls == 3 and s.wall_s > 0
    assert s.counters == {"sync.x": 3} and sp.per_call(s, "sync.") == 1.0
    assert sp.collect(run) is s
    profiling.reset()
