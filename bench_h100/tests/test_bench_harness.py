"""The harness on the CPU: lookup by name, the contract's names and units,
what each metric moves, the result line, no card, and the benchmark's own
metric arithmetic on hand-made traces and shapes."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench_h100.common import compare, graphs, harness, roofline, stats
from bench_h100.common import trace as tr

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("bench_h100/") and (REPO / c["file"]).exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    assert "setup_s" in e2e
    for cell in cells:
        c = harness.Cell(bench, cell)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer, cell
        for m in c.per_layer:
            assert m["moves"] in reported, (cell, m["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert harness.applies(e2e[m["moves"]], cell, []), (m["name"], cell)


def test_cell_lookup_reads_its_files(bench):
    c = harness.Cell(bench, "cyl480-kernels.stream64")
    assert c.traffic["entry"] == "stream" and c.config["detect"]["use_pallas"] is True
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "stream_frames_per_s"]
    assert {m["name"] for m in c.per_layer} == {"device_ms.stream", "idle_pct.stream"}
    with pytest.raises(KeyError):
        harness.Cell(bench, "no-such.cell")


def test_new_files_are_found_by_name_without_an_edit(tmp_path, bench):
    """A configuration, a traffic mix and a per-layer metric dropped in as new
    files, with new entries, are found by name; no existing file changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_h100", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench_h100").rglob("*") if p.is_file()}
    cfg = json.loads((BENCH / "configs" / "cyl480-kernels.json").read_text())
    cfg["detect"]["bridge_endpoint_stats"] = True
    (root / "bench_h100" / "configs" / "cyl480-endpoint.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "batch16.json").read_text())
    traffic["batch"] = 64
    (root / "bench_h100" / "traffic" / "batch64.json").write_text(json.dumps(traffic))
    (root / "bench_h100" / "metrics" / "calls.batch.py").write_text("def read(run):\n    return 7.0\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "cyl480-endpoint", "source": "s", "file": "bench_h100/configs/cyl480-endpoint.json",
                           "reduced": [], "why": "w"})
    new["workloads"].append({"name": "cyl480-endpoint.batch64", "config": "cyl480-endpoint", "traffic": "batch64",
                             "chips": 1, "why": "w"})
    for m in new["end_to_end"]:
        if m["name"].startswith("batch_"):
            m["workloads"].append("cyl480-endpoint.batch64")
    new["per_layer"].append({"name": "calls.batch", "unit": "calls", "better": "higher", "source": "host_clock",
                             "layer": "card", "moves": "batch_frames_per_s"})
    c = harness.Cell(new, "cyl480-endpoint.batch64", root=root)
    assert c.config["detect"]["bridge_endpoint_stats"] is True and c.traffic["batch"] == 64
    assert "calls.batch" in {m["name"] for m in c.per_layer}
    assert harness.reader("calls.batch", root)(None) == 7.0
    # The new metric, with no list of cells, reaches every cell that reports what it moves.
    assert "calls.batch" in {m["name"] for m in harness.Cell(new, "cyl480-kernels.batch16", root).per_layer}
    assert "calls.batch" not in {m["name"] for m in harness.Cell(new, "cyl480-kernels.stream64", root).per_layer}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_result_line_keys():
    base = dict(correct=True, attempted=3, failed=0, metrics={"setup_s": {"value": 1.0, "unit": "s"}},
                device={"platform": "gpu"}, table={"xy_px": {"value": 0.0, "limit": 1.0}})
    out = harness.result_line(breakdown=None, **base)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    out = harness.result_line(breakdown={"device_ops": [], "idle_gaps": []}, **base)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "compared"]
    json.loads(json.dumps(out))


def test_no_card_fails_and_prints_no_result(tmp_path):
    """Here there is no CUDA device: the run exits non-zero with no result
    line, also in a directory that holds only the benchmark's own files."""
    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "bench_h100", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", bare / "BENCHMARK.json")
    for where in (REPO, bare):
        out = subprocess.run([sys.executable, str(where / "bench_h100" / "run.py"), "--workload",
                              "cyl480-kernels.batch16", "--seed", "1", "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, timeout=300, cwd=where)
        assert out.returncode != 0
        assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_interval_union_and_idle_share():
    assert tr.union([(5, 9), (0, 2), (1, 3), (9, 10), (12, 12)]) == [(0, 3), (5, 10)]
    assert tr.gaps([(2, 3), (5, 6)], 0, 10) == [(0, 2), (3, 5), (6, 10)]
    events = [
        (tr.WINDOW, False, 100, 1100),
        ("bench.call", False, 100, 1100),
        ("cudaStreamSynchronize", False, 600, 900),
        ("kernel_a", True, 50, 300),     # starts before the window: clipped to 100
        ("kernel_b", True, 250, 500),
        ("Memcpy HtoD", True, 950, 1000),
        ("kernel_c", True, 1050, 1300),  # ends after it: clipped to 1100
        (tr.WINDOW, True, 100, 1100),    # the range's copy on the device timeline: no work
    ]
    s = tr.summarise(events)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx((400 + 50 + 50) * 1e-9)
    assert s.idle_pct == pytest.approx(50.0)
    assert s.device_ops[0] == ["kernel_b", pytest.approx(250e-9)]
    assert s.idle_gaps[0] == ["cudaStreamSynchronize", pytest.approx(450e-9)]
    assert s.idle_gaps[1] == ["bench.call", pytest.approx(50e-9)]
    with pytest.raises(ValueError):
        tr.summarise([e for e in events if e[0] != tr.WINDOW])


def test_no_device_events_read_nothing():
    s = tr.summarise([(tr.WINDOW, False, 0, 10), ("aten::add", False, 1, 2)])
    assert s.busy_s == 0 and s.idle_pct is None


def test_percentile_over_all_calls():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200):
        xs = rng.exponential(size=n).tolist()
        assert stats.percentile(xs, 95.0) == pytest.approx(float(np.percentile(xs, 95.0)))
    assert stats.percentile([3.0, 1.0, 2.0], 50.0) == 2.0


def test_graph_node_count():
    assert graphs.count_kernels([0, 0, 1, 2, 0, 8]) == 3
    assert graphs.count_kernels([]) == 0


def test_preprocess_binarize_bytes_and_share():
    # The (32, 480, 640) site of a B=16 step: one input plane and six output planes, float32.
    assert roofline.preprocess_binarize_bytes(32, 480, 640) == 275_251_200
    kind = "NVIDIA H100 80GB HBM3"
    least_ms = 275_251_200 / 3.35e12 * 1e3
    assert roofline.bandwidth_share(275_251_200, least_ms, kind) == pytest.approx(100.0)
    assert roofline.bandwidth_share(275_251_200, 4 * least_ms, kind) == pytest.approx(25.0)
    with pytest.raises(KeyError):
        roofline.peak("some other card")


def test_compare_readings():
    assert compare.gap([1.0, np.nan], [1.5, np.nan]) == 0.5
    assert compare.gap([1.0], [np.nan]) == float("inf")
    assert compare.rel_gap([2.0], [1.0]) == 1.0
    merged = compare.merge([{"ids": 1, "xy_px": 0.1}, {"ids": 2, "xy_px": 0.05}])
    assert merged == {"ids": 3, "xy_px": 0.1}
    limits = {"ids": {"limit": 0}, "xy_px": {"limit": 0.2}}
    assert compare.over(merged, limits) == ["ids"]
    assert compare.over({"xy_px": 0.1, "new": 0.0}, limits) == ["new"]


COUNTDOWN = '''"""A loop of another kind: each call counts down from the traffic's
``start``; the check compares each answer with the count it should be."""

from bench_h100.common.drivers import Driver


class Countdown(Driver):
    entry = "countdown"

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.kept, self.frames_per_call = [], 1

    def warm(self):
        self.call(0)

    def call(self, i):
        return {"left": self.traffic["start"] - i}

    def keep(self, i, ans):
        self.kept.append((i, ans))

    def window_values(self, times, wall):
        return {"batch_frames_per_s": len(times) / wall, "batch_p95_ms": 1e3 * max(times)}

    def readings(self):
        return [{"ids": int(a["left"] != self.traffic["start"] - i)} for i, a in self.kept]


DRIVER = Countdown
'''


def test_new_loop_kind_is_a_new_file(tmp_path, bench):
    """A loop of a new kind is a driver file under ``drivers/`` and a traffic
    file naming it: the harness finds it by name and drives a whole run
    (window, check, result line) with no existing file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_h100", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench_h100").rglob("*") if p.is_file()}
    (root / "bench_h100" / "drivers" / "countdown.py").write_text(COUNTDOWN)
    (root / "bench_h100" / "traffic" / "countdown9.json").write_text(json.dumps({"entry": "countdown", "start": 9}))
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "cyl480-kernels.countdown9", "config": "cyl480-kernels",
                             "traffic": "countdown9", "chips": 1, "why": "w"})
    for m in new["end_to_end"]:
        if m["name"].startswith("batch_"):
            m["workloads"].append("cyl480-kernels.countdown9")
    cell = harness.Cell(new, "cyl480-kernels.countdown9", root=root)
    cell.limits = {"ids": {"limit": 0}}
    out = harness.run_cell(cell, seed=2 ** 33, seconds=0.05, trace=False, device="cpu")
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "batch_frames_per_s", "batch_p95_ms"}
    assert all(p.read_bytes() == b for p, b in before.items())
    with pytest.raises(KeyError):
        from bench_h100.common import drivers
        drivers.load("no-such-loop", root)
