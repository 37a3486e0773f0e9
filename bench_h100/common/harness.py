"""Runs one cell once: set-up, a measured (``--trace 0``) or traced
(``--trace 1``) window of whole calls, the check against the plain
reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in the file the configuration's entry names, its traffic
in ``traffic/<traffic>.json``, the driver of the loop that traffic names
(its ``entry``) in ``drivers/<entry>.py``, each per-layer metric's reader
in ``metrics/<metric>.py`` and the limits of the check in
``limits/<cell>.json``.  A new cell, traffic mix, kind of loop or metric
is a new file and a new entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from bench_h100.common import compare, drivers
from bench_h100.common import trace as tr

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cylinder_pose_estimation_tpu")


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Whether a metric is reported in a cell: the cells it lists, or, with
    no list, every cell that reports the end-to-end metric it moves (an
    end-to-end metric with no list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


class Cell:
    """A workload of BENCHMARK.json with its files loaded."""

    def __init__(self, bench: dict, name: str, root: Path = REPO):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(root / cfgs[self.entry["config"]]["file"])
        here = root / BENCH.name
        self.traffic = _json(here / "traffic" / f"{self.entry['traffic']}.json")
        limits = here / "limits" / f"{name}.json"
        self.limits: Dict[str, dict] = {k: v for k, v in (_json(limits) if limits.exists() else {}).items()
                                        if not k.startswith("_")}
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name, [])]
        reported = [m["name"] for m in self.end_to_end]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name, reported)]
        self.chips = self.entry["chips"]
        self.root = root


def reader(metric: str, root: Path = REPO) -> Callable:
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = root / BENCH.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must never load
    (JAX, its libraries, the JAX package), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a per-layer reader sees: the cell, the driver with the
    program's steps and the cell's inputs, the traced window's summary, and
    timing helpers."""

    def __init__(self, cell: Cell, driver, device: str):
        self.cell, self.driver, self.device = cell, driver, device
        self.trace: Optional[tr.TraceSummary] = None
        self.traced_frames = 0
        self._memo: dict = {}

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def cuda_ms(self, fn: Callable, reps: int, warm: int = 2) -> float:
        """Device ms of one ``fn()``: CUDA events around ``reps`` calls in a
        row, after ``warm`` calls."""
        import torch

        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def card_info(chips: int) -> str:
    """Fails unless the cell's cards are there; returns their name and
    power limit as nvidia-smi reads them."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card and runs nowhere else")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, found {torch.cuda.device_count()}")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi: {e}"
    return smi


def _finite(v: float) -> float:
    """A reading for JSON: an infinite gap (NaN on one side) as 1e30."""
    return v if math.isfinite(v) else 1e30


def _window(cell: Cell, driver, seconds: float, setup_s: float, log) -> Tuple[int, Dict[str, dict]]:
    """Whole calls, one after another, until ``seconds`` have passed; the
    cell's end-to-end metrics of them."""
    times: List[float] = []
    i, first = 0, time.perf_counter()
    while True:
        t0 = time.perf_counter()
        ans = driver.call(i)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        driver.keep(i, ans)
        i += 1
        if t1 - first >= seconds:
            break
    wall = t1 - first
    values = {"setup_s": setup_s, **driver.window_values(times, wall)}
    print(f"window: {len(times)} calls, {driver.frames_per_call * len(times)} frames in {wall:.6f} s; "
          f"set-up {setup_s:.6f} s", file=log, flush=True)
    return len(times), {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                        for m in cell.end_to_end if m["name"] in values}


def _traced(cell: Cell, run: Run, log) -> Tuple[int, Dict[str, dict], dict]:
    """``trace_calls`` whole calls under ``torch.profiler``, then every
    per-layer reader of the cell; (calls, metrics, breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    driver, n_calls = run.driver, cell.traffic["trace_calls"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(tr.WINDOW):
            t0 = time.perf_counter()
            for i in range(n_calls):
                driver.keep(i, driver.call(i))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    run.trace = tr.summarise(tr.events_of(prof))
    del prof
    run.traced_frames = driver.frames_per_call * n_calls
    print(f"traced window: {n_calls} calls in {wall:.6f} s host wall, {run.trace.window_s:.6f} s traced, "
          f"{run.trace.busy_s:.6f} s busy, {run.trace.n_device_events} device events", file=log, flush=True)
    metrics = {}
    for m in cell.per_layer:
        value = reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return n_calls, metrics, {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, log=sys.stderr) -> dict:
    """One run of a cell; returns the result line's object.  ``device`` is
    "cuda" for every run of the benchmark; the CPU tests drive the same
    path on "cpu" (``trace=False`` only), where no device number is read."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    driver = drivers.make(cell.config, cell.traffic, seed, device, cell.root)
    driver.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    breakdown = None
    if not trace:
        attempted, metrics = _window(cell, driver, seconds, setup_s, log)
        dev: Dict[str, object] = {}
    else:
        if not cuda:
            raise ValueError("a traced run reads the card's trace: it needs a CUDA device")
        print(f"set-up {setup_s:.6f} s", file=log, flush=True)
        run = Run(cell, driver, device)
        attempted, metrics, breakdown = _traced(cell, run, log)
        dev = {"busy_s": run.trace.busy_s, "window_s": run.trace.window_s}
        del run
    if cuda:
        torch.cuda.synchronize()
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": torch.cuda.max_memory_allocated(0), **dev}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run loaded {bad}: the benchmark must not load JAX or the JAX package")
    # The program's state goes before the reference runs.
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings, compared, failed = driver.judge(cell.limits)
    over = compare.over(readings, cell.limits)
    correct = compared > 0 and failed == 0 and not over
    table = compare.table({k: _finite(v) for k, v in readings.items()}, cell.limits)
    print(f"reference: {compared} answers compared in {time.perf_counter() - t_ref:.1f} s, "
          f"{failed} over a limit; correct: {correct}", file=log)
    # The numbers compared, each beside its limit, are the last lines.
    for k, v in table.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=log)
    log.flush()
    return result_line(correct, attempted, failed if compared else attempted, metrics, dev, breakdown, table)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                breakdown: Optional[dict], table: dict) -> dict:
    """The result's object, its keys in the contract's order, the numbers
    compared last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = table
    return out
