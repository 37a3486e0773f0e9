"""The port's spans and counters (``utils/profiling``'s registry) on the CPU:
the span tree of a step, the profiler's clock, tracing off, the compiled
steps' counters through a stand-in for the CUDA graph, the stream's spans,
the kernel and graph launch views, and the lazy reading of device times
with stand-in events."""

from __future__ import annotations

import collections
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.ops import frontend, kernels
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils import profiling
from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

torch.set_num_threads(1)

H, W = 240, 320


@pytest.fixture
def tracing():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


@pytest.fixture(scope="module")
def scene():
    st, (a, b) = example_pair(H, W, 3)
    return stereo_from_numpy(*st, device="cpu"), a, b


def _by_name(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r["name"]].append(r)
    return out


def test_span_tree_of_an_eager_batch_step(scene, tracing):
    stereo, a, b = scene
    cfg = CylinderDetectConfig(height=H, width=W, use_pallas=True)
    pipeline.compiled_batch(stereo, cfg, FitConfig())(torch.as_tensor(a[:2]), torch.as_tensor(b[:2]))
    recs = profiling.records()
    names = _by_name(recs)
    by_id = {r["id"]: r for r in recs}
    (step,) = names["step.batch"]
    assert step["parent"] is None and step["attrs"] == {"phase": "eager"} and step["call"] == step["id"]
    stages = ["detect.front", "detect.roi", "detect.bridge", "detect.grid", "fit.correspond", "fit.lm"]
    kids = sorted((r for r in recs if r["parent"] == step["id"]), key=lambda r: r["start"])
    assert [k["name"] for k in kids] == stages
    for k in kids:
        assert step["start"] <= k["start"] <= k["end"] <= step["end"]
        assert by_id[k["parent"]] is step
    assert {r["call"] for r in recs} == {step["id"]}
    assert all(r["thread"] == threading.current_thread().name for r in recs)
    assert profiling.counters("step.") == {}


def test_spans_on_the_profilers_clock(tracing):
    x = torch.ones(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clock.first"):  # the session's first range pays its set-up
            pass
        for i in range(4):
            with profiling.span(f"clock.outer{i}"):
                with profiling.span(f"clock.inner{i}"):
                    (x @ x).sum()
    events = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()}
    recs = [r for r in profiling.records() if r["name"] != "clock.first"]
    assert len(recs) == 8
    for r in recs:
        start, end = events[r["name"]]
        assert abs(r["start"] - start) < 500_000, r["name"]
        assert abs(r["end"] - end) < 500_000, r["name"]


def test_tracing_off_records_nothing_and_opens_no_range(monkeypatch):
    profiling.reset()
    opened = []
    real = profiling._autograd_profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", counting)
    assert not profiling.enabled()
    with profiling.span("off.outer") as s:
        with profiling.span("off.inner", like=torch.ones(2)):
            pass
    profiling.add("off.added", 0, 1)
    assert s is None and opened == [] and profiling.records() == []
    # Under a profiler a span opens its range, with tracing still off.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("off.profiled"):
            torch.ones(3).sum()
    assert opened == ["off.profiled"] and profiling.records() == []
    assert "off.profiled" in {e.name() for e in prof.profiler.kineto_results.events()}
    # With tracing on and no profiler: a record, no range.
    profiling.enable()
    try:
        with profiling.span("on.plain"):
            pass
    finally:
        profiling.disable()
    assert opened == ["off.profiled"] and [r["name"] for r in profiling.records()] == ["on.plain"]
    profiling.reset()


class _FakeGraph:
    """Stands in for ``_GraphStep`` on the CPU: runs the body eagerly, and
    counts a replay as the real one does."""

    def __init__(self, fn, inputs):
        self.fn = fn

    def __call__(self, *inputs):
        with profiling.span("step.launch"):
            out = self.fn(*inputs)
        profiling.count("step.replay")
        return out


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(pipeline, "_GraphStep", _FakeGraph)
    monkeypatch.setattr(pipeline, "_graphs", lambda t: True)
    monkeypatch.setattr(pipeline, "_STREAM_STEP_CACHE", collections.OrderedDict())


def test_step_counters_and_phases(fake_graphs, tracing):
    def body(x):
        return x + 1

    x = torch.zeros(3)
    pipeline.reset_graph_launch_counts()
    for _ in range(4):
        pipeline._compiled(("k",), body, (x,))

    def phases():
        return [r["attrs"]["phase"] for r in profiling.records() if r["name"] == "step.k"]

    assert profiling.counters("step.") == {"step.replay": 3}
    assert pipeline.graph_launch_counts()["replays"] == 3
    assert phases() == ["eager", "capture", "replay", "replay"]
    # The tracing flag is part of the key: untraced, the same step starts
    # over (eagerly, so it records nothing).
    profiling.disable()
    pipeline._compiled(("k",), body, (x,))
    pipeline._compiled(("k",), body, (x,))
    assert len(pipeline._STREAM_STEP_CACHE) == 2
    profiling.enable()
    cap = pipeline._STREAM_STEP_CACHE_SIZE
    for i in range(cap - 1):
        pipeline._compiled(("other", i), body, (x,))
    assert len(pipeline._STREAM_STEP_CACHE) == cap
    # The traced key was the oldest: it was evicted and starts over.
    pipeline._compiled(("k",), body, (x,))
    pipeline._compiled(("k",), body, (x,))
    assert phases() == ["eager", "capture", "replay", "replay", "eager", "capture"]
    assert profiling.counters("step.") == {"step.replay": 5}
    kinds = {r["name"] for r in profiling.records() if r["parent"] is None}
    assert kinds == {"step.k", "step.other"}
    pipeline.reset_graph_launch_counts()


def test_fresh_step_clones_inside_its_span(fake_graphs, tracing, monkeypatch):
    """A ``fresh`` step hands out clones of the graph's static outputs; its
    span, named by ``kind``, holds the replay's launch."""
    static = (torch.zeros(2),)

    class Static(_FakeGraph):
        def __call__(self, *inputs):
            super().__call__(*inputs)
            return static

    monkeypatch.setattr(pipeline, "_GraphStep", Static)
    x = torch.ones(2)
    outs = [pipeline._compiled(("f",), lambda t: (t * 2,), (x,), fresh=True, kind="fresh") for _ in range(3)]
    assert outs[1][0] is not static[0] and outs[2][0] is not outs[1][0]
    assert torch.equal(outs[2][0], static[0])
    names = _by_name(profiling.records())
    (replay,) = [r for r in names["step.fresh"] if r["attrs"]["phase"] == "replay"]
    assert [r["parent"] for r in names["step.launch"] if r["call"] == replay["id"]] == [replay["id"]]


def test_stream_chunk_spans(scene, tracing):
    stereo, a, b = scene
    u1, u2 = (np.clip(x, 0, 255).astype(np.uint8) for x in (a, b))
    cfg = CylinderDetectConfig(height=H, width=W, use_pallas=True)
    pipeline.estimate_poses_stream(u1, u2, stereo, cfg, FitConfig(), chunk=1, compact=True)
    recs = profiling.records()
    names = _by_name(recs)
    (call,) = names["stream.call"]
    assert {r["call"] for r in recs} == {call["id"]}
    chunks = sorted(names["stream.chunk"], key=lambda r: r["attrs"]["chunk"])
    assert [r["attrs"]["chunk"] for r in chunks] == [0, 1, 2]
    assert all(r["parent"] == call["id"] and r["start"] < r["end"] for r in chunks)
    assert all(r["thread"] == threading.current_thread().name for r in recs)
    for name in ("stream.wait_upload", "stream.step"):
        assert sorted(r["attrs"]["chunk"] for r in names[name]) == [0, 1, 2], name
    # A chunk's span runs from its load, before the main loop waits for its
    # upload and steps it, to the end of its materialisation.
    for name in ("stream.wait_upload", "stream.step"):
        for r in names[name]:
            c = chunks[r["attrs"]["chunk"]]
            assert c["start"] <= r["start"] <= r["end"] <= c["end"], name
    # Each chunk's step span holds that chunk's compiled step.
    steps = {r["id"]: r["attrs"]["chunk"] for r in names["stream.step"]}
    assert sorted(steps[r["parent"]] for r in names["step.stream"]) == [0, 1, 2]
    # On the CPU no wait for a card.
    assert "stream.wait_readback" not in names and not any(profiling.counters("sync.").values())


def test_launch_views_read_as_before():
    kernels.reset_launch_counts()
    pipeline.reset_graph_launch_counts()
    counts = kernels.launch_counts()
    assert list(counts) == list(kernels.COUNTERS) and set(counts.values()) == {0}
    assert "bridge_morphology.split" in counts and "connected_components.capped.band" in counts
    assert "solve_spd" in counts
    profiling.count("kernel.bridge_morphology")
    profiling.count("kernel.bridge_morphology.cluster", 2)
    counts = kernels.launch_counts()
    assert counts["bridge_morphology"] == 1 and counts["bridge_morphology.cluster"] == 2
    assert pipeline.graph_launch_counts() == {"captured": {}, "replayed": {}, "replays": 0}
    profiling.count("graph.captured.bridge_morphology", 1)
    profiling.count("graph.replayed.bridge_morphology", 3)
    profiling.count("step.replay", 3)
    assert pipeline.graph_launch_counts() == {"captured": {"bridge_morphology": 1},
                                              "replayed": {"bridge_morphology": 3}, "replays": 3}
    pipeline.reset_graph_launch_counts()
    assert pipeline.graph_launch_counts() == {"captured": {}, "replayed": {}, "replays": 0}
    assert kernels.launch_counts()["bridge_morphology"] == 1
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_plain_kernel_runs_count_no_launch():
    kernels.reset_launch_counts()
    m = torch.zeros(1, 16, 16, dtype=torch.float32)
    frontend.connected_components(m, rounds=1, pools_per_round=1)
    assert kernels.launch_counts()["connected_components"] == 0


def test_counters_under_thread_contention():
    """More threads than cores adding to shared counters, with a short
    switch interval: no update is lost."""
    profiling.reset_counters("stress.")
    threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                profiling.count("stress.a")
                profiling.count("stress.b", 2)
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counters("stress.") == {"stress.a": threads * per, "stress.b": 2 * threads * per}
    profiling.reset_counters("stress.")


class _FakeEvent:
    """Stands in for a CUDA timing event: a time in ms, done or not."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_times_are_read_lazily(tracing):
    owner = object()
    with profiling.span("lazy.step") as step:
        profiling.time_device(step, _FakeEvent(0.0), _FakeEvent(5.0, done=False))
        # Stages captured in a graph: detect (id 1) holds front (id 2).
        stages = [(2, 1, "lazy.front", _FakeEvent(1.0), _FakeEvent(2.0), {}),
                  (1, None, "lazy.detect", _FakeEvent(0.5), _FakeEvent(4.0, done=False), {})]
        profiling.replayed(stages, owner)
    profiling.poll()
    names = _by_name(profiling.records())
    (front,), (detect,) = names["lazy.front"], names["lazy.detect"]
    assert front["attrs"] == {"replay": True, "device_ms": 1.0} and front["parent"] == detect["id"]
    assert detect["parent"] == step.record["id"] and detect["call"] == step.record["call"]
    assert "device_ms" not in detect["attrs"] and "device_ms" not in names["lazy.step"][0]["attrs"]
    # The owner's next replay drops what its graph has not finished (its events are recorded again) ...
    profiling.poll(owner=owner)
    assert "device_ms" not in _by_name(profiling.records())["lazy.detect"][0]["attrs"]
    # ... and flush waits for the rest, and not for the dropped.
    profiling.flush()
    names = _by_name(profiling.records())
    assert names["lazy.step"][0]["attrs"]["device_ms"] == 5.0
    assert "device_ms" not in names["lazy.detect"][0]["attrs"]


def test_rig_read_back_counts_only_card_waits(scene):
    stereo, _, _ = scene
    before = profiling.counters("sync.").get("sync.stereo_key", 0)
    pipeline._stereo_key(stereo)
    assert profiling.counters("sync.").get("sync.stereo_key", 0) == before


def test_reset_keeps_the_launch_counters():
    """``profiling.reset`` clears the records, the pending device times and
    the ``sync.*`` counters; the kernel and graph launch counters are
    cleared only by their own resets."""
    kernels.reset_launch_counts()
    pipeline.reset_graph_launch_counts()
    profiling.count("kernel.connected_components", 3)
    profiling.count("graph.replayed.connected_components", 2)
    profiling.count("step.replay")
    profiling.count("sync.stereo_key", 7)
    profiling.enable()
    try:
        with profiling.span("reset.me"):
            pass
    finally:
        profiling.disable()
    profiling.reset()
    assert profiling.records() == [] and profiling.counters("sync.") == {}
    assert kernels.launch_counts()["connected_components"] == 3
    assert pipeline.graph_launch_counts() == {"captured": {}, "replayed": {"connected_components": 2}, "replays": 1}
    kernels.reset_launch_counts()
    pipeline.reset_graph_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert pipeline.graph_launch_counts() == {"captured": {}, "replayed": {}, "replays": 0}
