"""The full-HD configuration of the benchmark (``cyl1080-kernels``) and the
port at its sizes, on the CPU: the configuration builds the port's configs
and differs from its 480x640 sibling only in height and width; the launch
plans at the cell's sites take the CC family's band route, 8-CTA CC
clusters and the bridge's split route; one 1080x1920 pair through
``compiled_batch`` passes the cell's check against the benchmark's plain
reference; the byte counts and sites of the cell's two roofline readers;
CPU tensors count nothing on the band-route counters.  No JAX here."""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100.common import compare, drivers, harness, program, roofline, route_bytes, sites
from bench_h100.inputs import scenes
from cylinder_pose_estimation_tpu_torch import config as port_config
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf
from cylinder_pose_estimation_tpu_torch.ops import kernels

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CELL = "cyl1080-kernels.batch16"
H, W, B = 1080, 1920, 16
# The cell's sites: 2B views, two masks each, on the half-res and
# quarter-res canvases of a 1080x1920 view.
HALF, QUARTER = (4 * B, 544, 1024), (4 * B, 272, 512)
BAND_COUNTERS = ("connected_components.band",)


def _cfg(name):
    return json.loads((REPO / "bench_h100" / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_configuration_builds_the_ports_configs():
    detect, fit, reg = program.configs(program.port(), _cfg("cyl1080-kernels"))
    port_config.validate(detect)
    assert (detect.height, detect.width, detect.use_pallas) == (H, W, True)
    assert fit.cyl_radius == reg.cyl_radius == 45.0


def test_configuration_is_its_sibling_at_full_hd():
    """Every field of ``cyl480-kernels`` holds, apart from the frame's
    height and width (and the describing text: name, source, deployment,
    assumptions)."""
    hd, sd = _cfg("cyl1080-kernels"), _cfg("cyl480-kernels")
    text = {"name", "source", "deployment", "assumed"}
    assert set(hd) == set(sd)
    for key in set(sd) - text:
        if key in ("height", "width"):
            continue
        if key == "detect":
            assert {k: v for k, v in hd[key].items() if k not in ("height", "width")} == \
                   {k: v for k, v in sd[key].items() if k not in ("height", "width")}
        else:
            assert hd[key] == sd[key], key
    assert (hd["height"], hd["width"], hd["detect"]["height"], hd["detect"]["width"]) == (H, W, H, W)
    assert hd["reduced"] == ["sequence_frames"]
    assert "f 900 px, centre (960, 540)" in hd["assumed"]["rig"]


def test_cell_is_the_batch_traffic_on_the_new_configuration(bench):
    cell = harness.Cell(bench, CELL)
    assert cell.config["name"] == "cyl1080-kernels" and cell.chips == 1
    assert cell.traffic == json.loads((REPO / "bench_h100" / "traffic" / "batch16.json").read_text())
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "batch_frames_per_s", "batch_p95_ms"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"cc_band_roofline", "bridge_split_roofline", "preprocess_binarize_roofline", "detect_ms.batch",
            "step_gap_pct.batch"} <= per_layer
    assert len(per_layer) == 15
    for name in ("cc_band_roofline", "bridge_split_roofline"):
        assert (REPO / "bench_h100" / "metrics" / f"{name}.py").exists()
    limits = cell.limits
    assert set(limits) == {"ids", "flags", "points", "xy_px", "tcyl", "params0", "reproj_px", "fval_rel",
                           "fval0_rel"}
    for v in limits.values():
        assert v["lower"] <= v["limit"] <= v["upper"]
        assert v["limit"] == 0 or v["lower"] < v["limit"] < v["upper"]


def test_plans_at_the_cells_sites():
    """The half-res CCs take the band route (28 bands of 20 rows), the
    quarter-res CC an 8-CTA cluster, the bridge its split route; the
    two-channel payload kernel takes the band route at both canvases."""
    band = tf.cc_plan(*HALF)
    assert band["route"] == "global" and (band["bands"], band["band_rows"]) == (28, 20)
    quarter = tf.cc_plan(*QUARTER)
    assert quarter.get("route") is None and quarter["cluster"] == 8
    assert tf.bridge_plan(*HALF)["route"] == "split"
    assert tf.cc_plan(*HALF, channels=2)["route"] == "global"
    assert tf.cc_plan(*QUARTER, channels=2)["route"] == "global"
    # The 480x640 cells' sites keep their cluster routes.
    assert tf.cc_plan(4 * B, 240, 384)["cluster"] == 4 and tf.cc_plan(4 * B, 128, 256)["cluster"] == 2
    assert "route" not in tf.bridge_plan(4 * B, 240, 384)


def test_route_bytes_at_the_cells_sites():
    """12 bytes a pixel for a warm CC call (float32 mask, int32 initial
    labels, int32 labels), 3 for the bool bridge, at the cell's
    (64, 544, 1024), and the kernels' own byte counts agree."""
    assert route_bytes.connected_components_bytes(*HALF) == 427_819_008
    assert route_bytes.connected_components_bytes(*HALF, warm=False) == 285_212_672
    assert route_bytes.bridge_morphology_bytes(*HALF) == 106_954_752
    assert route_bytes.connected_components_bytes(*HALF) == kernels.min_bytes("connected_components", *HALF, warm=True)
    assert route_bytes.bridge_morphology_bytes(*HALF) == kernels.min_bytes("bridge_morphology", *HALF, itemsize=1)
    kind = "NVIDIA H100 80GB HBM3"
    least_ms = 427_819_008 / 3.35e12 * 1e3
    assert least_ms == pytest.approx(0.1277, abs=1e-4)
    assert roofline.bandwidth_share(427_819_008, 2 * least_ms, kind) == pytest.approx(50.0)


def _fake_run(use_pallas=True, entry="batch", counters=()):
    fe = types.SimpleNamespace(launch_counts=lambda: dict.fromkeys(counters, 0))
    driver = types.SimpleNamespace(entry=entry, detect_cfg=types.SimpleNamespace(use_pallas=use_pallas),
                                   p=types.SimpleNamespace(frontend=fe))
    return types.SimpleNamespace(driver=driver)


@pytest.mark.parametrize("metric", ["cc_band_roofline", "bridge_split_roofline"])
def test_readers_read_nothing_where_the_route_is_not_there(metric):
    """On the XLA branch, in a loop other than the batch's, and on a program
    that does not count the route, a reader returns None and does not
    raise: a parent that lacks the counter leaves the metric out."""
    read = harness.reader(metric)
    assert read(_fake_run(use_pallas=False)) is None
    assert read(_fake_run(entry="stream")) is None
    run = _fake_run(counters=("connected_components", "bridge_morphology"))
    run.memo = lambda key, fn: {"connected_components": [], "bridge_morphology": []}
    assert read(run) is None
    # A warm CC call and a bridge call recorded, on a program without the counter.
    site = ((None,), {"init_labels": object()})
    run.memo = lambda key, fn: {"connected_components": [site], "bridge_morphology": [site]}
    assert read(run) is None


def test_sites_are_the_detectors_calls_at_full_hd():
    """The calls the readers time, recorded from one eager ``detect_grid``
    on a 1080x1920 pair (B=1 here, 16 in the cell): the quarter-res CC in
    an 8-CTA cluster, the pre-bridge and the warm final CC on the band
    route, one bridge on the split route; float32 masks, int32 initial
    labels, bool bridge masks.  The wrappers are restored."""
    cfg = _cfg("cyl1080-kernels")
    p = program.port()
    detect, _, _ = program.configs(p, cfg)
    st, (i1, i2) = scenes.example_pair(H, W, n_frames=1, seed=5, pans=[12.0], radius=45.0)
    driver = types.SimpleNamespace(p=p, detect_cfg=detect, batches=[(i1, i2)],
                                   upload=lambda *a: tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a))
    memo = {}
    run = types.SimpleNamespace(driver=driver, memo=lambda k, fn: memo[k] if k in memo else memo.setdefault(k, fn()))
    originals = (tf.connected_components, tf.bridge_morphology)
    calls = sites.sites(run)
    assert (tf.connected_components, tf.bridge_morphology) == originals
    assert sites.sites(run) is calls
    cc = calls["connected_components"]
    assert [tuple(a[0].shape) for a, _ in cc] == [(4, 272, 512), (4, 544, 1024), (4, 544, 1024)]
    assert [tf.cc_plan(*a[0].shape).get("route", "cluster") for a, _ in cc] == ["cluster", "global", "global"]
    assert tf.cc_plan(*cc[0][0][0].shape)["cluster"] == 8
    assert [kw.get("init_labels") is not None for _, kw in cc] == [False, False, True]
    assert cc[2][0][0].dtype == torch.float32 and cc[2][1]["init_labels"].dtype == torch.int32
    (masks, exps, _, _), _ = calls["bridge_morphology"][0]
    assert len(calls["bridge_morphology"]) == 1 and masks.shape == (4, 544, 1024)
    assert masks.dtype == exps.dtype == torch.bool
    assert tf.bridge_plan(*masks.shape)["route"] == "split"


def test_one_pair_through_the_compiled_step_passes_the_cells_check(bench):
    """One 1080x1920 pair of the cell's scene family (45 mm cylinder, pan
    12, where the reference finds the frame healthy) through
    ``compiled_batch`` on the CPU, against the benchmark's plain reference
    under the cell's limits (``compare.frame``): every number, the fit's
    included, within its limit.  CPU tensors count nothing on the
    band-route counters."""
    cfg = _cfg("cyl1080-kernels")
    p = program.port()
    detect, fit, _ = program.configs(p, cfg)
    st, (i1, i2) = scenes.example_pair(H, W, n_frames=1, seed=4_300_002_020, pans=[12.0], radius=45.0)
    before = kernels.launch_counts()
    step = p.pipeline.compiled_batch(program.rig(p, st, "cpu"), detect, fit)
    ans = drivers.take(program.to_host(step(torch.from_numpy(i1), torch.from_numpy(i2))), 0)
    assert kernels.launch_counts() == before
    from bench_h100.reference import pipeline as ref

    want = ref.poses(i1, i2, st, cfg["detect"], cfg["fit"], cfg["registration"], workers=1)[0]
    assert want["healthy"] and len(want["detect1"]["ids"]) == len(want["detect2"]["ids"]) == 40
    readings = compare.frame(ans, want, cfg["registration"])
    assert {"tcyl", "params0", "reproj_px", "fval_rel", "fval0_rel", "xy_px", "ids"} <= set(readings)
    assert compare.over(readings, harness.Cell(bench, CELL).limits) == [], readings


@pytest.mark.parametrize("channels", [1, 2])
def test_cpu_calls_count_nothing_on_the_band_counters(channels):
    """A CPU tensor runs the plain version at a band-route shape: no
    counter moves."""
    n, h, w = 1, 544, 1024
    assert tf.cc_plan(n, h, w, channels=channels)["route"] == "global"
    g = torch.Generator().manual_seed(channels)
    m = (torch.rand((n, h, w), generator=g) < 0.4).to(torch.float32)
    before = kernels.launch_counts()
    assert set(BAND_COUNTERS) <= set(before) and set(kernels.COUNTERS) == set(before)
    if channels == 1:
        tf.connected_components(m, 1, 1)
    else:
        tf.component_payload_minmax(m, torch.arange(h * w, dtype=torch.int32).reshape(1, h, w), 1, 1)
    assert kernels.launch_counts() == before
