"""PyTorch port on the card: each CUDA kernel equals its plain version, and
the wrappers refuse what the kernels do not take.  Marked ``cuda``; they
skip without a CUDA device.  This file imports no JAX, so on a GPU machine
without JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

``chip_smoke.py`` is the full check at the production shapes.
"""

import functools
import math

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu_torch.ops import frontend as tf

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _equal(a, b):
    torch.cuda.synchronize()
    outs_a = a if isinstance(a, tuple) else (a,)
    outs_b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(outs_a, outs_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), int((x != y).sum())


@pytest.mark.parametrize("iters", [0, 5, 8])
@pytest.mark.parametrize("shape", [(2, 96, 256), (3, 240, 320), (1, 480, 640), (1, 488, 648)])
def test_preprocess_kernel_equals_plain(dev, shape, iters):
    """Widths and heights that are not multiples of the 32x64 tile, and the
    peak rounds at 0, 5 and 8 (halo 0 to 13 px)."""
    g = torch.Generator().manual_seed(sum(shape))
    img = torch.rand(shape, generator=g) * 255.0
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import _smooth

    x = _smooth(img.to(dev), CylinderDetectConfig())
    before = tf.launch_counts()["preprocess_binarize"]
    kw = dict(margin=24, joint_peak_iters=iters)
    _equal(tf.preprocess_binarize(x, **kw), tf.preprocess_binarize_plain(x, **kw))
    assert tf.launch_counts()["preprocess_binarize"] == before + 1


def test_preprocess_kernel_on_grid_lines(dev):
    """A grid of bright lines: joints, counts and peaks are non-trivial."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import _smooth

    h, w = 240, 320
    img = torch.full((2, h, w), 20.0)
    for y in range(30, h - 30, 17):
        img[:, y:y + 3, 30:w - 30] += 150.0
    for x in range(30, w - 30, 19):
        img[:, 30:h - 30, x:x + 3] += 150.0
    img += torch.randn(img.shape, generator=torch.Generator().manual_seed(3)) * 2.0
    x = _smooth(img.to(dev), CylinderDetectConfig())
    out = tf.preprocess_binarize(x, margin=24, joint_peak_iters=5)
    _equal(out, tf.preprocess_binarize_plain(x, margin=24, joint_peak_iters=5))
    assert float(out[5].sum()) > 0


def test_preprocess_margin_under_reach_raises(dev):
    x = torch.zeros((1, 96, 128), device=dev)
    with pytest.raises(ValueError):
        tf.preprocess_binarize(x, margin=tf.preprocess_reach() - 1)


@pytest.mark.parametrize("rounds, pools, warm", [(2, 4, False), (2, 2, False), (2, 2, True), (3, 1, False),
                                                (10, 4, False)])
@pytest.mark.parametrize("shape", [(4, 128, 256), (4, 240, 384), (4, 64, 128)])
def test_cc_kernel_equals_plain(dev, rounds, pools, warm, shape):
    g = torch.Generator().manual_seed(rounds * 10 + pools)
    m = (torch.rand(shape, generator=g) < 0.45).to(torch.float32).to(dev)
    init = None
    if warm:
        # Warm-start values up to 2 H*W: min(init, idx) must still win.
        init = torch.randint(0, 2 * shape[1] * shape[2], shape, generator=g, dtype=torch.int32).to(dev)
    before = tf.launch_counts()["connected_components"]
    _equal(tf.connected_components(m, rounds, pools, init),
           tf.connected_components_plain(m, rounds, pools, init))
    assert tf.launch_counts()["connected_components"] == before + 1


def _cluster_masks(h, w, rows_per):
    """(3, h, w): vertical bars, half of them crossing every split row and
    one a single run over the whole height; a serpentine that stays
    unconverged after 2 rounds; blobs straddling each split row."""
    m = torch.zeros((3, h, w))
    m[0, 1:h - 1, w // 2] = 1
    for x in range(5, w - 5, 9):
        m[0, 3 + x % 7:h - 3 - x % 5, x] = 1
    m[0, ::rows_per, 5::18] = 0  # every other bar stops at each split row
    for y in range(2, h - 2, 4):
        m[1, y, 2:w - 2] = 1
        m[1, y:y + 4, w - 3 if (y // 4) % 2 == 0 else 2] = 1
    for r in range(rows_per, h, rows_per):
        for x in range(4, w - 8, 12):
            m[2, max(r - 3, 1):min(r + 3, h - 1), x:x + 5] = 1
    return m


@pytest.mark.parametrize("rounds, pools", [(2, 4), (2, 2), (3, 1), (10, 4)])
@pytest.mark.parametrize("hw", [(128, 256), (240, 384), (64, 128)])
def test_cc_kernel_across_cluster_splits(dev, rounds, pools, hw):
    h, w = hw
    plan = tf.cc_plan(3, h, w)
    m = _cluster_masks(h, w, plan["rows_per_cta"]).to(dev)
    init = torch.full(m.shape, h * w + 5, dtype=torch.int32, device=dev)  # every value >= H*W
    for start in (None, init):
        _equal(tf.connected_components(m, rounds, pools, start),
               tf.connected_components_plain(m, rounds, pools, start))
    if rounds == 2:
        # The serpentine is unconverged after 2 rounds, on the card as in the plain version.
        lab = tf.connected_components(m, rounds, pools)[1]
        on = m[1] > 0.5
        assert int(lab[on].max()) != int(lab[on].min())


@pytest.mark.parametrize("kernel_len", [0.0, 20.0, 124.0, 300.0])
def test_bridge_kernel_equals_plain(dev, kernel_len):
    n, h, w = 6, 240, 384
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    angles = [0.0, math.pi / 2, 0.4, 1.1, -0.7, 2.3]
    ms = []
    for a in angles:
        d = (xx - w / 2) * math.sin(a) - (yy - h / 2) * math.cos(a)
        al = (xx - w / 2) * math.cos(a) + (yy - h / 2) * math.sin(a)
        ms.append(((torch.remainder(d + 200, 16) - 8).abs() < 1.0) & ((torch.remainder(al, 30) - 15).abs() > 4))
    m = torch.stack(ms).to(torch.float32).to(dev)
    g = torch.Generator().manual_seed(int(kernel_len))
    ex = (torch.rand((n, h, w), generator=g) < 0.8).to(torch.float32).to(dev)
    ang = torch.tensor(angles, device=dev)
    kl = torch.tensor(kernel_len, device=dev)
    _equal(tf.bridge_morphology(m, ex, ang, kl, 5, 125),
           tf.bridge_morphology_plain(m, ex, ang, kl, 5, 125))


def _border_lines(n, h, w, angles, seed):
    """(n, h, w) bool: broken 2-px lines at the given angles plus pixels on
    all four borders (the shifts' zero fill and the erosion's one fill)."""
    g = torch.Generator().manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    m = torch.zeros((n, h, w), dtype=torch.bool)
    for i in range(n):
        a = float(angles[i % len(angles)])
        d = (xx - w / 2) * math.sin(a) - (yy - h / 2) * math.cos(a)
        al = (xx - w / 2) * math.cos(a) + (yy - h / 2) * math.sin(a)
        shift = float(torch.rand(1, generator=g)) * 16
        m[i] = ((torch.remainder(d + shift, 13) - 6.5).abs() < 1.0) & ((torch.remainder(al, 29) - 14.5).abs() > 3)
    m[:, 0, ::3] = True
    m[:, -1, 1::4] = True
    m[:, ::5, 0] = True
    m[:, 2::3, -1] = True
    return m


SWEEP = [0.0, math.pi / 2, -math.pi / 2, math.pi / 4, -math.pi / 4, 0.4, 1.1, -0.7, 2.3, 3.0, -2.9, 1.5707964]


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.float32])
@pytest.mark.parametrize("hw", [(37, 100), (241, 383), (240, 384), (121, 640)])
@pytest.mark.parametrize("n", [8, 24, 64, 140])
def test_bridge_kernel_across_cluster_splits(dev, n, hw, dtype):
    """Clusters of 8, 4, 2 and 1 CTAs (by the batch size), widths off 32,
    odd heights, masks on every border, one kernel length per mask pair."""
    h, w = hw
    assert tf.bridge_plan(n, h, w)["cluster"] == {8: 8, 24: 4, 64: 2, 140: 1}[n]
    g = torch.Generator().manual_seed(n + h + w)
    m = _border_lines(n, h, w, SWEEP, n + w).to(dtype).to(dev)
    ex = (torch.rand((n, h, w), generator=g) < 0.8).to(dtype).to(dev)
    ang = torch.tensor([SWEEP[i % len(SWEEP)] for i in range(n)], device=dev)
    kl = torch.tensor([0.0, 20.0, 124.0, 300.0], device=dev)[torch.arange(n // 2, device=dev) % 4]
    before = tf.launch_counts()["bridge_morphology"]
    out = tf.bridge_morphology(m, ex, ang, kl, 5, 125)
    _equal(out, tf.bridge_morphology_plain(m, ex, ang, kl, 5, 125))
    assert out.dtype == dtype and tf.launch_counts()["bridge_morphology"] == before + 1


@pytest.mark.parametrize("kernel_len", [0.0, 20.0, 124.0, 300.0])
@pytest.mark.parametrize("probe_len", [1, 2, 3, 5, 8, 64])
def test_bridge_kernel_probe_lengths(dev, probe_len, kernel_len):
    n, h, w = len(SWEEP), 96, 128
    m = _border_lines(n, h, w, SWEEP, probe_len).to(dev)
    ex = (torch.rand((n, h, w), generator=torch.Generator().manual_seed(probe_len)) < 0.7).to(dev)
    ang = torch.tensor(SWEEP, device=dev)
    kl = torch.tensor(kernel_len, device=dev)
    sched = torch.zeros((n, tf.bridge_schedule_size(probe_len, 125)), dtype=torch.int32, device=dev)
    _equal(tf.bridge_morphology(m, ex, ang, kl, probe_len, 125, schedule_out=sched),
           tf.bridge_morphology_plain(m, ex, ang, kl, probe_len, 125))
    ray, line = tf.bridge_schedule(ang, kl, probe_len, 125)
    _equal(sched, torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1))


@pytest.mark.parametrize("probe_len, max_kernel", [(5, 125), (64, 300)])
def test_bridge_schedule_in_kernel_equals_torch_on_card(dev, probe_len, max_kernel):
    """The kernel's own schedule (sinf, cosf, rintf) equals
    ``bridge_schedule`` computed by torch on the card for 10^5 angles and a
    kernel length per mask pair; the count that differs from the CPU's
    schedule is printed."""
    n = 100_000
    g = torch.Generator().manual_seed(probe_len)
    ang = (torch.rand(n, generator=g) * 2 - 1) * math.pi
    ang[:len(SWEEP)] = torch.tensor(SWEEP)
    kl = torch.rand(n // 2, generator=g) * 320.0
    kl[:4] = torch.tensor([0.0, 20.0, 124.0, 300.0])
    m = torch.zeros((n, 2, 32), dtype=torch.bool, device=dev)
    sched = torch.zeros((n, tf.bridge_schedule_size(probe_len, max_kernel)), dtype=torch.int32, device=dev)
    tf.bridge_morphology(m, m, ang.to(dev), kl.to(dev), probe_len, max_kernel, schedule_out=sched)
    ray, line = tf.bridge_schedule(ang.to(dev), kl.to(dev), probe_len, max_kernel)
    _equal(sched, torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1))
    ray_c, line_c = tf.bridge_schedule(ang, kl, probe_len, max_kernel)
    host = torch.cat([ray_c.reshape(n, -1), line_c.reshape(n, -1)], 1)
    print(f"in-kernel schedule vs the CPU's: {int((sched.cpu() != host).any(1).sum())} of {n} masks differ")


def test_bridge_wrapper_refuses(dev):
    m = torch.zeros((4, 32, 64), dtype=torch.bool, device=dev)
    ang = torch.zeros(4, device=dev)
    kl = torch.tensor(10.0, device=dev)
    with pytest.raises(ValueError, match="bool, uint8 or float32"):
        tf.bridge_morphology(m.to(torch.float64), m, ang, kl, 5, 125)
    with pytest.raises(ValueError, match="dividing"):
        tf.bridge_morphology(m, m, ang, torch.ones(3, device=dev), 5, 125)
    with pytest.raises(ValueError, match="schedule_out"):
        tf.bridge_morphology(m, m, ang, kl, 5, 125, schedule_out=torch.zeros((4, 3), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="probe_len"):
        tf.bridge_morphology(m, m, ang, kl, 65, 125)


@pytest.mark.parametrize("rounds, pools", [(2, 4), (1, 2), (3, 1), (10, 4)])
@pytest.mark.parametrize("hw", [(64, 128), (128, 128), (128, 256), (240, 384)])
def test_payload_kernel_across_cluster_splits(dev, rounds, pools, hw):
    """Two-channel clusters of 1, 2, 4 and 8 CTAs: bars across every split
    row, a full column, an unconverged serpentine, random payload
    permutations."""
    h, w = hw
    plan = tf.cc_plan(3, h, w, channels=2)
    assert plan["cluster"] == {(64, 128): 1, (128, 128): 2, (128, 256): 4, (240, 384): 8}[hw]
    m = _cluster_masks(h, w, plan["rows_per_cta"]).to(dev)
    g = torch.Generator().manual_seed(rounds * 10 + pools + h + w)
    pay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(3)]).reshape(3, h, w)
    pay = pay.to(torch.int32).to(dev)
    before = tf.launch_counts()["component_payload_minmax"]
    lo, hi = tf.component_payload_minmax(m, pay, rounds, pools)
    _equal((lo, hi), tf.component_payload_minmax_plain(m, pay, rounds, pools))
    assert tf.launch_counts()["component_payload_minmax"] == before + 1
    if rounds == 2:  # the serpentine is still unconverged
        on = m[1] > 0.5
        assert int(lo[1][on].max()) != int(lo[1][on].min())


@pytest.mark.parametrize("rounds, pools", [(2, 4), (1, 2), (3, 1)])
@pytest.mark.parametrize("shape", [(4, 128, 256), (4, 240, 384)])
def test_payload_minmax_kernel_equals_plain(dev, rounds, pools, shape):
    n, h, w = shape
    g = torch.Generator().manual_seed(rounds * 10 + pools + h)
    m = (torch.rand(shape, generator=g) < 0.45).to(torch.float32).to(dev)
    pay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(n)])
    pay = pay.reshape(shape).to(torch.int32).to(dev)
    before = tf.launch_counts()["component_payload_minmax"]
    _equal(tf.component_payload_minmax(m, pay, rounds, pools),
           tf.component_payload_minmax_plain(m, pay, rounds, pools))
    assert tf.launch_counts()["component_payload_minmax"] == before + 1


def test_wrappers_check_inputs(dev):
    x = torch.zeros((2, 64, 128), device=dev)
    with pytest.raises(ValueError):
        tf.preprocess_binarize(x.to(torch.float64))
    with pytest.raises(ValueError):
        tf.preprocess_binarize(x.transpose(1, 2))
    with pytest.raises(ValueError):
        tf.connected_components(x, 2, 2, torch.zeros((2, 64, 64), dtype=torch.int32, device=dev))
    big = torch.zeros((1, 480, 640), device=dev)
    with pytest.raises(ValueError):
        tf.bridge_morphology(big, big, torch.zeros(1, device=dev), torch.tensor(10.0), 5, 125)
    with pytest.raises(ValueError):
        tf.component_payload_minmax(x, torch.zeros((2, 64, 64), dtype=torch.int32, device=dev), 2, 4)


def test_pipeline_on_card_matches_cpu(dev):
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    st, (i1, i2) = example_pair(480, 640, n_frames=2)
    cfg = CylinderDetectConfig(use_pallas=True)
    cpu = estimate_poses_batch(torch.as_tensor(i1), torch.as_tensor(i2), stereo_from_numpy(*st, device="cpu"),
                               cfg, FitConfig())
    gpu = estimate_poses_batch(torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev),
                               stereo_from_numpy(*st, device=dev), cfg, FitConfig())
    for a, b in ((cpu.detect1, gpu.detect1), (cpu.detect2, gpu.detect2)):
        np.testing.assert_array_equal(a.grid.valid.numpy(), b.grid.valid.cpu().numpy())
        np.testing.assert_array_equal(a.grid.idx.numpy(), b.grid.idx.cpu().numpy())
        np.testing.assert_allclose(a.grid.xy.numpy(), b.grid.xy.cpu().numpy(), atol=1e-3)


@pytest.mark.parametrize("mode", ["endpoint", "plane"])
def test_detect_on_card_matches_cpu(dev, mode):
    """The endpoint-stats and plane detectors on the card give the CPU's
    grids (kernels vs plain versions through the whole detector)."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair, plane_view

    if mode == "endpoint":
        _, (imgs, _) = example_pair(480, 640, n_frames=2)
        cfg = CylinderDetectConfig(use_pallas=True, bridge_endpoint_stats=True)
    else:
        imgs = np.stack([plane_view(480, 640, (0.0, 0.0, 700.0), (0.05, -0.08, -1.0), 9, 11, 30.0, 1),
                         plane_view(480, 640, (5.0, 0.0, 700.0), (0.05, -0.08, -1.0), 9, 9, 30.0, 2,
                                    gap_col=2)])
        cfg = PlaneDetectConfig(use_pallas=True, roi_threshold=30.0)
    cpu = detect_grid(torch.as_tensor(imgs), cfg)
    gpu = detect_grid(torch.as_tensor(imgs, device=dev), cfg)
    np.testing.assert_array_equal(cpu.grid.valid.numpy(), gpu.grid.valid.cpu().numpy())
    np.testing.assert_array_equal(cpu.grid.idx.numpy(), gpu.grid.idx.cpu().numpy())
    np.testing.assert_allclose(cpu.grid.xy.numpy(), gpu.grid.xy.cpu().numpy(), atol=1e-3)
    assert cpu.bridged_components.tolist() == gpu.bridged_components.cpu().tolist()


# The detector's half-res canvases (detector._pool2_pad) of the frames past
# the cluster kernels' shared memory: 600x800, 768x1024, 1024x768, 720x1280,
# 960x1280, 1080x1920, 1200x1600.  The two-channel CC plan takes its global
# route at all seven, the one-channel CC at the last four, where the bridge
# takes its split route.
LARGE_CANVASES = [(304, 512), (384, 512), (512, 384), (360, 640), (480, 640), (544, 1024), (600, 896)]
LARGE_CC = [(hw, 1) for hw in LARGE_CANVASES[3:]] + [(hw, 2) for hw in LARGE_CANVASES]


@pytest.mark.parametrize("hw, channels", LARGE_CC)
def test_cc_global_route_equals_plain(dev, hw, channels):
    """The large-frame route of the CC family: random masks and the
    split-row structures (bars, a serpentine, blobs), cold and warm starts,
    several round schedules; one launch count per call."""
    h, w = hw
    assert tf.cc_plan(2, h, w, channels=channels)["route"] == "global"
    g = torch.Generator().manual_seed(h + w + channels)
    rnd = (torch.rand((2, h, w), generator=g) < 0.45).to(torch.float32)
    m = torch.cat([rnd, _cluster_masks(h, w, 64)]).to(dev)
    n = m.shape[0]
    key = "connected_components" if channels == 1 else "component_payload_minmax"
    for rounds, pools in ((2, 2), (2, 4), (3, 1), (1, 0)):
        before = tf.launch_counts()[key]
        if channels == 1:
            init = torch.randint(0, 2 * h * w, m.shape, generator=g, dtype=torch.int32).to(dev)
            for start in (None, init):
                _equal(tf.connected_components(m, rounds, pools, start),
                       tf.connected_components_plain(m, rounds, pools, start))
            calls = 2
        else:
            pay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(n)]).reshape(n, h, w)
            pay = pay.to(torch.int32).to(dev)
            _equal(tf.component_payload_minmax(m, pay, rounds, pools),
                   tf.component_payload_minmax_plain(m, pay, rounds, pools))
            calls = 1
        assert tf.launch_counts()[key] == before + calls


def _band_masks(n, h, w, band_rows, seed):
    """(n, h, w) float masks that stress the band route: random pixels, and
    in mask 0 a column in the mask over the whole height (one run across
    every band), runs ending exactly on each band edge, one-pixel gaps on
    the first and on the last row of each band; in mask 1 a serpentine
    across the bands."""
    g = torch.Generator().manual_seed(seed)
    m = torch.rand((n, h, w), generator=g) < 0.45
    m[0, :, 3] = True
    m[0, :, 8] = True
    m[0, :, 9] = True
    for y0 in range(band_rows, h, band_rows):
        m[0, y0 - 3:y0, 6] = True
        m[0, y0:y0 + 2, 6] = False
        m[0, y0, 8] = False
        m[0, y0 - 1, 9] = False
    if n > 1:
        m[1] = False
        for y in range(2, h - 2, 3):
            m[1, y, 2:w - 2] = True
            m[1, y:y + 3, w - 3 if (y // 3) % 2 == 0 else 2] = True
    return m.to(torch.float32)


def _device_kernels_per_call(fns):
    """CUDA kernels that each call in ``fns`` launches: the kernel nodes of
    a CUDA graph captured from one call (``utils.profiling.graph_kernels``).
    Unlike a torch.profiler session, which late in a long process may
    record nothing (PERF.md), the count does not depend on the process's
    history."""
    from cylinder_pose_estimation_tpu_torch.utils.profiling import graph_kernels

    return [graph_kernels(fn, reps=1, warmup=0)[0] for fn in fns]


# (n, h, w): H a multiple of the bands' rows and not, widths where two
# channels fuse their pools and where they do not (2048), one mask and the
# ds=1 variants' 64 masks at 480x640.
BAND_CASES = [(2, 360, 640), (2, 481, 640), (2, 500, 700), (2, 544, 1024), (2, 480, 2048), (1, 480, 640),
              (64, 480, 640)]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("shape", BAND_CASES)
def test_cc_band_route_equals_plain(dev, shape, channels):
    """The band route on masks built around its band edges (``_band_masks``
    with the plan's band rows), every schedule of the detector plus 1x0,
    cold and warm; each call is one wrapper launch and
    ``cc_global_launches`` device kernels."""
    n, h, w = shape
    key = "connected_components" if channels == 1 else "component_payload_minmax"
    timed, want = [], []
    for rounds, pools in ((2, 2), (2, 4), (3, 2), (1, 0)):
        plan = tf.cc_plan(n, h, w, channels=channels, pools_per_round=pools)
        assert plan["route"] == "global"
        m = _band_masks(n, h, w, plan["band_rows"], h + w + rounds + pools).to(dev)
        g = torch.Generator().manual_seed(rounds * 10 + pools)
        if channels == 1:
            init = torch.randint(0, 2 * h * w, m.shape, generator=g, dtype=torch.int32).to(dev)
            calls = [functools.partial(tf.connected_components, m, rounds, pools, start) for start in (None, init)]
            plains = [functools.partial(tf.connected_components_plain, m, rounds, pools, start)
                      for start in (None, init)]
        else:
            pay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(n)]).reshape(n, h, w)
            pay = pay.to(torch.int32).to(dev)
            calls = [functools.partial(tf.component_payload_minmax, m, pay, rounds, pools)]
            plains = [functools.partial(tf.component_payload_minmax_plain, m, pay, rounds, pools)]
        for call, plain in zip(calls, plains):
            before = tf.launch_counts()[key]
            _equal(call(), plain())
            assert tf.launch_counts()[key] == before + 1
        timed.append(calls[0])
        want.append(tf.cc_global_launches(rounds, pools, plan["fused"]))
        if rounds == 2 and n > 1 and channels == 1:  # the serpentine is still unconverged
            lab = calls[0]()[1]
            on = m[1] > 0.5
            assert int(lab[on].max()) != int(lab[on].min())
    assert _device_kernels_per_call(timed) == want


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("band_rows", [1, 2, 3, 7, 18, 33, 100])
def test_cc_band_rows_equal_plain(dev, band_rows, fused):
    """The band kernel at band heights the plans do not pick (bands shorter
    than the halo, one row, H not a multiple), through the wrappers' launch
    helper with a plan of that height: labels cold and warm and the payload
    equal the plain versions."""
    n, h, w = 3, 100, 130
    m = _band_masks(n, h, w, band_rows, band_rows).to(dev)
    g = torch.Generator().manual_seed(band_rows)
    init = torch.randint(0, 2 * h * w, m.shape, generator=g, dtype=torch.int32).to(dev)
    pay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(n)]).reshape(n, h, w)
    pay = pay.to(torch.int32).to(dev)
    for rounds, pools in ((2, 2), (2, 4), (3, 1), (1, 0)):
        for channels in (1, 2):
            kp = pools if fused else 0  # pools inside the band kernel
            plan = {"band_rows": band_rows, "fused": fused,
                    "smem": 4 * channels * (2 if kp else 1) * (band_rows + 2 * kp) * w,
                    "scratch_ints": channels * n * h * w + n * -(-h // band_rows) * w * (2 * channels + 2)}
            outs = [torch.empty(m.shape, dtype=torch.int32, device=dev) for _ in range(channels)]
            if channels == 1:
                for start in (None, init):
                    tf._cc_global("cpe_connected_components_global", m, start, outs, rounds, pools, plan)
                    _equal(outs[0], tf.connected_components_plain(m, rounds, pools, start))
            else:
                tf._cc_global("cpe_component_payload_minmax_global", m, pay, outs, rounds, pools, plan)
                _equal(tuple(outs), tf.component_payload_minmax_plain(m, pay, rounds, pools))


def _bridge_route_call(dev, m, ex, ang, kl, probe_len, max_kernel, route):
    """One bridge call on ``route``: ``torch.equal`` to plain, its schedule
    equal to ``bridge_schedule``, one wrapper launch counted for the bridge
    and for the route."""
    n = m.shape[0]
    sched = torch.zeros((n, tf.bridge_schedule_size(probe_len, max_kernel)), dtype=torch.int32, device=dev)
    before = tf.launch_counts()
    out = tf.bridge_morphology(m, ex, ang, kl, probe_len, max_kernel, schedule_out=sched)
    _equal(out, tf.bridge_morphology_plain(m, ex, ang, kl, probe_len, max_kernel))
    after = tf.launch_counts()
    assert out.dtype == m.dtype
    for key in ("bridge_morphology", f"bridge_morphology.{route}"):
        assert after[key] == before[key] + 1
    ray, line = tf.bridge_schedule(ang, kl, probe_len, max_kernel)
    _equal(sched, torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1))


# (h, w) masks that no 8-CTA split holds (4K frames at full resolution).
GLOBAL_ONLY = [(2160, 3840), (1100, 4096)]


@pytest.mark.parametrize("dtype", [torch.bool, torch.float32])
@pytest.mark.parametrize("hw", GLOBAL_ONLY)
def test_bridge_global_route_equals_plain(dev, hw, dtype):
    """The bridge's per-pass route, where it remains (masks past what 8 CTAs
    of the split route hold), bool and float32 interfaces: lines at the
    sweep's angles with pixels on every border, kernel lengths from 0 (every
    line step (0, 0)) past the caps, the cylinder (5, 125) and plane (5, 180)
    reaches and a short probe; the schedule it computes equals
    ``bridge_schedule``."""
    h, w = hw
    n = len(SWEEP)
    assert tf.bridge_plan(n, h, w)["route"] == "global"
    g = torch.Generator().manual_seed(h + w)
    m = _border_lines(n, h, w, SWEEP, h + w).to(dtype).to(dev)
    ex = (torch.rand((n, h, w), generator=g) < 0.8).to(dtype).to(dev)
    ang = torch.tensor(SWEEP, device=dev)
    kl = torch.tensor([0.0, 20.0, 124.0, 300.0, 90.0, 180.0], device=dev)
    for probe_len, max_kernel in ((5, 125), (5, 180), (2, 125)):
        _bridge_route_call(dev, m, ex, ang, kl, probe_len, max_kernel, "global")


# The split route's cases: every LARGE_CANVASES shape it takes, the
# full-resolution 480x640 sites (ds=1 at B=16: 64 masks; plane mode: 16),
# 720x1280 at full resolution, and a single mask with H off its 8 CTAs' rows
# and W off 32.  Near-vertical angles: the line reach runs along the rows.
SPLIT_CASES = [(12, *hw) for hw in LARGE_CANVASES[3:]] + [(64, 480, 640), (16, 480, 640), (2, 720, 1280),
                                                           (1, 481, 650)]
SPLIT_SWEEP = SWEEP + [1.45, -1.5, 1.62, 1.68]
SPLIT_REACH = ((9, 251), (9, 361), (5, 125), (2, 125))


def _split_inputs(shape, dtype, dev):
    n, h, w = shape
    g = torch.Generator().manual_seed(n + h + w)
    m = _border_lines(n, h, w, SPLIT_SWEEP, n + h).to(dtype).to(dev)
    ex = (torch.rand((n, h, w), generator=g) < 0.8).to(dtype).to(dev)
    ang = torch.tensor([SPLIT_SWEEP[i % len(SPLIT_SWEEP)] for i in range(n)], device=dev)
    kl = torch.tensor([300.0, 20.0, 124.0, 0.0, 251.0, 361.0, 90.0, 180.0], device=dev)[torch.arange(n) % 8]
    return m, ex, ang, kl


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.float32])
@pytest.mark.parametrize("shape", SPLIT_CASES)
def test_bridge_split_route_equals_plain(dev, shape, dtype):
    """The split route: per mask a cluster of 2-8 CTAs, each with its rows
    of the bit planes, the other rows read from their CTA.  Lines at the
    sweep's angles (near vertical among them: line steps of up to 180 rows
    cross two or more CTAs of 45-120 rows) with pixels on every border,
    per-mask kernel lengths from 0 past the caps, the reaches of the
    detector's sites; each call equal to plain, with its schedule."""
    n, h, w = shape
    plan = tf.bridge_plan(n, h, w)
    assert plan["route"] == "split" and plan["rows_per_cta"] < 181
    m, ex, ang, kl = _split_inputs(shape, dtype, dev)
    for probe_len, max_kernel in SPLIT_REACH:
        _bridge_route_call(dev, m, ex, ang, kl, probe_len, max_kernel, "split")


def test_bridge_split_route_one_device_kernel(dev):
    """One device kernel per call at the sites the split route serves:
    (64,480,640) probe 9 max kernel 251, (16,480,640) 9/361, (8,360,640)
    and (8,544,1024) 5/125."""
    calls = []
    for shape, (probe_len, max_kernel) in (((64, 480, 640), (9, 251)), ((16, 480, 640), (9, 361)),
                                           ((8, 360, 640), (5, 125)), ((8, 544, 1024), (5, 125))):
        assert tf.bridge_plan(*shape)["route"] == "split"
        m, ex, ang, kl = _split_inputs(shape, torch.bool, dev)
        calls.append(functools.partial(tf.bridge_morphology, m, ex, ang, kl, probe_len, max_kernel))
    assert _device_kernels_per_call(calls) == [1, 1, 1, 1]


def test_bridge_split_plans_fit_the_card(dev):
    """Every split plan of the detector's shapes (the half-res canvases of
    720x1280 to 1200x1600 at B=2 and B=16, the full-resolution masks of
    480x640 at B=16 and of 720x1280 and 1080x1920 at B=2) can launch: the
    card holds at least one cluster at its shared memory
    (cudaOccupancyMaxActiveClusters), for both pixel sizes."""
    from cylinder_pose_estimation_tpu_torch.ops import kernels

    shapes = [(n, *hw) for n in (8, 64) for hw in LARGE_CANVASES[3:]]
    shapes += [(64, 480, 640), (16, 480, 640), (8, 720, 1280), (8, 1080, 1920)]
    for shape in shapes:
        plan = tf.bridge_plan(*shape)
        assert plan["route"] == "split"
        for elem in (1, 4):
            assert kernels.bridge_split_max_clusters(elem, plan["cluster"], plan["smem"], dev) >= 1, (shape, plan)


@pytest.mark.parametrize("shape", [(2, 720, 1280), (2, 1080, 1920)])
def test_preprocess_kernel_at_large_frames(dev, shape):
    """All six outputs at 720p and 1080p, where the joint-peak key needs 21
    bits of linear index: smoothed noise and a grid of lines."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import _border_margin, _smooth

    cfg = CylinderDetectConfig()
    n, h, w = shape
    img = torch.rand(shape, generator=torch.Generator().manual_seed(h)) * 255.0
    img[1] = 20.0
    for y in range(40, h - 40, 17):
        img[1, y:y + 3, 40:w - 40] += 150.0
    for x in range(40, w - 40, 19):
        img[1, 40:h - 40, x:x + 3] += 150.0
    x = _smooth(img.to(dev), cfg)
    kw = dict(margin=_border_margin(cfg), joint_peak_iters=cfg.joint_peak_iters)
    out = tf.preprocess_binarize(x, **kw)
    _equal(out, tf.preprocess_binarize_plain(x, **kw))
    assert float(out[5][1].sum()) > 0


@pytest.mark.parametrize("endpoint", [False, True])
def test_detect_large_frame_on_card_matches_cpu(dev, endpoint):
    """One 720x1280 frame pair through the kernel branch (the global CC and
    split bridge routes) on the card and on the CPU: the same grids."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    _, (i1, i2) = example_pair(720, 1280, n_frames=1)
    imgs = np.concatenate([i1, i2])
    cfg = CylinderDetectConfig(height=720, width=1280, use_pallas=True, bridge_endpoint_stats=endpoint)
    cpu = detect_grid(torch.as_tensor(imgs), cfg)
    gpu = detect_grid(torch.as_tensor(imgs, device=dev), cfg)
    np.testing.assert_array_equal(cpu.grid.valid.numpy(), gpu.grid.valid.cpu().numpy())
    np.testing.assert_array_equal(cpu.grid.idx.numpy(), gpu.grid.idx.cpu().numpy())
    np.testing.assert_allclose(cpu.grid.xy.numpy(), gpu.grid.xy.cpu().numpy(), atol=1e-3)
    assert cpu.stable.tolist() == gpu.stable.cpu().tolist()
