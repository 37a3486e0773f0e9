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

from _torch_spd import KINDS, bits, spd_systems
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf
from cylinder_pose_estimation_tpu_torch.ops import kernels, labeling, linalg

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
    before = kernels.launch_counts()["preprocess_binarize"]
    kw = dict(margin=24, joint_peak_iters=iters, pre_smoothed=True)
    _equal(tf.preprocess_binarize(x, **kw), tf.preprocess_binarize_plain(x, **kw))
    assert kernels.launch_counts()["preprocess_binarize"] == before + 1


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
    out = tf.preprocess_binarize(x, margin=24, joint_peak_iters=5, pre_smoothed=True)
    _equal(out, tf.preprocess_binarize_plain(x, margin=24, joint_peak_iters=5, pre_smoothed=True))
    assert float(out[5].sum()) > 0


def test_preprocess_margin_under_reach_raises(dev):
    x = torch.zeros((1, 96, 128), device=dev)
    with pytest.raises(ValueError):
        tf.preprocess_binarize(x, margin=tf.preprocess_reach() - 1, pre_smoothed=True)


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
    before = kernels.launch_counts()["connected_components"]
    _equal(tf.connected_components(m, rounds, pools, init),
           tf.connected_components_plain(m, rounds, pools, init))
    assert kernels.launch_counts()["connected_components"] == before + 1


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
    before = kernels.launch_counts()["bridge_morphology"]
    out = tf.bridge_morphology(m, ex, ang, kl, 5, 125)
    _equal(out, tf.bridge_morphology_plain(m, ex, ang, kl, 5, 125))
    assert out.dtype == dtype and kernels.launch_counts()["bridge_morphology"] == before + 1


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
    before = kernels.launch_counts()["component_payload_minmax"]
    lo, hi = tf.component_payload_minmax(m, pay, rounds, pools)
    _equal((lo, hi), tf.component_payload_minmax_plain(m, pay, rounds, pools))
    assert kernels.launch_counts()["component_payload_minmax"] == before + 1
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
    before = kernels.launch_counts()["component_payload_minmax"]
    _equal(tf.component_payload_minmax(m, pay, rounds, pools),
           tf.component_payload_minmax_plain(m, pay, rounds, pools))
    assert kernels.launch_counts()["component_payload_minmax"] == before + 1


def test_wrappers_check_inputs(dev):
    x = torch.zeros((2, 64, 128), device=dev)
    with pytest.raises(ValueError):
        tf.preprocess_binarize(x.to(torch.float64), pre_smoothed=True)
    with pytest.raises(ValueError):
        tf.preprocess_binarize(x.transpose(1, 2), pre_smoothed=True)
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
        before = kernels.launch_counts()[key]
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
        assert kernels.launch_counts()[key] == before + calls


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
            before = kernels.launch_counts()[key]
            _equal(call(), plain())
            assert kernels.launch_counts()[key] == before + 1
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
    helper with a plan of that height: labels cold and warm, capped along
    either axis, and the payload equal the plain versions."""
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
                for cap_axis in (0, 1):  # cap 3 reaches 3 px
                    reach = tf.cap_reach((h, w)[cap_axis], 3)
                    capped = dict(plan, cap_axis=cap_axis, cap_reach=reach,
                                  **({"cap_strip": min(tf.CAPPED_STREAM_ROWS, h)} if cap_axis == 0 else {}))
                    tf._cc_global("cpe_connected_components_global", m, init, outs, rounds, pools, capped)
                    _equal(outs[0], tf.connected_components_plain(m, rounds, pools, init, cap_axis, 3))
            else:
                tf._cc_global("cpe_component_payload_minmax_global", m, pay, outs, rounds, pools, plan)
                _equal(tuple(outs), tf.component_payload_minmax_plain(m, pay, rounds, pools))


def _bridge_route_call(dev, m, ex, ang, kl, probe_len, max_kernel, route):
    """One bridge call on ``route``: ``torch.equal`` to plain, its schedule
    equal to ``bridge_schedule``, one wrapper launch counted for the bridge
    and for the route."""
    n = m.shape[0]
    sched = torch.zeros((n, tf.bridge_schedule_size(probe_len, max_kernel)), dtype=torch.int32, device=dev)
    before = kernels.launch_counts()
    out = tf.bridge_morphology(m, ex, ang, kl, probe_len, max_kernel, schedule_out=sched)
    _equal(out, tf.bridge_morphology_plain(m, ex, ang, kl, probe_len, max_kernel))
    after = kernels.launch_counts()
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
    kw = dict(margin=_border_margin(cfg), joint_peak_iters=cfg.joint_peak_iters, pre_smoothed=True)
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


def _grey_grid(n, h, w, seed):
    """(n, h, w) grey images: noise, then bright line grids on a dark floor."""
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((n, h, w), generator=g) * 255.0
    for i in range(1, n):
        img[i] = 20.0 + torch.randn((h, w), generator=g) * 2.0
        img[i, 30:h - 30:17] += 150.0
        img[i, :, 30:w - 30:19] += 150.0
    return img


@pytest.mark.parametrize("shape", [(2, 96, 256), (3, 240, 320), (2, 488, 648), (2, 40, 64), (1, 720, 1280)])
def test_preprocess_in_kernel_smoothing_equals_plain(dev, shape):
    """pre_smoothed=False: the kernel smooths the grey tile itself, its
    reads wrapped around the image (heights and widths under the halo of
    23 px included), and equals the plain version's rolls on every plane."""
    x = _grey_grid(*shape, seed=sum(shape)).to(dev)
    before = kernels.launch_counts()
    kw = dict(margin=24, joint_peak_iters=8)
    _equal(tf.preprocess_binarize(x, **kw), tf.preprocess_binarize_plain(x, **kw))
    after = kernels.launch_counts()
    assert after["preprocess_binarize"] == before["preprocess_binarize"] + 1
    assert after["preprocess_binarize.smoothing"] == before["preprocess_binarize.smoothing"] + 1


@pytest.mark.parametrize("blur_ksize, ridge_sigma", [(3, 1.5), (7, 2.0), (5, 4.0)])
def test_preprocess_in_kernel_smoothing_other_taps(dev, blur_ksize, ridge_sigma):
    x = _grey_grid(2, 240, 320, seed=blur_ksize).to(dev)
    kw = dict(blur_ksize=blur_ksize, ridge_sigma=ridge_sigma, margin=24)
    _equal(tf.preprocess_binarize(x, **kw), tf.preprocess_binarize_plain(x, **kw))


@pytest.mark.parametrize("shape", [(2, 40, 64), (1, 65, 129), (3, 130, 200), (2, 488, 648), (1, 720, 1280)])
@pytest.mark.parametrize("blur_ksize, ridge_sigma", [(5, 3.0), (3, 1.5), (7, 5.0), (3, 5.0), (7, 1.5)])
def test_smoothing_kernel_equals_four_rolls(dev, shape, blur_ksize, ridge_sigma):
    """The smoothing launch alone (the detector's radii 2 and 12 compiled in,
    other radii through the generic instantiation), at shapes that are not
    multiples of its 64 x 128 tile and smaller than its halo: torch.equal
    to _sep_conv_roll along W, H, W, H."""
    x = _grey_grid(*shape, seed=sum(shape) + blur_ksize).to(dev)
    k5, k25 = tf.smoothing_taps(blur_ksize, ridge_sigma)
    want = tf._sep_conv_roll(tf._sep_conv_roll(x, k5, 2), k5, 1)
    want = tf._sep_conv_roll(tf._sep_conv_roll(want, k25, 2), k25, 1)
    before = kernels.launch_counts()
    _equal(tf.wrapped_smoothing(x, blur_ksize, ridge_sigma), want)
    after = kernels.launch_counts()
    assert after["preprocess_binarize.smoothing"] == before["preprocess_binarize.smoothing"] + 1
    assert after["preprocess_binarize"] == before["preprocess_binarize"]


def test_preprocess_with_the_smoothing_device_kernels(dev):
    """pre_smoothed=False launches three device kernels a call (the
    smoothing, then launches A and B on its plane), pre_smoothed=True two."""
    x = _grey_grid(4, 240, 320, seed=7).to(dev)
    calls = [lambda: tf.preprocess_binarize(x, margin=24), lambda: tf.preprocess_binarize(x, margin=24, pre_smoothed=True)]
    assert _device_kernels_per_call(calls) == [3, 2]


# --- the front stage's banded correlations as stencils (ops/stencils) -----

STENCIL_SHAPES = [(32, 480, 640), (32, 1080, 1920), (4, 200, 328)]


def _corr64(x, taps, dim):
    """Zero-padded correlation out[i] = sum_t taps[t] * x[i + t - r] along
    ``dim``, in float64."""
    x = x.double()
    r = len(taps) // 2
    n = x.shape[dim]
    out = torch.zeros_like(x)
    for t, v in enumerate(taps):
        s = t - r
        if abs(s) < n:
            out.narrow(dim, max(0, -s), n - abs(s)).add_(x.narrow(dim, max(0, s), n - abs(s)), alpha=float(v))
    return out


def _two_pass_bound(x, taps):
    """What two float32 summation orders of the same two passes of
    ``taps`` (float32 operands, the intermediate kept in float32) may differ
    by: 2 gamma_n of the terms' magnitudes in each pass, the first pass's
    carried through the second, n the tap count."""
    k = [abs(v) for v in taps]
    g = len(taps) * 2.0**-24 * 1.01
    return 4 * g * _corr64(_corr64(x.abs(), k, 2), k, 1)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16_pass_bound(inter, taps):
    """Bound on the difference of the second pass of a bf16-operand band
    pair between two summation orders: the second pass's own 2 gamma_n, plus
    one bfloat16 step (at most 2^-7 relative) of every intermediate that
    the first pass's last bits may have rounded the other way."""
    k = [abs(v) for v in taps]
    g = len(taps) * 2.0**-24 * 1.01
    return 2 * g * _corr64(_bf16(inter).abs(), k, 1) + _corr64(inter.abs() * 2.0**-7, k, 1)


def _stencil_inputs(shape, seed, dev):
    """Grey images with saturated blocks and line grids, their integer
    rounding, sparse 0/1 joints and the joints' 11 x 11 count, on ``dev``."""
    n, h, w = shape
    gray = _grey_grid(n, h, w, seed)
    gray[0, h // 4:h // 2, w // 4:w // 2] = 255.0
    gray[-1, h // 3:h // 3 + 40, w // 3:w // 3 + 60] = 250.0
    gray = gray.to(dev)
    joints = (torch.rand(shape, generator=torch.Generator().manual_seed(seed + 1)) < 0.02).to(torch.float32).to(dev)
    cnt = _corr64(_corr64(joints, [1.0] * 11, 2), [1.0] * 11, 1).to(torch.float32)
    return gray, gray.round(), joints, cnt


@pytest.mark.parametrize("kw", [{}, dict(blur_ksize=3, ridge_sigma=2.0)], ids=["r14", "r9"])
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_stencil_smooth_equals_plain_within_bound(dev, shape, kw):
    """The smoothing stencil (the detector's radius 14 compiled in, radius 9
    through the generic instantiation) against the exact-mode banded
    matmuls on the card: the same float32 correlation in another summation
    order, so within two passes' rounding of sum |k| |k| |x|; one device
    kernel and one ``stencil_smooth`` count a call."""
    from cylinder_pose_estimation_tpu_torch.ops import stencils

    x = _grey_grid(*shape, seed=sum(shape)).to(dev)
    before = kernels.launch_counts()["stencil_smooth"]
    got = stencils.smooth(x, **kw)
    assert kernels.launch_counts()["stencil_smooth"] == before + 1
    want = stencils.smooth_plain(x, **kw)
    torch.cuda.synchronize()
    bound = _two_pass_bound(x, stencils.smooth_taps(**kw))
    assert bool(((got.double() - want.double()).abs() <= bound).all()), float((got - want).abs().max())
    ref = _corr64(_corr64(x, stencils.smooth_taps(**kw), 2), stencils.smooth_taps(**kw), 1)
    assert bool(((got.double() - ref).abs() <= bound).all())
    assert _device_kernels_per_call([lambda: stencils.smooth(x, **kw)]) == [1]


STATS_CASES = {
    "defaults": {},
    "center": dict(center_patch_half=5),
    "radii": dict(sat_blur_ksize=15, index_blur_ksize=5, center_patch_half=3, joint_window=9),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_stencil_stats_equals_plain(dev, shape, case):
    """The statistic-image stencil (the detector's radii compiled in; the
    centre box of ``bright_at_points=False``; other radii through the
    generic instantiation) against the banded matmuls on the card: the
    centroid images torch.equal (integer sums); the saturation blur within
    the bf16 pair's bound, and the saturation mask equal except at pixels
    within that bound of the threshold (ties of the two summation orders);
    the index blur equal on integer grey and within its bound otherwise;
    the centre box within two float32 passes' bound over its area."""
    from cylinder_pose_estimation_tpu_torch.ops import mxu_conv as mxc
    from cylinder_pose_estimation_tpu_torch.ops import stencils

    kw = dict(STATS_CASES[case], margin=20)
    n, h, w = shape
    gray_f, gray_i, joints, cnt = _stencil_inputs(shape, h + w, dev)
    for gray, integer in ((gray_f, False), (gray_i, True)):
        sat = torch.empty_like(gray)
        before = kernels.launch_counts()["stencil_stats"]
        got = stencils.stats_images(gray, joints, cnt, sat_out=sat, **kw)
        assert kernels.launch_counts()["stencil_stats"] == before + 1
        want = stencils.stats_images_plain(gray, joints, cnt, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        gt = mxc.gauss_taps_cv(kw.get("sat_blur_ksize", 19))
        inter = mxc.conv_x(gray, mxc.x_mat(gt, w, dev))
        sat_plain = mxc.conv_y(inter, mxc.y_mat(gt, h, dev))
        bound = _bf16_pass_bound(inter, stencils.stats_taps(kw.get("sat_blur_ksize", 19))[1][:len(gt)])
        assert bool(((sat.double() - sat_plain.double()).abs() <= bound).all())
        flips = got[0] != want[0]
        ties = (sat_plain.double() - 240.0).abs() <= bound
        assert bool((flips <= ties).all()), int(flips.sum())
        assert int(got[0].sum()) > 0
        gk = mxc.gauss_taps_cv(kw.get("index_blur_ksize", 7))
        if integer:
            assert torch.equal(got[2], want[2])
        else:
            inter = mxc.conv_x(gray, mxc.x_mat(gk, w, dev))
            bk = _bf16(torch.tensor(gk, dtype=torch.float32)).tolist()
            assert bool(((got[2].double() - want[2].double()).abs() <= _bf16_pass_bound(inter, bk)).all())
        if "center_patch_half" in kw:
            pc = 2 * kw["center_patch_half"] + 1
            cb = _two_pass_bound(gray, [1.0] * pc) / pc**2 + want[1].double().abs() * 2.0**-23
            assert bool(((got[1].double() - want[1].double()).abs() <= cb).all())
        else:
            assert got[1] is None and want[1] is None


def test_stencils_one_device_kernel_and_no_gemm_in_the_front_stage(dev):
    """Each stencil wrapper is one device kernel, and the kernel branch's
    front stage on the card dispatches no matrix product and makes no
    bfloat16 tensor on the device (the banded matmuls' traces)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models import detector
    from cylinder_pose_estimation_tpu_torch.ops import stencils

    gray, _, joints, cnt = _stencil_inputs((4, 240, 320), 5, dev)
    calls = [lambda: stencils.smooth(gray), lambda: stencils.stats_images(gray, joints, cnt, margin=20),
             lambda: stencils.stats_images(gray, joints, cnt, margin=20, center_patch_half=5)]
    assert _device_kernels_per_call(calls) == [1, 1, 1]

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and out.device.type == "cuda":
                self.seen.append((str(func), out.dtype))
            return out

    for bright_at_points in (True, False):
        cfg = CylinderDetectConfig(height=240, width=320, use_pallas=True, bright_at_points=bright_at_points)
        with Ops() as rec:
            detector.front_stage(gray, cfg)
        names = [f for f, _ in rec.seen]
        assert not [f for f in names if any(m in f for m in ("aten.mm", "aten.bmm", "aten.addmm", "aten.matmul"))]
        assert torch.bfloat16 not in [d for _, d in rec.seen]


@pytest.mark.parametrize("case", ["dtype", "device", "shape", "contiguous", "radius"])
def test_stencil_wrappers_refuse(dev, case):
    from cylinder_pose_estimation_tpu_torch.ops import stencils

    x = torch.rand((2, 64, 128), device=dev)
    bad = {"dtype": x.double(), "device": x, "shape": x[0], "contiguous": x.transpose(1, 2), "radius": x}[case]
    if case == "device":
        with pytest.raises(ValueError):
            stencils.stats_images(x, x.cpu(), x, margin=4)
        return
    if case == "radius":
        with pytest.raises(ValueError):
            stencils.smooth(x, blur_ksize=5, ridge_sigma=8.0)
        with pytest.raises(ValueError):
            stencils.stats_images(x, x, x, sat_blur_ksize=65)
        return
    with pytest.raises(ValueError):
        stencils.smooth(bad)
    with pytest.raises(ValueError):
        stencils.stats_images(bad, x, x, margin=4)


def test_compiled_batch_captures_one_stencil_each(dev):
    """A captured kernel-branch B=4 step records one smoothing and one
    statistic-image stencil a call (``graph.captured.*``), and every replay
    runs them (``graph.replayed.*``)."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    st, (i1, i2) = example_pair(240, 320, n_frames=4)
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=True)
    a, b = torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev)
    pipeline._STREAM_STEP_CACHE.clear()
    step = pipeline.compiled_batch(stereo, cfg, FitConfig())
    pipeline.reset_graph_launch_counts()
    for _ in range(3):
        step(a, b)
    counts = pipeline.graph_launch_counts()
    for name in ("stencil_smooth", "stencil_stats"):
        assert counts["captured"].get(name) == 1, counts
        assert counts["replayed"].get(name) == 2, counts


def _cross_cap_masks(n, h, w, seed):
    """Wavy 2-px lines along W and H, blobs thicker than the caps, random
    pixels: tests/test_pallas.py's cross-cap mask and its transpose among
    them."""
    g = torch.Generator().manual_seed(seed)
    m = (torch.rand((n, h, w), generator=g) < 0.4).to(torch.float32)
    xs = torch.arange(10, w - 10)
    for yc in range(24, h - 24, 20):
        ys = (yc + 6 * torch.sin(xs / 45.0)).to(torch.int64)
        m[0, ys, xs] = 1
        m[0, ys + 1, xs] = 1
    ys = torch.arange(10, h - 10)
    for xc in range(24, w - 24, 20):
        xx = (xc + 6 * torch.sin(ys / 45.0)).to(torch.int64)
        m[1 % n, ys, xx] = 1
        m[1 % n, ys, xx + 1] = 1
    m[0, h // 2:h // 2 + 24, w // 2:w // 2 + 30] = 1
    m[1 % n, h // 3:h // 3 + 30, w // 3:w // 3 + 24] = 1
    return m


@pytest.mark.parametrize("cap", [1, 2, 3, 10, 16])
@pytest.mark.parametrize("cap_axis", [0, 1])
@pytest.mark.parametrize("hw", [(240, 384), (128, 256), (96, 256)])
def test_cc_capped_at_cluster_route_shapes_equals_plain(dev, hw, cap_axis, cap):
    """The capped scan at shapes whose uncapped calls take the cluster route
    (with masks that cross every CTA split): the capped calls take the band
    route there, cold and warm, at several round schedules; counted on the
    band route."""
    h, w = hw
    assert "cluster" in tf.cc_plan(4, h, w)
    plan = tf.cc_plan(4, h, w, cap_axis=cap_axis, cap=cap)
    assert plan["route"] == "global" and plan["cap_reach"] == tf.cap_reach((h, w)[cap_axis], cap)
    m = torch.cat([_cross_cap_masks(2, h, w, cap), _cluster_masks(h, w, tf.cc_plan(4, h, w)["rows_per_cta"])[:2]])
    m = m.to(dev)
    g = torch.Generator().manual_seed(h + cap)
    init = torch.randint(0, 2 * h * w, m.shape, generator=g, dtype=torch.int32).to(dev)
    for rounds, pools in ((1, 2), (2, 2), (3, 1), (24, 2)):
        for start in (None, init):
            before = kernels.launch_counts()["connected_components.capped.band"]
            _equal(tf.connected_components(m, rounds, pools, start, cap_axis=cap_axis, cap=cap),
                   tf.connected_components_plain(m, rounds, pools, start, cap_axis=cap_axis, cap=cap))
            assert kernels.launch_counts()["connected_components.capped.band"] == before + 1


@pytest.mark.parametrize("cap", [1, 3, 16])
@pytest.mark.parametrize("cap_axis", [0, 1])
@pytest.mark.parametrize("shape, pools", [((2, 480, 640), 2), ((2, 360, 640), 0), ((1, 64, 5000), 2)])
def test_cc_capped_band_route_equals_plain(dev, shape, pools, cap_axis, cap):
    """The capped scan on the large-frame route: fused bands, no pools (the
    band keeps two buffers for a cap along W) and unfused pools (a mask
    5000 px wide); one launch count per call, on the band route."""
    n, h, w = shape
    plan = tf.cc_plan(n, h, w, pools_per_round=pools, cap_axis=cap_axis, cap=cap)
    assert plan["route"] == "global" and plan["fused"] == (w < 5000)
    m = _cross_cap_masks(n, h, w, cap).to(dev)
    g = torch.Generator().manual_seed(w + cap)
    init = torch.randint(0, 2 * h * w, m.shape, generator=g, dtype=torch.int32).to(dev)
    for rounds in (1, 2, 3):
        for start in (None, init):
            before = kernels.launch_counts()["connected_components.capped.band"]
            _equal(tf.connected_components(m, rounds, pools, start, cap_axis=cap_axis, cap=cap),
                   tf.connected_components_plain(m, rounds, pools, start, cap_axis=cap_axis, cap=cap))
            assert kernels.launch_counts()["connected_components.capped.band"] == before + 1


# Capped calls at shapes a cluster holds, reach past the band rows at cap 64
# along H ((96, 256): one band of 96 rows) and reaches past a warp along W.
CLUSTER_SIZE_CAP_CASES = [((h, w), a, c) for h, w in ((504, 200), (120, 700), (96, 256)) for a in (0, 1)
                          for c in (1, 2, 3, 10, 16, 64)]


@pytest.mark.parametrize("hw, cap_axis, cap", CLUSTER_SIZE_CAP_CASES)
def test_cc_capped_at_cluster_sizes_equals_plain(dev, hw, cap_axis, cap):
    """Capped calls where an uncapped one takes the cluster route: the band
    route, cold and warm, torch.equal to plain."""
    h, w = hw
    plan = tf.cc_plan(2, h, w, pools_per_round=2, cap_axis=cap_axis, cap=cap)
    assert plan["route"] == "global"
    m = torch.cat([_cross_cap_masks(1, h, w, cap), _cluster_masks(h, w, 16)[:1]]).to(dev)
    g = torch.Generator().manual_seed(h + cap)
    init = torch.randint(0, 2 * h * w, m.shape, generator=g, dtype=torch.int32).to(dev)
    for rounds, pools in ((1, 2), (2, 2), (5, 1)):
        for start in (None, init):
            _equal(tf.connected_components(m, rounds, pools, start, cap_axis=cap_axis, cap=cap),
                   tf.connected_components_plain(m, rounds, pools, start, cap_axis=cap_axis, cap=cap))


# Band-route calls at caps the other band test leaves out: along H the
# streamed column pass (strips of 64 rows) up to cap 16 and the walk past
# it, at cap 256 past the strip and, on the 360-row canvas of 720x1280,
# past most of the mask; along W one in-place row pass up to cap 32 and the
# walk into a second band buffer past it.  (2, 240, 384) is a shape of the
# cluster route.
BAND_CAP_CASES = ([((2, 480, 640), 2, a, c) for a in (0, 1) for c in (2, 10, 64, 256)]
                  + [((2, 300, 1200), 0, a, c) for a in (0, 1) for c in (10, 64)] + [((2, 240, 384), 2, 0, 64)]
                  + [((2, 360, 640), 2, 0, 256)])


@pytest.mark.parametrize("shape, pools, cap_axis, cap", BAND_CAP_CASES)
def test_cc_capped_band_route_reach_past_the_strip(dev, shape, pools, cap_axis, cap):
    """The band route's capped passes, reach past the strip included; cold
    and warm, torch.equal to plain."""
    n, h, w = shape
    plan = tf.cc_plan(n, h, w, pools_per_round=pools, cap_axis=cap_axis, cap=cap)
    assert plan["route"] == "global"
    if cap_axis == 0:  # streamed strips of 64 rows up to reach 15, a walk past it
        assert plan["cap_strip"] == 64 and (cap > 64) == (plan["cap_reach"] >= plan["cap_strip"])
    m = _cross_cap_masks(n, h, w, cap).to(dev)
    g = torch.Generator().manual_seed(w + cap)
    init = torch.randint(0, 2 * h * w, m.shape, generator=g, dtype=torch.int32).to(dev)
    for rounds in (1, 2, 3):
        for start in (None, init):
            before = kernels.launch_counts()["connected_components.capped.band"]
            _equal(tf.connected_components(m, rounds, pools, start, cap_axis=cap_axis, cap=cap),
                   tf.connected_components_plain(m, rounds, pools, start, cap_axis=cap_axis, cap=cap))
            assert kernels.launch_counts()["connected_components.capped.band"] == before + 1


def test_cc_capped_band_route_device_kernels(dev):
    """A capped call on the band route launches the band route's count of
    device kernels (along H the capped column pass, streamed or walking,
    takes the fix's place)."""
    from cylinder_pose_estimation_tpu_torch.utils import profiling

    m = _cross_cap_masks(2, 480, 640, 0).to(dev)
    for cap_axis in (0, 1):
        for cap in (16, 64, 256):
            n_dev, _ = profiling.graph_kernels(lambda: tf.connected_components(m, 2, 2, cap_axis=cap_axis, cap=cap))
            assert n_dev == tf.cc_global_launches(2, 2, True)


def test_capped_wrapper_refuses(dev):
    m = torch.zeros((2, 64, 128), device=dev)
    with pytest.raises(ValueError, match="cap_axis"):
        tf.connected_components(m, 2, 2, cap_axis=2, cap=4)
    with pytest.raises(ValueError, match="cap"):
        tf.connected_components(m, 2, 2, cap_axis=0, cap=-1)


@pytest.mark.parametrize("override", [{"smooth_mxu": False}, {"pallas_cc_cross_cap": 16},
                                      {"bright_at_points": False},
                                      {"pallas_cc_cross_cap": 16, "label_downsample": 1}])
def test_knobs_on_card_match_cpu(dev, override):
    """The knobs through detect_grid: the card's grids equal the CPU port's."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    _, (i1, _) = example_pair(480, 640, n_frames=2)
    cfg = CylinderDetectConfig(use_pallas=True, **override)
    cpu = detect_grid(torch.as_tensor(i1), cfg)
    gpu = detect_grid(torch.as_tensor(i1, device=dev), cfg)
    np.testing.assert_array_equal(cpu.grid.valid.numpy(), gpu.grid.valid.cpu().numpy())
    np.testing.assert_array_equal(cpu.grid.idx.numpy(), gpu.grid.idx.cpu().numpy())
    np.testing.assert_allclose(cpu.grid.xy.numpy(), gpu.grid.xy.cpu().numpy(), atol=1e-3)
    assert cpu.ok.tolist() == gpu.ok.cpu().tolist() and cpu.stable.tolist() == gpu.stable.cpu().tolist()


# --- the compiled steps (CUDA graphs of the batch, stream and registration
# steps) against the eager calls they replay -------------------------------

def _leaves_equal(got, want):
    from cylinder_pose_estimation_tpu_torch.models.pipeline import _tree_leaves

    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(_tree_leaves(got), _tree_leaves(want))):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        assert torch.equal(g, w) or (g.is_floating_point() and bool(((g == w) | (g.isnan() & w.isnan())).all())), i


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernels", "xla"])
def test_compiled_batch_equals_eager(dev, use_pallas):
    """``compiled_batch`` (eager at the first call, a CUDA graph replayed
    from the second) is equal, leaf for leaf, to ``estimate_poses_batch`` on
    every call, and returns fresh tensors."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    st, (i1, i2) = example_pair(240, 320, n_frames=4)
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=use_pallas)
    a, b = torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev)
    step = pipeline.compiled_batch(stereo, cfg, FitConfig())
    first = step(a, b)
    for eps in (0.0, 0.5):
        got = step(a + eps, b + eps)
        _leaves_equal(got, pipeline.estimate_poses_batch(a + eps, b + eps, stereo, cfg, FitConfig()))
    assert first.fit.params.data_ptr() != got.fit.params.data_ptr()
    _leaves_equal(first, pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig()))


def test_stream_chunks_equal_the_batch_call(dev):
    """Every chunk of ``estimate_poses_stream`` (the compiled stream step,
    the padded tail included) equals ``_summarize_batch`` of the eager batch
    call on the same frames."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, RegistrationConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    st, (i1, i2) = example_pair(240, 320, n_frames=5)
    u1, u2 = (np.clip(x, 0, 255).astype(np.uint8) for x in (i1, i2))
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=True)
    out = pipeline.estimate_poses_stream(u1, u2, stereo, cfg, FitConfig(), chunk=2, compact=True, device=dev)
    for s in range(0, 5, 2):
        idx = np.minimum(np.arange(s, s + 2), 4)
        want = pipeline._summarize_batch(pipeline.estimate_poses_batch(
            torch.as_tensor(u1[idx], device=dev), torch.as_tensor(u2[idx], device=dev), stereo, cfg, FitConfig()),
            RegistrationConfig())
        live = min(2, 5 - s)
        for g, w in zip(pipeline._tree_leaves(out), pipeline._tree_leaves(want)):
            np.testing.assert_array_equal(g[s:s + live], w[:live].cpu().numpy())


def test_compiled_registration_equals_eager(dev):
    """``register_sequence`` on the card replays the registration step, equal
    leaf for leaf to ``fit_cylinders_with_angles`` on the same inputs, with
    no host synchronisation in a replayed call."""
    import warnings

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, RegistrationConfig
    from cylinder_pose_estimation_tpu_torch.geometry.registration import fit_cylinders_with_angles
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import registration_sequence

    st, ang, (i1, i2), _ = registration_sequence(6, 240, 320)
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=True)
    batch = pipeline.estimate_poses_batch(torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev),
                                          stereo, cfg, FitConfig())
    angles = torch.as_tensor(ang, device=dev)
    pipeline.register_sequence(batch, angles)  # eager
    pipeline.register_sequence(batch, angles)  # warm-up, capture, replay
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = pipeline.register_sequence(batch, angles)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    reg_cfg = RegistrationConfig()
    want = fit_cylinders_with_angles(batch.fit.points3, batch.fit.points_valid, angles, reg_cfg,
                                     frame_valid=pipeline.frame_health(batch, reg_cfg))
    _leaves_equal(got, want)


# --- the program's spans and counters on the card (utils/profiling) -------

_CU_GRAPH_NODE_EVENT_RECORD = 7
_TIMED_SPANS = ("detect.front", "detect.roi", "detect.bridge", "detect.grid", "fit.correspond", "fit.lm")


def _batch_scene(dev, frames=2):
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    st, (i1, i2) = example_pair(240, 320, n_frames=frames)
    return (stereo_from_numpy(*st, device=dev), CylinderDetectConfig(height=240, width=320, use_pallas=True),
            torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev))


def _node_kinds(fn):
    """Node types of one ``fn()`` captured as a CUDA graph (warmed up first)
    as a compiled step captures it (its timed spans collected)."""
    import ctypes

    from cylinder_pose_estimation_tpu_torch.utils import profiling

    cu = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with profiling.graph_stages() as stages:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
            kinds = profiling._capture_node_kinds(cu)
    del graph, stages
    torch.cuda.synchronize()
    return sorted(kinds)


def test_untraced_capture_is_the_step_alone(dev, monkeypatch):
    """With tracing off, the captured B=2 step has the node types and count
    of the same step with every span taken out; with tracing on, the same
    kernels and two event-record nodes per timed span."""
    import contextlib

    from cylinder_pose_estimation_tpu_torch.config import FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.utils import profiling

    stereo, cfg, a, b = _batch_scene(dev)

    def step():
        return pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig())

    assert not profiling.enabled()
    off = _node_kinds(step)
    profiling.enable()
    try:
        on = _node_kinds(step)
    finally:
        profiling.disable()
        profiling.reset()
    with monkeypatch.context() as m:
        m.setattr(profiling, "span", lambda *args, **kwargs: contextlib.nullcontext())
        bare = _node_kinds(step)
    assert off == bare and off.count(0) > 1000
    assert on.count(0) == off.count(0)
    assert on.count(_CU_GRAPH_NODE_EVENT_RECORD) - off.count(_CU_GRAPH_NODE_EVENT_RECORD) == 2 * len(_TIMED_SPANS)
    # A capture that does not collect timed spans (not a compiled step's) gets no event from them.
    profiling.enable()
    try:
        kernels = profiling.graph_kernels(step, reps=1, warmup=0)[0]
    finally:
        profiling.disable()
        profiling.reset()
    assert kernels == off.count(0)


def test_traced_stage_times_add_up_to_the_replay(dev):
    """With tracing on, each replay of the B=2 step gives each stage's device
    ms from its events in the graph; the stages add up within 5% to the
    replay's own device ms, timed by the graph's first and last nodes (so
    from the graph's start on the card, after its launch).  Each call is
    waited for, as a caller reading its answers does (the events of a
    replay still running when the next one starts are dropped: that replay
    records them again)."""
    from cylinder_pose_estimation_tpu_torch.config import FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.utils import profiling

    stereo, cfg, a, b = _batch_scene(dev)
    profiling.reset()
    profiling.enable()
    try:
        step = pipeline.compiled_batch(stereo, cfg, FitConfig())
        for eps in (0.0, 0.5):  # eager, capture
            step(a + eps, b + eps)
        torch.cuda.synchronize()
        profiling.reset()
        for k in range(4):
            step(a + k, b + k)
            torch.cuda.synchronize()
        profiling.flush()
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    steps = [r for r in recs if r["name"] == "step.batch"]
    assert [r["attrs"]["phase"] for r in steps] == ["replay"] * 4
    for s in steps:
        stages = {r["name"]: r["attrs"]["device_ms"] for r in recs if r["call"] == s["id"] and r["attrs"].get("replay")}
        assert set(stages) == set(_TIMED_SPANS)
        assert all(v > 0 for v in stages.values())
        total = sum(stages.values())
        assert total <= s["attrs"]["device_ms"] * 1.001
        assert total == pytest.approx(s["attrs"]["device_ms"], rel=0.05), (stages, s["attrs"])


def test_sync_counters_match_the_sync_debug_mode(dev):
    """The ``sync.*`` counters of a replayed ``full_experiment`` call equal
    the synchronising operations ``torch.cuda.set_sync_debug_mode`` reports
    for it: the rig read back to key the batch step, one per leaf."""
    import warnings

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils import profiling
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import registration_sequence

    st, ang, (i1, i2), _ = registration_sequence(6, 240, 320)
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=True)
    a, b, angles = (torch.as_tensor(x, device=dev) for x in (i1, i2, ang))
    for _ in range(2):  # eager, capture
        pipeline.full_experiment(a, b, angles, stereo, cfg, FitConfig())
    torch.cuda.synchronize()
    before = profiling.counters("sync.")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipeline.full_experiment(a, b, angles, stereo, cfg, FitConfig())
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = profiling.counters("sync.")
    counted = sum(after.values()) - sum(before.values())
    reported = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert counted == len(reported) >= 7
    assert after.get("sync.stereo_key", 0) - before.get("sync.stereo_key", 0) == counted


# --- the fit tail's SPD solve (ops/linalg.solve_spd, csrc/linalg.cu) -----

SPD_LEADS = [(0,), (2,), (16,), (26,), (64,), (100,), (32, 48)]
_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _solve_equal(a, b):
    """solve_spd on CUDA tensors launches the kernel once and equals
    solve_spd_plain on the same tensors bit for bit (NaN and inf rows too)."""
    before = kernels.launch_counts()["solve_spd"]
    got = linalg.solve_spd(a, b)
    assert kernels.launch_counts()["solve_spd"] == before + 1
    want = linalg.solve_spd_plain(a, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape == b.shape and got.dtype == want.dtype
    assert torch.equal(bits(got), bits(want)), int((bits(got) != bits(want)).sum())


@pytest.mark.parametrize("lead", SPD_LEADS, ids=str)
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("p", [3, 5, 6])
def test_solve_spd_kernel_equals_plain(dev, p, dtype, lead):
    """Graded (1e-6 .. 1e6), the LM's damped, zero, singular, NaN and inf
    systems at the call sites' orders and batch shapes."""
    for i, kind in enumerate(KINDS):
        _solve_equal(*spd_systems(p, lead, _DTYPES[dtype], kind, seed=i, device=dev))


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("p", range(1, linalg.SPD_MAX_ORDER + 1))
def test_solve_spd_kernel_every_order(dev, p, dtype):
    for i, kind in enumerate(("graded", "damped")):
        _solve_equal(*spd_systems(p, (130,), _DTYPES[dtype], kind, seed=i, device=dev))


def test_solve_spd_kernel_strided_rhs(dev):
    """The LM's right-hand side is a slice of a matmul: a strided b."""
    a, b = spd_systems(6, (16,), torch.float32, "damped", device=dev)
    bt = b.t().contiguous().t()
    assert not bt.is_contiguous()
    _solve_equal(a, bt)


@pytest.mark.parametrize("p, dtype, lead", [(6, "f32", (16,)), (6, "f32", (26,)), (5, "f32", (16,)),
                                            (3, "f64", (32, 48)), (6, "f64", (2,))])
def test_solve_spd_kernel_in_a_captured_graph(dev, p, dtype, lead):
    """Captured in a CUDA graph, as the compiled steps capture it, and
    replayed on new systems: equal to the plain solve of each, at most 5
    kernel nodes a solve (the two launches and the residual's three)."""
    from cylinder_pose_estimation_tpu_torch.utils import profiling

    a, b = spd_systems(p, lead, _DTYPES[dtype], "damped", device=dev)
    n_kernels, _ = profiling.graph_kernels(lambda: linalg.solve_spd(a, b), reps=1, warmup=0)
    assert n_kernels <= 5
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        linalg.solve_spd(a, b)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = linalg.solve_spd(a, b)
    for i, kind in enumerate(KINDS):
        a2, b2 = spd_systems(p, lead, _DTYPES[dtype], kind, seed=10 + i, device=dev)
        a.copy_(a2)
        b.copy_(b2)
        graph.replay()
        want = linalg.solve_spd_plain(a2, b2)
        torch.cuda.synchronize()
        assert torch.equal(bits(out), bits(want)), kind


@pytest.mark.parametrize("case", ["order_9", "float16", "host_rhs", "lead_shapes_differ", "mixed_dtypes"])
def test_solve_spd_wrapper_refuses(dev, case):
    a = torch.eye(6, device=dev).expand(2, 6, 6).contiguous()
    b = torch.ones(2, 6, device=dev)
    a, b = {
        "order_9": (torch.eye(9, device=dev).expand(2, 9, 9), torch.ones(2, 9, device=dev)),
        "float16": (a.half(), b.half()),
        "host_rhs": (a, b.cpu()),
        "lead_shapes_differ": (a, torch.ones(3, 6, device=dev)),
        "mixed_dtypes": (a, b.double()),
    }[case]
    before = kernels.launch_counts()["solve_spd"]
    with pytest.raises(ValueError, match="solve_spd"):
        linalg.solve_spd(a, b)
    assert kernels.launch_counts()["solve_spd"] == before


def _plain_solves(monkeypatch):
    """Every caller of solve_spd (the LM, the polyfit, the normal
    equations) takes the plain version."""
    from cylinder_pose_estimation_tpu_torch.ops import lm, polyfit

    for mod in (linalg, lm, polyfit):
        monkeypatch.setattr(mod, "solve_spd", linalg.solve_spd_plain)


def test_solve_spd_kernel_in_the_batch_step(dev, monkeypatch):
    """An eager B=16 480x640 ``estimate_poses_batch`` (kernel branch) makes
    22 kernel solves, and its result equals, leaf for leaf, the same call
    with every solve the plain version on the card."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    st, (i1, i2) = example_pair(480, 640, n_frames=16)
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=480, width=640, use_pallas=True)
    a, b = torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev)
    before = kernels.launch_counts()["solve_spd"]
    got = pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig())
    assert kernels.launch_counts()["solve_spd"] == before + 22
    _plain_solves(monkeypatch)
    _leaves_equal(got, pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig()))
    assert kernels.launch_counts()["solve_spd"] == before + 22


def test_solve_spd_kernel_in_the_registration(dev, monkeypatch):
    """One eager ``fit_cylinders_with_angles`` makes 141 kernel solves (the
    init fit's 60, the registration LM's 80 over 26 candidates, the
    curvature's one) and equals the same call with plain solves."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, RegistrationConfig
    from cylinder_pose_estimation_tpu_torch.geometry.registration import fit_cylinders_with_angles
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import registration_sequence

    st, ang, (i1, i2), _ = registration_sequence(6, 240, 320)
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=True)
    batch = pipeline.estimate_poses_batch(torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev),
                                          stereo, cfg, FitConfig())
    angles, reg_cfg = torch.as_tensor(ang, device=dev), RegistrationConfig()
    health = pipeline.frame_health(batch, reg_cfg)

    def register():
        return fit_cylinders_with_angles(batch.fit.points3, batch.fit.points_valid, angles, reg_cfg,
                                         frame_valid=health)

    before = kernels.launch_counts()["solve_spd"]
    got = register()
    assert kernels.launch_counts()["solve_spd"] == before + 141
    _plain_solves(monkeypatch)
    _leaves_equal(got, register())


# --- full HD: the CC family's band route, 8-CTA CC clusters and the
# bridge's split route inside the captured B=16 batch step -----------------

@pytest.mark.parametrize("channels", [1, 2])
def test_band_route_calls_count_once_on_band(dev, channels):
    """One call on the band route (the half-res canvas of a 1080x1920
    frame) equals its plain version and counts once on the kernel; the CC
    call counts once on ``connected_components.band``, the payload call
    (which has no band counter) launches the band route's
    ``cc_global_launches`` device kernels.  A call on the cluster route
    (the 480x640 frame's canvas) and a capped call, which takes the band
    route at every size, count as the plan says."""
    key = "connected_components" if channels == 1 else "component_payload_minmax"
    for (h, w), band in (((544, 1024), True), ((240, 384), False)):
        assert (tf.cc_plan(2, h, w, channels=channels).get("route") == "global") == band
        g = torch.Generator().manual_seed(h + channels)
        m = _band_masks(2, h, w, 20, h).to(dev)
        before = kernels.launch_counts()
        if channels == 1:
            init = torch.randint(0, 2 * h * w, m.shape, generator=g, dtype=torch.int32).to(dev)
            _equal(tf.connected_components(m, 2, 2, init), tf.connected_components_plain(m, 2, 2, init))
        else:
            pay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(2)]).reshape(2, h, w)
            pay = pay.to(torch.int32).to(dev)
            _equal(tf.component_payload_minmax(m, pay, 2, 4), tf.component_payload_minmax_plain(m, pay, 2, 4))
        after = kernels.launch_counts()
        assert after[key] == before[key] + 1
        if channels == 1:
            assert after[f"{key}.band"] == before[f"{key}.band"] + int(band)
        else:
            fused = tf.cc_plan(2, h, w, channels=2, pools_per_round=4).get("fused")
            want = tf.cc_global_launches(2, 4, fused) if band else 1
            assert _device_kernels_per_call([lambda: tf.component_payload_minmax(m, pay, 2, 4)]) == [want]
    if channels == 1:
        m = _cross_cap_masks(2, 240, 384, 16).to(dev)
        before = kernels.launch_counts()["connected_components.band"]
        _equal(tf.connected_components(m, 2, 2, cap_axis=0, cap=16),
               tf.connected_components_plain(m, 2, 2, cap_axis=0, cap=16))
        assert kernels.launch_counts()["connected_components.band"] == before + 1


def test_compiled_batch_full_hd_equals_eager(dev, monkeypatch):
    """``compiled_batch`` of the kernel branch at B=16 on 1080x1920 pairs:
    the capture (the half-res CCs on the band route, the quarter-res CC in
    8-CTA clusters, the bridge on its split route) replays equal, leaf for
    leaf, to ``estimate_poses_batch`` on the same inputs.  The capture
    records two band-route CC calls, one split-route bridge and no payload
    kernel; each replay adds them to ``graph_launch_counts()``.  Every
    kernel call of the eager call equals its plain version on the same
    tensors."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    h, w, n = 1080, 1920, 16
    assert tf.cc_plan(4 * n, 544, 1024).get("route") == "global"
    assert tf.cc_plan(4 * n, 272, 512)["cluster"] == 8
    assert tf.bridge_plan(4 * n, 544, 1024)["route"] == "split"
    st, (i1, i2) = example_pair(h, w, n_frames=n, pans=[float(i % 13) for i in range(n)])
    stereo = stereo_from_numpy(*st, device=dev)
    cfg = CylinderDetectConfig(height=h, width=w, use_pallas=True)
    a, b = torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev)
    pipeline._STREAM_STEP_CACHE.clear()
    pipeline.reset_graph_launch_counts()
    step = pipeline.compiled_batch(stereo, cfg, FitConfig())
    step(a, b)  # eager
    got = step(a, b)  # capture and replay
    captured = pipeline.graph_launch_counts()["captured"]
    assert captured["connected_components.band"] == 2 and captured["connected_components"] == 3
    assert captured["bridge_morphology.split"] == 1 and "component_payload_minmax" not in captured
    calls = []
    for name in ("preprocess_binarize", "connected_components", "bridge_morphology"):
        def record(*args, _kernel=getattr(tf, name), _name=name, **kw):
            calls.append((_name, args, kw))
            return _kernel(*args, **kw)
        monkeypatch.setattr(tf, name, record)
    _leaves_equal(got, pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig()))
    monkeypatch.undo()
    assert [c[0] for c in calls].count("connected_components") == 3 and len(calls) == 5
    with torch.inference_mode():
        for name, args, kw in calls:
            _equal(getattr(tf, name)(*args, **kw), getattr(tf, f"{name}_plain")(*args, **kw))
    del calls
    for eps in (0.5, 1.0):
        got = step(a + eps, b + eps)
        _leaves_equal(got, pipeline.estimate_poses_batch(a + eps, b + eps, stereo, cfg, FitConfig()))
    counts = pipeline.graph_launch_counts()
    assert counts["replays"] == 3
    assert counts["replayed"]["connected_components.band"] == 3 * 2
    assert counts["replayed"]["bridge_morphology.split"] == 3
    assert bool(got.detect1.ok.any()) and bool(got.detect2.ok.any())
    pipeline._STREAM_STEP_CACHE.clear()


# --- the XLA branch's connected components (ops/labeling, csrc/scan_cc.cu) -

# The default config's three call sites at 480x640 B=16: (masks, rounds) of
# the ROI pair, the bridge pair and the final labels.
SCAN_CC_SITES = [((64, 128, 256), 8), ((64, 240, 384), 8), ((128, 240, 384), 16)]


def _cc_equal(m, iters):
    """connected_components on CUDA masks launches the kernel once (one
    count) and equals connected_components_plain on the same masks."""
    before = kernels.launch_counts()["scan_cc"]
    got = labeling.connected_components(m, iters)
    assert kernels.launch_counts()["scan_cc"] == before + 1
    _equal(got, labeling.connected_components_plain(m, iters))
    return got


def _random_masks(shape, density, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) < density).to(dev)


def _snakes(n, h, w, dev):
    """Serpentines (rows every second line joined at alternating ends, and
    the same turned): more bends than 16 rounds cross."""
    m = torch.zeros((n, h, w), dtype=torch.bool)
    for i, y in enumerate(range(0, h - 1, 2)):
        m[:, y, :] = True
        m[:, y:y + 3, w - 1 if i % 2 == 0 else 0] = True
    m[1::2] = m[1::2].flip(-1, -2)
    return m.to(dev)


@pytest.mark.parametrize("density", [0.05, 0.3, 0.5, 0.7])
@pytest.mark.parametrize("shape, iters", SCAN_CC_SITES)
def test_scan_cc_equals_plain_at_the_sites(dev, shape, iters, density):
    _cc_equal(_random_masks(shape, density, int(density * 100) + shape[0], dev), iters)


def test_scan_cc_on_the_default_detectors_masks(dev):
    """Every CC call of the default config (cylinder and plane mode) on
    rendered frames, held to the plain version on the same masks."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair, plane_view

    _, (imgs, _) = example_pair(480, 640, n_frames=2)
    pviews = np.stack([plane_view(480, 640, (0.0, 0.0, 700.0), (0.05, -0.08, -1.0), 9, 11, 30.0, 1)])
    calls = []
    cc = labeling.connected_components

    def record(m, iters=16):
        calls.append((m.clone(), iters))
        return cc(m, iters)

    labeling.connected_components = record
    try:
        detect_grid(torch.as_tensor(imgs, device=dev), CylinderDetectConfig())
        detect_grid(torch.as_tensor(pviews, device=dev), PlaneDetectConfig(roi_threshold=30.0))
    finally:
        labeling.connected_components = cc
    assert [tuple(m.shape[1:]) for m, _ in calls[:3]] == [(128, 256), (240, 384), (240, 384)]
    assert [i for _, i in calls[:3]] == [8, 8, 16] and len(calls) == 6
    for m, iters in calls:
        assert bool(m.any())
        _cc_equal(m, iters)


@pytest.mark.parametrize("iters", [0, 1, 2, 3, 5, 16])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 70), (2, 70, 1), (3, 37, 70), (2, 33, 65), (1, 257, 31),
                                   (2, 64, 128)])
def test_scan_cc_equals_plain_at_odd_shapes(dev, shape, iters):
    for i, density in enumerate((0.3, 0.6)):
        _cc_equal(_random_masks(shape, density, i, dev), iters)
    _cc_equal(torch.zeros(shape, dtype=torch.bool, device=dev), iters)
    _cc_equal(torch.ones(shape, dtype=torch.bool, device=dev), iters)


@pytest.mark.parametrize("iters", [1, 8, 16])
@pytest.mark.parametrize("hw", [(40, 56), (240, 384), (128, 256)])
def test_scan_cc_unconverged_snakes(dev, hw, iters):
    """Components that ``iters`` rounds leave split: every round counts."""
    m = _snakes(2, *hw, dev)
    got = _cc_equal(m, iters)
    assert len(torch.unique(got[0][m[0]])) > 1


def _xla_canvases():
    """(n, h, w) of the XLA branch's calls at ``label_downsample`` 1 and on
    full-HD frames, n cut to 4: the full-resolution canvases (ds=1) at
    480x640 and 1080x1920, and the quarter- and half-res ones at full HD."""
    from cylinder_pose_estimation_tpu_torch.models import detector

    z = torch.zeros((1, 1080, 1920), dtype=torch.bool)
    return [(4, 480, 640), (4, 1080, 1920), (4, *detector._pool4_pad(z).shape[-2:]),
            (4, *detector._pool2_pad(z).shape[-2:]), (4, 272, 512), (4, 544, 1024)]


@pytest.mark.parametrize("iters", [8, 16])
@pytest.mark.parametrize("shape", _xla_canvases())
def test_scan_cc_equals_plain_at_large_canvases(dev, shape, iters):
    _cc_equal(_random_masks(shape, 0.5, iters, dev), iters)
    _cc_equal(_snakes(*shape, dev), iters)


@pytest.mark.parametrize("shape, iters", SCAN_CC_SITES + [((4, 1080, 1920), 16), ((3, 37, 70), 0)])
def test_scan_cc_device_kernels_per_call(dev, shape, iters):
    from cylinder_pose_estimation_tpu_torch.utils import profiling

    m = _random_masks(shape, 0.5, 0, dev)
    n_kernels, _ = profiling.graph_kernels(lambda: labeling.connected_components(m, iters), reps=1, warmup=0)
    assert n_kernels == labeling.scan_cc_launches(iters)


@pytest.mark.parametrize("shape, iters", SCAN_CC_SITES + [((2, 37, 70), 1), ((2, 37, 70), 0)])
def test_scan_cc_in_a_captured_graph(dev, shape, iters):
    """Captured in a CUDA graph, as the compiled steps capture it, and
    replayed on new masks: equal to the plain version of each."""
    m = _random_masks(shape, 0.5, 1, dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        labeling.connected_components(m, iters)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = labeling.connected_components(m, iters)
    for i, density in enumerate((0.1, 0.45, 0.8)):
        m2 = _random_masks(shape, density, 20 + i, dev)
        m.copy_(m2)
        graph.replay()
        _equal(out, labeling.connected_components_plain(m2, iters))
    m.copy_(_snakes(*shape, dev))
    graph.replay()
    _equal(out, labeling.connected_components_plain(m, iters))


@pytest.mark.parametrize("case", ["uint8", "float32", "rank_2", "not_contiguous", "labels_past_2_24",
                                  "negative_iters"])
def test_scan_cc_wrapper_refuses(dev, case):
    m = torch.zeros((2, 64, 96), dtype=torch.bool, device=dev)
    m, iters = {
        "uint8": (m.to(torch.uint8), 4),
        "float32": (m.float(), 4),
        "rank_2": (m[0], 4),
        "not_contiguous": (m.transpose(1, 2), 4),
        "labels_past_2_24": (torch.zeros((1, 4096, 4096), dtype=torch.bool, device=dev), 4),
        "negative_iters": (m, -1),
    }[case]
    before = kernels.launch_counts()["scan_cc"]
    with pytest.raises(ValueError, match="connected_components"):
        labeling.connected_components(m, iters)
    assert kernels.launch_counts()["scan_cc"] == before


def test_compiled_default_batch_replays_scan_cc(dev):
    """The default config's ``compiled_batch`` at 480x640 B=16: its capture
    records 3 ``scan_cc`` launches and each replay runs 3; every replay is
    equal, leaf for leaf, to the eager call.  The kernel branch's step
    records none."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    st, (i1, i2) = example_pair(480, 640, n_frames=16)
    stereo = stereo_from_numpy(*st, device=dev)
    a, b = torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev)
    for use_pallas, per_step in ((False, 3), (True, 0)):
        pipeline._STREAM_STEP_CACHE.clear()
        pipeline.reset_graph_launch_counts()
        cfg = CylinderDetectConfig(use_pallas=use_pallas)
        step = pipeline.compiled_batch(stereo, cfg, FitConfig())
        step(a, b)  # eager
        for eps in (0.0, 0.5):
            got = step(a + eps, b + eps)
            _leaves_equal(got, pipeline.estimate_poses_batch(a + eps, b + eps, stereo, cfg, FitConfig()))
        counts = pipeline.graph_launch_counts()
        assert counts["replays"] == 2
        assert counts["captured"].get("scan_cc", 0) == per_step
        assert counts["replayed"].get("scan_cc", 0) == 2 * per_step
        assert bool(got.detect1.ok.any()) and bool(got.detect2.ok.any())
    pipeline._STREAM_STEP_CACHE.clear()


@pytest.mark.parametrize("mode", ["cylinder", "plane"])
def test_xla_detect_with_scan_cc_equals_plain_cc(dev, mode, monkeypatch):
    """``detect_grid`` through the XLA branch on the card gives the same
    grids with the kernel as with the plain CC (the parent's)."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import _tree_leaves
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair, plane_view

    if mode == "cylinder":
        _, (imgs, _) = example_pair(480, 640, n_frames=4)
        cfg = CylinderDetectConfig()
    else:
        imgs = np.stack([plane_view(480, 640, (0.0, 0.0, 700.0), (0.05, -0.08, -1.0), 9, 11, 30.0, 1),
                         plane_view(480, 640, (5.0, 0.0, 700.0), (0.05, -0.08, -1.0), 9, 9, 30.0, 2,
                                    gap_col=2)])
        cfg = PlaneDetectConfig(roi_threshold=30.0)
    views = torch.as_tensor(imgs, device=dev)
    before = kernels.launch_counts()["scan_cc"]
    got = detect_grid(views, cfg)
    assert kernels.launch_counts()["scan_cc"] == before + 3
    monkeypatch.setattr(labeling, "connected_components", labeling.connected_components_plain)
    want = detect_grid(views, cfg)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(_tree_leaves(got), _tree_leaves(want))):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        assert torch.equal(g, w) or (g.is_floating_point() and bool(((g == w) | (g.isnan() & w.isnan())).all())), i
    assert int(got.grid.valid.sum()) > 0
