"""PyTorch port on the card: each CUDA kernel equals its plain version, and
the wrappers refuse what the kernels do not take.  Marked ``cuda``; they
skip without a CUDA device.  This file imports no JAX, so on a GPU machine
without JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

``chip_smoke.py`` is the full check at the production shapes.
"""

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
