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


@pytest.mark.parametrize("shape", [(2, 96, 256), (3, 240, 320), (1, 480, 640)])
def test_preprocess_kernel_equals_plain(dev, shape):
    g = torch.Generator().manual_seed(sum(shape))
    img = torch.rand(shape, generator=g) * 255.0
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import _smooth

    x = _smooth(img.to(dev), CylinderDetectConfig())
    before = tf.launch_counts()["preprocess_binarize"]
    kw = dict(margin=24, joint_peak_iters=5)
    _equal(tf.preprocess_binarize(x, **kw), tf.preprocess_binarize_plain(x, **kw))
    assert tf.launch_counts()["preprocess_binarize"] == before + 1


@pytest.mark.parametrize("rounds, pools, warm", [(2, 4, False), (2, 2, False), (2, 2, True), (3, 1, False)])
@pytest.mark.parametrize("shape", [(4, 128, 256), (4, 240, 384)])
def test_cc_kernel_equals_plain(dev, rounds, pools, warm, shape):
    g = torch.Generator().manual_seed(rounds * 10 + pools)
    m = (torch.rand(shape, generator=g) < 0.45).to(torch.float32).to(dev)
    init = None
    if warm:
        init = torch.randint(0, 2 * shape[1] * shape[2], shape, generator=g, dtype=torch.int32).to(dev)
    _equal(tf.connected_components(m, rounds, pools, init),
           tf.connected_components_plain(m, rounds, pools, init))


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
    cpu = estimate_poses_batch(torch.as_tensor(i1), torch.as_tensor(i2), stereo_from_numpy(*st), cfg, FitConfig())
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
