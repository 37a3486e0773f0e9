"""``ops/labeling.connected_components`` on the CPU: its plain version
(``connected_components_plain``) against the JAX package's
``connected_components`` at small canvases, converged or not; CPU tensors
take the plain version and count no kernel launch; the wrapper refuses what
the CUDA kernel (``csrc/scan_cc.cu``) does not take before anything
launches, and its plan takes every canvas the XLA branch makes.  The kernel
itself is held to the plain version bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import re

import jax
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.ops import labeling as jlab
from cylinder_pose_estimation_tpu_torch.models import detector
from cylinder_pose_estimation_tpu_torch.ops import kernels, labeling

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W = 40, 56


def snake(h, w):
    """One serpentine component: rows every second line joined at
    alternating ends, more bends than 16 rounds cross."""
    m = np.zeros((h, w), bool)
    for i, y in enumerate(range(0, h - 1, 2)):
        m[y, :] = True
        m[y:y + 3, w - 1 if i % 2 == 0 else 0] = True
    return m[:h]


def masks():
    rng = np.random.default_rng(5)
    return {
        "random": rng.random((3, H, W)) < np.array([0.3, 0.45, 0.6])[:, None, None],
        "snake": np.stack([snake(H, W), snake(H, W)[::-1, ::-1]]),
        "empty": np.zeros((1, H, W), bool),
        "full": np.ones((1, H, W), bool),
    }


@pytest.mark.parametrize("iters", [0, 1, 8, 16])
@pytest.mark.parametrize("case", ["random", "snake", "empty", "full"])
def test_plain_cc_equals_jax(case, iters):
    m = masks()[case]
    want = np.asarray(jax.jit(jax.vmap(lambda x: jlab.connected_components(x, iters)))(m))
    got = labeling.connected_components_plain(torch.as_tensor(m), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "snake" and iters:
        # 16 rounds leave the serpentine split: the unconverged case.
        assert len(np.unique(want[0][m[0]])) > 1


@pytest.mark.parametrize("iters", [0, 1, 8, 16])
def test_cpu_tensors_take_the_plain_cc(iters):
    kernels.reset_launch_counts()
    for m in masks().values():
        m = torch.as_tensor(m)
        assert torch.equal(labeling.connected_components(m, iters), labeling.connected_components_plain(m, iters))
    assert kernels.launch_counts()["scan_cc"] == 0


def _canvases():
    """(n, h, w) of the XLA branch's CC calls for B=16 pairs, at every frame
    size the port is checked at and both label canvases: the quarter-res ROI
    pair, the half-res bridge and final canvases, the full-resolution ones
    (``label_downsample=1``); and the full-HD canvases at 64 and 128
    masks."""
    out = set()
    for h, w in ((480, 640), (240, 320), (600, 800), (720, 1280), (1080, 1920), (1200, 1600)):
        z = torch.zeros((1, h, w), dtype=torch.bool)
        q = detector._pool4_pad(z).shape[-2:]
        p = detector._pool2_pad(z).shape[-2:]
        out |= {(64, *q), (64, *p), (128, *p), (64, h, w), (128, h, w)}
    return sorted(out | {(64, 272, 512), (64, 544, 1024), (128, 1080, 1920)})


@pytest.mark.parametrize("shape", _canvases())
def test_scan_cc_plan_takes_every_xla_canvas(shape):
    n, h, w = shape
    plan = labeling.scan_cc_plan(n, h, w)
    assert plan["strip"] in labeling.SCAN_CC_STRIPS
    assert plan["row_smem"] <= kernels.MAX_DYNAMIC_SMEM
    assert plan["seg"] % 2 == 1 and 32 * plan["seg"] >= w > 32 * (plan["seg"] - 2)
    assert plan["row_smem"] == 4 * labeling.SCAN_CC_WARPS * 32 * plan["seg"]
    summaries = 3 * 32 * labeling.SCAN_CC_WARPS
    assert plan["col_smem"] == (h * (plan["strip"] + 1) + summaries) * 4 <= kernels.MAX_DYNAMIC_SMEM // 4
    # The widest strip that fits: one step wider would not.
    wider = [s for s in labeling.SCAN_CC_STRIPS if s > plan["strip"]]
    assert all((h * (s + 1) + summaries) * 4 > kernels.MAX_DYNAMIC_SMEM // 4 for s in wider)
    m = torch.zeros(shape, dtype=torch.bool, device="meta")
    assert labeling._check_scan_cc(m, 16) == plan


REFUSED = {
    "uint8": (torch.zeros((2, 8, 8), dtype=torch.uint8), 4),
    "float32": (torch.zeros((2, 8, 8)), 4),
    "int32": (torch.zeros((2, 8, 8), dtype=torch.int32), 4),
    "rank_2": (torch.zeros((8, 8), dtype=torch.bool), 4),
    "rank_4": (torch.zeros((1, 2, 8, 8), dtype=torch.bool), 4),
    "not_contiguous": (torch.zeros((2, 8, 16), dtype=torch.bool).transpose(1, 2), 4),
    "strided": (torch.zeros((2, 8, 16), dtype=torch.bool)[:, :, ::2], 4),
    "labels_past_2_24": (torch.zeros((1, 4096, 4096), dtype=torch.bool, device="meta"), 4),
    "labels_past_2_24_tall": (torch.zeros((1, 1 << 24, 1), dtype=torch.bool, device="meta"), 4),
    "wide_rows": (torch.zeros((1, 2, 8000), dtype=torch.bool, device="meta"), 4),
    "tall_columns": (torch.zeros((1, 8000, 2), dtype=torch.bool, device="meta"), 4),
    "too_many_masks": (torch.zeros((65536, 2, 2), dtype=torch.bool, device="meta"), 4),
    "negative_iters": (torch.zeros((2, 8, 8), dtype=torch.bool), -1),
    "fractional_iters": (torch.zeros((2, 8, 8), dtype=torch.bool), 1.5),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_scan_cc_check_refuses(case):
    m, iters = REFUSED[case]
    with pytest.raises(ValueError, match="connected_components"):
        labeling._check_scan_cc(m, iters)


@pytest.mark.parametrize("case", sorted(c for c in REFUSED if REFUSED[c][0].device.type == "cpu"))
def test_scan_cc_refuses_before_any_launch(case, monkeypatch):
    """With the card's route taken on CPU tensors, the wrapper raises
    before it launches, allocates or counts anything."""

    def no_launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(kernels, "route", lambda x: True)
    monkeypatch.setattr(kernels, "launch", no_launch)
    kernels.reset_launch_counts()
    m, iters = REFUSED[case]
    with pytest.raises(ValueError, match="connected_components"):
        labeling.connected_components(m, iters)
    assert kernels.launch_counts()["scan_cc"] == 0


def test_scan_cc_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        labeling.connected_components(torch.zeros((2, 8, 8), dtype=torch.bool, device="meta"), 4)


@pytest.mark.parametrize("iters", [0, 1, 2, 8, 16])
@pytest.mark.parametrize("shape", [(4, 64, 128), (1, 240, 384), (2, 1080, 1920), (0, 8, 8)])
def test_scan_cc_launch_arguments(shape, iters, monkeypatch):
    """On the card's route: one ``cpe_scan_cc`` call with the mask, the
    output, a scratch buffer when two or more rounds alternate, the shape,
    the rounds and the plan's strip; one count a call, none for no mask."""
    calls = []
    monkeypatch.setattr(kernels, "route", lambda x: True)
    monkeypatch.setattr(kernels, "check", lambda *args: None)
    monkeypatch.setattr(kernels, "launch", lambda *args: calls.append(args))
    kernels.reset_launch_counts()
    m = torch.zeros(shape, dtype=torch.bool)
    out = labeling.connected_components(m, iters)
    assert out.shape == shape and out.dtype == torch.int32
    assert kernels.launch_counts()["scan_cc"] == 1
    if not m.numel():
        assert calls == []
        return
    (name, tensors, ints, floats), = calls
    assert name == "cpe_scan_cc" and floats == []
    assert tensors[0] is m and tensors[1] is out
    assert (tensors[2] is None) == (iters < 2)
    if iters >= 2:
        assert tensors[2].shape == shape and tensors[2].dtype == torch.int32
    assert ints == [*shape, iters, labeling.scan_cc_plan(*shape)["strip"]]


def test_scan_cc_entry_matches_its_signature():
    """``cpe_scan_cc`` takes the pointers and ints ``kernels.ENTRIES``
    declares, then the stream; the source's block and strips are the plan's."""
    src = (kernels.CSRC / "scan_cc.cu").read_text()
    params = re.search(r"CPE_API int cpe_scan_cc\(([^)]*)\)", src).group(1).split(",")
    kinds = [("ptr" if "*" in q else "int" if q.split()[0] == "int" else q.split()[0]) for q in params]
    n_ptr, n_int, n_float = kernels.ENTRIES["cpe_scan_cc"]
    assert kinds == ["ptr"] * n_ptr + ["int"] * n_int + ["float"] * n_float + ["cudaStream_t"], kinds
    assert labeling.SCAN_CC_WARPS == int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    ok = re.search(r"bool strip_ok\(int s\) \{ return ([^;]*); \}", src).group(1)
    assert sorted(int(v) for v in re.findall(r"s == (\d+)", ok)) == sorted(labeling.SCAN_CC_STRIPS)
    entry = kernels.CATALOGUE["scan_cc"]
    assert entry.source == "scan_cc.cu" and entry.wrapper == "labeling.connected_components"
    assert entry.replaces.startswith("cylinder_pose_estimation_tpu/ops/labeling.py:")
    line = int(entry.replaces.rsplit(":", 1)[1])
    jax_src = (kernels.PKG.parent / "cylinder_pose_estimation_tpu" / "ops" / "labeling.py").read_text()
    assert jax_src.splitlines()[line - 1].startswith("def connected_components(")


@pytest.mark.parametrize("shape", [(1, 1, 1), (64, 128, 256), (64, 240, 384), (128, 240, 384), (128, 1080, 1920)])
def test_scan_cc_min_bytes(shape):
    """The int32 labels written once and the one-byte mask read once."""
    n, h, w = shape
    assert kernels.min_bytes("scan_cc", n, h, w) == (4 + 1) * n * h * w


@pytest.mark.parametrize("iters, launches", [(0, 1), (1, 2), (8, 16), (16, 32)])
def test_scan_cc_launches_two_a_round(iters, launches):
    assert labeling.scan_cc_launches(iters) == launches
