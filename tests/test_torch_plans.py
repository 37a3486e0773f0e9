"""PyTorch port, on the CPU: the launch plans of the preprocess, CC (one and
two channels) and bridge kernels at every shape the detector passes, from
480x640 (the cluster kernels) to 1080x1920 and 1200x1600 (the CC family's
and the bridge's large-frame routes), the kernels' byte counts, the
preprocess margin check and the rig's default device.  No JAX here."""

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
from cylinder_pose_estimation_tpu_torch.models import detector
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf
from cylinder_pose_estimation_tpu_torch.ops import kernels
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils.synthetic import default_stereo

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

SIZES = [(480, 640), (240, 320)]
# Frames whose half-res canvas is past some cluster kernel's shared memory.
LARGE_SIZES = [(600, 800), (768, 1024), (1024, 768), (720, 1280), (960, 1280), (1080, 1920), (1200, 1600)]


def _cc_shapes(h, w):
    """The (h, w) of the detector's CC canvases for h x w views: the
    quarter-res ROI pair and the half-res h/v pair (pre-bridge and final)."""
    z = torch.zeros((1, h, w), dtype=torch.bool)
    return tuple(detector._pool4_pad(z).shape[-2:]), tuple(detector._pool2_pad(z).shape[-2:])


@pytest.mark.parametrize("iters", [0, 5, 8])
@pytest.mark.parametrize("hw", SIZES)
def test_preprocess_plan_at_detector_shapes(hw, iters):
    h, w = hw
    cfg = CylinderDetectConfig(height=h, width=w)
    plan = tf.preprocess_plan(32, h, w, cfg.sauvola_window, cfg.line_kernel_len, 11, iters)
    th, tw = plan["tile"]
    assert plan["launches"] <= 3
    assert plan["grid"] == (-(-w // tw), -(-h // th), 32)
    assert plan["grid"][0] * tw >= w and plan["grid"][1] * th >= h
    assert plan["halo_a"] == 2 + cfg.sauvola_window // 2 == 9
    a = (cfg.line_kernel_len - 1) // 2
    rj = iters + 11 // 2
    assert plan["halo_b_rows"] == (rj + 2 * a, rj + 2 * (cfg.line_kernel_len - 1 - a))
    assert plan["halo_b_cols"] == (rj, rj) and rj <= 32  # the column halo stays in one word
    assert plan["bit_words"] == -(-w // 32)
    for key in ("smem_a", "smem_b"):
        assert 0 < plan[key] <= kernels.MAX_DYNAMIC_SMEM == 232448


def test_preprocess_plan_layouts():
    """The shared bytes of the two launches at the defaults (32x64 tiles,
    window 15, line 20, 8 rounds), as the kernel's layouts count them."""
    plan = tf.preprocess_plan(32, 480, 640)
    assert plan["tile"] == (32, 64)
    assert plan["smem_a"] == 4 * (50 * 82 + 46 * 79 + 2 * 46 * 65)
    jh, kh, kw = 32 + 26, 32 + 16, 64 + 16
    assert plan["smem_b"] == 4 * ((jh + 38) * 8 + (jh + 19) * 4 + 3 * jh * 4 + jh * kw + 3 * kh * kw + 1)


@pytest.mark.parametrize("kw, match", [
    (dict(sauvola_window=14), "odd"), (dict(joint_window=17), "odd"), (dict(line_len=33), "line_len"),
    (dict(joint_peak_iters=28), "joint_peak_iters"), (dict(joint_peak_iters=-1), "joint_peak_iters"),
])
def test_preprocess_plan_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        tf.preprocess_plan(2, 96, 128, **kw)


@pytest.mark.parametrize("hw", SIZES)
def test_cc_plan_at_detector_shapes(hw):
    quarter, half = _cc_shapes(*hw)
    want = {(480, 640): (2, 4), (240, 320): (1, 2)}[hw]
    for (h, w), c in zip((quarter, half), want):
        plan = tf.cc_plan(64, h, w)
        rows = plan["rows_per_cta"]
        assert plan["cluster"] == c
        assert rows * c >= h and rows * (c - 1) < h  # every CTA holds rows
        assert plan["smem"] == 4 * (2 * rows * w + 3 * w) <= kernels.MAX_DYNAMIC_SMEM
        assert plan["ctas"] == 64 * c
        if c > 1:  # the smallest cluster that fits
            smaller = -(-h // (c // 2))
            assert 4 * (2 * smaller * w + 3 * w) > kernels.MAX_DYNAMIC_SMEM


def test_cc_plan_at_issue_shapes():
    assert _cc_shapes(480, 640) == ((128, 256), (240, 384))
    assert _cc_shapes(240, 320) == ((64, 128), (120, 256))
    assert tf.cc_plan(64, 128, 256)["smem"] == 131072 + 3072
    assert tf.cc_plan(64, 240, 384)["rows_per_cta"] == 60


@pytest.mark.parametrize("hw", [(1024, 1024), (480, 2048), (8192, 64)])
def test_cc_plan_raises_beyond_eight_ctas(hw):
    """Beyond 8 CTAs the plan no longer raises: it takes the global route,
    with one scratch plane per channel."""
    plan = tf.cc_plan(1, *hw)
    assert plan == {"route": "global", "scratch_ints": hw[0] * hw[1]}
    assert tf.cc_plan(3, *hw, channels=2)["scratch_ints"] == 2 * 3 * hw[0] * hw[1]


def test_cc_plan_raises_on_index_overflow():
    with pytest.raises(ValueError, match="32-bit"):
        tf.cc_plan(4096, 1024, 1024)
    with pytest.raises(ValueError, match="32-bit"):
        tf.bridge_plan(4096, 1024, 1024)


def test_cc_plan_two_channels():
    """The payload kernel's plan: two buffers per channel plus per column a
    top and bottom entry per channel and the one-run flag; 8 CTAs of 30 rows
    at the detector's half-res canvas."""
    plan = tf.cc_plan(64, 240, 384, channels=2)
    assert (plan["cluster"], plan["rows_per_cta"], plan["ctas"]) == (8, 30, 512)
    assert plan["smem"] == 4 * (4 * 30 * 384 + 5 * 384) == 192_000 <= kernels.MAX_DYNAMIC_SMEM
    assert 4 * (4 * 60 * 384 + 5 * 384) > kernels.MAX_DYNAMIC_SMEM  # 4 CTAs would not fit
    assert tf.cc_plan(2, 64, 128, channels=2)["cluster"] == 1
    assert tf.cc_plan(2, 128, 128, channels=2)["cluster"] == 2
    assert tf.cc_plan(2, 128, 256, channels=2)["cluster"] == 4
    assert tf.cc_plan(1, 480, 640, channels=2)["route"] == "global"
    with pytest.raises(ValueError, match="channels"):
        tf.cc_plan(1, 64, 128, channels=3)


def test_cc_plan_one_channel_unchanged():
    assert tf.cc_plan(64, 240, 384) == tf.cc_plan(64, 240, 384, channels=1) == {
        "cluster": 4, "rows_per_cta": 60, "smem": 188_928, "ctas": 256}
    assert tf.cc_plan(64, 128, 256) == {"cluster": 2, "rows_per_cta": 64, "smem": 134_144, "ctas": 128}


@pytest.mark.parametrize("hw", SIZES)
def test_bridge_plan_at_detector_shapes(hw):
    """At the detector's half-res canvas and 2 views x 16 frames x (h, v):
    clusters of 2 CTAs, 128 CTAs in one wave on 132 SMs; each CTA holds the
    nine bit planes of the whole mask and the schedule."""
    _, (h, w) = _cc_shapes(*hw)
    plan = tf.bridge_plan(64, h, w)
    words = -(-w // 32)
    assert plan["cluster"] == 2 and plan["ctas"] == 128 <= tf.H100_SMS
    assert plan["rows_per_cta"] == -(-h // 2) and plan["words_per_row"] == words
    assert plan["smem"] == 4 * (9 * h * words + 4 * 65 + 2 * 32) <= kernels.MAX_DYNAMIC_SMEM
    if hw == (480, 640):
        assert plan["smem"] == 104_976


@pytest.mark.parametrize("n, c", [(1, 8), (16, 8), (17, 4), (33, 4), (34, 2), (66, 2), (67, 1), (100_000, 1)])
def test_bridge_plan_fills_one_wave(n, c):
    plan = tf.bridge_plan(n, 240, 384)
    assert plan["cluster"] == c
    assert plan["rows_per_cta"] * c >= 240 and plan["rows_per_cta"] * (c - 1) < 240


def test_bridge_plan_limits():
    assert tf.bridge_plan(1, 5, 64)["cluster"] == 2  # 4 or 8 CTAs would leave one without rows
    # Past the shared memory (480 x 20 words x 9 planes): the global route.
    assert tf.bridge_plan(2, 480, 640) == {"route": "global", "words_per_row": 20,
                                           "scratch_ints": 9 * 2 * 480 * 20 + 2 * (4 * 65 + 2 * 32)}
    assert "route" not in tf.bridge_plan(2, 321, 640)  # 321 x 20 x 9 words + the schedule fit
    assert tf.bridge_plan(2, 322, 640)["route"] == "global"
    assert tf.bridge_schedule_size(5, 125) == 4 * 6 + 2 * 6
    assert tf.bridge_schedule_size(64, 2) == 4 * 65 + 2


@pytest.mark.parametrize("hw", LARGE_SIZES)
def test_plans_at_large_frames(hw):
    """At every large frame the detector's sites get a plan: the quarter-res
    ROI pair stays on the cluster kernel; the half-res pair takes the global
    route for two channels everywhere and, from 720x1280 on, for one
    channel and for the bridge.  Every global plan says its scratch."""
    quarter, (h, w) = _cc_shapes(*hw)
    assert "cluster" in tf.cc_plan(64, *quarter)
    wide = hw[0] * hw[1] >= 720 * 1280
    plan1 = tf.cc_plan(4, h, w)
    assert (plan1.get("route") == "global") == wide
    if wide:
        assert plan1["scratch_ints"] == 4 * h * w
    plan2 = tf.cc_plan(4, h, w, channels=2)
    assert plan2["route"] == "global" and plan2["scratch_ints"] == 2 * 4 * h * w
    bplan = tf.bridge_plan(4, h, w)
    assert (bplan.get("route") == "global") == wide
    words = -(-w // 32)
    if wide:
        assert bplan["words_per_row"] == words
        assert bplan["scratch_ints"] == 9 * 4 * h * words + 4 * tf.BRIDGE_SCHEDULE_INTS
    else:
        assert bplan["smem"] == 4 * (9 * h * words + tf.BRIDGE_SCHEDULE_INTS) <= kernels.MAX_DYNAMIC_SMEM
    pplan = tf.preprocess_plan(2, *hw)
    assert pplan["grid"] == (-(-hw[1] // 64), -(-hw[0] // 32), 2)


def test_large_frame_canvases():
    assert _cc_shapes(720, 1280) == ((184, 384), (360, 640))
    assert _cc_shapes(1080, 1920) == ((272, 512), (544, 1024))


def test_global_route_launch_counts():
    """Device kernels per call of the global routes at the detector's
    settings: CC 1 + rounds x (pools + 2); bridge 2 + 2 (1 + levels) + steps
    + 5 (probe 5: 3 levels; max_kernel 125: 6 steps, 180: 7)."""
    assert tf.cc_global_launches(2, 4) == 13
    assert tf.cc_global_launches(2, 2) == 9
    assert tf.cc_global_launches(3, 2) == 13
    assert tf.bridge_global_launches(5, 125) == 21
    assert tf.bridge_global_launches(5, 180) == 22
    assert tf.bridge_global_launches(1, 2) == 2 + 4 + 1 + 5


def test_min_bytes_at_the_detector_sites():
    assert tf.min_bytes("preprocess_binarize", 32, 480, 640) == 275_251_200
    assert tf.min_bytes("connected_components", 64, 128, 256) == 16_777_216
    assert tf.min_bytes("connected_components", 64, 240, 384) == 47_185_920
    assert tf.min_bytes("connected_components", 64, 240, 384, warm=True) == 70_778_880
    assert tf.min_bytes("bridge_morphology", 64, 240, 384) == 70_778_880
    assert tf.min_bytes("component_payload_minmax", 64, 240, 384) == 94_371_840


def test_min_bytes_of_the_bool_bridge():
    assert tf.min_bytes("bridge_morphology", 64, 240, 384, itemsize=1) == 17_694_720
    assert tf.min_bytes("bridge_morphology", 64, 240, 384, itemsize=4) == 70_778_880


def test_preprocess_margin_under_reach_raises():
    assert tf.preprocess_reach() == 20
    x = torch.zeros((1, 64, 96))
    with pytest.raises(ValueError, match="reach"):
        tf.preprocess_binarize(x, margin=19)
    assert len(tf.preprocess_binarize(x, margin=20)) == 6


@pytest.mark.parametrize("cfg", [CylinderDetectConfig(), PlaneDetectConfig(roi_threshold=30.0)])
def test_detector_margin_covers_the_reach(cfg):
    reach = tf.preprocess_reach(cfg.sauvola_window, cfg.line_kernel_len, 11)
    assert detector._border_margin(cfg) >= reach


def test_stereo_rig_defaults_to_the_card(monkeypatch):
    """Without ``device`` every leaf of the rig is made on the card;
    ``device="cpu"`` keeps it on the CPU."""
    import inspect

    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy as fn

    assert inspect.signature(fn).parameters["device"].default == "cuda"
    seen = []
    real = torch.as_tensor

    def spy(*args, **kw):
        seen.append(str(kw.get("device")))
        return real(*args, **{**kw, "device": "cpu"})

    monkeypatch.setattr(torch, "as_tensor", spy)
    stereo_from_numpy(*default_stereo())
    assert seen and set(seen) == {"cuda"}
    monkeypatch.undo()
    st = stereo_from_numpy(*default_stereo(), device="cpu")
    assert st.t_c2_c1.device.type == "cpu"
    assert np.allclose(st.t_c2_c1.numpy(), default_stereo()[6])
