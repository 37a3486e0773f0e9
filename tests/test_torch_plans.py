"""PyTorch port, on the CPU: the launch plans of the preprocess, CC (one and
two channels) and bridge kernels at every shape the detector passes, from
480x640 (the cluster kernels) to 1080x1920 and 1200x1600 (the CC family's
and the bridge's large-frame routes), the preprocess kernel's smoothing
halo and the CC kernel's capped scans, the kernels' byte counts, the
catalogue's launch counters, the preprocess margin check and the rig's
default device.  No JAX here."""

import ast
import inspect

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
from cylinder_pose_estimation_tpu_torch.models import detector
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf
from cylinder_pose_estimation_tpu_torch.ops import kernels, labeling, linalg, stencils
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


@pytest.mark.parametrize("hw", SIZES + LARGE_SIZES)
def test_preprocess_plan_with_the_smoothing(hw):
    """pre_smoothed=False at the default taps (radii 2 and 12): a launch of
    its own smooths 64 x 128 tiles, each loaded with a halo of 2 + 12 px
    (92 x 156 floats, odd pitch 157), its first pass (92 x 152, pitch 153)
    and the wrapped row and column indices; launches A and B then run on the
    smoothed plane with the plan of any smoothed image."""
    h, w = hw
    k5, k25 = tf.smoothing_taps(5, 3.0)
    assert (len(k5), len(k25)) == (5, 25)
    plan = tf.smoothing_plan(32, h, w, (len(k5) // 2, len(k25) // 2))
    assert plan["tile"] == tf.SMOOTH_TILE == (64, 128) and plan["smooth"] == (2, 12)
    assert plan["halo"] == 14 and tf.preprocess_plan(32, h, w)["halo_a"] == 9
    assert plan["grid"] == (-(-w // 128), -(-h // 64), 32)
    assert plan["smem"] == 4 * (92 * 157 + 92 * 153 + 92 + 156) <= kernels.MAX_DYNAMIC_SMEM
    assert tf.preprocess_plan(32, h, w)["launches"] == 2  # plus the smoothing's one: 3


@pytest.mark.parametrize("blur_ksize, ridge_sigma", [(3, 1.5), (7, 5.0), (5, 4.0), (1, 3.0)])
def test_smoothing_plan_at_other_taps(blur_ksize, ridge_sigma):
    """Other radii (the generic instantiation): the same tile, the halo and
    the shared bytes follow the radii."""
    r1, r2 = (len(k) // 2 for k in tf.smoothing_taps(blur_ksize, ridge_sigma))
    plan = tf.smoothing_plan(4, 240, 320, (r1, r2))
    xh, xw = 64 + 2 * (r1 + r2), 128 + 2 * (r1 + r2)
    assert plan["halo"] == r1 + r2 and plan["tile"] == (64, 128) and plan["grid"] == (3, 4, 4)
    assert plan["smem"] == 4 * (xh * (xw | 1) + xh * ((128 + 2 * r2) | 1) + xh + xw)


def test_smoothing_plan_at_the_most_taps():
    """64 taps in all (r1 + r2 = 31) still fit one CTA; past them the plan
    refuses."""
    assert tf.smoothing_plan(1, 480, 640, (1, 30))["smem"] <= kernels.MAX_DYNAMIC_SMEM
    assert tf.smoothing_plan(1, 480, 640, (15, 16))["smem"] <= kernels.MAX_DYNAMIC_SMEM
    with pytest.raises(ValueError, match="taps"):
        tf.smoothing_plan(1, 480, 640, (16, 16))


def test_smoothing_taps_are_float32_and_symmetric():
    k5, k25 = tf.smoothing_taps()
    assert k5 == (0.0625, 0.25, 0.375, 0.25, 0.0625)
    assert all(float(np.float32(t)) == t for t in k25) and k25 == k25[::-1]
    assert abs(sum(k25) - 1.0) < 1e-6


@pytest.mark.parametrize("kw, match", [
    (dict(sauvola_window=14), "odd"), (dict(joint_window=17), "odd"), (dict(line_len=33), "line_len"),
    (dict(joint_peak_iters=28), "joint_peak_iters"), (dict(joint_peak_iters=-1), "joint_peak_iters"),
    (dict(smooth=(2, 30)), "taps"), (dict(smooth=(-1, 12)), "taps"),
])
def test_preprocess_plan_refuses(kw, match):
    """Parameters the kernel does not take; the smoothing's radii go to its
    own launch's plan."""
    with pytest.raises(ValueError, match=match):
        if "smooth" in kw:
            tf.smoothing_plan(2, 96, 128, kw["smooth"])
        else:
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
    rows in bands, with one scratch plane per channel and the edge tables
    (per mask, band and column: two extremes per channel, two lengths)."""
    h, w = hw
    plan = tf.cc_plan(1, *hw)
    bands = -(-h // plan["band_rows"])
    assert plan == {"route": "global", "band_rows": plan["band_rows"], "bands": bands, "fused": True,
                    "smem": 2 * 4 * w * (plan["band_rows"] + 8), "ctas": bands,
                    "scratch_ints": h * w + bands * w * 4}
    plan2 = tf.cc_plan(3, *hw, channels=2)
    assert plan2["scratch_ints"] == 2 * 3 * h * w + 3 * plan2["bands"] * w * 6
    # At 2048 two channels leave no band under a 4-row halo: the pools run
    # as device-memory passes and the band kernel holds one buffer.
    assert plan2["fused"] == (w < 2048)


def test_cc_plan_raises_on_index_overflow():
    with pytest.raises(ValueError, match="32-bit"):
        tf.cc_plan(4096, 1024, 1024)
    # The bridge's split route indexes within a mask: only the global
    # route, past what 8 CTAs hold, still has a batch-wide 32-bit index.
    assert tf.bridge_plan(4096, 1024, 1024)["route"] == "split"
    with pytest.raises(ValueError, match="32-bit"):
        tf.bridge_plan(4096, 2048, 2048)


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
    # Past the shared memory (480 x 20 words x 9 planes): the split route,
    # 8 CTAs of 60 rows (16 CTAs fill one wave), each a table of 480 row
    # pointers, 4 planes of 60 x 20 words and the schedule with the ray
    # offsets' totals.
    assert tf.bridge_plan(2, 480, 640) == {"route": "split", "cluster": 8, "rows_per_cta": 60,
                                           "smem": 8 * 480 + 4 * (4 * 60 * 20 + 4 * 65 + 2 * 32 + 4 * 64),
                                           "ctas": 16}
    assert "route" not in tf.bridge_plan(2, 321, 640)  # 321 x 20 x 9 words + the schedule fit
    assert tf.bridge_plan(2, 322, 640)["route"] == "split"
    # Past what 8 CTAs hold (2160 rows of 120 words: 270 a CTA): the global route.
    assert tf.bridge_plan(2, 2160, 3840) == {"route": "global", "words_per_row": 120,
                                             "scratch_ints": 9 * 2 * 2160 * 120 + 2 * (4 * 65 + 2 * 32)}
    assert tf.bridge_schedule_size(5, 125) == 4 * 6 + 2 * 6
    assert tf.bridge_schedule_size(64, 2) == 4 * 65 + 2


@pytest.mark.parametrize("hw", LARGE_SIZES)
def test_plans_at_large_frames(hw):
    """At every large frame the detector's sites get a plan: the quarter-res
    ROI pair stays on the cluster kernel; the half-res pair takes the global
    route for two channels everywhere and, from 720x1280 on, for one
    channel; the bridge takes its split route there.  Every global plan
    says its scratch."""
    quarter, (h, w) = _cc_shapes(*hw)
    assert "cluster" in tf.cc_plan(64, *quarter)
    wide = hw[0] * hw[1] >= 720 * 1280
    plan1 = tf.cc_plan(4, h, w)
    assert (plan1.get("route") == "global") == wide
    if wide:
        assert plan1["scratch_ints"] == 4 * h * w + 4 * plan1["bands"] * w * 4
    plan2 = tf.cc_plan(4, h, w, channels=2)
    assert plan2["route"] == "global" and plan2["scratch_ints"] == 2 * 4 * h * w + 4 * plan2["bands"] * w * 6
    bplan = tf.bridge_plan(4, h, w)
    assert (bplan.get("route") == "split") == wide
    words = -(-w // 32)
    if wide:
        rows = bplan["rows_per_cta"]
        assert bplan["cluster"] == 8 and (8 - 1) * rows < h <= 8 * rows
        assert bplan["smem"] == tf.bridge_split_smem(h, w, rows) <= kernels.MAX_DYNAMIC_SMEM
    else:
        assert bplan["smem"] == 4 * (9 * h * words + tf.BRIDGE_SCHEDULE_INTS) <= kernels.MAX_DYNAMIC_SMEM
    pplan = tf.preprocess_plan(2, *hw)
    assert pplan["grid"] == (-(-hw[1] // 64), -(-hw[0] // 32), 2)


def test_large_frame_canvases():
    assert _cc_shapes(720, 1280) == ((184, 384), (360, 640))
    assert _cc_shapes(1080, 1920) == ((272, 512), (544, 1024))


def test_global_route_launch_counts():
    """Device kernels per call of the global routes at the detector's
    settings: CC 2 per round (the band kernel and the fix; 1 with no round),
    or where the pools do not fuse 1 + rounds x (pools + 2); bridge 2 + 2 (1
    + levels) + steps + 5 (probe 5: 3 levels; max_kernel 125: 6 steps, 180:
    7)."""
    assert tf.cc_global_launches(2, 4) == 4
    assert tf.cc_global_launches(2, 2) == 4
    assert tf.cc_global_launches(3, 2) == 6
    assert tf.cc_global_launches(1, 0) == 2
    assert tf.cc_global_launches(0, 4) == 1
    assert tf.cc_global_launches(2, 4, fused=False) == 13
    assert tf.cc_global_launches(3, 2, fused=False) == 13
    assert tf.bridge_global_launches(5, 125) == 21
    assert tf.bridge_global_launches(5, 180) == 22
    assert tf.bridge_global_launches(1, 2) == 2 + 4 + 1 + 5


def _split_checks(plan, n, h, w):
    """A split plan: the smallest cluster whose share fits, raised while c n
    CTAs run in one wave at two CTAs an SM; rows for every CTA."""
    c, rows = plan["cluster"], plan["rows_per_cta"]
    assert plan["route"] == "split" and c in (2, 4, 8) and plan["ctas"] == c * n
    assert rows == -(-h // c) and (c - 1) * rows < h <= c * rows
    assert plan["smem"] == 8 * h + 4 * (4 * rows * -(-w // 32) + tf.BRIDGE_SPLIT_SCHEDULE_INTS)
    assert plan["smem"] <= kernels.MAX_DYNAMIC_SMEM
    assert 4 * (9 * h * -(-w // 32) + tf.BRIDGE_SCHEDULE_INTS) > kernels.MAX_DYNAMIC_SMEM  # past one CTA
    per_sm = min(2, tf.H100_SM_SMEM // (plan["smem"] + 1024))
    if c > 2 and tf.bridge_split_smem(h, w, -(-h // (c // 2))) <= kernels.MAX_DYNAMIC_SMEM:
        assert c * n <= tf.H100_SMS * per_sm  # raised only within one wave
    if c < 8:  # not raised further: 2c CTAs a mask would not fit one wave
        more = tf.bridge_split_smem(h, w, -(-h // (2 * c)))
        assert 2 * c * n > tf.H100_SMS * min(2, tf.H100_SM_SMEM // (more + 1024))


@pytest.mark.parametrize("n, hw, want", [
    (64, (480, 640), (4, 120, 44_560)),   # ds=1, half-res off, endpoint ds=1 at B=16: 256 CTAs, 2 an SM
    (16, (480, 640), (8, 60, 25_360)),    # plane mode at ds=1, 8 views
    (8, (720, 1280), (8, 45, 19_600)),    # half-res canvases of 720x1280 to 1200x1600 at B=2
    (8, (960, 1280), (8, 60, 25_360)),
    (8, (1080, 1920), (8, 68, 41_488)),
    (8, (1200, 1600), (8, 75, 40_720)),
])
def test_split_plan_at_detector_shapes(n, hw, want):
    """The split plan at the detector's bridge sites past the cluster
    kernel: full resolution 480x640 at n = 64 and 16, and the half-res
    canvases from 720x1280 to 1200x1600 at n = 8."""
    h, w = hw if n > 8 else _cc_shapes(*hw)[1]
    plan = tf.bridge_plan(n, h, w)
    _split_checks(plan, n, h, w)
    assert (plan["cluster"], plan["rows_per_cta"], plan["smem"]) == want


@pytest.mark.parametrize("shape", [(1, 481, 650), (3, 333, 1000), (2, 720, 1280), (2, 1080, 1920), (64, 544, 1024),
                                   (200, 480, 640), (8, 1100, 1600)])
def test_split_plan_limits(shape):
    """Single masks, H off every cluster, W off 32, full-resolution 720p and
    1080p masks, more masks than one wave holds, and the tallest masks 8 CTAs
    take."""
    _split_checks(tf.bridge_plan(*shape), *shape)


# The detector's half-res canvases of the frames past the cluster kernels'
# shared memory (tests/test_torch_cuda.py LARGE_CANVASES), and the
# full-resolution 480x640 masks of the kernel branch's ds=1 and plane
# variants at B=16.
BAND_SHAPES = [(8, 304, 512), (8, 384, 512), (8, 512, 384), (8, 360, 640), (8, 480, 640), (8, 544, 1024),
               (8, 600, 896), (64, 480, 640), (16, 480, 640)]


@pytest.mark.parametrize("pools", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_band_plan_fits_shared_memory(shape, channels, pools):
    """The global plan at every large canvas: the pools fuse (bands of at
    least max(pools, 1) rows under a halo of ``pools`` rows), the bands
    cover H evenly, and the band kernel's buffers fit the opt-in shared
    memory."""
    n, h, w = shape
    plan = tf.cc_plan(n, h, w, channels=channels, pools_per_round=pools)
    if "cluster" in plan:  # (8, 304, 512) and the like hold one channel in a cluster
        assert channels == 1
        return
    r, bands = plan["band_rows"], plan["bands"]
    assert plan["fused"] and r >= max(pools, 1)
    assert (bands - 1) * r < h <= bands * r and plan["ctas"] == n * bands
    nbuf = 2 if pools else 1
    assert plan["smem"] == 4 * channels * nbuf * (r + 2 * pools) * w <= kernels.MAX_DYNAMIC_SMEM
    if bands > 1:  # the fewest bands that fit: one band fewer would not
        assert 4 * channels * nbuf * (-(-h // (bands - 1)) + 2 * pools) * w > kernels.MAX_DYNAMIC_SMEM


def test_band_plan_at_the_variant_sites():
    """(64, 480, 640): 12 bands of 40 rows for labels at 2 pools, 35 bands
    of 14 rows for the payload at 4; (8, 544, 1024): 23 bands of 24 rows and
    91 of 6."""
    p1 = tf.cc_plan(64, 480, 640, pools_per_round=2)
    assert (p1["band_rows"], p1["bands"], p1["smem"]) == (40, 12, 2 * 4 * 640 * 44)
    p2 = tf.cc_plan(64, 480, 640, channels=2, pools_per_round=4)
    assert (p2["band_rows"], p2["bands"], p2["smem"]) == (14, 35, 2 * 2 * 4 * 640 * 22)
    assert tf.cc_plan(8, 544, 1024, pools_per_round=2)["band_rows"] == 24
    assert tf.cc_plan(8, 544, 1024, channels=2, pools_per_round=4)["bands"] == 91
    with pytest.raises(ValueError, match="shared memory"):
        tf.cc_plan(1, 8, 40_000, channels=2, pools_per_round=2)


@pytest.mark.parametrize("cap_axis", [0, 1])
@pytest.mark.parametrize("cap", [1, 2, 3, 10, 16])
def test_cc_plan_with_a_cap_at_a_cluster_shape_takes_the_band_route(cap, cap_axis):
    """A cap at a shape of the cluster route: the detector's capped final
    labels at 480x640 (the half-res canvas, (32, 240, 384)), whose uncapped
    calls take the cluster route.  A capped call leaves it for the
    large-frame route: the band plan of the same pools plus the cap's axis
    and reach (and along H one streamed column pass in strips of 64
    rows)."""
    plan = tf.cc_plan(32, 240, 384, pools_per_round=2, cap_axis=cap_axis, cap=cap)
    reach = tf.cap_reach((240, 384)[cap_axis], cap)
    assert reach == {1: 0, 2: 1, 3: 3, 10: 15, 16: 15}[cap]
    assert "cluster" in tf.cc_plan(32, 240, 384, pools_per_round=2) and "cluster" not in plan
    strip = {"cap_strip": 64} if cap_axis == 0 else {}
    assert plan == {**tf._band_plan(32, 240, 384, 1, 2), "cap_axis": cap_axis, "cap_reach": reach, **strip}


@pytest.mark.parametrize("cap_axis", [0, 1])
def test_cc_plan_with_a_cap_on_the_band_route(cap_axis):
    """(32, 480, 640), the capped final labels at label_downsample=1: the
    band plan of the uncapped call (the capped row pass runs in place, so a
    band needs no second buffer for it); along H the capped column pass's
    strips of 64 rows and 128 columns, streamed through registers."""
    for pools in (0, 2):
        plan = tf.cc_plan(32, 480, 640, pools_per_round=pools, cap_axis=cap_axis, cap=16)
        base = tf.cc_plan(32, 480, 640, pools_per_round=pools)
        nbuf = 2 if pools else 1
        assert plan["smem"] == 4 * nbuf * (plan["band_rows"] + 2 * pools) * 640 <= kernels.MAX_DYNAMIC_SMEM
        strip = {"cap_strip": 64} if cap_axis == 0 else {}
        assert plan == {**base, "cap_axis": cap_axis, "cap_reach": 15, **strip}
    assert tf.cc_global_launches(2, 2, True) == 4


@pytest.mark.parametrize("cap", [32, 64, 256])
def test_cc_plan_long_reach_walks(cap):
    """Past one pass's reach (15 along H, 31 along W) the capped scans walk
    (reach 31, 63, 255 at (32, 480, 640), and on the 360-row canvas of
    720x1280 at cap 256): along H the plan is the streamed pass's, strips of
    64 rows; along W past reach 31 the bands keep a second buffer for the
    walk's output, also without pools."""
    for h, w in ((480, 640), (360, 640)):
        for pools in (0, 2):
            base = tf.cc_plan(32, h, w, pools_per_round=pools)
            along_h = tf.cc_plan(32, h, w, pools_per_round=pools, cap_axis=0, cap=cap)
            assert along_h == {**base, "cap_axis": 0, "cap_reach": cap - 1, "cap_strip": 64}
            along_w = tf.cc_plan(32, h, w, pools_per_round=pools, cap_axis=1, cap=cap)
            walk = cap > 32
            assert along_w == {**tf._band_plan(32, h, w, 1, pools, walk), "cap_axis": 1, "cap_reach": cap - 1}
            nbuf = 2 if pools or walk else 1
            assert along_w["smem"] == 4 * nbuf * (along_w["band_rows"] + 2 * pools) * w <= kernels.MAX_DYNAMIC_SMEM
            assert (along_w == {**base, "cap_axis": 1, "cap_reach": cap - 1}) == (pools > 0 or not walk)
    assert tf.cc_global_launches(2, 2, True) == 4


@pytest.mark.parametrize("hw, cap, band_rows", [((120, 700), 64, 30), ((120, 700), 16, 30), ((504, 200), 64, 126),
                                               ((96, 256), 64, 96)])
def test_cc_plan_capped_reach_against_the_bands(hw, cap, band_rows):
    """Capped calls at shapes a cluster would hold take the band route: its
    bands as the uncapped band plan sizes them, whatever the reach (63 at
    (120, 700) passes the bands' 30 rows: the column pass reads across bands
    from the state plane; the row pass stays within a row)."""
    h, w = hw
    for cap_axis in (0, 1):
        plan = tf.cc_plan(2, h, w, pools_per_round=2, cap_axis=cap_axis, cap=cap)
        assert plan["route"] == "global" and plan["band_rows"] == band_rows
        assert plan["smem"] == 4 * 2 * (band_rows + 4) * w <= kernels.MAX_DYNAMIC_SMEM
        assert plan["cap_reach"] == tf.cap_reach((h, w)[cap_axis], cap)


@pytest.mark.parametrize("h, cap, strip", [(480, 1, 64), (480, 16, 64), (20, 16, 20), (480, 32, 64),
                                           (480, 128, 64), (96, 64, 64), (1080, 512, 64), (600, 256, 64)])
def test_capped_strip_rows(h, cap, strip):
    """The band route's capped column pass along H: strips of 64 rows (the
    mask's height if less) at every reach (the streamed pass up to reach 15
    uses them, the walk past it does not); no strip along W."""
    plan = tf.cc_plan(2, h, 640, pools_per_round=2, cap_axis=0, cap=cap)
    assert plan["cap_strip"] == strip and plan["cap_reach"] == tf.cap_reach(h, cap) >= 0
    assert "cap_strip" not in tf.cc_plan(2, h, 640, pools_per_round=2, cap_axis=1, cap=cap)


def test_cc_plan_cap_that_covers_every_run_is_no_cap():
    """A cap of at least the axis (or 0, or an axis of -1) scans whole runs:
    the plan is the uncapped one."""
    base = tf.cc_plan(4, 96, 256, pools_per_round=2)
    for cap_axis, cap in ((0, 96), (0, 200), (1, 256), (0, 0), (-1, 16)):
        assert tf.cc_plan(4, 96, 256, pools_per_round=2, cap_axis=cap_axis, cap=cap) == base


@pytest.mark.parametrize("kw, match", [(dict(cap_axis=2, cap=4), "cap_axis"), (dict(cap_axis=0, cap=-3), "cap"),
                                       (dict(channels=2, cap_axis=0, cap=4), "labels only")])
def test_cc_plan_refuses_caps(kw, match):
    with pytest.raises(ValueError, match=match):
        tf.cc_plan(4, 96, 256, **kw)


def test_min_bytes_at_the_detector_sites():
    assert kernels.min_bytes("preprocess_binarize", 32, 480, 640) == 275_251_200
    assert kernels.min_bytes("connected_components", 64, 128, 256) == 16_777_216
    assert kernels.min_bytes("connected_components", 64, 240, 384) == 47_185_920
    assert kernels.min_bytes("connected_components", 64, 240, 384, warm=True) == 70_778_880
    assert kernels.min_bytes("bridge_morphology", 64, 240, 384) == 70_778_880
    assert kernels.min_bytes("component_payload_minmax", 64, 240, 384) == 94_371_840


def test_min_bytes_of_the_bool_bridge():
    assert kernels.min_bytes("bridge_morphology", 64, 240, 384, itemsize=1) == 17_694_720
    assert kernels.min_bytes("bridge_morphology", 64, 240, 384, itemsize=4) == 70_778_880


def test_wrappers_count_through_the_catalogue(monkeypatch):
    """With the card's route taken on CPU tensors and the launches stubbed,
    every wrapper on every route counts only the catalogue's counters
    (``kernels.count`` refuses any other name), and every counter of the
    catalogue is counted by one of them.  ``ops/linalg``,
    ``ops/stencils`` and ``ops/labeling`` reach the kernels through
    ``ops/kernels``, never through the front end."""
    monkeypatch.setattr(kernels, "route", lambda x: True)
    monkeypatch.setattr(kernels, "check", lambda *args: None)
    monkeypatch.setattr(kernels, "launch", lambda *args: None)
    kernels.reset_launch_counts()
    x = torch.zeros((1, 64, 96))
    tf.preprocess_binarize(x)  # with its own smoothing
    for m in (x, torch.zeros((1, 544, 1024))):  # the cluster and the band route
        tf.connected_components(m, 1, 1)
        tf.component_payload_minmax(m, m.to(torch.int32), 1, 1)
    tf.connected_components(x, 1, 1, cap_axis=0, cap=16)  # capped, band
    for shape in ((1, 64, 96), (1, 720, 1280), (1, 2160, 3840)):  # cluster, split, global
        m = torch.zeros(shape, dtype=torch.bool)
        tf.bridge_morphology(m, m, torch.zeros(1), torch.tensor(20.0), 5, 25)
    linalg.solve_spd(torch.eye(6).expand(2, 6, 6), torch.zeros((2, 6)))
    stencils.smooth(x)
    stencils.stats_images(x, x, x)
    labeling.connected_components(torch.zeros((2, 64, 96), dtype=torch.bool), 8)
    assert {k for k, n in kernels.launch_counts().items() if n} == set(kernels.COUNTERS)
    with pytest.raises(KeyError):
        kernels.count("component_payload_minmax.band")
    for mod in (linalg, stencils, labeling):
        imported = set()
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if isinstance(node, ast.ImportFrom):
                imported |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
            elif isinstance(node, ast.Import):
                imported |= {a.name for a in node.names}
        assert not any(m.endswith(".frontend") for m in imported), (mod.__name__, imported)


def test_preprocess_margin_under_reach_raises():
    assert tf.preprocess_reach() == 20
    x = torch.zeros((1, 64, 96))
    with pytest.raises(ValueError, match="reach"):
        tf.preprocess_binarize(x, margin=19, pre_smoothed=True)
    assert len(tf.preprocess_binarize(x, margin=20, pre_smoothed=True)) == 6


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
