"""PyTorch port, on the CPU: the front stage's banded correlations
(``ops/stencils``).  The launch plans of the two stencil kernels (tiles
over ragged edges, shared memory at every radius they take), the taps they
are handed, the C entries against ``kernels.ENTRIES`` and the source's
constants, the byte counts, the CPU route against the former matmul code
bit for bit, and the correlation the kernels compute (zero padding, the
ramp's orientation) against ``mxu_conv.conv_x`` / ``conv_y`` at the
borders.  No JAX here."""

import re

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
from cylinder_pose_estimation_tpu_torch.models import detector
from cylinder_pose_estimation_tpu_torch.ops import kernels
from cylinder_pose_estimation_tpu_torch.ops import mxu_conv as mxc
from cylinder_pose_estimation_tpu_torch.ops import stencils

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

SRC = (kernels.CSRC / "stencils.cu").read_text()
# (n, h, w) of the detector's calls (B=16, a 64-frame chunk, F=100, full
# HD) and ragged 8-aligned shapes.
SHAPES = [(32, 480, 640), (128, 480, 640), (200, 480, 640), (32, 1080, 1920), (4, 200, 328), (2, 8, 8),
          (1, 136, 200), (3, 720, 1280)]


def _covers(grid_n, tile, n):
    """The tiles along an axis cover it, and the last one starts inside it."""
    return grid_n * tile >= n and (grid_n - 1) * tile < n


@pytest.mark.parametrize("shape", SHAPES)
def test_smooth_plan_tiles_cover_ragged_edges(shape):
    n, h, w = shape
    plan = stencils.smooth_plan(n, h, w)
    th, tw = plan["tile"]
    gx, gy, gz = plan["grid"]
    assert (th, tw) == stencils.SMOOTH_TILE and gz == n and plan["radius"] == 14
    assert _covers(gx, tw, w) and _covers(gy, th, h)


@pytest.mark.parametrize("radii", [(9, 3, -1, 5), (9, 3, 5, 5), (7, 2, 3, 4)])
@pytest.mark.parametrize("shape", SHAPES)
def test_stats_plan_tiles_cover_ragged_edges(shape, radii):
    n, h, w = shape
    plan = stencils.stats_plan(n, h, w, radii)
    t = plan["tile"]
    gx, gy, gz = plan["grid"]
    assert t == stencils.STATS_TILE and gz == 2 * n  # grey tiles, then joint tiles
    assert _covers(gx, t, w) and _covers(gy, t, h)
    assert plan["halo"] == (max(radii[:3]), radii[3])


def test_plans_mirror_the_kernel_layouts():
    """The shared bytes at the detector's radii, as csrc/stencils.cu's
    LayoutS0 and LayoutT count them (odd pitches)."""
    assert stencils.smooth_plan(32, 480, 640)["smem"] == 4 * (92 * 157 + 92 * 129)
    grey = 82 * 83 + 82 * 65 + 70 * 65
    joint = 74 * 75 + 74 * 65 + 64 * 75
    assert stencils.stats_plan(32, 480, 640, (9, 3, -1, 5))["smem"] == 4 * max(grey, joint)
    assert stencils.stats_plan(32, 480, 640, (9, 3, 5, 5))["smem"] == 4 * (grey + 74 * 65)


@pytest.mark.parametrize("radius", range(stencils.MAX_RADIUS + 1))
def test_shared_memory_fits_at_every_radius(radius):
    """Every radius the kernels take fits the 227 KB a block may opt in to:
    the smoothing at each radius, the statistic images with each band at
    this radius and the others at their widest (the bytes grow with every
    radius)."""
    assert stencils.smooth_plan(1, 64, 128, radius)["smem"] <= kernels.MAX_DYNAMIC_SMEM == 232448
    m = stencils.MAX_RADIUS
    for radii in ((radius, m, m, m), (m, radius, m, m), (m, m, radius, m), (m, m, m, radius), (m, m, -1, m),
                  (radius,) * 4):
        assert stencils.stats_plan(1, 64, 64, radii)["smem"] <= kernels.MAX_DYNAMIC_SMEM


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        stencils.smooth_plan(1, 64, 64, stencils.MAX_RADIUS + 1)
    with pytest.raises(ValueError):
        stencils.stats_plan(1, 64, 64, (stencils.MAX_RADIUS + 1, 3, -1, 5))
    with pytest.raises(ValueError):
        stencils.stats_plan(1, 64, 64, (9, 3, -2, 5))
    with pytest.raises(ValueError):
        stencils.stats_plan(32768, 8, 8)  # 2N planes past a grid's z
    with pytest.raises(ValueError):
        stencils.smooth_plan(1024, 2048, 1024)  # past the 32-bit plane index


def test_composed_taps_and_the_cap():
    """The detector's smoothing: the 5-tap OpenCV Gaussian composed with the
    25-tap scipy Gaussian, 29 float32 taps, symmetric, summing to 1; the
    kernel's cap is 2 MAX_RADIUS + 1 taps (a radius of 31)."""
    cfg = CylinderDetectConfig()
    taps = stencils.smooth_taps(cfg.blur_ksize, cfg.ridge_sigma)
    ct = mxc.compose_taps(mxc.gauss_taps_cv(5), mxc.gauss_taps_scipy(3.0))
    assert len(taps) == 29 and taps == tuple(np.asarray(ct, np.float32).tolist())
    assert taps == taps[::-1] and abs(sum(taps) - 1.0) < 1e-6
    assert taps == tuple(mxc.band_matrix(ct, 64, True, "cpu")[:29, 14].tolist())
    assert len(stencils.smooth_taps(7, 7.0)) == 2 * (3 + 28) + 1 == 2 * stencils.MAX_RADIUS + 1
    with pytest.raises(ValueError):
        stencils.smooth_taps(9, 7.0)
    assert stencils.MAX_RADIUS == int(re.search(r"kMaxRadius = (\d+);", SRC).group(1))


@pytest.mark.parametrize("center", [None, 5])
def test_stats_tap_packing(center):
    """The statistic images' taps in the kernel's order: the saturation and
    index blurs as the default-mode band matrices hold them (bfloat16), the
    centre box, the joint ramp and box; the radii at the detector's
    defaults."""
    radii, taps = stencils.stats_taps(19, 7, center, 11)
    assert radii == (9, 3, -1 if center is None else 5, 5)
    sizes = [19, 7] + ([11] if center is not None else []) + [11, 11]
    assert len(taps) == sum(sizes)
    parts, i = [], 0
    for n in sizes:
        parts.append(taps[i:i + n])
        i += n
    for part, band in zip(parts[:2], (mxc.gauss_taps_cv(19), mxc.gauss_taps_cv(7))):
        held = mxc.band_matrix(band, 64, False, "cpu")
        r = len(band) // 2
        assert part == tuple(held[:len(band), r].tolist())  # column r holds the taps in order
        assert torch.equal(torch.tensor(part).to(torch.bfloat16).to(torch.float32), torch.tensor(part))
    assert parts[-2] == tuple(float(t) for t in range(-5, 6)) and parts[-1] == (1.0,) * 11
    if center is not None:
        assert parts[2] == (1.0,) * 11
    assert len(taps) <= 5 * (2 * stencils.MAX_RADIUS + 1)
    with pytest.raises(ValueError):
        stencils.stats_taps(65, 7, None, 11)
    with pytest.raises(ValueError):
        stencils.stats_taps(19, 7, None, 10)


@pytest.mark.parametrize("name", ["cpe_stencil_smooth", "cpe_stencil_stats"])
def test_stencil_entry_points_match_their_signatures(name):
    """Each C entry takes the pointers, ints and floats
    ``kernels.ENTRIES`` declares, then the stream; the tiles are the
    plans'."""
    params = re.search(rf"CPE_API int {name}\(([^)]*)\)", SRC).group(1).split(",")
    kinds = [("ptr" if "*" in q else "int" if q.split()[0] == "int" else q.split()[0]) for q in params]
    n_ptr, n_int, n_float = kernels.ENTRIES[name]
    assert kinds == ["ptr"] * n_ptr + ["int"] * n_int + ["float"] * n_float + ["cudaStream_t"], kinds
    assert stencils.SMOOTH_TILE == (int(re.search(r"kSmoothH = (\d+);", SRC).group(1)),
                                    int(re.search(r"kSmoothW = (\d+);", SRC).group(1)))
    assert stencils.STATS_TILE == int(re.search(r"kStatsTile = (\d+);", SRC).group(1))


@pytest.mark.parametrize("shape, want", [((32, 480, 640), (78_643_200, 245_760_000, 285_081_600)),
                                         ((32, 1080, 1920), (530_841_600, 1_658_880_000, 1_924_300_800))])
def test_stencil_bytes(shape, want):
    """Inputs read once, outputs written once: S0 8 B a pixel; T 25 B (29 B
    with the centre-seed image)."""
    got = (kernels.min_bytes("stencil_smooth", *shape), kernels.min_bytes("stencil_stats", *shape),
           kernels.min_bytes("stencil_stats", *shape, center=True))
    assert got == want
    with pytest.raises(KeyError):
        kernels.min_bytes("stencil_blur", *shape)


def test_stencil_counters_are_kernel_counters():
    assert {"stencil_smooth", "stencil_stats"} <= set(kernels.COUNTERS)
    assert {"stencil_smooth", "stencil_stats"} <= set(kernels.launch_counts())


# --- the CPU route: the former matmul code, bit for bit -------------------

def _former_smooth(gray, cfg):
    h, w = gray.shape[-2:]
    ct = mxc.compose_taps(mxc.gauss_taps_cv(cfg.blur_ksize), mxc.gauss_taps_scipy(cfg.ridge_sigma))
    kin = mxc.conv_x(gray, mxc.x_mat(ct, w, gray.device, exact=True), exact=True)
    kin = mxc.conv_x(kin.transpose(-1, -2), mxc.x_mat(ct, h, gray.device, exact=True), exact=True)
    return kin.transpose(-1, -2).contiguous()


def _former_stats(gray, joints_f, cnt, cfg, joint_window=11):
    h, w = gray.shape[-2:]
    dev = gray.device
    rr = torch.arange(h, device=dev)[:, None]
    cc = torch.arange(w, device=dev)[None, :]
    mrg = detector._border_margin(cfg)
    inside = (rr >= mrg) & (rr < h - mrg) & (cc >= mrg) & (cc < w - mrg)
    gt = mxc.gauss_taps_cv(cfg.sat_blur_ksize)
    sat = mxc.conv_y(mxc.conv_x(gray, mxc.x_mat(gt, w, dev)), mxc.y_mat(gt, h, dev))
    sat_mask = (sat > cfg.sat_threshold) & inside
    bright_center = None
    if not cfg.bright_at_points:
        pc = 2 * cfg.center_patch_half + 1
        bt = mxc.box_taps(pc)
        bc = mxc.conv_y(mxc.conv_x(gray, mxc.x_mat(bt, w, dev, exact=True), exact=True),
                        mxc.y_mat(bt, h, dev, exact=True), exact=True)
        bright_center = bc / float(pc * pc)
    gk = mxc.gauss_taps_cv(cfg.index_blur_ksize)
    bright_blur = mxc.conv_y(mxc.conv_x(gray, mxc.x_mat(gk, w, dev)), mxc.y_mat(gk, h, dev))
    jb = mxc.box_taps(joint_window)
    jr = mxc.ramp_taps(joint_window)
    tx = mxc.conv_x(joints_f, mxc.x_mat(jr, w, dev))
    ty = mxc.conv_y(joints_f, mxc.y_mat(jr, h, dev))
    sx = cc.to(torch.float32) * cnt + mxc.conv_y(tx, mxc.y_mat(jb, h, dev))
    sy = rr.to(torch.float32) * cnt + mxc.conv_x(ty, mxc.x_mat(jb, w, dev))
    c = torch.clamp(cnt, min=1.0)
    return sat_mask, bright_center, bright_blur, torch.floor(sx / c), torch.floor(sy / c)


def _inputs(shape, seed):
    g = torch.Generator().manual_seed(seed)
    gray = torch.rand(shape, generator=g) * 255.0
    gray[:, 30:60, 40:90] = 255.0
    joints = (torch.rand(shape, generator=g) < 0.03).to(torch.float32)
    cnt = _corr64(_corr64(joints.double(), (1.0,) * 11, 2), (1.0,) * 11, 1).to(torch.float32)
    return gray, joints, cnt


CFGS = {
    "defaults": CylinderDetectConfig(height=96, width=136, use_pallas=True),
    "center": CylinderDetectConfig(height=96, width=136, use_pallas=True, bright_at_points=False),
    "radii": CylinderDetectConfig(height=96, width=136, use_pallas=True, blur_ksize=3, ridge_sigma=2.0,
                                  sat_blur_ksize=15, index_blur_ksize=5, center_patch_half=3,
                                  bright_at_points=False),
    "plane": PlaneDetectConfig(height=96, width=136, use_pallas=True),
}


@pytest.mark.parametrize("case", list(CFGS))
def test_cpu_route_is_the_former_matmul_code(case):
    """On CPU tensors the wrappers, the detector's ``_smooth`` and
    ``_stats_images`` (the XLA branch's route) give the former banded-matmul
    code's outputs bit for bit."""
    cfg = CFGS[case]
    gray, joints, cnt = _inputs((2, 96, 136), seed=len(case))
    want = _former_smooth(gray, cfg)
    assert torch.equal(stencils.smooth(gray, cfg.blur_ksize, cfg.ridge_sigma), want)
    assert torch.equal(detector._smooth(gray, cfg), want)
    want = _former_stats(gray, joints, cnt, cfg)
    for got in (stencils.stats_images(gray, joints, cnt, **detector._stats_args(cfg)),
                detector._stats_images(gray, joints, cnt, cfg)):
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    assert int(want[0].sum()) > 0


def test_sat_out_is_the_card_route_only():
    gray, joints, cnt = _inputs((1, 64, 64), seed=1)
    with pytest.raises(ValueError, match="card"):
        stencils.stats_images(gray, joints, cnt, sat_out=torch.empty_like(gray))


# --- the correlation the kernels compute ---------------------------------

def _corr64(x, taps, dim):
    """Zero-padded correlation out[i] = sum_t taps[t] * x[i + t - r] along
    ``dim``, in float64: the kernels' definition, tap by tap."""
    x = x.double()
    r = len(taps) // 2
    n = x.shape[dim]
    out = torch.zeros_like(x)
    for t, v in enumerate(taps):
        s = t - r
        if abs(s) < n:
            out.narrow(dim, max(0, -s), n - abs(s)).add_(x.narrow(dim, max(0, s), n - abs(s)), alpha=float(v))
    return out


@pytest.mark.parametrize("exact", [True, False], ids=["float32", "bf16"])
@pytest.mark.parametrize("taps", [mxc.ramp_taps(11), (1.0, 2.0, 4.0, -3.0, 0.5), mxc.box_taps(7)],
                         ids=["ramp11", "asymmetric5", "box7"])
@pytest.mark.parametrize("hw", [(24, 40), (9, 13), (5, 7)])
def test_band_products_are_zero_padded_correlations(hw, taps, exact):
    """conv_x with x_mat and conv_y with y_mat are out[i] = sum_t taps[t] *
    x[i + t - r], zero outside the image, along W and along H (y_mat
    reverses the taps so that both axes correlate): the orientation and the
    padding the kernels implement, held exactly on small integers (products
    and sums exact in float32), up to the borders and on axes shorter than
    the band."""
    h, w = hw
    x = torch.randint(-8, 9, (2, h, w), generator=torch.Generator().manual_seed(h * w)).to(torch.float32)
    gx = mxc.conv_x(x, mxc.x_mat(taps, w, "cpu", exact=exact), exact=exact)
    gy = mxc.conv_y(x, mxc.y_mat(taps, h, "cpu", exact=exact), exact=exact)
    assert torch.equal(gx.double(), _corr64(x, taps, 2))
    assert torch.equal(gy.double(), _corr64(x, taps, 1))
    # A border pixel: its band reaches past the image, where the product is 0.
    r = len(taps) // 2
    assert float(gx[0, 0, 0]) == sum(taps[t] * float(x[0, 0, t - r]) for t in range(r, min(len(taps), w + r)))


def test_centroid_sums_are_the_window_moments():
    """The joint ramp along W then the box along H, plus x * cnt, is the sum
    of the window's joints' x coordinates (the same along H for y): the
    ramp's sign as the kernels take it."""
    _, joints, cnt = _inputs((1, 40, 56), seed=3)
    j = joints.double()
    sx = torch.arange(56, dtype=torch.float64) * cnt.double() + _corr64(_corr64(j, mxc.ramp_taps(11), 2),
                                                                        mxc.box_taps(11), 1)
    sy = torch.arange(40, dtype=torch.float64)[:, None] * cnt.double() + _corr64(
        _corr64(j, mxc.ramp_taps(11), 1), mxc.box_taps(11), 2)
    xx = torch.arange(56, dtype=torch.float64).expand(40, 56)
    yy = torch.arange(40, dtype=torch.float64)[:, None].expand(40, 56)
    box = (1.0,) * 11
    assert torch.equal(sx, _corr64(_corr64(j * xx, box, 2), box, 1))
    assert torch.equal(sy, _corr64(_corr64(j * yy, box, 2), box, 1))
    got = stencils.stats_images(torch.zeros_like(joints), joints, cnt)
    assert torch.equal(got[3].double(), torch.floor(sx / cnt.double().clamp(min=1.0)))
