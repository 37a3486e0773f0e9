"""PyTorch port: the detector's full-resolution variants and sub-pixel
refinement against the JAX record ``tests/fixtures/torch_variant_scenes.json``
(240x320; ``python tools/make_torch_port_fixtures.py variants``).

Each configuration of the record (``label_downsample`` 1 or 2 with
``bridge_half_res`` on or off, ``subpixel_refine``, the endpoint bridge at
full resolution, plane mode at full resolution; the kernel branch and the
XLA branch) runs through the port's stages on the record's scenes: the
bridged masks and the final labels must be bit-equal to the JAX package's
(SHA-256 of their bytes), the grids must have identical ids with xy within
1e-3 px, and ``ok``, ``stable`` and the bridged count must be equal.  The
full-resolution ``_bridge`` case of tests/test_detector_hardening.py is held
to its record the same way.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu_torch import config as tcfg
from cylinder_pose_estimation_tpu_torch.models import detector as td
from cylinder_pose_estimation_tpu_torch.utils.synthetic import cylinder_view, plane_view

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W = 240, 320
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_variant_scenes.json")
with open(FIXTURE) as _f:
    RECORD = json.load(_f)["records"][f"{H}x{W}"]
CONFIGS = {c["name"]: c for c in RECORD["configs"]}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def views():
    cyl = np.stack([cylinder_view(H, W, **s) for s in RECORD["scenes"]["cylinder_views"]])
    plane = np.stack([plane_view(H, W, **s) for s in RECORD["scenes"]["plane_views"]])
    return {"cylinder": torch.as_tensor(cyl), "plane": torch.as_tensor(plane)}


def _config(rec):
    cls = tcfg.PlaneDetectConfig if rec["mode"] == "plane" else tcfg.CylinderDetectConfig
    return cls(height=H, width=W, use_pallas=rec["use_pallas"], **rec["overrides"])


def _stages(images, cfg):
    """The port's detector, stage by stage (as ``detect_grid``)."""
    gray = td._to_gray(images)
    front = (td.front_stage if cfg.use_pallas else td.front_stage_xla)(gray, cfg)
    roi = td.roi_stage(front, cfg)
    br = (td.bridge_stage if cfg.use_pallas else td.bridge_stage_xla)(roi.mh, roi.mv, roi.circle_radius0, cfg)
    st = td.GridState(
        cents=front.cents, inside=roi.inside, bbox=roi.bbox, h_exp=br.h_exp, v_exp=br.v_exp,
        circle_radius0=roi.circle_radius0, gray=front.gray, bright_blur=front.bright_blur,
        warm_labels=br.warm_labels, bridge_angles=br.angles, n_pre=br.n_pre,
        binary=front.binary, mh=roi.mh, mv=roi.mv, carve_domain=roi.carve_domain,
    )
    _, labels, _ = td.final_labels(st, cfg)
    result, _ = td.grid_stage(st, cfg)
    return br, labels, result


def _points_match(grid, i, records):
    xy, idx, valid = grid.xy[i].numpy(), grid.idx[i].numpy(), grid.valid[i].numpy()
    got = {(int(idx[k, 0]), int(idx[k, 1])): xy[k] for k in range(len(valid)) if valid[k]}
    want = {tuple(r["id"]): (r["x"], r["y"]) for r in records}
    assert set(got) == set(want)
    return max((float(np.abs(got[k] - np.asarray(want[k])).max()) for k in want), default=0.0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_variant_matches_jax_stage_by_stage(name, views):
    rec = CONFIGS[name]
    cfg = _config(rec)
    tcfg.validate(cfg)
    with torch.inference_mode():
        br, labels, result = _stages(views[rec["mode"]], cfg)
    for i, want in enumerate(rec["views"]):
        assert list(labels.shape[-2:]) == want["canvas"]
        assert _digest(br.h_exp[i]) == want["h_exp"], f"view {i}: bridged h mask differs"
        assert _digest(br.v_exp[i]) == want["v_exp"], f"view {i}: bridged v mask differs"
        assert _digest(labels[i].to(torch.int32)) == want["labels"], f"view {i}: final labels differ"
        assert _points_match(result.grid, i, want["points"]) <= 1e-3
        assert bool(result.ok[i]) == want["ok"]
        assert bool(result.stable[i]) == want["stable"]
        assert int(result.bridged_components[i]) == want["bridged_components"]


def test_variants_cover_every_configuration():
    """Every new (label_downsample, bridge_half_res) pair and refinement on
    both branches, the full-resolution endpoint bridge and plane mode, and a
    dropout the bridge closes at full resolution."""
    combos = {(c["overrides"].get("label_downsample", 2), c["overrides"].get("bridge_half_res", True),
               c["use_pallas"]) for c in CONFIGS.values() if c["mode"] == "cylinder"}
    for ds, half in ((2, False), (1, True), (1, False)):
        assert {(ds, half, True), (ds, half, False)} <= combos
    assert any(c["overrides"].get("subpixel_refine") for c in CONFIGS.values())
    assert any(c["overrides"].get("bridge_endpoint_stats") for c in CONFIGS.values())
    assert {c["use_pallas"] for c in CONFIGS.values() if c["mode"] == "plane"} == {True, False}
    assert all(CONFIGS[n]["views"][1]["bridged_components"] > 0 for n in ("ds1_kernel", "ds1_xla"))


def _bridge_case_mask():
    """tests/test_detector_hardening.py's masks: a long line and a line
    broken by a 20 px gap."""
    m = np.zeros((H, W), bool)
    m[60:62, 40:280] = True
    m[120:122, 40:140] = True
    m[120:122, 160:280] = True
    return m


def test_full_resolution_bridge_case_matches_jax():
    """The XLA branch's full-resolution bridge (statistics on the half-res
    canvas, morphology on the full masks) closes the gap, keeps the long
    line, and equals the JAX package's ``_bridge``."""
    case = RECORD["bridge_case"]
    cfg = tcfg.CylinderDetectConfig(height=H, width=W, bridge_half_res=False)
    m = torch.as_tensor(_bridge_case_mask())[None]
    with torch.inference_mode():
        br = td.bridge_stage_xla(m, torch.zeros_like(m), torch.tensor([case["circle_radius0"]]), cfg)
    out = br.h_exp[0]
    assert out.shape == (H, W)
    assert bool(out[118:124, 140:160].any()), "the gap must be bridged at full resolution"
    assert bool(out[60, 40:280].all()), "the long line must stay"
    assert _digest(out) == case["h_exp"] and int(out.sum()) == case["pixels"]
    assert int(br.n_pre[0]) == case["n_pre"]
    assert abs(float(br.angles[0, 0]) - case["angle"]) <= 1e-6


@pytest.mark.parametrize("h, w", [(240, 320), (36, 52)])
def test_upsample2_undoes_pool2_pad(h, w):
    """``_upsample2`` crops the half-res canvas and repeats each pixel 2x2:
    a pooled-then-upsampled mask covers the original and pools back to the
    same canvas."""
    g = torch.Generator().manual_seed(h)
    m = torch.rand((2, h, w), generator=g) < 0.3
    up = td._upsample2(td._pool2_pad(m), h, w)
    assert up.shape == (2, h, w) and bool((up | ~m).all())
    assert torch.equal(td._pool2_pad(up), td._pool2_pad(m))
