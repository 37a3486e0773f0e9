"""PyTorch port: the detector's stages fed the JAX package's own intermediate
state (``detect_grid(..., return_debug=True)`` and the ``bridge_state``
probe, Pallas path in interpret mode), on a 240x320 cylinder scene and the
same scene with a laser dropout that the bridge closes.

Masks and labels must be exact; centroids within 1e-4 px; the final grid
ids identical and coordinates within 1e-3 px.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.config import CylinderDetectConfig
from cylinder_pose_estimation_tpu.models.detector import detect_grid as jdetect
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)
from cylinder_pose_estimation_tpu_torch.config import from_reference
from cylinder_pose_estimation_tpu_torch.models import detector as td

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W = 240, 320
GAP = (112, 122, 130, 140)  # y0, y1, x0, x1: closes across 2 fragments


def _scene(gap):
    st = default_stereo(cx=W / 2.0, cy=H / 2.0)
    sc = cylinder_grid_points(st, capacity=128, origin=(0.0, -15.0, 560.0), radius=52.0,
                              row_spacing=12.0, theta_span=2.2)
    img = np.asarray(render_grid_image(sc.gp1.xy, sc.gp1.valid, 9, 9, H, W), np.float32)
    img = np.clip(img + np.random.default_rng(0).normal(0, 2.0, (H, W)).astype(np.float32), 0, 255)
    if gap is not None:
        y0, y1, x0, x1 = gap
        yy = np.arange(H, dtype=np.float32)[:, None]
        xx = np.arange(W, dtype=np.float32)[None, :]

        def edge(v, lo, hi):
            return 1.0 / (1.0 + np.exp(-(v - lo) / 1.5)) * 1.0 / (1.0 + np.exp((v - hi) / 1.5))

        with np.errstate(over="ignore"):
            img = np.clip(img * (1.0 - 0.97 * edge(yy, y0, y1) * edge(xx, x0, x1)), 0, 255)
    return img.astype(np.float32)


JCFG = CylinderDetectConfig(height=H, width=W, use_pallas=True, pallas_interpret=True)
TCFG = from_reference(JCFG)
_full = jax.jit(lambda im: jdetect(im, JCFG, return_debug=True))
_probe = jax.jit(lambda im: jdetect(im, dataclasses.replace(JCFG, stage_probe="bridge_state")))


@pytest.fixture(scope="module", params=[None, GAP], ids=["clean", "gap"])
def ref(request):
    img = _scene(request.param)
    res, dbg = _full(jnp.asarray(img))
    st = _probe(jnp.asarray(img))
    if request.param is not None:
        assert int(res.bridged_components) > 0, "the gap scene must bridge"
    return img, jax.tree.map(np.asarray, res), jax.tree.map(np.asarray, dbg), {
        k: np.asarray(v) for k, v in st.items()
    }


def _b(x):
    """numpy -> torch with a leading batch axis of 1."""
    return torch.as_tensor(np.array(x))[None]


def test_front_stage_matches(ref):
    img, _, dbg, _ = ref
    front = td.front_stage(_b(img), TCFG)
    np.testing.assert_array_equal(front.binary[0].numpy(), dbg.binary)
    np.testing.assert_allclose(front.cents[0].numpy(), dbg.centroids, atol=1e-4)


def test_roi_stage_matches(ref):
    img, _, dbg, st = ref
    roi = td.roi_stage(td.front_stage(_b(img), TCFG), TCFG)
    np.testing.assert_array_equal(roi.roi[0].numpy(), dbg.roi_mask)
    np.testing.assert_array_equal(roi.inside[0].numpy(), dbg.centroids_valid)
    np.testing.assert_array_equal(roi.mh[0].numpy(), dbg.h_mask)
    np.testing.assert_array_equal(roi.mv[0].numpy(), dbg.v_mask)
    np.testing.assert_array_equal(roi.bbox[0].numpy(), st["bbox"])
    assert float(roi.circle_radius0[0]) == float(st["circle_radius0"])
    np.testing.assert_allclose(roi.center[0].numpy(), dbg.center_seed, atol=1e-4)


def test_bridge_stage_matches(ref):
    """Fed the JAX carved masks, the bridge gives the JAX bridged masks."""
    _, _, dbg, st = ref
    br = td.bridge_stage(_b(dbg.h_mask), _b(dbg.v_mask), _b(st["circle_radius0"]), TCFG)
    np.testing.assert_array_equal(br.h_exp[0].numpy(), st["h_exp"])
    np.testing.assert_array_equal(br.v_exp[0].numpy(), st["v_exp"])
    np.testing.assert_array_equal(br.h_exp[0].numpy(), dbg.h_expanded)


@pytest.mark.parametrize("endpoint", [False, True], ids=["moments", "endpoint"])
def test_bridge_call_site_passes_bool(ref, endpoint, monkeypatch):
    """The bridge stage hands the kernel its bool masks and one kernel
    length per view, and gets the masks the float call (per-mask lengths,
    result > 0.5) gives."""
    _, _, dbg, st = ref
    cfg = dataclasses.replace(TCFG, bridge_endpoint_stats=endpoint)
    calls = []
    real = td.frontend.bridge_morphology

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(td.frontend, "bridge_morphology", spy)
    br = td.bridge_stage(_b(dbg.h_mask), _b(dbg.v_mask), _b(st["circle_radius0"]), cfg)
    (masks, exps, angles, klen), kw, out = calls[0]
    assert masks.dtype == exps.dtype == out.dtype == torch.bool and klen.shape == (1,)
    want = td.frontend.bridge_morphology_plain(masks.to(torch.float32), exps.to(torch.float32), angles,
                                               klen.repeat_interleave(2), **kw) > 0.5
    assert torch.equal(out, want)
    assert torch.equal(br.h_exp, want[0::2]) and torch.equal(br.v_exp, want[1::2])


def _grid_map(grid, i=0):
    xy = grid.xy[i].numpy()
    idx = grid.idx[i].numpy()
    v = grid.valid[i].numpy()
    return {tuple(idx[k]): xy[k] for k in range(len(v)) if v[k]}


def test_grid_stage_matches(ref):
    """Fed the JAX bridge_state, the label -> grid tail gives the JAX grid."""
    img, res, dbg, st = ref
    front = td.front_stage(_b(img), TCFG)
    roi = td.roi_stage(front, TCFG)
    br = td.bridge_stage(_b(dbg.h_mask), _b(dbg.v_mask), _b(st["circle_radius0"]), TCFG)
    gs = td.GridState(
        cents=_b(st["cents"]), inside=_b(st["inside"]), bbox=_b(st["bbox"]),
        h_exp=_b(st["h_exp"]), v_exp=_b(st["v_exp"]), circle_radius0=_b(st["circle_radius0"]),
        gray=_b(st["gray"]), bright_blur=front.bright_blur, warm_labels=br.warm_labels, bridge_angles=br.angles,
        n_pre=br.n_pre, binary=_b(dbg.binary), mh=_b(dbg.h_mask), mv=_b(dbg.v_mask),
        carve_domain=roi.carve_domain,
    )
    out, (rc, cc, rv, cv) = td.grid_stage(gs, TCFG)
    np.testing.assert_array_equal(rv[0].numpy(), dbg.row_valid)
    np.testing.assert_array_equal(cv[0].numpy(), dbg.col_valid)
    got = _grid_map(out.grid)
    want = {tuple(res.grid.idx[k]): res.grid.xy[k] for k in range(len(res.grid.valid))
            if res.grid.valid[k]}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    assert int(out.bridged_components[0]) == int(res.bridged_components)
    assert bool(out.labels_converged[0]) == bool(res.labels_converged)
    assert bool(out.stable[0]) == bool(res.stable)
    assert bool(out.ok[0]) == bool(res.ok)
    assert abs(float(out.max_line_tilt[0]) - float(res.max_line_tilt)) < 1e-5


def test_detect_grid_matches(ref):
    """The whole port detector against the JAX Pallas path (interpret)."""
    img, res, dbg, _ = ref
    out, tdbg = td.detect_grid(_b(img), TCFG, return_debug=True)
    got = _grid_map(out.grid)
    want = {tuple(res.grid.idx[k]): res.grid.xy[k] for k in range(len(res.grid.valid))
            if res.grid.valid[k]}
    assert set(got) == set(want)
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-3
    np.testing.assert_array_equal(tdbg.v_expanded[0].numpy(), dbg.v_expanded)
    np.testing.assert_allclose(out.grid.center[0].numpy(), res.grid.center, atol=1e-3)
    np.testing.assert_array_equal(out.roi_bbox[0].numpy(), res.roi_bbox)
    assert int(out.bridged_components[0]) == int(res.bridged_components)


def test_detect_grid_batches_views_independently(ref):
    """Two views in one batch equal each view alone (the kernels and the
    bookkeeping are per view)."""
    img = ref[0]
    both = td.detect_grid(torch.as_tensor(np.stack([img, img[:, ::-1].copy()])), TCFG)
    one = td.detect_grid(_b(img), TCFG)
    np.testing.assert_array_equal(both.grid.valid[0].numpy(), one.grid.valid[0].numpy())
    np.testing.assert_array_equal(both.grid.idx[0].numpy(), one.grid.idx[0].numpy())
    np.testing.assert_allclose(both.grid.xy[0].numpy(), one.grid.xy[0].numpy(), atol=1e-4)
