"""PyTorch port: the endpoint-stats bridge (``bridge_endpoint_stats=True``)
against the JAX package's Pallas path in interpret mode.

* ``_bridge_angle_exp_endpoint_pair`` fed the same payload extremes: median
  angles within 1e-6 rad, expandability masks exact, on line fragments and
  on a mask with more in-band fragments than the median's 64-entry cap;
* ``bridge_stage`` fed the JAX carved masks: bridged masks exact, the same
  pre-bridge count, no warm labels;
* ``detect_grid`` on a 240x320 cylinder scene, clean and with a bridged
  dropout: ids identical, xy within 1e-3 px, the same flags and counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, PlaneDetectConfig
from cylinder_pose_estimation_tpu.models import detector as jd
from cylinder_pose_estimation_tpu.ops.pallas import frontend as jf
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
GAP = (112, 122, 130, 140)  # y0, y1, x0, x1: a dropout the bridge closes

JCFG = CylinderDetectConfig(height=H, width=W, use_pallas=True, pallas_interpret=True,
                            bridge_endpoint_stats=True)
TCFG = from_reference(JCFG)
JPLANE = PlaneDetectConfig(height=H, width=W, use_pallas=True, pallas_interpret=True,
                           bridge_endpoint_stats=True)


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


# --------------------------------------------------------------------------
# Endpoint statistics, given the same payload extremes
# --------------------------------------------------------------------------


def _half_res_masks(kind, hs=120, ws=256):
    """(2, hs, ws) h/v masks on a half-res padded canvas."""
    rng = np.random.default_rng({"lines": 0, "curved": 1, "many": 2}[kind])
    yy, xx = np.mgrid[:hs, :ws]
    mh = np.zeros((hs, ws), bool)
    mv = np.zeros((hs, ws), bool)
    if kind == "lines":
        for yc in range(8, hs - 8, 9):
            tilt = rng.uniform(-0.15, 0.15)
            seg = (np.abs(yy - yc - tilt * (xx - ws / 2)) < 1.0) & (xx > 4) & (xx < 150)
            mh |= seg & (((xx + 7 * yc) // 23) % 4 != 0)
        for xc in range(6, 150, 11):
            tilt = rng.uniform(-0.2, 0.2)
            seg = (np.abs(xx - xc - tilt * (yy - hs / 2)) < 1.0) & (yy > 3) & (yy < hs - 3)
            mv |= seg & (((yy + 5 * xc) // 19) % 3 != 0)
    elif kind == "curved":
        xs = np.arange(4, 150)
        for yc in range(10, hs - 10, 12):
            ys = (yc + 3 * np.sin(xs / 9.0 + rng.uniform(0, 6))).astype(int)
            keep = (xs // 17) % 3 != 1
            mh[ys[keep], xs[keep]] = True
        ys = np.arange(4, hs - 4)
        for xc in range(8, 150, 13):
            xv = (xc + 3 * np.sin(ys / 8.0 + rng.uniform(0, 6))).astype(int)
            keep = (ys // 15) % 3 != 1
            mv[ys[keep], xv[keep]] = True
    else:  # "many": >64 short in-band dashes per mask
        for yc in range(4, hs - 4, 5):
            for x0 in range(4, 150, 9):
                mh[yc, x0:x0 + 4 + (x0 // 9) % 3] = True
        for xc in range(4, 150, 5):
            for y0 in range(4, hs - 8, 9):
                mv[y0:y0 + 4 + (y0 // 9) % 3, xc] = True
    return np.stack([mh, mv])


def _scan_payloads(hs, ws):
    ys, xs = np.mgrid[:hs, :ws]
    return np.stack([xs * hs + ys, ys * ws + xs]).astype(np.int32)


@pytest.mark.parametrize("cfg", [JCFG, JPLANE], ids=["cylinder", "plane"])
@pytest.mark.parametrize("kind", ["lines", "curved", "many"])
def test_endpoint_stats_match(kind, cfg):
    small = _half_res_masks(kind)
    hs, ws = small.shape[-2:]
    pay = _scan_payloads(hs, ws)
    assert np.array_equal(td._scan_payloads(hs, ws, "cpu").numpy(), pay)
    pmin, pmax = jf.component_payload_minmax(jnp.asarray(small), jnp.asarray(pay), rounds=2,
                                             interpret=True)
    ang_j, exp_j = jax.jit(lambda o, a, b: jd._bridge_angle_exp_endpoint_pair(o, a, b, cfg, scale=2))(
        jnp.asarray(small, jnp.float32), pmin, pmax)
    ang_t, exp_t = td._bridge_angle_exp_endpoint_pair(
        torch.as_tensor(small)[None], torch.as_tensor(np.array(pmin))[None],
        torch.as_tensor(np.array(pmax))[None], from_reference(cfg), scale=2)
    np.testing.assert_allclose(ang_t[0].numpy(), np.asarray(ang_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(exp_t[0].numpy(), np.asarray(exp_j))
    if kind == "many":
        # The median reads only the first 64 in-band roots: there are more.
        pm = np.asarray(pmin)
        mx = np.asarray(pmax)
        roots = small & (pm == pay) & (mx > pm)
        assert (roots.reshape(2, -1).sum(axis=1) > 64).all()


# --------------------------------------------------------------------------
# Bridge stage and the whole detector
# --------------------------------------------------------------------------

_full = jax.jit(lambda im: jd.detect_grid(im, JCFG, return_debug=True))
_probe = jax.jit(lambda im: jd.detect_grid(im, dataclasses.replace(JCFG, stage_probe="bridge_state")))
_jbridge = jax.jit(lambda mh, mv, kl: jd._bridge_pair(
    mh, mv, kl, JCFG.bridge_kernel_base + 160, JCFG))


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
    return torch.as_tensor(np.array(x))[None]


def test_bridge_stage_endpoint_matches(ref):
    _, _, dbg, st = ref
    kl = jnp.float32(JCFG.bridge_kernel_base) + jnp.asarray(st["circle_radius0"])
    h_j, v_j, warm_j, ang_j, n_pre_j, _ = _jbridge(jnp.asarray(dbg.h_mask), jnp.asarray(dbg.v_mask), kl)
    assert warm_j is None
    br = td.bridge_stage(_b(dbg.h_mask), _b(dbg.v_mask), _b(st["circle_radius0"]), TCFG)
    np.testing.assert_array_equal(br.h_exp[0].numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(br.v_exp[0].numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(br.h_exp[0].numpy(), st["h_exp"])
    np.testing.assert_allclose(br.angles[0].numpy(), np.asarray(ang_j), rtol=0, atol=1e-6)
    assert int(br.n_pre[0]) == int(n_pre_j)
    assert br.warm_labels is None
    assert not bool(br.pre_converged[0])


def _grid_map(grid, i=0):
    xy = grid.xy[i].numpy()
    idx = grid.idx[i].numpy()
    v = grid.valid[i].numpy()
    return {tuple(idx[k]): xy[k] for k in range(len(v)) if v[k]}


def test_detect_grid_endpoint_matches(ref):
    img, res, _, _ = ref
    out = td.detect_grid(_b(img), TCFG)
    got = _grid_map(out.grid)
    want = {tuple(res.grid.idx[k]): res.grid.xy[k] for k in range(len(res.grid.valid))
            if res.grid.valid[k]}
    assert len(want) >= 20 and set(got) == set(want)
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-3
    for flag in ("ok", "stable", "labels_converged"):
        assert bool(getattr(out, flag)[0]) == bool(getattr(res, flag)), flag
    assert int(out.bridged_components[0]) == int(res.bridged_components)
    np.testing.assert_array_equal(out.roi_bbox[0].numpy(), res.roi_bbox)
