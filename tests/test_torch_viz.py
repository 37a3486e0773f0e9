"""PyTorch port: ``utils/viz.py`` (the cylinder mesh against the JAX
package's, every figure renders, the numpy detection overlay),
``utils/profiling.py`` and the package API."""

import json
import os

import numpy as np
import pytest
import torch

import cylinder_pose_estimation_tpu as jpkg
import cylinder_pose_estimation_tpu_torch as tpkg
from cylinder_pose_estimation_tpu.utils import viz as jviz
from cylinder_pose_estimation_tpu_torch.types import GridPoints
from cylinder_pose_estimation_tpu_torch.utils import profiling, png
from cylinder_pose_estimation_tpu_torch.utils import viz as tviz
from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)

torch.set_num_threads(1)

H, W = 240, 320


@pytest.fixture(scope="module")
def scene():
    st = default_stereo(cx=W / 2.0, cy=H / 2.0, baseline=30.0)
    return st, cylinder_grid_points(st, origin=(0.0, -15.0, 560.0), radius=70.0, row_spacing=18.0,
                                    theta_span=2.0)


def _gp(sc) -> GridPoints:
    n = len(sc.xy1)
    return GridPoints(torch.as_tensor(sc.xy1), torch.as_tensor(sc.idx), torch.ones(n, dtype=torch.bool),
                      torch.as_tensor(sc.xy1[n // 2]))


@pytest.mark.parametrize("params", [
    [0.0, -15.0, 560.0, 0.05, 1.0, 0.02],
    [10.0, 3.0, 400.0, -0.3, 0.9, 0.4],
])
def test_cylinder_mesh_matches_jax(params):
    p = np.asarray(params, np.float32)
    got = tviz.cylinder_mesh(p, 45.0)
    want = jviz.cylinder_mesh(p, 45.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    # the mesh lies on the cylinder
    pts = np.stack(got, -1).reshape(-1, 3)
    d = p[3:] / np.linalg.norm(p[3:])
    rel = pts - p[:3]
    np.testing.assert_allclose(np.linalg.norm(rel - (rel @ d)[:, None] * d, axis=1), 45.0, atol=1e-3)


def test_figures_render(tmp_path, scene):
    import matplotlib.pyplot as plt

    st, sc = scene
    p = str(tmp_path)
    pts = torch.as_tensor(sc.pts3)
    valid = torch.ones(len(pts), dtype=torch.bool)
    prm = torch.as_tensor(sc.cyl_params)
    tviz.plot_reprojection_errors(torch.full((32,), 0.2), torch.ones(32, dtype=torch.bool),
                                  path=os.path.join(p, "re.png"))
    tviz.visualize_cylinder_fitting(pts, valid, prm, prm, 70.0, path=os.path.join(p, "fit.png"))
    tviz.plot_fvals(np.asarray([[900.0, 60.0], [800.0, 50.0]]), path=os.path.join(p, "fv.png"))
    tviz.plot_cylinders_3d([prm], 70.0, pts3=[pts], valid=[valid], path=os.path.join(p, "c3.png"))
    line = np.stack([sc.cyl_params[:3] - 50 * sc.cyl_params[3:], sc.cyl_params[:3] + 50 * sc.cyl_params[3:]])
    tviz.plot_transformed_data(pts, line, np.eye(4), radius=70.0, path=os.path.join(p, "tr.png"))
    tviz.visualize_3d_points(pts, path=os.path.join(p, "p3.png"))
    tviz.animate_orbit(pts, valid, prm, 70.0, os.path.join(p, "orbit.png"), n_frames=3)
    fig, ax = plt.subplots()
    tviz.draw_grid_points(ax, _gp(sc))
    tviz.draw_cylinder(ax, prm, 70.0, st.cam1_k)
    tviz.figresize(fig, (800, 500))
    assert tuple(np.round(fig.get_size_inches() * fig.dpi)) == (800, 500)
    plt.close(fig)
    for f in ("re.png", "fit.png", "fv.png", "c3.png", "tr.png", "p3.png", "orbit.png"):
        assert os.path.getsize(os.path.join(p, f)) > 1000
    xs = [np.zeros((2, 2)) + i for i in range(4)]
    info = tviz.structure_cyl_info([2, 0], xs, xs, xs)
    assert len(info) == 2 and float(info[0]["X"][0, 0]) == 2.0
    assert tviz.find_matching_idx(["/a/b/10-20L.png", "/a/b/frameR.png", "c/00L.png"],
                                  {"10-20L", "00L"}) == [0, 2]


def test_overlay_detection_rasterises_points(tmp_path, scene):
    _, sc = scene
    gp = _gp(sc)
    img = render_grid_image(sc.xy1, 9, 9, H, W)
    path = str(tmp_path / "ov.png")
    rgb = tviz.overlay_detection(img, gp, path=path)
    np.testing.assert_array_equal(png.read_png(path), rgb)
    assert rgb.shape == (H, W, 3)
    # Each point's dot carries its column's hue: one colour per column.
    xy = np.round(sc.xy1).astype(int)
    inside = (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)
    far = np.linalg.norm(sc.xy1 - sc.xy1[len(xy) // 2], axis=1) > 9  # off the centre cross
    dots = {}
    for (x, y), col in zip(xy[inside & far], sc.idx[inside & far, 0]):
        dots.setdefault(int(col), set()).add(tuple(rgb[y, x]))
    assert all(len(c) == 1 for c in dots.values()) and len({next(iter(c)) for c in dots.values()}) == len(dots)
    cx, cy = np.round(sc.xy1[len(xy) // 2]).astype(int)
    assert tuple(rgb[cy, cx + 5]) == (255, 255, 255)
    # Pixels away from the marks keep the grey frame.
    np.testing.assert_array_equal(rgb[:5, :5], np.repeat(img[:5, :5, None], 3, -1))


def test_stage_timer_and_trace(tmp_path):
    seen = []

    def fn(x):
        seen.append(float(x[0]))
        return {"y": x * 2.0, "z": (x.sum(),)}

    out = profiling.stage_timer(fn, lambda i: (torch.full((8,), float(i)),), n_calls=4, warmup=2)
    assert out["n_calls"] == 4 and out["device"] == "cpu"
    assert out["total_s"] > 0 and out["avg_s"] == pytest.approx(out["total_s"] / 4)
    assert seen == [-1.0, -2.0, 0.0, 1.0, 2.0, 3.0]
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(16).cumsum(0)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_package_api_mirrors_the_reference():
    assert tpkg.__all__ == jpkg.__all__
    assert tpkg.__version__ == jpkg.__version__
    for name in tpkg.__all__:
        obj = getattr(tpkg, name)
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")).startswith(
            "cylinder_pose_estimation_tpu_torch"), name
    assert tpkg.io.grid_points_to_json is not None and tpkg.detect_grid.__module__.endswith("detector")
