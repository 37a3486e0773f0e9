"""PyTorch port: the ``cylpose-torch`` drivers (``cli.py``) on the CPU.

``detect-folder`` and ``experiment`` run on the PNG frames of
``write_registration_folder`` and are held to the JAX package's ``cylpose``
on the same files (``tests/fixtures/torch_cli.json``, 240x320): ids
identical with xy within 1e-3 px; the experiment (``experiment_args`` of the
record: ``--no-clahe``) with the healthy frames' fvals within rel 1e-3,
as many healthy frames, the registration within 0.05 deg, 0.1 mm and fval rel
1e-2, well posed as recorded.  ``undistort-folder`` is held to
the JAX package's ``undistort_image`` within one grey level.  Chunks run in
ceil(N / chunk) padded detector calls, and an unreadable image is recorded
as an error while the rest go on.
"""

import contextlib
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.ops.remap import undistort_image as j_undistort
from cylinder_pose_estimation_tpu.utils.io import load_stereo_json as j_load_stereo
from cylinder_pose_estimation_tpu_torch import cli
from cylinder_pose_estimation_tpu_torch.geometry.registration import axis_errors
from cylinder_pose_estimation_tpu_torch.utils import png
from cylinder_pose_estimation_tpu_torch.utils.synthetic import write_registration_folder

torch.set_num_threads(1)

H, W = 240, 320
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_cli.json")
with open(FIXTURE) as _f:
    RECORD = json.load(_f)["records"][f"{H}x{W}"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_in"))
    assert write_registration_folder(d, RECORD["frames"], H, W) == RECORD["names"]
    return d


def _run(*argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    return buf.getvalue()


def test_parse_img_info():
    assert cli.parse_img_info("10-20") == (10.0, -20.0)
    assert cli.parse_img_info("-15-5") == (-15.0, -5.0)
    assert cli.parse_img_info("175") == (17.0, 5.0)
    assert cli.parse_img_info("00") == (0.0, 0.0)
    assert cli.parse_img_info("frame1") is None
    # The reference's greedy first group: unsigned multi-digit pairs split
    # as (all but the last digit, the last digit).
    assert cli.parse_img_info("1010") == (101.0, 0.0)
    assert all(cli.parse_img_info(n) == tuple(map(float, a))
               for n, a in zip(RECORD["names"], RECORD["angles_deg"]))


def test_detect_folder_matches_jax_cli(folder, tmp_path):
    out = str(tmp_path / "out")
    _run("detect-folder", "--camera-json", os.path.join(folder, "cameras.json"), "--input", folder,
         "--output", out, "--device", "cpu")
    with open(os.path.join(out, "processed_images_data.json")) as f:
        got = json.load(f)
    want = RECORD["detect_folder"]
    assert set(got) == set(want)
    for name, rec in want.items():
        g = {p["id"]: (p["x"], p["y"]) for p in got[name]["points"]}
        w = {p["id"]: (p["x"], p["y"]) for p in rec["points"]}
        assert set(g) == set(w), name
        assert max((max(abs(g[k][0] - w[k][0]), abs(g[k][1] - w[k][1])) for k in w), default=0.0) <= 1e-3
        assert [p["id"] for p in got[name]["points"]] == [p["id"] for p in rec["points"]]
        assert np.abs(np.subtract(got[name]["center_point"], rec["center_point"])).max() <= 1e-3
        assert os.path.exists(os.path.join(out, os.path.splitext(name)[0] + "_arc.png"))


_FLOAT = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"


def parse_experiment(text: str) -> dict:
    """The experiment's printed per-frame errors, fvals, observability and
    T_Cam_AGV."""
    frames = [tuple(float(v) for v in m) for m in
              re.findall(rf"average error = ({_FLOAT}) -> ({_FLOAT}) mm", text)]
    fval0, fval = (float(v) for v in re.search(rf"registration fval: ({_FLOAT}) -> ({_FLOAT})", text).groups())
    obs = re.search(rf"registration: (\d+) of \d+ frames healthy, min eigenvalue ({_FLOAT}), "
                    r"well posed (True|False)", text)
    t = np.asarray([float(v) for v in re.findall(_FLOAT, text.split("T_Cam_AGV =")[1])[:16]]).reshape(4, 4)
    return {"frames": frames, "fval0": fval0, "fval": fval, "healthy": int(obs.group(1)),
            "jtj_min_eig": float(obs.group(2)), "well_posed": obs.group(3) == "True", "t_cam_agv": t}


def test_experiment_matches_jax_cli(folder):
    text = _run("experiment", "--camera-json", os.path.join(folder, "cameras.json"), "--input", folder,
                "--device", "cpu", *RECORD["experiment_args"])
    got = parse_experiment(text)
    want = RECORD["experiment"]
    assert len(got["frames"]) == RECORD["frames"]
    assert got["healthy"] == want["healthy"] >= 2
    # The healthy frames' fits (an unhealthy frame's few points may fit
    # another way: it does not enter the registration).
    healthy = np.asarray(want["healthy_frames"])
    np.testing.assert_allclose(np.square(got["frames"])[healthy], np.asarray(want["fvals"])[healthy], rtol=1e-3)
    ang = np.radians(np.asarray(RECORD["angles_deg"], np.float32))
    a, p = axis_errors(np.asarray(want["t_cam_agv"]), got["t_cam_agv"], ang)
    assert a.max() < 0.05 and p.max() < 0.1
    assert abs(got["fval"] - want["fval"]) <= 1e-2 * abs(want["fval"])
    assert got["well_posed"] == want["well_posed"] is True


def test_undistort_folder_within_one_grey_level_of_jax(folder, tmp_path):
    out = str(tmp_path / "und")
    cam = os.path.join(folder, "cameras.json")
    _run("undistort-folder", "--camera-json", cam, "--input", folder, "--output", out, "--device", "cpu")
    jst = j_load_stereo(cam)
    names = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    assert sorted(os.listdir(out)) == sorted(n[:-4] + "_undistorted.png" for n in names)
    und = {True: jax.jit(lambda x: j_undistort(x, jst.cam1)), False: jax.jit(lambda x: j_undistort(x, jst.cam2))}
    for n in names[:2]:
        img = png.read_png(os.path.join(folder, n)).astype(np.float32)
        want = np.clip(np.asarray(und["L" in n[:-4]](img)), 0, 255).astype(np.uint8)
        got = png.read_png(os.path.join(out, n[:-4] + "_undistorted.png"))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_detect_folder_chunks_and_isolates_errors(folder, tmp_path, monkeypatch):
    """Five frames at --chunk 2 run in three calls of two (the last padded);
    a broken file is recorded as an error and the others are detected."""
    src = str(tmp_path / "in")
    os.makedirs(src)
    names = sorted(f for f in os.listdir(folder) if f.endswith(".png"))[:5]
    for n in names:
        with open(os.path.join(folder, n), "rb") as a, open(os.path.join(src, n), "wb") as b:
            b.write(a.read())
    with open(os.path.join(src, "brokenL.png"), "wb") as f:
        f.write(b"not a png")
    calls = []
    real = cli._batched_detect_runner

    def counting(stereo, cfg):
        run = real(stereo, cfg)

        def wrapped(imgs, is_left):
            calls.append(imgs.shape[0])
            return run(imgs, is_left)

        return wrapped

    monkeypatch.setattr(cli, "_batched_detect_runner", counting)
    out = str(tmp_path / "out")
    _run("detect-folder", "--camera-json", os.path.join(folder, "cameras.json"), "--input", src,
         "--output", out, "--device", "cpu", "--chunk", "2")
    assert calls == [2, 2, 2]
    with open(os.path.join(out, "processed_images_data.json")) as f:
        data = json.load(f)
    assert set(data) == set(names) | {"brokenL.png"}
    assert "not a PNG" in data["brokenL.png"]["error"]
    for n in names:
        assert [p["id"] for p in data[n]["points"]] == [p["id"] for p in RECORD["detect_folder"][n]["points"]]


def test_load_image_reads_pillow_formats(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "x.bmp")
    with Image.open(tmp_path / "x.bmp") as im:
        np.testing.assert_array_equal(cli.load_image(str(tmp_path / "x.bmp")),
                                      np.asarray(im.convert("L"), np.float32))
