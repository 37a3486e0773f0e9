"""PyTorch port: the reference's JSON contracts (``utils/io.py``) written
byte for byte as the JAX package writes them, read back on any device, with
both id spellings of the grid-point JSON."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu.types import GridPoints as JGridPoints
from cylinder_pose_estimation_tpu.utils import io as jio
from cylinder_pose_estimation_tpu.utils.synthetic import default_stereo
from cylinder_pose_estimation_tpu_torch.types import GridPoints
from cylinder_pose_estimation_tpu_torch.utils import io as tio
from _torch_port import port_stereo

torch.set_num_threads(1)


def _rigs(with_artifacts: bool):
    st = default_stereo(f=911.5, cx=318.25, cy=241.75)
    st = st._replace(cam1=st.cam1._replace(radial=jnp.asarray([-0.3, 0.08, 1e-3], jnp.float32),
                                           tangential=jnp.asarray([1e-3, -5e-4], jnp.float32)))
    if with_artifacts:
        pats = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        pats[:, 0, 3] = [1.5, 2.25, -3.0]
        st = st._replace(t_c1_patterns=jnp.asarray(pats), t_c2_patterns=jnp.asarray(pats + 0.5),
                         calib_points=jnp.asarray(np.arange(12, dtype=np.float32).reshape(6, 2) * 0.1))
    port = port_stereo(st)
    if with_artifacts:
        port = port._replace(**{k: torch.as_tensor(np.array(getattr(st, k)))
                                for k in ("t_c1_patterns", "t_c2_patterns", "calib_points")})
    return st, port


@pytest.mark.parametrize("with_artifacts", [False, True], ids=["rig", "rig_with_calibration"])
def test_stereo_json_byte_equal_and_round_trip(tmp_path, with_artifacts):
    jst, tst = _rigs(with_artifacts)
    jio.save_stereo_json(str(tmp_path / "jax.json"), jst)
    tio.save_stereo_json(str(tmp_path / "port.json"), tst)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    back = tio.load_stereo_json(str(tmp_path / "jax.json"), device="cpu")
    for a, b in zip((back.cam1.k, back.cam1.radial, back.cam1.tangential, back.cam2.k, back.t_c2_c1),
                    (tst.cam1.k, tst.cam1.radial, tst.cam1.tangential, tst.cam2.k, tst.t_c2_c1)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert (back.t_c1_patterns is None) == (not with_artifacts)
    if with_artifacts:
        assert torch.equal(back.calib_points, tst.calib_points)


def test_loaders_take_device_and_dtype(tmp_path):
    """The reference's own wire format (IntrinsicMatrix only, short
    distortion lists) loads as the JAX loader reads it, in the asked dtype."""
    ref_style = {
        "LeftCamera": {"IntrinsicMatrix": [[900.0, 0, 320.0], [0, 901.0, 240.0], [0, 0, 1]],
                       "RadialDistortion": [0.1, -0.05], "TangentialDistortion": [0.001, -0.002]},
        "RightCamera": {"FocalLength": [905.0, 906.0], "PrincipalPoint": [322.0, 238.0],
                        "RadialDistortion": [0.09], "TangentialDistortion": []},
    }
    p = tmp_path / "ref_cam.json"
    p.write_text(json.dumps(ref_style))
    got = tio.load_stereo_json(str(p), device="cpu", dtype=torch.float64)
    want = jio.load_stereo_json(str(p))
    assert got.cam1.k.dtype == torch.float64
    for a, b in ((got.cam1.k, want.cam1.k), (got.cam1.radial, want.cam1.radial),
                 (got.cam2.k, want.cam2.k), (got.cam2.tangential, want.cam2.tangential),
                 (got.t_c2_c1, want.t_c2_c1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float64))
    cams = tio.load_camera_json(str(p), device="cpu")
    assert torch.equal(cams[1].radial, torch.tensor([0.09, 0.0, 0.0], dtype=torch.float32))


def _points(seed: int, n: int = 40, cap: int = 64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 640, (cap, 2)).astype(np.float32)
    idx = rng.integers(-6, 7, (cap, 2)).astype(np.int32)
    valid = np.zeros(cap, bool)
    valid[rng.choice(cap, n, replace=False)] = True
    center = xy[np.flatnonzero(valid)[0]]
    return xy, idx, valid, center


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_points_json_byte_equal(seed):
    xy, idx, valid, center = _points(seed)
    want = jio.grid_points_to_json(JGridPoints(jnp.asarray(xy), jnp.asarray(idx), jnp.asarray(valid),
                                               jnp.asarray(center)))
    got = tio.grid_points_to_json(GridPoints(*(torch.as_tensor(a) for a in (xy, idx, valid, center))))
    assert got == want


@pytest.mark.parametrize("spelling", ["({},{})", "[{},{}]", "( {} , {} )"])
def test_grid_points_from_json_id_spellings(spelling):
    xy, idx, valid, center = _points(3, n=12, cap=16)
    text = json.dumps({"center_point": [float(c) for c in center],
                       "points": [{"id": spelling.format(int(i), int(j)), "x": float(x), "y": float(y)}
                                  for (x, y), (i, j), v in zip(xy, idx, valid) if v]})
    got = tio.grid_points_from_json(text, capacity=16, device="cpu")
    want = jio.grid_points_from_json(text, capacity=16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.valid.sum()) == 12


def test_grid_points_to_json_takes_one_view():
    xy, idx, valid, center = _points(4)
    batch = GridPoints(*(torch.as_tensor(a)[None] for a in (xy, idx, valid, center)))
    with pytest.raises(ValueError, match="one view"):
        tio.grid_points_to_json(batch)
