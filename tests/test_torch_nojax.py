"""PyTorch port: runs with JAX absent.

The GPU machine has no JAX, so neither the port nor ``chip_smoke.py`` may
import it.  A subprocess blocks ``import jax``, renders a 2-frame scene with
the port's own scene source and runs ``estimate_poses_batch`` on the CPU,
then the endpoint-stats detector on it, plane-mode ``detect_grid`` on a
rendered plane view and ``fit_plane``, and imports the preprocessing,
kinematics, registration and stream modules and runs a small registration,
imports ``parallel/`` and runs ``sharded_pipeline`` over a one-rank gloo
group (equal to the unsharded batch and registration), then imports the package and every module of the user surface (refinement,
JSON contracts, PNG files, viz, profiling, CLI, examples) and runs the
full-resolution and refinement variants.  A second subprocess blocks JAX,
Pillow and matplotlib (a minimal GPU installation) and runs
``cylpose-torch detect-folder`` and ``undistort-folder`` on two PNGs.  A
third loads tests/_oracle_detect.py, which ``chip_smoke.py`` phase 17 runs
on the card machine, with JAX blocked; the source check covers it too.
``chip_smoke.py`` must print its first line before it fails, in the
repository and alone in a directory.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cylinder_pose_estimation_tpu_torch"

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)  # one thread: test workers share the cores
from cylinder_pose_estimation_tpu_torch.config import (
    CylinderDetectConfig, FitConfig, PlaneDetectConfig)
from cylinder_pose_estimation_tpu_torch.geometry.plane import fit_plane
from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair, plane_view

stereo_np, (i1, i2) = example_pair(480, 640, n_frames=2)
stereo = stereo_from_numpy(*stereo_np, device="cpu")
res = estimate_poses_batch(torch.as_tensor(i1), torch.as_tensor(i2), stereo,
                           CylinderDetectConfig(use_pallas=True), FitConfig())
assert res.fit.params.shape == (2, 6)
assert bool(torch.isfinite(res.fit.params).all())
assert bool(res.detect1.ok.all()) and bool(res.detect2.ok.all())
assert int(res.detect1.grid.valid.sum()) == 80
ep = detect_grid(torch.as_tensor(i1), CylinderDetectConfig(use_pallas=True, bridge_endpoint_stats=True))
assert bool(ep.ok.all())
pv = plane_view(480, 640, (0.0, 0.0, 700.0), (0.05, -0.08, -1.0), 9, 11, 30.0, 10)
pl = detect_grid(torch.as_tensor(pv)[None], PlaneDetectConfig(use_pallas=True, roi_threshold=30.0))
assert int(pl.grid.valid.sum()) == 99
pts = torch.randn(1, 20, 3) * torch.tensor([50.0, 50.0, 0.0])
assert abs(float(fit_plane(pts, torch.ones(1, 20, dtype=torch.bool))[0, 2])) > 0.999
from cylinder_pose_estimation_tpu_torch.config import RegistrationConfig
from cylinder_pose_estimation_tpu_torch.geometry.kinematics import t_agv_cyl
from cylinder_pose_estimation_tpu_torch.geometry.registration import fit_cylinders_with_angles
from cylinder_pose_estimation_tpu_torch.models.pipeline import (
    estimate_poses_stream, full_experiment, preprocess_stereo_batch, register_sequence)
from cylinder_pose_estimation_tpu_torch.ops.clahe import clahe
from cylinder_pose_estimation_tpu_torch.ops.remap import undistort_image
p1, p2 = preprocess_stereo_batch(torch.as_tensor(i1[:1]), torch.as_tensor(i2[:1]), stereo)
assert p1.shape == (1, 480, 640) and bool(torch.isfinite(p1).all())
ang = torch.tensor([[-0.2, 0.03], [0.2, -0.03]])
reg = register_sequence(res, ang, RegistrationConfig(lm_iters=3))
assert reg.t_cam_agv.shape == (4, 4) and bool(torch.isfinite(reg.t_cam_agv).all())
import datetime
import torch.distributed as dist
from cylinder_pose_estimation_tpu_torch.parallel import dryrun, mesh, sharding
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                        timeout=datetime.timedelta(seconds=60))
sb, sr = sharding.sharded_pipeline(mesh.make_mesh(devices=["cpu"]), stereo, CylinderDetectConfig(use_pallas=True),
                                   FitConfig(), RegistrationConfig(lm_iters=3))(i1, i2, ang.numpy())
dist.destroy_process_group()
assert dryrun.digest(sb) == dryrun.digest(res) and dryrun.digest(sr) == dryrun.digest(reg)
import cylinder_pose_estimation_tpu_torch as pkg
from cylinder_pose_estimation_tpu_torch import cli
from cylinder_pose_estimation_tpu_torch.examples import quickstart, streaming_serving
from cylinder_pose_estimation_tpu_torch.models import refine
from cylinder_pose_estimation_tpu_torch.utils import io, png, profiling, viz
assert pkg.io is io and pkg.detect_grid is detect_grid
for over in ({"subpixel_refine": True}, {"label_downsample": 1}, {"bridge_half_res": False}):
    for up in (True, False):
        d = detect_grid(torch.as_tensor(i1[:1]), CylinderDetectConfig(use_pallas=up, **over))
        assert bool(d.ok.all()), (over, up)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m] is not None)
print("NOJAX_OK", float(res.fit.mean_reproj_error.max()))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(ROOT)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


_CLI_SCRIPT = r"""
import sys
for blocked in ("jax", "PIL", "matplotlib"):
    sys.modules[blocked] = None  # importing any of them now raises ImportError
sys.path.insert(0, sys.argv[1])
import json, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from cylinder_pose_estimation_tpu_torch import cli
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils.io import save_stereo_json
from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

st, (i1, i2) = example_pair(240, 320, n_frames=1)
with tempfile.TemporaryDirectory() as d:
    src = os.path.join(d, "in")
    os.makedirs(src)
    cli.save_image(os.path.join(src, "00L.png"), i1[0])
    cli.save_image(os.path.join(src, "00R.png"), i2[0])
    with open(os.path.join(src, "01L.jpg"), "wb") as f:
        f.write(b"a jpeg without Pillow")
    cam = os.path.join(d, "cameras.json")
    save_stereo_json(cam, stereo_from_numpy(*st, device="cpu"))
    cli.main(["detect-folder", "--camera-json", cam, "--input", src, "--output", os.path.join(d, "out"),
              "--device", "cpu", "--chunk", "2"])
    with open(os.path.join(d, "out", "processed_images_data.json")) as f:
        data = json.load(f)
    assert all(len(data[n]["points"]) >= 5 for n in ("00L.png", "00R.png")), data
    assert "Pillow" in data["01L.jpg"]["error"]
    assert os.path.getsize(os.path.join(d, "out", "00L_arc.png")) > 1000
    cli.main(["undistort-folder", "--camera-json", cam, "--input", src, "--output", os.path.join(d, "und"),
              "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(d, "und"))) == ["00L_undistorted.png", "00R_undistorted.png"]
loaded = [m for m in ("jax", "PIL", "matplotlib") if sys.modules.get(m) is not None]
assert not loaded, loaded
print("CLI_OK")
"""


def test_cli_runs_without_jax_pillow_matplotlib():
    """A GPU host may have neither Pillow nor matplotlib: detect-folder
    reads and writes PNGs with the package's own codec, draws its overlays
    in numpy, and records a .jpg it cannot read as that file's error."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_SCRIPT, str(ROOT)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLI_OK" in proc.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    # _build/ holds build output, not sources.  chip_smoke.py also loads the
    # numpy oracle of tests/_oracle_detect.py (phase 17).
    sorted(p for p in PORT.rglob("*.py") if "_build" not in p.relative_to(PORT).parts)
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "_oracle_detect.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_port_sources(path):
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "cylinder_pose_estimation_tpu"), (
            f"{path.name} imports {mod}"
        )


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """On a machine without a CUDA device the chip check must fail and
    print no result line, both in the repository and alone in a directory
    without the package; either way its first stdout line, the versions in
    use, comes before the failure."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is not reachable")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        proc = subprocess.run(
            [sys.executable, str(script)],
            capture_output=True, text=True, timeout=120, cwd=cwd,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
        first = proc.stdout.splitlines()[0]
        assert first.startswith("chip_smoke: python ") and f"torch {torch.__version__}" in first, proc.stdout


_ORACLE_SCRIPT = r"""
import importlib.util, os, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
spec = importlib.util.spec_from_file_location("_oracle_detect", os.path.join(sys.argv[1], "tests", "_oracle_detect.py"))
od = importlib.util.module_from_spec(spec)
spec.loader.exec_module(od)
labels = od.label_masks(np.eye(8, dtype=bool))
assert labels.max() == 1
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m] is not None)
print("ORACLE_OK")
"""


def test_oracle_loads_without_jax():
    """chip_smoke.py phase 17 loads tests/_oracle_detect.py (numpy and
    scipy) on a machine without JAX, as this subprocess does."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _ORACLE_SCRIPT, str(ROOT)],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ORACLE_OK" in proc.stdout
