"""PyTorch port: runs with JAX absent.

The GPU machine has no JAX, so neither the port nor ``chip_smoke.py`` may
import it.  A subprocess blocks ``import jax``, renders a 2-frame scene with
the port's own scene source and runs ``estimate_poses_batch`` on the CPU,
then the endpoint-stats detector on it, plane-mode ``detect_grid`` on a
rendered plane view and ``fit_plane``, and imports the preprocessing,
kinematics, registration and stream modules and runs a small registration.
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
    # _build/ holds build output, not sources.
    sorted(p for p in PORT.rglob("*.py") if "_build" not in p.relative_to(PORT).parts)
    + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_port_sources(path):
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "cylinder_pose_estimation_tpu"), (
            f"{path.name} imports {mod}"
        )


def test_chip_smoke_refuses_without_cuda():
    """On a machine without a CUDA device the chip check must fail and
    print no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is not reachable")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
